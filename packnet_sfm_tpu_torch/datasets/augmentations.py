"""Host-side sample transforms: the port's own copy of the eval half of
``packnet_sfm_tpu/datasets/augmentations.py`` and of ``draw_jitter_params``
(numpy; same results for the same inputs). The jitter itself runs on the
device (``ops/jitter.apply_jitter``). Pillow (the LANCZOS resize) and cv2
(the nearest depth resize) are imported where they are used. The train
transform waits for the trainer slice (ROADMAP.md §1 item 2).

Images flow as float32 [H, W, 3] in [0, 1] (or uint8 before
``ensure_float_sample``); depths as float32 [H, W, 1] (0 = invalid).
"""

from __future__ import annotations

import numpy as np

from packnet_sfm_tpu_torch.utils.misc import filter_dict, parse_crop_borders

_IMAGE_KEYS = ("rgb", "rgb_original")
_IMAGE_LIST_KEYS = ("rgb_context", "rgb_context_original")
_DEPTH_KEYS = ("depth", "input_depth")


def resize_image(image: np.ndarray, shape, filter: str = "lanczos") -> np.ndarray:
    """Antialiased LANCZOS resize through Pillow, the eval protocol's.

    uint8 stays uint8; float32 in [0, 1] goes through uint8 and comes back
    float32. The train transform's 'area' filter (cv2) is not ported yet.
    """
    h, w = int(shape[0]), int(shape[1])
    if image.shape[:2] == (h, w):
        return image
    if filter != "lanczos":
        raise NotImplementedError(
            f"resize filter {filter!r} belongs to the train transform, which is not "
            "ported yet; see ROADMAP.md §1 item 2")
    from PIL import Image

    if image.dtype == np.uint8:
        return np.asarray(Image.fromarray(image).resize((w, h), Image.LANCZOS))
    pil = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    out = pil.resize((w, h), Image.LANCZOS)
    return np.asarray(out).astype(np.float32) / 255.0


def ensure_float_sample(sample: dict) -> dict:
    """Convert any uint8 image entries to float32 [0, 1] (model contract)."""
    for key in filter_dict(sample, _IMAGE_KEYS):
        if sample[key].dtype == np.uint8:
            sample[key] = sample[key].astype(np.float32) / 255.0
    for key in filter_dict(sample, _IMAGE_LIST_KEYS):
        sample[key] = [im.astype(np.float32) / 255.0 if im.dtype == np.uint8
                       else im for im in sample[key]]
    return sample


def resize_depth(depth: np.ndarray, shape) -> np.ndarray:
    """Nearest-neighbor depth resize (cv2)."""
    import cv2

    h, w = int(shape[0]), int(shape[1])
    out = cv2.resize(depth[..., 0], dsize=(w, h), interpolation=cv2.INTER_NEAREST)
    return out[..., None].astype(np.float32)


def resize_depth_preserve(depth: np.ndarray, shape) -> np.ndarray:
    """Sparse-point-preserving depth resize: every valid source point is
    scattered to its downsampled coordinate."""
    h, w = depth.shape[:2]
    oh, ow = int(shape[0]), int(shape[1])
    flat = depth.reshape(-1)
    ys, xs = np.mgrid[:h, :w]
    valid = flat > 0
    ys = (ys.reshape(-1)[valid] * (oh / h)).astype(np.int32)
    xs = (xs.reshape(-1)[valid] * (ow / w)).astype(np.int32)
    vals = flat[valid]
    keep = (ys < oh) & (xs < ow)
    out = np.zeros((oh, ow), np.float32)
    out[ys[keep], xs[keep]] = vals[keep]
    return out[..., None]


def crop_sample(sample: dict, borders) -> dict:
    """Crop images and depths, and shift the intrinsics.

    borders: absolute (x1, y1, x2, y2) from ``parse_crop_borders``.
    """
    x1, y1, x2, y2 = borders
    if "intrinsics" in sample:
        K = np.copy(sample["intrinsics"])
        K[0, 2] -= x1
        K[1, 2] -= y1
        sample["intrinsics"] = K
    for key in filter_dict(sample, _IMAGE_KEYS + _DEPTH_KEYS):
        sample[key] = sample[key][y1:y2, x1:x2]
    for key in filter_dict(sample, _IMAGE_LIST_KEYS):
        sample[key] = [im[y1:y2, x1:x2] for im in sample[key]]
    return sample


def draw_jitter_params(parameters, rng: np.random.Generator,
                       prob: float = 1.0) -> np.ndarray:
    """Draw one sample's shared jitter factors [b, c, s, hue] (identity =
    [1, 1, 1, 0]): brightness/contrast/saturation in [max(0, 1-v), 1+v],
    hue in [-v, v]."""
    if rng.uniform() > prob:
        return np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    bv, cv, sv, hv = parameters
    return np.array([
        rng.uniform(max(0.0, 1 - bv), 1 + bv),
        rng.uniform(max(0.0, 1 - cv), 1 + cv),
        rng.uniform(max(0.0, 1 - sv), 1 + sv),
        rng.uniform(-hv, hv),
    ], np.float32)


def eval_transform(sample: dict, image_shape, crop_eval_borders,
                   depth_preserve_input: bool = True) -> dict:
    """Validation/test pipeline: crop the inputs, resize rgb (and
    input_depth), keep the ground-truth depth at its native resolution."""
    if crop_eval_borders:
        borders = parse_crop_borders(crop_eval_borders, sample["rgb"].shape[:2])
        sample = crop_sample(sample, borders)
    if image_shape:
        h, w = sample["rgb"].shape[:2]
        oh, ow = int(image_shape[0]), int(image_shape[1])
        if "intrinsics" in sample:
            K = np.copy(sample["intrinsics"])
            K[0] *= ow / w
            K[1] *= oh / h
            sample["intrinsics"] = K
        sample["rgb"] = resize_image(sample["rgb"], image_shape)
        if "rgb_context" in sample:
            sample["rgb_context"] = [resize_image(im, image_shape)
                                     for im in sample["rgb_context"]]
        if "input_depth" in sample:
            rd = resize_depth_preserve if depth_preserve_input else resize_depth
            sample["input_depth"] = rd(sample["input_depth"], image_shape)
    return ensure_float_sample(sample)
