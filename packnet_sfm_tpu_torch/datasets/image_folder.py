"""Plain image-folder dataset (numbered frames, dummy intrinsics): the
port's own copy of ``packnet_sfm_tpu/datasets/image_folder.py``, used for
OmniCam/NRS training, where the intrinsics are learned (dummy K: f=1000,
centered).

One rule differs from the JAX package's: a context frame is the frame's own
neighbour in its folder's sorted list of images. The JAX package takes the
file at the sample's position in the (trimmed) sample list, plus the
trimmed count and the offset, in the folder's whole sorted listing: the
same frame where there is no split file and the folder holds only the
frames, and another frame under a split (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from packnet_sfm_tpu_torch.datasets.kitti import load_image_u8

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def dummy_intrinsics(image: np.ndarray) -> np.ndarray:
    """f=1000, principal point centered."""
    h, w = image.shape[:2]
    return np.array([[1000.0, 0.0, w / 2.0 - 0.5],
                     [0.0, 1000.0, h / 2.0 - 0.5],
                     [0.0, 0.0, 1.0]], np.float32)


def _folder_images(folder: str) -> list:
    return sorted(f for f in os.listdir(folder) if f.lower().endswith(IMAGE_EXTENSIONS))


class ImageFolderDataset:
    """Folder of numbered frames; context = the neighbouring images of the
    frame's folder."""

    def __init__(self, root_dir: str, split: Optional[str] = None, train: bool = True,
                 data_transform=None, back_context: int = 0, forward_context: int = 0,
                 **kwargs):
        self.root_dir = root_dir
        self.train = train
        self.data_transform = data_transform
        self.backward_context = back_context
        self.forward_context = forward_context
        self.has_context = back_context + forward_context > 0

        if split:
            with open(os.path.join(root_dir, split) if not os.path.isabs(split)
                      else split) as f:
                files = [l.strip() for l in f if l.strip()]
            self.files = [os.path.join(root_dir, fn) for fn in files]
        else:
            self.files = [os.path.join(root_dir, f) for f in _folder_images(root_dir)]
        if self.has_context:
            self.files = self.files[back_context:len(self.files) - forward_context]
        self._listings: dict = {}

    def __len__(self):
        return len(self.files)

    def _neighbor(self, idx: int, delta: int) -> str:
        folder, name = os.path.split(self.files[idx])
        if folder not in self._listings:
            listing = _folder_images(folder)
            self._listings[folder] = listing, {n: i for i, n in enumerate(listing)}
        listing, position = self._listings[folder]
        pos = position[name] + delta
        if not 0 <= pos < len(listing):
            raise IndexError(f"{self.files[idx]} has no image {delta:+d} frames away in "
                             f"{folder}")
        return os.path.join(folder, listing[pos])

    def __getitem__(self, idx: int) -> dict:
        rgb = load_image_u8(self.files[idx])
        sample = {
            "idx": idx,
            "filename": os.path.splitext(os.path.basename(self.files[idx]))[0],
            "rgb": rgb,
            "intrinsics": dummy_intrinsics(rgb),
        }
        if self.has_context:
            ctx = [self._neighbor(idx, -d) for d in range(self.backward_context, 0, -1)]
            ctx += [self._neighbor(idx, d) for d in range(1, self.forward_context + 1)]
            sample["rgb_context"] = [load_image_u8(f) for f in ctx]
        if self.data_transform is not None:
            sample = self.data_transform(sample, idx=idx)
        else:
            from packnet_sfm_tpu_torch.datasets.augmentations import ensure_float_sample
            sample = ensure_float_sample(sample)
        return sample
