"""Inference CLI (port of ``packnet_sfm_tpu/cli/infer.py``): an image or a
folder of images to depth maps::

    python -m packnet_sfm_tpu_torch.cli.infer --checkpoint <dir> --input <img|dir>
        --output <file|dir> [--image_shape H W] [--save npz|png] [--device cuda|cpu]

Loads a checkpoint directory, runs the depth network alone in eval mode
(``make_depth_fn``), and saves the depth as npz or png, or else the image
above its colormapped inverse depth as one png. Decoding and writing images
needs Pillow, the colormap matplotlib; both are imported where they are
used. Runs on the card unless ``--device cpu`` is given. ``--half``
(bfloat16) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PackNet-SfM inference (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--input", type=str, required=True, help="image or folder")
    parser.add_argument("--output", type=str, required=True, help="output file or folder")
    parser.add_argument("--image_shape", type=int, nargs=2, default=None)
    parser.add_argument("--half", action="store_true", help="bfloat16 (not ported yet)")
    parser.add_argument("--save", type=str, choices=["npz", "png"], default=None,
                        help="save depth as npz/png instead of rgb+viz image")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def make_depth_fn(model):
    """fn(rgb [B, H, W, 3] on the model's device) -> inverse depth
    [B, H, W, 1] float32: the depth network alone, in eval mode."""
    from packnet_sfm_tpu_torch.models.sfm import model_forward

    def depth_fn(rgb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model_forward(model, {"rgb": rgb}, train=False)["inv_depths"][0].float()

    return depth_fn


def infer_and_save(checkpoint, inp, out, image_shape=None, half=False, save=None,
                   device="cuda"):
    from packnet_sfm_tpu_torch.core.config import ConfigNode
    from packnet_sfm_tpu_torch.datasets.augmentations import resize_image
    from packnet_sfm_tpu_torch.datasets.kitti import load_image
    from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.engine.trainer import save_side_by_side
    from packnet_sfm_tpu_torch.utils.save import write_depth

    if half:
        raise NotImplementedError("--half (bfloat16) is not ported yet; see ROADMAP.md §1 item 3")
    with open(os.path.join(checkpoint, "meta.json")) as f:
        meta = json.load(f)
    config = ConfigNode.from_dict(meta["config"])
    model = setup_model(config.model, device=device)
    restore_checkpoint(checkpoint, model)
    depth_fn = make_depth_fn(model)
    dev = next(model.parameters()).device

    if image_shape is None:
        image_shape = tuple(config.datasets.augmentation.image_shape) or None

    exts = (".png", ".jpg", ".jpeg")
    if os.path.isdir(inp):
        files = sorted(os.path.join(inp, f) for f in os.listdir(inp)
                       if f.lower().endswith(exts))
        os.makedirs(out, exist_ok=True)
        outs = [os.path.join(out, os.path.basename(f)) for f in files]
    else:
        files, outs = [inp], [out]
    # this process's share of the files; one process until ROADMAP.md §1 item 5
    rank, world = 0, 1
    files, outs = files[rank::world], outs[rank::world]

    for f, o in zip(files, outs):
        rgb = load_image(f)
        if image_shape is not None:
            rgb = resize_image(rgb, image_shape)
        inv_depth = depth_fn(torch.from_numpy(rgb[None]).to(dev))[0].cpu().numpy()
        if save in ("npz", "png"):
            write_depth(os.path.splitext(o)[0] + "." + save,
                        1.0 / np.clip(inv_depth[..., 0], 1e-6, None))
        else:
            save_side_by_side(os.path.splitext(o)[0] + ".png", inv_depth[..., 0], rgb)
        print(f"{f} -> {o}")


def main(argv=None):
    a = parse_args(argv)
    infer_and_save(a.checkpoint, a.input, a.output, a.image_shape, a.half, a.save, a.device)


if __name__ == "__main__":
    main()
