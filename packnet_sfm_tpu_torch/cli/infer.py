"""Inference CLI (port of ``packnet_sfm_tpu/cli/infer.py``): an image or a
folder of images to depth maps::

    python -m packnet_sfm_tpu_torch.cli.infer --checkpoint <dir> --input <img|dir>
        --output <file|dir> [--image_shape H W] [--save npz|png] [--device cuda|cpu]

Loads a checkpoint directory, runs the depth network alone in eval mode
on the image alone (``make_depth_fn``; PackNet-SAN takes its rgb-only
pass), and saves the depth as npz or png, or else the image
above its colormapped inverse depth as one png. Decoding and writing images
needs Pillow, the colormap matplotlib; both are imported where they are
used. Runs on the card unless ``--device cpu`` is given. ``--half`` builds
the model with the bfloat16 compute dtype, as eval's ``--half`` does (the
JAX CLI's ``--half`` builds a float32 model and only rounds the image to
bfloat16, so it computes in float32: ``ROADMAP.md`` §3 (i)). Without it the
model computes in float32, whatever the checkpoint's config says, as in the
JAX CLI. Where a process group is initialized (``parallel/mesh.
init_distributed``), each process infers its share of the files,
``files[rank::world]``, as the JAX CLI does.
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
    parser.add_argument("--half", action="store_true", help="bfloat16 compute")
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
    from packnet_sfm_tpu_torch.parallel.mesh import process_count, process_index
    from packnet_sfm_tpu_torch.utils.save import write_depth

    with open(os.path.join(checkpoint, "meta.json")) as f:
        meta = json.load(f)
    config = ConfigNode.from_dict(meta["config"])
    model = setup_model(config.model, device=device,
                        dtype=torch.bfloat16 if half else None)
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
    # this process's share of the files, where a process group is initialized
    rank, world = process_index(), process_count()
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
