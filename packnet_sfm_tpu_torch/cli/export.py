"""Export the depth forward for deployment (port of ``packnet_sfm_tpu/cli/
export.py``)::

    python -m packnet_sfm_tpu_torch.cli.export --checkpoint <dir> \\
        --output depth_model.pt2 [--image_shape H W] [--batch 1] [--half] \\
        [--device cuda|cpu]

The JAX CLI lowers the depth forward to StableHLO with ``jax.export``; here
``torch.export`` traces it into an ATen graph with the weights baked in
and ``torch.export.save`` writes it as a ``.pt2`` file. The graph maps rgb
[B, H, W, 3] float32 to inverse depth [B, H, W, 1] float32; ``--half``
builds the model with the bfloat16 compute dtype, as eval's ``--half``
does, and the output is still float32. The eval path reaches none of the
port's hand-written kernels, so the graph holds ATen operators only, and
a process that imports nothing but ``torch`` runs it::

    import torch
    fn = torch.export.load("depth_model.pt2").module()
    inv_depth = fn(rgb)     # rgb on the device the model was exported on

The JAX CLI's ``--platforms`` (lowering for several backends at once) has
no counterpart: an exported program runs on the device it was traced on
(``--device``, the card unless ``cpu`` is given).
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PackNet-SfM depth export (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--output", type=str, required=True, help=".pt2 output path")
    p.add_argument("--image_shape", type=int, nargs=2, default=None,
                   help="H W (default: the checkpoint's augmentation.image_shape)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--half", action="store_true", help="bfloat16 compute")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


class DepthForward(torch.nn.Module):
    """The depth network alone, in eval mode: rgb -> float32 inverse depth
    at the finest scale."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        from packnet_sfm_tpu_torch.models.sfm import model_forward

        return model_forward(self.model, {"rgb": rgb}, train=False)["inv_depths"][0].float()


def export_depth_model(model, batch: int, image_shape, path: str) -> int:
    """Export ``model``'s depth forward (weights baked in) to ``path``;
    returns the file's size in bytes."""
    h, w = image_shape
    device = next(model.parameters()).device
    model.eval()
    example = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(DepthForward(model), (example,))
    torch.export.save(program, path)
    return os.path.getsize(path)


def export_checkpoint(checkpoint: str, output: str, image_shape=None, batch: int = 1,
                      half: bool = False, device="cuda") -> int:
    """Restore ``checkpoint`` and export its depth forward to ``output``."""
    from packnet_sfm_tpu_torch.core.config import ConfigNode
    from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint
    from packnet_sfm_tpu_torch.engine.factory import setup_model

    with open(os.path.join(checkpoint, "meta.json")) as f:
        meta = json.load(f)
    config = ConfigNode.from_dict(meta["config"])
    model = setup_model(config.model, device=device, dtype=torch.bfloat16 if half else None)
    restore_checkpoint(checkpoint, model)
    image_shape = image_shape or tuple(config.datasets.augmentation.image_shape) or (192, 640)
    size = export_depth_model(model, batch, image_shape, output)
    print(f"### Exported depth forward ({size / 1e6:.1f} MB) to {output}")
    return size


def main(argv=None):
    a = parse_args(argv)
    export_checkpoint(a.checkpoint, a.output, a.image_shape, a.batch, a.half, a.device)


if __name__ == "__main__":
    main()
