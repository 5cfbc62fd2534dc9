"""Convert a reference (PyTorch packnet-sfm) checkpoint into the port's
checkpoint format (port of ``packnet_sfm_tpu/cli/convert_checkpoint.py``)::

    python -m packnet_sfm_tpu_torch.cli.convert_checkpoint \\
        --input PackNet01_MR_selfsup_K.ckpt --output ./converted.ckpt
    python -m packnet_sfm_tpu_torch.cli.convert_checkpoint --imagenet \\
        --input resnet18.pth --output resnet18.npz

A reference checkpoint (``torch.save`` of {config, epoch, state_dict, ...};
an older ``.pth.tar`` with the legacy names is renamed first) becomes a
checkpoint directory (``engine/checkpoint.py``: state.pt + meta.json) that
the port's ``cli.eval``, ``cli.infer``, ``cli.odometry`` and ``cli.train``
load. Only the weights and the config carry over; training restarts its
optimizer. The config is recovered as the JAX CLI recovers it: the
reference's embedded config merged over the defaults where it merges, else
the depth network named from the weights (``pack1`` -> PackNet01 1A, else
DepthResNet 18), and an unnamed pose net with weights is PoseNet.
``--imagenet`` converts a torchvision ResNet into the
encoder artifact that ``pretrained_path`` configs graft. Runs on the CPU.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference ckpt -> packnet-sfm (PyTorch port)")
    p.add_argument("--input", type=str, required=True,
                   help="torch .ckpt (or torchvision .pth with --imagenet)")
    p.add_argument("--output", type=str, required=True,
                   help="output checkpoint directory (or .npz artifact with --imagenet)")
    p.add_argument("--imagenet", action="store_true",
                   help="input is a torchvision ResNet state_dict; write an encoder-weights "
                        "npz artifact for model.*_net.pretrained_path ('18pt' configs)")
    return p.parse_args(argv)


def convert_imagenet_encoder(input_path: str, output_path: str) -> str:
    """torchvision ResNet state dict (.pth) -> the pretrained-encoder npz
    artifact."""
    import torch

    from packnet_sfm_tpu_torch.utils import torch_import as ti

    obj = torch.load(input_path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    params, stats = ti.resnet_encoder_trees(ti.state_dict_to_numpy(sd), prefix="",
                                            flax_layout=True)
    ti.save_encoder_artifact(output_path, params, stats)
    n = sum(v.size for v in ti._flatten_tree(params).values())
    print(f"converted {n / 1e6:.2f}M encoder params -> {output_path}")
    return output_path


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def recover_config(ref_cfg, sd):
    """The port's config for a reference checkpoint: its embedded config
    merged over the defaults where it merges, the depth network named from
    the weights where the config names none, and PoseNet where the weights
    hold a pose net that the config does not name."""
    from packnet_sfm_tpu_torch.core.config import ConfigNode, get_default_config, merge_config

    cfg = get_default_config()
    if ref_cfg is not None:
        try:
            cfg = merge_config(cfg, ConfigNode.from_dict(
                ref_cfg if isinstance(ref_cfg, dict) else dict(ref_cfg)))
        except Exception:
            pass
    if not (cfg.model.depth_net.get("name") or ""):
        name = "PackNet01" if any("pack1" in k for k in sd) else "DepthResNet"
        cfg.model.depth_net.name = name
        cfg.model.depth_net.version = "1A" if name == "PackNet01" else "18"
    if not cfg.model.get("name"):
        cfg.model.name = "SelfSupModel"
    if not (cfg.model.pose_net.get("name") or "") and any(
            k.startswith("model.pose_net.") for k in sd):
        # the converters read an unnamed pose net as PoseNet: build one (the
        # JAX CLI builds none and fails on such a checkpoint)
        cfg.model.pose_net.name = "PoseNet"
    return cfg


def convert(input_path: str, output_path: str) -> str:
    """A reference .ckpt (or legacy .pth.tar) -> a port checkpoint directory
    at ``output_path``; returns its path."""
    import torch

    from packnet_sfm_tpu_torch.engine.checkpoint import save_checkpoint
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.utils import torch_import as ti

    ckpt = torch.load(input_path, map_location="cpu", weights_only=False)
    sd = ti.state_dict_to_numpy(ckpt["state_dict"])
    if input_path.endswith(".pth.tar"):
        sd = ti.legacy_state_dict(sd)
    cfg = recover_config(ckpt.get("config"), sd)
    depth_name = cfg.model.depth_net.get("name") or ""
    pose_name = cfg.model.pose_net.get("name") or ""

    depth_sd, pose_sd = _strip(sd, "model.depth_net."), _strip(sd, "model.pose_net.")
    if depth_name in ("PackNet01", "PackNetSlim01"):
        nets = {"depth_net": ti.packnet_from_torch(depth_sd)}
    elif depth_name == "DepthResNet":
        nets = {"depth_net": ti.depth_resnet_from_torch(depth_sd)}
    else:
        raise ValueError(f"Unsupported depth net for conversion: {depth_name}")
    if pose_sd:
        if pose_name in ("PoseNet", ""):
            nets["pose_net"] = ti.posenet_from_torch(pose_sd)
        elif pose_name == "PoseResNet":
            nets["pose_net"] = ti.pose_resnet_from_torch(pose_sd)
        else:
            raise ValueError(f"Unsupported pose net for conversion: {pose_name}")

    model = setup_model(cfg.model, device="cpu")
    for name, state in nets.items():
        net = getattr(model, name)
        if net is None:
            raise ValueError(f"the config builds no {name}, but the checkpoint has one")
        net.load_state_dict(state, strict=True)
    path = save_checkpoint(output_path, model, cfg.to_dict(), epoch=int(ckpt.get("epoch", 0)))
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {n / 1e6:.2f}M params -> {path}")
    return path


def main(argv=None):
    a = parse_args(argv)
    if a.imagenet:
        convert_imagenet_encoder(a.input, a.output)
    else:
        convert(a.input, a.output)


if __name__ == "__main__":
    main()
