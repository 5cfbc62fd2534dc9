"""Carry the JAX package's initial weights of the PackNetSlim overfit recipe
to a machine without JAX, and start the port's training from them::

    python tests/jax_initial_weights.py export <dir> [--seed N]   # needs jax
    python tests/jax_initial_weights.py start <dir> [--seed N]    # torch and numpy only
    python -m packnet_sfm_tpu_torch.cli.train <dir>/jax.ckpt
    python -m packnet_sfm_tpu_torch.cli.train <dir>/port.ckpt

``export`` draws configs/overfit_packnet_synthetic.yaml's initial variables
as the JAX package's ``Trainer.init_state`` does, from ``arch.seed`` or
``--seed``, maps
them to the port's names (``utils/convert.from_jax``) and writes
``<dir>/weights.npz``: each float32 rounded to its top 24 bits (16
significant bits, a relative error of at most 2**-16) and kept as 3 bytes,
so that the 78.6 M weights of PackNetSlim01-1A + PoseNet take 236 MB.

``start`` rebuilds them as float32 and writes two checkpoints that
``cli.train`` resumes at epoch 0 with the recipe's config
(``core/config.OVERFIT_PACKNET_SYNTHETIC``) and nothing else of a train
state: ``jax.ckpt``, JAX's weights, and ``port.ckpt``, the port's own draw
from the same seed rounded the same way. ``--seed`` changes the weights'
draw alone: the checkpoints keep the recipe's ``arch.seed``, which also
seeds its data, shuffle, jitter and flip. The two runs differ in their
initial weights alone.
"""

import argparse
import copy
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def pack(arr: np.ndarray) -> np.ndarray:
    """float32 -> [..., 3] uint8, rounded to nearest at the 24th bit."""
    bits = (np.ascontiguousarray(arr, np.float32).view(np.uint32).astype(np.uint64) + 0x80) >> 8
    return np.stack([(bits >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8)


def unpack(packed: np.ndarray) -> np.ndarray:
    b = packed.astype(np.uint32)
    return ((b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16) << 8).view(np.float32)


def export(out_dir: pathlib.Path, seed=None) -> None:
    import jax

    from packnet_sfm_tpu.core.config import parse_train_config
    from packnet_sfm_tpu.engine.trainer import Trainer
    from packnet_sfm_tpu.parallel.mesh import make_mesh
    from packnet_sfm_tpu_torch.utils.convert import from_jax

    jax.config.update("jax_platforms", "cpu")
    cfg = parse_train_config(str(ROOT / "configs" / "overfit_packnet_synthetic.yaml"))
    if seed is not None:
        cfg.arch.seed = seed
    trainer = Trainer(cfg, mesh=make_mesh(num_devices=1))
    trainer.init_state(next(iter(trainer.train_loaders[0].epoch(0))))
    tree = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    state = from_jax(tree, jax.tree_util.tree_map(np.asarray, trainer.state.batch_stats))
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "weights.npz", **{k: pack(v.numpy()) for k, v in state.items()})
    print(f"{len(state)} tensors, {sum(v.numel() for v in state.values())} weights -> "
          f"{out_dir / 'weights.npz'}")


def start(out_dir: pathlib.Path, seed=None) -> None:
    import torch

    from packnet_sfm_tpu_torch.core.config import (
        OVERFIT_PACKNET_SYNTHETIC,
        config_from_dict,
        parse_train_config,
    )
    from packnet_sfm_tpu_torch.engine.checkpoint import save_checkpoint
    from packnet_sfm_tpu_torch.engine.factory import setup_model

    cfg = parse_train_config(config_from_dict(copy.deepcopy(OVERFIT_PACKNET_SYNTHETIC)))
    model = setup_model(cfg.model, device="cpu", seed=cfg.arch.seed if seed is None else seed)
    own = {k: torch.from_numpy(unpack(pack(v.numpy()))) for k, v in model.state_dict().items()}
    with np.load(out_dir / "weights.npz") as z:
        jax_drawn = {k: torch.from_numpy(unpack(z[k])) for k in z.files}
    for name, state in (("jax", jax_drawn), ("port", own)):
        model.load_state_dict(state)
        path = save_checkpoint(str(out_dir / f"{name}.ckpt"), model, cfg.to_dict(), epoch=-1)
        print(f"{name}: {path}")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("command", choices=["export", "start"])
    parser.add_argument("dir", type=pathlib.Path)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args()
    {"export": export, "start": start}[args.command](args.dir, args.seed)
