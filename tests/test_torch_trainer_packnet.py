"""The PackNetSlim overfit recipe (configs/overfit_packnet_synthetic.yaml:
SelfSupModel, PackNetSlim01-1A + PoseNet, Adam at lr 5e-5, 64x96 Synthetic
with device jitter and the training flip) through the port's ``Trainer``
against the JAX package's, on the CPU in float32.

The recipe is cut to fit: batch 2 over 4 samples (2 steps an epoch), 2
epochs, and the flip forced on (``flip_lr_prob`` 1), because the two
packages draw the flip from different generators and only a flip taken at
every step is the same draw in both. Both trainers start from JAX's initial
variables (``utils/convert.from_jax``), and the port's trainer is fed the
JAX loader's batches: its jitter factors are JAX's draw, which the port
does not copy (ROADMAP.md §3 (g)). Tolerances, and what was measured on a
CPU:
- each epoch's mean loss, photometric and smoothness terms: rtol 1e-4, as
  tests/test_torch_flagship_step.py holds PackNetSlim's steps (measured
  3.1e-6 on the loss, 4.8e-5 on the smoothness term);
- the weights' update over the 4 steps: cosine >= 0.9999 (measured
  0.999997) and relative error <= 2e-2 (measured 2.4e-3), as
  tests/test_torch_trainer.py holds DepthResNet's epoch;
- the initial weights the port draws from a seed, against JAX's: every
  tensor of the same shape, the constant ones (biases, norm scales) equal,
  and every random one of 1000 elements or more within 5% of JAX's standard
  deviation and largest magnitude (the same distribution, another draw);
- tests/jax_initial_weights.py's transport of JAX's initial weights to a
  machine without JAX: within 2**-16 of each weight, zeros and ones exact.
"""

import copy
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from packnet_sfm_tpu.core.config import parse_train_config as jax_parse_train_config
from packnet_sfm_tpu.engine import train as jax_train
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.engine.trainer import Trainer as JaxTrainer
from packnet_sfm_tpu.parallel.mesh import make_mesh
from packnet_sfm_tpu_torch.core.config import (
    OVERFIT_PACKNET_SYNTHETIC,
    ConfigNode,
    config_from_dict,
    parse_train_config,
)
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPOCHS = 2


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _cut(cfg):
    cfg.model.loss.flip_lr_prob = 1.0
    for mode in ("train", "validation", "test"):
        d = cfg.datasets[mode]
        d.batch_size, d.num_workers, d.synthetic_length = 2, 1, 4 if mode == "train" else 2
        d.repeat = [1]
    return cfg


def _committed(tree, mesh):
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _flat(state, keys):
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


@pytest.fixture(scope="module")
def runs():
    # the JAX package's yaml parse of the recipe; the port's dict copy is
    # held to the same parse by tests/test_torch_port_rules.py
    jcfg = _cut(jax_parse_train_config(str(ROOT / "configs" / "overfit_packnet_synthetic.yaml")))
    mesh = make_mesh(num_devices=1)
    jt = JaxTrainer(jcfg, mesh=mesh)
    jt.init_state(next(iter(jt.train_loaders[0].epoch(0))))
    # JAX's step returns its state and metrics committed to the mesh; from
    # uncommitted ones it would compile a second program (the same numbers)
    jt.state = _committed(jt.state, mesh)
    state0 = from_jax(_np_tree(jt.state.params), _np_tree(jt.state.batch_stats))
    pt = Trainer(parse_train_config(ConfigNode.from_dict(copy.deepcopy(jcfg.to_dict()))),
                 device="cpu")
    pt.model.load_state_dict(state0)
    pt._setup_training()
    pt.train_loaders = jt.train_loaders
    j_epochs, t_epochs = [], []
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_train, "zero_metrics",
                      lambda: _committed(jax_zero_metrics(), mesh))
        for epoch in range(EPOCHS):
            j_epochs.append(jt.train_epoch(epoch))
            t_epochs.append(pt.train_epoch(epoch))
    return dict(state0=state0, j_epochs=j_epochs, t_epochs=t_epochs, trainer=pt,
                j_state=from_jax(_np_tree(jt.state.params)),
                t_state={k: v.numpy() for k, v in pt.model.state_dict().items()})


def test_recipe_epochs_loss_matches_jax(runs):
    assert runs["trainer"].step == 2 * EPOCHS
    assert runs["trainer"].config.model.optimizer.depth.lr == 5e-5
    for got, want in zip(runs["t_epochs"], runs["j_epochs"]):
        for key in ("loss", "photometric_loss", "smoothness_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_recipe_update_matches_jax(runs):
    keys = sorted(runs["j_state"])
    p0 = _flat(runs["state0"], keys)
    dj = _flat(runs["j_state"], keys) - p0
    dt = _flat(runs["t_state"], keys) - p0
    assert np.linalg.norm(dt) > 0
    assert dj @ dt / np.linalg.norm(dj) / np.linalg.norm(dt) >= 0.9999
    assert np.linalg.norm(dt - dj) / np.linalg.norm(dj) <= 2e-2


def test_initial_weights_are_drawn_as_jax_draws_them(runs):
    cfg = config_from_dict(copy.deepcopy(OVERFIT_PACKNET_SYNTHETIC))
    ours = setup_model(cfg.model, device="cpu", seed=cfg.arch.seed).state_dict()
    theirs = runs["state0"]
    assert ours.keys() == theirs.keys()
    drawn = 0
    for key, want in theirs.items():
        got = ours[key]
        assert got.shape == want.shape, key
        if want.numel() < 2 or float(want.std()) == 0.0:
            assert torch.equal(got, want), key
        elif want.numel() >= 1000:
            drawn += 1
            assert abs(float(got.std() / want.std()) - 1) <= 0.05, key
            assert abs(float(got.abs().max() / want.abs().max()) - 1) <= 0.05, key
    assert drawn >= 40


def test_initial_weights_travel_within_their_rounding(runs, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tests"))
    from jax_initial_weights import pack, unpack

    for key, value in runs["state0"].items():
        want = value.numpy()
        got = unpack(pack(want))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -16), key
        constant = (want == 0) | (want == 1)
        np.testing.assert_array_equal(got[constant], want[constant])
