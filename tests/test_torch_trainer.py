"""The training loop of the port (``engine/trainer.Trainer``) against the JAX
package's, and its resume, preemption, checkpoint and grad_accum rules; on
the CPU in float32.

One epoch of 2 steps of both trainers from the same initial variables
(``utils/convert.from_jax``): SelfSupModel with DepthResNet-18 + PoseNet,
32x64 Synthetic, batch 2, no flip and no jitter (the port draws its jitter
from (seed, epoch, position), JAX from (seed, index): by design they
differ, and tests/test_torch_augmentations.py holds the transform itself to
JAX's), then the validation table over 3 samples in batches of 2 (the last
one padded). Tolerances, and what was measured on a CPU:
- the epoch's mean loss: rtol 1e-5, the JAX suite's parity tolerance
  (docs/PARITY.md; measured 6e-7);
- the parameters' update over the epoch: cosine >= 0.9999 (measured
  0.99998) and relative error <= 2e-2 (measured 5.5e-3; Adam's first steps
  are about lr * sign(g), so gradients near 0 move the error most);
- the BatchNorm running statistics: within 1e-3 of the largest (measured
  7e-5), and they moved (by 0.6);
- the validation table: rtol 1e-3, atol 1e-4 on the continuous metrics
  (measured 5e-5), a1-a3 within 2 / n_valid, as tests/test_torch_eval.py.

Resume: a run of 3 epochs (flip and device jitter on) against 1 epoch, its
checkpoint, a resume and 2 epochs, and the same through a preemption
checkpoint written at the boundary of epoch 1: the weights, the optimizer
and scheduler states, the step, the flip generator and the later epochs'
losses equal bit for bit. A preemption after step 1 writes
``preempt_epoch=00.ckpt`` (epoch -1, step 1) and a resume redoes epoch 0.
"""

import copy
import json
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import parse_train_config as jax_parse_train_config
from packnet_sfm_tpu.engine import train as jax_train
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.engine.trainer import Trainer as JaxTrainer
from packnet_sfm_tpu.parallel.mesh import make_mesh
from packnet_sfm_tpu_torch.core.config import ConfigNode, parse_train_config
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
from packnet_sfm_tpu_torch.engine.checkpoint import ModelCheckpoint, read_state
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, make_train_step, zero_metrics
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.models.sfm import model_forward
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_cleanup import remove_tmp_path, remove_tree  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

H, W, BATCH = 32, 64, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _config(max_epochs=1, flip=0.0, jitter=(), **checkpoint):
    c = jax_default_config()
    c.arch.max_epochs = max_epochs
    c.model.name = "SelfSupModel"
    c.model.depth_net.name = "DepthResNet"
    c.model.depth_net.version = "18"
    c.model.pose_net.name = "PoseNet"
    c.model.loss.flip_lr_prob = flip
    c.datasets.augmentation.jittering = jitter
    c.checkpoint.update(checkpoint)
    for mode in ("train", "validation", "test"):
        d = c.datasets[mode]
        d.dataset, d.path, d.split, d.depth_type = ["Synthetic"], [""], [""], [""]
        d.batch_size = BATCH
        d.num_workers = 1
        d.synthetic_length = 4 if mode == "train" else 3
        d.synthetic_height, d.synthetic_width = H, W
    return jax_parse_train_config(c)


def _port_config(jcfg):
    return parse_train_config(ConfigNode.from_dict(copy.deepcopy(jcfg.to_dict())))


def _flat(state, keys):
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


def _committed(tree, mesh):
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _epoch_committed(jt, mesh):
    """JAX's ``train_epoch(0)`` with its metrics committed to the mesh."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_train, "zero_metrics", lambda: _committed(jax_zero_metrics(), mesh))
        return jt.train_epoch(0)


@pytest.fixture(scope="module")
def one_epoch():
    jcfg = _config()
    mesh = make_mesh(num_devices=1)
    jt = JaxTrainer(jcfg, mesh=mesh)
    jt.init_state(next(iter(jt.train_loaders[0].epoch(0))))
    # JAX's step returns its state and metrics committed to the mesh; from
    # uncommitted ones it would compile a second program (the same numbers)
    jt.state = _committed(jt.state, mesh)
    state0 = from_jax(_np_tree(jt.state.params), _np_tree(jt.state.batch_stats))
    pt = Trainer(_port_config(jcfg), device="cpu")
    pt.model.load_state_dict(state0)
    out = dict(state0=state0, j_train=_epoch_committed(jt, mesh), t_train=pt.train_epoch(0),
               j_val=jt.validate(0), t_val=pt.validate(0),
               j_state=from_jax(_np_tree(jt.state.params), _np_tree(jt.state.batch_stats)),
               t_state={k: v.numpy() for k, v in pt.model.state_dict().items()},
               trainer=pt)
    return out


def test_one_epoch_loss_matches_jax(one_epoch):
    got, want = one_epoch["t_train"], one_epoch["j_train"]
    for key in ("loss", "photometric_loss", "smoothness_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert got["imgs_per_sec"] > 0 and one_epoch["trainer"].step == 2
    assert one_epoch["trainer"].steps_per_epoch == 2


def test_one_epoch_update_matches_jax(one_epoch):
    keys = sorted(k for k in one_epoch["state0"] if "running_" not in k)
    p0 = _flat(one_epoch["state0"], keys)
    dj = _flat(one_epoch["j_state"], keys) - p0
    dt = _flat(one_epoch["t_state"], keys) - p0
    assert np.linalg.norm(dt) > 0
    assert dj @ dt / np.linalg.norm(dj) / np.linalg.norm(dt) >= 0.9999
    assert np.linalg.norm(dt - dj) / np.linalg.norm(dj) <= 2e-2
    for prefix in ("depth_net.", "pose_net."):
        sub = [k for k in keys if k.startswith(prefix)]
        assert np.linalg.norm(_flat(one_epoch["t_state"], sub) - _flat(one_epoch["state0"], sub)) > 0


def test_one_epoch_batch_stats_match_jax(one_epoch):
    keys = sorted(k for k in one_epoch["state0"] if "running_" in k)
    assert len(keys) == 2 * 20            # ResNet-18: 20 BatchNorms, mean and var each
    s0 = _flat(one_epoch["state0"], keys)
    sj, st = _flat(one_epoch["j_state"], keys), _flat(one_epoch["t_state"], keys)
    assert np.abs(sj - s0).max() > 0.1
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()


def test_one_epoch_validation_matches_jax(one_epoch):
    (want,), (got,) = one_epoch["j_val"], one_epoch["t_val"]
    ds = one_epoch["trainer"].val_datasets[0]
    gt = np.stack([ds[i]["depth"] for i in range(len(ds))])
    valid = (gt[..., 0] > 0) & (gt[..., 0] < 80)
    n_valid = int(valid.reshape(len(gt), -1).sum(axis=1).min())
    for mode in EVAL_MODES:
        np.testing.assert_allclose(got[mode][:4], want[mode][:4], rtol=1e-3, atol=1e-4,
                                   err_msg=mode)
        np.testing.assert_allclose(got[mode][4:], want[mode][4:], rtol=0, atol=2.0 / n_valid)


# --- resume and preemption ---------------------------------------------------------

def _resume_config(path, max_epochs=3):
    return _port_config(_config(max_epochs=max_epochs, flip=0.5, jitter=(0.2, 0.2, 0.2, 0.05),
                                filepath=str(path), monitor="depth_gt_abs_rel",
                                save_top_k=-1))


def _snapshot(trainer):
    return dict(model={k: v.clone() for k, v in trainer.model.state_dict().items()},
                optimizer=copy.deepcopy(trainer.optimizer.state_dict()),
                scheduler=trainer.scheduler.state_dict(), step=trainer.step,
                generator=trainer.generator.get_state().clone(),
                losses={h["epoch"]: h["loss"] for h in trainer.history})


def _assert_same(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["generator"], b["generator"])
    assert a["scheduler"] == b["scheduler"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"], b["optimizer"]
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("full")
    trainer = Trainer(_resume_config(path), device="cpu")
    trainer.fit()
    yield path, _snapshot(trainer)
    remove_tree(path)


def test_full_run_keeps_every_epoch_checkpoint(full_run):
    path, full = full_run
    names = sorted(p.name for p in path.iterdir())
    assert [re.sub(r"=[0-9.]+\.ckpt$", "", n) for n in names] == [
        f"epoch={e:02d}_depth_gt_abs_rel" for e in range(3)]
    assert full["step"] == 6 and sorted(full["losses"]) == [0, 1, 2]
    assert all(np.isfinite(v) for v in full["losses"].values())
    # the flip generator drew once a step, the schedule counted every step
    assert full["scheduler"]["last_epoch"] == 6
    assert not torch.equal(full["generator"], torch.Generator().manual_seed(43).get_state())


def test_resume_equals_the_uninterrupted_run(full_run, tmp_path):
    path, full = full_run
    (ckpt,) = path.glob("epoch=00_*.ckpt")
    resumed = Trainer(_resume_config(tmp_path), device="cpu")
    resumed.resume(str(ckpt))
    assert resumed.current_epoch == 1 and resumed.step == 2
    resumed.fit()
    got = _snapshot(resumed)
    _assert_same(got, full)
    assert got["losses"] == {e: full["losses"][e] for e in (1, 2)}


def test_resume_without_the_generator_state_differs(full_run, tmp_path):
    """The resume test has teeth: the flip generator's state is what makes
    it exact."""
    path, full = full_run
    (ckpt,) = path.glob("epoch=00_*.ckpt")
    resumed = Trainer(_resume_config(tmp_path), device="cpu")
    resumed.resume(str(ckpt))
    resumed._setup_training()
    resumed.generator.manual_seed(7)
    resumed.fit()
    assert resumed.history[-1]["loss"] != full["losses"][2]


def _preempt_at(trainer, after_steps):
    """Flag a preemption once ``after_steps`` train steps have run."""
    trainer._setup_training()
    build = trainer._train_step_for
    done = [0]

    def wrapped(num_scales):
        step = build(num_scales)

        def counted(*args, **kwargs):
            out = step(*args, **kwargs)
            done[0] += 1
            if done[0] >= after_steps:
                trainer._preempt_requested = True
            return out
        return counted
    trainer._train_step_for = wrapped


def test_preemption_at_an_epoch_boundary_resumes_exactly(full_run, tmp_path):
    _, full = full_run
    first = Trainer(_resume_config(tmp_path / "a"), device="cpu")
    train_epoch = first.train_epoch

    def signalled(epoch):
        if epoch == 1:
            first._preempt_requested = True          # a signal between the epochs
        return train_epoch(epoch)
    first.train_epoch = signalled
    history = first.fit()
    assert [h["epoch"] for h in history] == [0] and first.step == 2
    ckpt = tmp_path / "a" / "preempt_epoch=01.ckpt"
    assert ckpt.is_dir()
    resumed = Trainer(_resume_config(tmp_path / "b"), device="cpu")
    resumed.resume(str(ckpt))
    assert resumed.current_epoch == 1 and resumed.step == 2
    resumed.fit()
    _assert_same(_snapshot(resumed), full)


def test_preemption_after_step_one_redoes_the_epoch(tmp_path):
    trainer = Trainer(_resume_config(tmp_path), device="cpu")
    _preempt_at(trainer, after_steps=1)
    trainer.fit()
    ckpt = tmp_path / "preempt_epoch=00.ckpt"
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epoch"] == -1 and meta["step"] == 1
    assert {"model", "optimizer", "scheduler", "generator"} <= set(read_state(str(ckpt)))
    resumed = Trainer(_resume_config(tmp_path / "again", max_epochs=1), device="cpu")
    resumed.resume(str(ckpt))
    assert resumed.current_epoch == 0 and resumed.step == 1
    history = resumed.fit()
    assert [h["epoch"] for h in history] == [0] and resumed.step == 3
    assert np.isfinite(history[0]["loss"])


def test_profiled_epoch_writes_its_spans(tmp_path):
    trainer = Trainer(_resume_config(tmp_path / "ckpt", max_epochs=2), device="cpu",
                      profile_dir=str(tmp_path / "trace"))
    trainer.fit()
    assert (tmp_path / "trace" / "epoch_001.json").is_file()
    out = json.loads((tmp_path / "trace" / "epoch_001_spans.json").read_text())
    assert out["steps"] == trainer.steps_per_epoch
    assert {"train_step", "batch_copy", "forward", "backward",
            "optimizer_step"} <= set(out["spans"])
    assert out["spans"]["train_step"]["calls"] == 1.0 and out["counters"]["copies"] > 0
    assert not (tmp_path / "trace" / "epoch_000_spans.json").exists()


# --- ModelCheckpoint ------------------------------------------------------------------

def _save_all(ckpt, values, monitor="loss"):
    model = torch.nn.Linear(2, 1)
    return [ckpt.check_and_save(model, {"name": "t"}, epoch, {monitor: v, "other": 0.0})
            for epoch, v in enumerate(values)]


def test_model_checkpoint_keeps_the_top_k(tmp_path):
    ckpt = ModelCheckpoint(str(tmp_path), monitor="loss", save_top_k=2)
    paths = _save_all(ckpt, [0.5, 0.3, 0.4, 0.6, 0.1])
    assert paths[3] is None                         # worse than both kept
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch=01_loss=0.300.ckpt", "epoch=04_loss=0.100.ckpt"]
    # the test of the JAX overfit bar globs these names
    assert re.search(r"abs_rel=([0-9.]+)\.ckpt", "epoch=07_depth_gt_abs_rel=0.067.ckpt")


@pytest.mark.parametrize("monitor,mode,want", [
    ("loss", "auto", "min"), ("depth_gt_a1", "auto", "max"), ("val/acc", "auto", "max"),
    ("depth_gt_abs_rel", "min", "min"), ("depth_gt_a1", "min", "min")])
def test_model_checkpoint_mode(tmp_path, monitor, mode, want):
    ckpt = ModelCheckpoint(str(tmp_path), monitor=monitor, save_top_k=1, mode=mode)
    assert ckpt.mode == want
    _save_all(ckpt, [0.2, 0.8], monitor=monitor)
    (kept,) = tmp_path.iterdir()
    best = "0.200" if want == "min" else "0.800"
    assert kept.name == f"epoch={0 if want == 'min' else 1:02d}_{monitor.replace('/', '-')}={best}.ckpt"


def test_unknown_monitor_raises_listing_the_metrics(tmp_path):
    ckpt = ModelCheckpoint(str(tmp_path), monitor="depth_gt_absrel")
    with pytest.raises(KeyError, match="depth_gt_absrel.*loss, other"):
        _save_all(ckpt, [0.1])
    assert not any(tmp_path.iterdir())
    with pytest.raises(NotImplementedError, match="S3"):
        ModelCheckpoint(str(tmp_path), s3_path="s3://bucket/run")
    # the trainer checks before its first epoch
    cfg = _resume_config(tmp_path / "run")
    cfg.checkpoint.monitor = "depth_gt_absrel"
    with pytest.raises(KeyError, match="depth_gt_abs_rel"):
        Trainer(cfg, device="cpu").fit()


# --- grad_accum and BatchNorm ----------------------------------------------------------

def test_grad_accum_moves_the_stats_once_per_microbatch():
    """grad_accum = 2 on DepthResNet-18: the running statistics are those of
    two train-mode forwards over the halves, in order (the JAX package
    drops them: its scan discards the updates, engine/train.py:204)."""
    cfg = _port_config(_config())
    model = setup_model(cfg.model, device="cpu")
    reference = setup_model(cfg.model, device="cpu", seed=1)
    reference.load_state_dict(model.state_dict())
    whole = setup_model(cfg.model, device="cpu", seed=1)
    whole.load_state_dict(model.state_dict())
    ds = SyntheticSfmDataset(length=4, height=H, width=W, seed=3)
    batch = {"rgb": np.stack([ds[i]["rgb"] for i in range(4)]),
             "rgb_context": [np.stack([ds[i]["rgb_context"][c] for i in range(4)])
                             for c in range(2)],
             "intrinsics": np.stack([ds[i]["intrinsics"] for i in range(4)])}
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), grad_accum=2)
    step(zero_metrics("cpu"), batch)
    with torch.no_grad():
        for half in (slice(0, 2), slice(2, 4)):
            model_forward(reference, {"rgb": torch.as_tensor(batch["rgb"][half])}, train=True)
        model_forward(whole, {"rgb": torch.as_tensor(batch["rgb"])}, train=True)
    stats = [k for k in model.state_dict() if "running_" in k]
    got, want = model.state_dict(), reference.state_dict()
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    apart = max((got[k] - whole.state_dict()[k]).abs().max().item() for k in stats)
    assert apart > 1e-3                      # not one step on the whole batch
