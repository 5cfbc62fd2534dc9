"""Multi-process training and evaluation of the port (``parallel/mesh.py``,
DDP in ``engine/train.make_train_step``, the global BatchNorm and clip
statistics, the trainer's agreements, rank-0 checkpoints,
``cli.train --distributed``, infer's file split, ``parallel/scaling.py``)
against the JAX package's step over the global batch, and against one rank
of the port; on the CPU, two gloo ranks.

Each launch is ``torch.distributed.run --standalone`` (it picks its own
free port, so parallel test files never share one) under a hard timeout of
120 s, after which every process of the launch is killed. The two ranks of
tests/torch_distributed_worker.py take each case on their rows; the JAX
references and the one-rank runs are computed here meanwhile.

Tolerances, and what was measured on a CPU (float32;
``PYTHONPATH=. python tests/test_torch_distributed.py`` prints them):
- DepthResNet-18 + PoseNet, 2 ranks x 4 rows of a 64x96 batch against JAX's
  step on the global batch of 8, from JAX's weights, one Adam step: the
  mean of the ranks' losses rtol 1e-5 (measured 4.9e-7), the update cosine
  >= 0.9999 (0.999992), the BatchNorm running statistics within 1e-5 of
  their largest (1.5e-6). Rank 1's rows are brighter than rank 0's, as
  shards of real data differ; without the cross-rank BatchNorm (the
  control) the loss is off by 6.1e-3, the update cosine is 0.27 and the
  statistics are off by 0.092 of their largest, far outside those bounds.
- grad_accum = 2 on 2 ranks against one rank taking the global batch in the
  order of the 2-rank microbatches (rows 0, 1, 4, 5, then 2, 3, 6, 7): the
  same bounds (measured 1.6e-7, 0.999989, 1.0e-6).
- The NRS step (train_omnicam.yaml's RaySurfaceResNet-18 + PoseNet at
  96x96, clip_loss 0.5, progress 0.3) on 2 ranks x 1 row against JAX on the
  batch of 2, and against one rank of the port: the chaos floor of
  tests/test_torch_train_step.py, loss rtol 1e-4 and step-1 update cosine
  >= 0.96 (measured 2.8e-5 and 0.9906 against JAX, 2.1e-7 and 0.9749
  against one rank); the running statistics of that one forward rtol 1e-4
  (1.4e-6 of their largest).
- validate over a 13-sample split (7 rows a rank, the 14th a wrapped
  duplicate on rank 1): one rank's table within rtol 1e-6 (measured equal),
  and JAX's validate within tests/test_torch_trainer.py's bounds.
- The one-sided SIGTERM: rank 1 alone is signalled a second after it
  printed its model; both ranks leave epoch 0 at the same step, before its
  24th, rank 0 writes preempt_epoch=00.ckpt, and a 2-rank resume of it
  finishes the epoch.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import merge_config as jax_merge_config
from packnet_sfm_tpu.core.config import parse_train_config as jax_parse_train_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.train import TrainState, make_train_step as jax_make_train_step
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.engine.trainer import Trainer as JaxTrainer
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu.parallel.mesh import make_mesh, shard_batch
from packnet_sfm_tpu_torch.core.config import OMNICAM, ConfigNode, parse_train_config
from packnet_sfm_tpu_torch.engine.checkpoint import save_checkpoint
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.parallel import mesh
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_distributed_worker import load_batch, one_step
from tests.torch_cleanup import remove_tmp_path, remove_tree  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
LAUNCH_TIMEOUT = 120
H, W = 64, 96
NRS_HW = 96
NRS_PROGRESS = 0.3
RESNET = {"model": {"name": "SelfSupModel",
                    "depth_net": {"name": "DepthResNet", "version": "18"},
                    "pose_net": {"name": "PoseNet"}, "loss": {"flip_lr_prob": 0.0}}}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _flat(state, keys):
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


def _cos(a, b):
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _smooth(rng, b, h, w):
    """Low-res noise bilinear-upsampled x8 (NHWC), as the step tests."""
    base = torch.from_numpy(rng.uniform(size=(b, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def _resnet_batch():
    """8 rows, rank 1's four brighter than rank 0's; contexts shifted by 2 px."""
    rng = np.random.default_rng(0)
    gain = np.where(np.arange(8) < 4, 0.6, 1.0).astype(np.float32)[:, None, None, None]
    img = _smooth(rng, 8, H, W) * gain
    K = np.zeros((8, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 50.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2 - 0.5, H / 2 - 0.5, 1.0
    return {"rgb": img, "rgb_context": [np.roll(img, 2, axis=2), np.roll(img, -2, axis=2)],
            "intrinsics": K}


def _nrs_batch():
    rng = np.random.default_rng(5)
    return {"rgb": _smooth(rng, 2, NRS_HW, NRS_HW),
            "rgb_context": [_smooth(rng, 2, NRS_HW, NRS_HW), _smooth(rng, 2, NRS_HW, NRS_HW)]}


def _save_batch(path, batch):
    np.savez(path, **{k: v for k, v in batch.items() if k != "rgb_context"},
             **{f"ctx{i}": c for i, c in enumerate(batch["rgb_context"])})


def _jax_batch(batch):
    return {**batch, "rgb_original": batch["rgb"],
            "rgb_context_original": batch["rgb_context"]}


def _jax_model(cfg_dict, batch):
    jcfg = jax_merge_config(jax_default_config(), cfg_dict)
    jmodel = jax_factory.setup_model(jcfg.model)
    return jcfg, jmodel, init_model(jmodel, jax.random.PRNGKey(0), _jax_batch(batch))


def _jax_init(cfg_dict, batch):
    """JAX's initial weights, under the port's names."""
    variables = _jax_model(cfg_dict, batch)[2]
    return from_jax(_np_tree(variables["params"]), _np_tree(variables["batch_stats"]))


def _jax_step(cfg_dict, batch, progress=0.0):
    """One JAX Adam step from those weights on the whole batch, on a
    1-device mesh: (loss, state after, under the port's names)."""
    jcfg, jmodel, variables = _jax_model(cfg_dict, batch)
    tx = jax_factory.make_optimizer(jcfg.model.optimizer, jcfg.model.scheduler, 1000)
    mesh1 = make_mesh(num_devices=1)
    step = jax_make_train_step(jmodel, tx, mesh1)
    state, acc = step(TrainState.create(variables, tx), jax_zero_metrics(),
                      shard_batch(_jax_batch(batch), mesh1), progress=progress)
    return float(acc["loss"][0]), from_jax(_np_tree(state.params), _np_tree(state.batch_stats))


def _trainer_config(length=13):
    c = jax_merge_config(jax_default_config(), RESNET)
    c.arch.max_epochs = 1
    for mode in ("train", "validation", "test"):
        d = c.datasets[mode]
        d.dataset, d.path, d.split, d.depth_type = ["Synthetic"], [""], [""], [""]
        d.batch_size, d.num_workers = 4, 1
        d.synthetic_length = length if mode != "train" else 8
        d.synthetic_height, d.synthetic_width = H, W
    return jax_parse_train_config(c)


def _kill_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _torchrun(args, log_dir=None, env=None):
    """Start ``torch.distributed.run --standalone --nproc_per_node 2`` on
    ``args`` in a session of its own (so that a timeout kills every rank)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2"]
    if log_dir:
        cmd += ["--log-dir", str(log_dir), "--redirects", "3"]
    environ = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   **(env or {}))
    return subprocess.Popen(cmd + args, cwd=ROOT, env=environ, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc, timeout=LAUNCH_TIMEOUT):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        out, _ = proc.communicate()
        pytest.fail(f"a launch did not finish in {timeout} s (deadlock?):\n{out[-4000:]}")
    return proc.returncode, out


def _run_all(data):
    """Both sides of every two-rank case; ``data`` is an empty directory."""
    batch8, nrs_batch = _resnet_batch(), _nrs_batch()
    _save_batch(data / "batch8.npz", batch8)
    _save_batch(data / "nrs_batch2.npz", nrs_batch)

    # the JAX initial weights (init is cheap; the steps compile below)
    jcfg = _trainer_config()
    jt = JaxTrainer(jcfg, mesh=make_mesh(num_devices=1))
    jt.init_state(next(iter(jt.train_loaders[0].epoch(0))))
    trainer_state0 = from_jax(_np_tree(jt.state.params), _np_tree(jt.state.batch_stats))
    resnet_state0, nrs_state0 = (_jax_init(RESNET, batch8), _jax_init(OMNICAM, nrs_batch))
    torch.save(resnet_state0, data / "resnet_state0.pt")
    torch.save(nrs_state0, data / "nrs_state0.pt")
    torch.save(trainer_state0, data / "trainer_state0.pt")
    port_cfg = parse_train_config(ConfigNode.from_dict(jcfg.to_dict()))
    (data / "trainer_config.json").write_text(json.dumps(port_cfg.to_dict()))
    configs = {"resnet": RESNET, "nrs": OMNICAM, "nrs_progress": NRS_PROGRESS}
    (data / "configs.json").write_text(json.dumps(configs))
    # infer's inputs: 5 frames and a checkpoint of the port's DepthResNet
    from PIL import Image

    (data / "frames").mkdir()
    for i in range(5):
        Image.fromarray((batch8["rgb"][i] * 255).astype(np.uint8)).save(
            data / "frames" / f"{i:03d}.png")
    model = setup_model(port_cfg.model, device="cpu")
    save_checkpoint(str(data / "infer_ckpt"), model, port_cfg.to_dict(), 0)

    proc = _torchrun([WORKER, str(data)])
    # meanwhile: JAX on the global batches, and the port on one rank
    j_loss, j_after = _jax_step(RESNET, batch8)
    jn_loss, jn_after = _jax_step(OMNICAM, nrs_batch, NRS_PROGRESS)
    j_val = jt.validate(0)
    order = [0, 1, 4, 5, 2, 3, 6, 7]
    one = dict(
        resnet=one_step(RESNET, resnet_state0, load_batch(data / "batch8.npz")),
        accum=one_step(RESNET, resnet_state0,
                       {k: [c[order] for c in v] if isinstance(v, list) else v[order]
                        for k, v in batch8.items()}, grad_accum=2),
        nrs=one_step(OMNICAM, nrs_state0, nrs_batch, progress=NRS_PROGRESS))
    pt = Trainer(port_cfg, device="cpu")
    pt.model.load_state_dict(trainer_state0)
    one["validate"] = pt.validate(0)
    rc, out = _finish(proc)
    assert rc == 0, out[-4000:]
    ranks = [torch.load(data / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(data=data, ranks=ranks, one=one, j_loss=j_loss, j_after=j_after,
                jn_loss=jn_loss, jn_after=jn_after, j_val=j_val, resnet_state0=resnet_state0,
                nrs_state0=nrs_state0, val_dataset=pt.val_datasets[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    yield _run_all(root)
    remove_tree(root)


def _update_cos(state0, a, b):
    keys = sorted(k for k in state0 if "running_" not in k)
    p0 = _flat(state0, keys)
    return _cos(_flat(a, keys) - p0, _flat(b, keys) - p0)


def _stats_err(a, b):
    keys = sorted(k for k in a if "running_" in k)
    assert len(keys) == 2 * 20              # ResNet-18: 20 BatchNorms, mean and var each
    sa, sb = _flat(a, keys), _flat(b, keys)
    return float(np.abs(sa - sb).max() / np.abs(sb).max())


def _global_loss(runs, case):
    return float(np.mean([r[case]["loss"] for r in runs["ranks"]]))


# --- without a group ---------------------------------------------------------------

def test_without_a_group_every_collective_is_the_identity():
    assert (mesh.process_index(), mesh.process_count(), mesh.batch_group()) == (0, 1, None)
    tree = {"rows": np.ones((3, 7)), "seen": [np.arange(3)]}
    assert mesh.all_reduce_host_sum(tree) is tree
    assert mesh.any_process_flag(True) and not mesh.any_process_flag(False)
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    mesh.barrier()


def test_init_distributed_takes_this_ranks_card_and_refuses_a_missing_one(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"],
                                                            kw["world_size"])))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(mesh, "_groups", {})
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.init_distributed(device="cpu") == torch.device("cpu")
    assert calls == [("gloo", 1, 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card cuda:1"):
        mesh.init_distributed()                 # cuda:LOCAL_RANK, and there is one card
    assert len(calls) == 1                      # nothing was joined


# --- two ranks against JAX's global batch and against one rank ------------------------

def test_group_ranks_and_host_collectives(runs):
    for r, got in enumerate(runs["ranks"]):
        g = got["group"]
        assert (g["rank"], g["world"]) == (r, 2)
        np.testing.assert_array_equal(g["host_sum"]["x"], [3.0])
        np.testing.assert_array_equal(g["host_sum"]["y"][0], np.arange(3))
        assert g["flag_one"] and not g["flag_none"]
        assert g["broadcast"] == "from rank 0"


def test_two_ranks_step_matches_jax_on_the_global_batch(runs):
    a, b = runs["ranks"]
    for key in a["resnet"]["state"]:              # the ranks stay one model
        assert torch.equal(a["resnet"]["state"][key], b["resnet"]["state"][key]), key
    np.testing.assert_allclose(_global_loss(runs, "resnet"), runs["j_loss"], rtol=1e-5)
    assert _update_cos(runs["resnet_state0"], a["resnet"]["state"], runs["j_after"]) >= 0.9999
    assert _stats_err(a["resnet"]["state"], runs["j_after"]) <= 1e-5


def test_control_without_the_cross_rank_batch_norm_misses_jax(runs):
    a, b = runs["ranks"]
    got = a["resnet_local"]["state"]
    loss_rel = abs(_global_loss(runs, "resnet_local") - runs["j_loss"]) / runs["j_loss"]
    assert loss_rel > 1e-4
    assert _update_cos(runs["resnet_state0"], got, runs["j_after"]) < 0.9995
    assert _stats_err(got, runs["j_after"]) > 1e-2
    # each rank moved its statistics by its own rows
    key = "depth_net.encoder.bn1.running_mean"
    assert not torch.equal(got[key], b["resnet_local"]["state"][key])


def test_grad_accum_on_two_ranks_matches_one_rank(runs):
    a = runs["ranks"][0]["accum"]
    one = runs["one"]["accum"]
    np.testing.assert_allclose(_global_loss(runs, "accum"), one["loss"], rtol=1e-5)
    assert _update_cos(runs["resnet_state0"], a["state"], one["state"]) >= 0.9999
    assert _stats_err(a["state"], one["state"]) <= 1e-5
    # two microbatches: the statistics moved twice, not as the one-step run
    assert _stats_err(a["state"], runs["ranks"][0]["resnet"]["state"]) > 1e-3


def test_nrs_step_on_two_ranks_matches_jax_and_one_rank(runs):
    a, b = runs["ranks"]
    for key in a["nrs"]["state"]:
        assert torch.equal(a["nrs"]["state"][key], b["nrs"]["state"][key]), key
    got = a["nrs"]["state"]
    state0 = runs["nrs_state0"]
    for want, loss in ((runs["jn_after"], runs["jn_loss"]),
                       (runs["one"]["nrs"]["state"], runs["one"]["nrs"]["loss"])):
        np.testing.assert_allclose(_global_loss(runs, "nrs"), loss, rtol=1e-4)
        assert _update_cos(state0, got, want) >= 0.96
        for key in (k for k in want if "running_" in k):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_unused_heads_keep_no_gradient_as_on_one_rank(runs):
    """NRS reads one of the four depth scales: DDP looks for unused
    parameters there, and leaves them as one rank does (no Adam state)."""
    got = runs["ranks"][0]["nrs"]
    assert got["optimizer_keys"] == runs["one"]["nrs"]["optimizer_keys"]
    n_params = len([k for k in runs["nrs_state0"] if "running_" not in k])
    assert len(got["optimizer_keys"]) < n_params
    for key in (k for k in got["state"] if "dispconv_3" in k):
        assert torch.equal(got["state"][key], runs["nrs_state0"][key]), key


def test_validate_on_two_ranks_matches_one_rank_and_jax(runs):
    ds = runs["val_dataset"]
    assert len(ds) == 13 and all(r["val_batches"] == 2 for r in runs["ranks"])
    gt = np.stack([ds[i]["depth"] for i in range(len(ds))])
    valid = (gt[..., 0] > 0) & (gt[..., 0] < 80)
    n_valid = int(valid.reshape(len(gt), -1).sum(axis=1).min())
    (one,), (want,) = runs["one"]["validate"], runs["j_val"]
    for r in runs["ranks"]:
        (got,) = r["validate"]
        for mode in EVAL_MODES:
            np.testing.assert_allclose(got[mode], one[mode], rtol=1e-6, atol=1e-7, err_msg=mode)
            np.testing.assert_allclose(got[mode][:4], want[mode][:4], rtol=1e-3, atol=1e-4,
                                       err_msg=mode)
            np.testing.assert_allclose(got[mode][4:], want[mode][4:], rtol=0,
                                       atol=2.0 / n_valid)


def test_run_name_reaches_every_rank(runs):
    """ROADMAP.md §3 (d): the logger runs on rank 0 only; its run name and
    checkpoint path reach rank 1."""
    f0, f1 = (r["faults"] for r in runs["ranks"])
    assert f0["logger_built_on"] == [0] and f1["logger_built_on"] == []
    assert f0["filepath"] == f1["filepath"] == str(runs["data"] / "ckpt" / "stub-run")
    assert f0["run_name"] == f1["run_name"] == "stub-run"


def test_ranks_take_rank_zeros_checkpoint_decision(runs):
    """ROADMAP.md §3 (e): a monitored value that differs between the ranks
    saves where rank 0's says, on every rank, once."""
    f0, f1 = (r["faults"] for r in runs["ranks"])
    assert f0["paths"] == f1["paths"]
    assert [os.path.basename(p) if p else None for p in f0["paths"]] == [
        "epoch=00_loss=0.500.ckpt", "epoch=01_loss=0.250.ckpt", None]
    assert f0["on_disk"] == ["epoch=01_loss=0.250.ckpt"]


def test_infer_splits_the_files_between_the_ranks(runs):
    f0, f1 = (r["infer_lines"] for r in runs["ranks"])
    names = [[os.path.basename(line.split(" -> ")[0]) for line in lines] for lines in (f0, f1)]
    assert names == [["000.png", "002.png", "004.png"], ["001.png", "003.png"]]
    assert sorted(os.listdir(runs["data"] / "infer_out")) == [f"{i:03d}.npz" for i in range(5)]


# --- cli.train --distributed: a one-sided SIGTERM, the drain and the resume ------------

def _drain_config(tmp):
    cfg = json.loads(json.dumps(RESNET))
    cfg["arch"] = {"max_epochs": 1, "preempt_sync_every": 4}
    cfg["checkpoint"] = {"filepath": str(tmp / "ckpt"), "monitor": "depth_gt_abs_rel",
                         "mode": "min"}
    cfg["datasets"] = {}
    for mode, length in (("train", 16), ("validation", 4), ("test", 4)):
        cfg["datasets"][mode] = dict(dataset=["Synthetic"], path=[""], split=[""],
                                     depth_type=[""], batch_size=2, num_workers=1,
                                     synthetic_length=length, synthetic_height=32,
                                     synthetic_width=64)
    cfg["datasets"]["train"]["repeat"] = [6]
    return cfg


def _rank_logs(log_dir):
    logs = {}
    for path in log_dir.rglob("stdout.log"):
        logs[int(path.parent.name)] = path.read_text()
    return logs


def test_sigterm_to_one_rank_drains_both_and_a_resume_finishes(tmp_path):
    yaml = pytest.importorskip("yaml")
    psutil = pytest.importorskip("psutil")
    cfg_path = tmp_path / "drain.yaml"
    cfg_path.write_text(yaml.safe_dump(_drain_config(tmp_path)))
    cli = ["-m", "packnet_sfm_tpu_torch.cli.train"]
    proc = _torchrun(cli + [str(cfg_path), "--distributed", "--device", "cpu"],
                     log_dir=tmp_path / "logs")
    deadline = time.time() + LAUNCH_TIMEOUT
    target = None
    while time.time() < deadline and proc.poll() is None:
        if "Initialized model" in _rank_logs(tmp_path / "logs").get(1, ""):
            ranks = [p for p in psutil.Process(proc.pid).children(recursive=True)
                     if "packnet_sfm_tpu_torch.cli.train" in " ".join(p.cmdline())]
            target = next(p for p in ranks if p.environ().get("RANK") == "1")
            time.sleep(1.0)
            target.send_signal(signal.SIGTERM)       # rank 1 only
            break
        time.sleep(0.2)
    rc, out = _finish(proc, max(deadline - time.time(), 1))
    logs = _rank_logs(tmp_path / "logs")
    assert target is not None, out[-4000:]
    assert rc == 0, out[-4000:] + str(logs)
    steps = [int(re.search(r"### Preempted at step (\d+)", logs[r]).group(1)) for r in (0, 1)]
    assert steps[0] == steps[1] and 0 < steps[0] < 24, steps      # mid-epoch, agreed
    assert "Caught signal" in logs[1] and "Caught signal" not in logs[0]
    ckpts = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert ckpts == ["preempt_epoch=00.ckpt"]
    meta = json.loads((tmp_path / "ckpt" / ckpts[0] / "meta.json").read_text())
    assert (meta["epoch"], meta["step"]) == (-1, steps[0])

    proc = _torchrun(cli + [str(tmp_path / "ckpt" / ckpts[0]), "--distributed", "--device",
                            "cpu"], log_dir=tmp_path / "logs_resume")
    rc, out = _finish(proc)
    logs = _rank_logs(tmp_path / "logs_resume")
    assert rc == 0, out[-4000:] + str(logs)
    history = json.loads(logs[0].strip().splitlines()[-1])["history"]
    assert [h["epoch"] for h in history] == [0] and np.isfinite(history[0]["loss"])
    assert '"history"' not in logs[1]                # rank 0 prints the result
    assert sum(p.name.startswith("epoch=00_") for p in (tmp_path / "ckpt").iterdir()) == 1


# --- parallel/scaling.py ----------------------------------------------------------------

def test_scaling_harness_runs_one_process_a_rank():
    from packnet_sfm_tpu_torch.parallel.scaling import measure_scaling

    cfg = json.loads(json.dumps(RESNET))
    rows = measure_scaling([1, 2], per_rank_batch=1, height=32, width=64, steps=1, warmup=1,
                           device="cpu", config=cfg, timeout=LAUNCH_TIMEOUT)
    assert [r["world"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["imgs_per_sec"] > 0 and r["device"] == "cpu"
        assert r["images_per_step"] == r["world"]


if __name__ == "__main__":
    # Prints the figures the tolerances above rest on:
    #   PYTHONPATH=. python tests/test_torch_distributed.py
    import pathlib
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        r = _run_all(pathlib.Path(tmp))
    a = r["ranks"][0]
    for case, loss, want, state0 in (
            ("resnet vs JAX", r["j_loss"], r["j_after"], r["resnet_state0"]),
            ("control vs JAX", r["j_loss"], r["j_after"], r["resnet_state0"]),
            ("accum vs one rank", r["one"]["accum"]["loss"], r["one"]["accum"]["state"],
             r["resnet_state0"]),
            ("nrs vs JAX", r["jn_loss"], r["jn_after"], r["nrs_state0"]),
            ("nrs vs one rank", r["one"]["nrs"]["loss"], r["one"]["nrs"]["state"],
             r["nrs_state0"])):
        key = {"resnet vs JAX": "resnet", "control vs JAX": "resnet_local",
               "accum vs one rank": "accum"}.get(case, "nrs")
        got = a[key]["state"]
        keys = [k for k in want if "running_" in k]
        stats = max(float(np.abs(got[k].numpy() - np.asarray(want[k])).max()) for k in keys) / \
            max(float(np.abs(np.asarray(want[k])).max()) for k in keys)
        print(f"{case}: loss rel {abs(_global_loss(r, key) - loss) / abs(loss):.2e}, "
              f"update cosine {_update_cos(state0, got, want):.6f}, running statistics "
              f"{stats:.2e} of their largest")
    (one,), (got,) = r["one"]["validate"], a["validate"]
    print("validate vs one rank: max abs",
          max(float(np.abs(got[m] - one[m]).max()) for m in EVAL_MODES))
