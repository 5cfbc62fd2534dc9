"""The training slice's smaller pieces against the JAX package, on the CPU:

- the learning-rate schedules: the port's per-step factor (a ``LambdaLR``
  stepped after every optimizer step) against the rate the JAX package's
  optax Adam applies, for 3 x T_max epochs of 3 steps, both parameter
  groups, the cosine's clamp at 0 after T_max epochs included (rtol 3e-5:
  under a constant gradient Adam's step is the rate, up to the float32
  rounding of optax's bias corrections, measured 1.0e-5);
- the ImageNet encoder graft: an npz written by the JAX package's
  ``save_encoder_artifact`` (random weights stand in for ImageNet's),
  grafted by ``Trainer.init_state`` through ``pretrained_path`` and
  ``$PN_PRETRAINED_DIR``, gives JAX's tensors exactly and its outputs within
  the networks' tolerance (rtol 1e-4, atol 1e-5); a missing artifact warns,
  a wrong key or shape raises;
- ``cli/train.py``: its arguments, a fresh run from a yaml file, and a
  resume from a checkpoint directory that ends on the uninterrupted run's
  weights bit for bit, with epoch 1 traced to the profile directory;
- ``cli/evaluate_depth_maps.py`` against JAX's on the same files: the same
  printed table, and the metrics within rtol 1e-5.
"""

import json
import os
import sys
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.core.config import ConfigNode as JaxConfigNode
from packnet_sfm_tpu.engine.factory import make_optimizer as jax_make_optimizer
from packnet_sfm_tpu.nn.depth_resnet import DepthResNet as JaxDepthResNet
from packnet_sfm_tpu_torch.cli import evaluate_depth_maps as tedm
from packnet_sfm_tpu_torch.cli import train as cli_train
from packnet_sfm_tpu_torch.core.config import ConfigNode, config_from_dict, parse_train_config
from packnet_sfm_tpu_torch.engine.checkpoint import load_pretrained_encoder, read_state
from packnet_sfm_tpu_torch.engine.factory import make_optimizer
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.utils.convert import from_jax
from packnet_sfm_tpu_torch.utils.save import write_depth

torch.set_num_threads(1)

STEPS_PER_EPOCH = 3
LRS = {"depth": 2e-4, "pose": 5e-5}


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


# --- schedules -----------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", [
    {"name": "StepLR", "step_size": 2, "gamma": 0.5},
    {"name": "CosineAnnealingLR", "T_max": 2},
    {"name": "CosineAnnealingLR", "T_max": 3}], ids=["step", "cosine2", "cosine3"])
def test_schedule_matches_optax(scheduler):
    opt_cfg = {"name": "Adam", "depth": {"lr": LRS["depth"]}, "pose": {"lr": LRS["pose"]}}
    n_steps = 3 * scheduler.get("T_max", 2) * STEPS_PER_EPOCH
    tx = jax_make_optimizer(JaxConfigNode.from_dict(opt_cfg), JaxConfigNode.from_dict(scheduler),
                            STEPS_PER_EPOCH)
    params = {"depth_net": {"w": jnp.zeros(2)}, "pose_net": {"w": jnp.zeros(2)}}
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    state = tx.init(params)
    want = []
    for _ in range(n_steps):
        updates, state = tx.update(grads, state, params)
        want.append([-float(updates[f"{net}_net"]["w"][0]) for net in ("depth", "pose")])

    model = types.SimpleNamespace(depth_net=torch.nn.Linear(2, 1), pose_net=torch.nn.Linear(2, 1))
    optimizer, schedule = make_optimizer(model, ConfigNode.from_dict(opt_cfg),
                                         ConfigNode.from_dict(scheduler), STEPS_PER_EPOCH)
    got = []
    for _ in range(n_steps):
        got.append([group["lr"] for group in optimizer.param_groups])
        optimizer.step()
        schedule.step()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-14)
    assert got[0] == [LRS["depth"], LRS["pose"]]
    if scheduler["name"] == "CosineAnnealingLR":
        held = scheduler["T_max"] * STEPS_PER_EPOCH
        assert all(lr == [0.0, 0.0] for lr in got[held:])         # clamped, not periodic
        assert 0 < got[held - 1][0] < got[1][0]


# --- the ImageNet encoder graft ------------------------------------------------------

H, W = 32, 64


def _train_config(**depth_net):
    cfg = {"arch": {"max_epochs": 1},
           "model": {"name": "SelfSupModel",
                     "depth_net": {"name": "DepthResNet", "version": "18", **depth_net},
                     "pose_net": {"name": "PoseNet"}}, "datasets": {}}
    for mode, length in (("train", 2), ("validation", 2), ("test", 2)):
        cfg["datasets"][mode] = {
            "dataset": ["Synthetic"], "path": [""], "split": [""], "depth_type": [""],
            "batch_size": 2, "num_workers": 1, "synthetic_length": length,
            "synthetic_height": H, "synthetic_width": W}
    return cfg


@pytest.fixture(scope="module")
def graft(tmp_path_factory):
    """JAX DepthResNet-18 variables, a donor encoder saved as an artifact,
    and the JAX package's graft of it."""
    from packnet_sfm_tpu.engine.checkpoint import load_pretrained_encoder as jax_graft
    from packnet_sfm_tpu.utils.torch_import import save_encoder_artifact

    x = np.random.default_rng(3).uniform(size=(2, H, W, 3)).astype(np.float32)
    net = JaxDepthResNet(version="18")
    init = jax.jit(partial(net.init, train=True))
    own, donor = init(jax.random.PRNGKey(0), x), init(jax.random.PRNGKey(7), x)
    path = tmp_path_factory.mktemp("pretrained") / "resnet18.npz"
    save_encoder_artifact(str(path), _np(donor["params"]["encoder"]),
                          _np(donor["batch_stats"]["encoder"]))
    wrapped = {"params": {"depth_net": _np(own["params"])},
               "batch_stats": {"depth_net": _np(own["batch_stats"])}}
    grafted = jax_graft(str(path), wrapped, "depth_net")
    return dict(x=x, net=net, own=_np(own), path=path,
                grafted={k: _np(grafted[k]["depth_net"]) for k in ("params", "batch_stats")})


def _port_trainer(graft, **depth_net):
    cfg = parse_train_config(config_from_dict(_train_config(**depth_net)))
    trainer = Trainer(cfg, device="cpu")
    trainer.model.depth_net.load_state_dict(
        from_jax(graft["own"]["params"], graft["own"]["batch_stats"]), strict=True)
    return trainer


@pytest.mark.parametrize("source", ["pretrained_path", "PN_PRETRAINED_DIR"])
def test_pretrained_encoder_graft_matches_jax(graft, source, monkeypatch):
    if source == "pretrained_path":
        trainer = _port_trainer(graft, version="18pt", pretrained_path=str(graft["path"]))
    else:
        monkeypatch.setenv("PN_PRETRAINED_DIR", str(graft["path"].parent))
        trainer = _port_trainer(graft, version="18pt")
    trainer.init_state()
    want = from_jax(graft["grafted"]["params"], graft["grafted"]["batch_stats"])
    got = trainer.model.depth_net.state_dict()
    assert want.keys() == got.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    # the decoder kept its own weights, the encoder took the donor's
    own = from_jax(graft["own"]["params"], graft["own"]["batch_stats"])
    assert torch.equal(got["decoder.upconv_4_0.conv.weight"],
                       own["decoder.upconv_4_0.conv.weight"])
    assert not torch.equal(got["encoder.conv1.weight"], own["encoder.conv1.weight"])
    depth_net = trainer.model.depth_net.eval()
    variables = {"params": graft["grafted"]["params"],
                 "batch_stats": graft["grafted"]["batch_stats"]}
    theirs = jax.jit(partial(graft["net"].apply, train=False))(variables, graft["x"])
    with torch.no_grad():
        ours = depth_net(torch.from_numpy(graft["x"]))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-4, atol=1e-5)


def test_missing_or_mismatched_artifact(graft, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("PN_PRETRAINED_DIR", raising=False)
    trainer = _port_trainer(graft, version="18pt")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.init_state()
    assert "WARNING: depth_net version 18pt requests ImageNet weights" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    # version 18 asks for no artifact at all
    _port_trainer(graft, pretrained_path=str(graft["path"])).init_state()
    assert "WARNING" not in capsys.readouterr().out

    from packnet_sfm_tpu.utils.torch_import import save_encoder_artifact

    params = {k: v for k, v in graft["grafted"]["params"]["encoder"].items()}
    wide = dict(params, conv1={"kernel": np.zeros((7, 7, 6, 64), np.float32)})
    extra = dict(params, conv9={"kernel": np.zeros((3, 3, 3, 3), np.float32)})
    for name, tree, error in (("wide", wide, ValueError), ("extra", extra, KeyError)):
        path = str(tmp_path / f"{name}.npz")
        save_encoder_artifact(path, tree, {})
        with pytest.raises(error):
            load_pretrained_encoder(path, trainer.model, "depth_net")
    # conv1 widened for two stacked frames no longer fits a one-image encoder
    with pytest.raises(ValueError, match="conv1"):
        load_pretrained_encoder(str(graft["path"]), trainer.model, "depth_net",
                                num_input_images=2)


# --- cli/train.py ----------------------------------------------------------------------

def test_train_cli_arguments(monkeypatch):
    args = cli_train.parse_args(["run.yaml"])
    assert (args.file, args.device, args.profile_dir, args.distributed) == (
        "run.yaml", "cuda", None, False)
    args = cli_train.parse_args(["x/epoch=03_loss=0.1.ckpt", "--device", "cpu",
                                 "--profile-dir", "p"])
    assert (args.device, args.profile_dir) == ("cpu", "p")
    with pytest.raises(SystemExit):
        cli_train.parse_args(["run.txt"])
    assert cli_train.parse_args(["run.yaml", "--distributed", "--device", "cpu"]).distributed
    # --distributed on a machine without the card: it raises, and nothing
    # moves to the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.train("run.yaml", distributed=True)
    # the backend by device, and cuda:LOCAL_RANK, with the group's calls recorded
    from packnet_sfm_tpu_torch.parallel import mesh

    joined = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: joined[-1])
    monkeypatch.setattr(torch.distributed, "new_group", lambda backend: f"{backend} group")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: joined.append(str(dev)))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for device, backend, want in (("cuda", None, ["cuda:1", "nccl"]),
                                  ("cpu", None, ["gloo"]),
                                  ("cuda:0", "gloo", ["cuda:0", "gloo"])):
        monkeypatch.setattr(mesh, "_groups", {})
        joined.clear()
        assert mesh.init_distributed(backend, device) == torch.device(want[0] if len(
            want) > 1 else "cpu")
        assert joined == want
        assert mesh._groups["host"] == ("gloo group" if want[-1] == "nccl"
                                        else torch.distributed.group.WORLD)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    joined.clear()
    with pytest.raises(RuntimeError, match="no card cuda:1"):
        mesh.init_distributed()
    assert joined == []


def test_train_cli_runs_a_yaml_and_resumes_a_directory(tmp_path, capsys):
    yaml = pytest.importorskip("yaml")
    cfg = _train_config()
    cfg["arch"]["max_epochs"] = 2
    cfg["checkpoint"] = {"filepath": str(tmp_path / "ckpts"), "monitor": "depth_gt_abs_rel",
                         "save_top_k": -1}
    path = tmp_path / "run.yaml"
    path.write_text(yaml.dump(cfg))
    cli_train.main([str(path), "--device", "cpu"])
    history = json.loads(capsys.readouterr().out.splitlines()[-1])["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and len(h["val"][0]["depth_gt"]) == 7 for h in history)
    ckpts = sorted((tmp_path / "ckpts").iterdir())
    assert [p.name.split("_")[0] for p in ckpts] == ["epoch=00", "epoch=01"]
    meta = json.loads((ckpts[0] / "meta.json").read_text())
    assert meta["epoch"] == 0 and meta["step"] == 1
    assert meta["config"]["model"]["depth_net"]["name"] == "DepthResNet"

    # resume the epoch-0 directory: epoch 1 again, traced, into the same names
    resumed = cli_train.train(str(ckpts[0]), profile_dir=str(tmp_path / "trace"),
                              device="cpu")
    assert [h["epoch"] for h in resumed.history] == [1] and resumed.step == 2
    assert (tmp_path / "trace" / "epoch_001.json").is_file()
    want = read_state(str(ckpts[1]))["model"]
    got = resumed.model.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value), key


# --- cli/evaluate_depth_maps.py ----------------------------------------------------------

@pytest.fixture(scope="module")
def depth_folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_maps")
    rng = np.random.default_rng(8)
    for i in range(3):
        gt = rng.uniform(2, 70, size=(40, 60)) * (rng.uniform(size=(40, 60)) < 0.5)
        pred = np.abs(gt + rng.normal(0, 2, size=gt.shape)) * 1.3 + 0.5
        write_depth(str(root / "pred" / f"{i:03d}.npz"), pred.astype(np.float32))
        write_depth(str(root / "gt" / f"{i:03d}.png"), gt.astype(np.float32))
    return str(root / "pred"), str(root / "gt")


@pytest.mark.parametrize("flags", [[], ["--use_gt_scale"], ["--crop", "garg", "--max_depth", "50"],
                                   ["--min_depth", "3", "--use_gt_scale"]],
                         ids=["plain", "gt-scale", "garg", "min-depth"])
def test_evaluate_depth_maps_matches_the_jax_package(depth_folders, flags, capsys, monkeypatch):
    from packnet_sfm_tpu.cli import evaluate_depth_maps as jedm
    from packnet_sfm_tpu.engine.metrics import DepthMetricsConfig, compute_depth_metrics
    from packnet_sfm_tpu.utils.save import load_depth

    pred, gt = depth_folders
    argv = ["--pred_folder", pred, "--gt_folder", gt] + flags
    ours = tedm.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["evaluate_depth_maps"] + argv)
    jedm.main()
    assert printed == capsys.readouterr().out
    args = tedm.parse_args(argv)
    cfg = DepthMetricsConfig(crop=args.crop, min_depth=args.min_depth, max_depth=args.max_depth)
    want = np.mean([np.asarray(compute_depth_metrics(
        jnp.asarray(load_depth(f"{gt}/{i:03d}.png")[None, ..., None]),
        jnp.asarray(load_depth(f"{pred}/{i:03d}.npz")[None, ..., None]), cfg,
        use_gt_scale=args.use_gt_scale)) for i in range(3)], axis=0)
    np.testing.assert_allclose(ours, want, rtol=1e-5)
    with pytest.raises(ValueError, match="Wrong number"):
        tedm.evaluate_folders(pred, os.path.dirname(gt), device="cpu")     # no maps there
