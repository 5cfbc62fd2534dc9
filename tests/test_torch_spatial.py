"""The (data x space) process grid of the port (``parallel/mesh.
make_mesh_2d``, ``parallel/spatial.py``, the grid in ``engine/train.
make_train_step`` / ``make_eval_step``): row-sharded train and eval steps
with halo exchanges, against the same ops on whole tensors, the port's
one-process step and the JAX package's step on its ``make_mesh_2d`` mesh.

Two launches of tests/torch_spatial_worker.py, one after the other, each
``torch.distributed.run --standalone`` on gloo ranks of the CPU under a hard
timeout of 120 s, after which every process of the launch is killed: two
ranks (data 1 x space 2), then four (data 2 x space 2). The references are
computed here meanwhile: JAX's steps beside the first, the port's
one-process steps beside the second.

Tolerances, and what was measured on a CPU (float32; ``PYTHONPATH=. python
tests/test_torch_spatial.py`` prints them):
- (a) ``reconstruct``/``project`` of a band of rows at its offset against
  the same rows of the whole image's: 1e-6 of the largest (measured 0, the
  same bits; without the offset and the height, 1.28 apart).
- (b) every halo op on a band against the same rows of the whole op, each
  rank its own band: forward within 1e-6 of the largest value (measured at
  most 5.2e-7, ``fused_pack_conv(mode='fused')``, fused on the whole tensor
  and two-step on a band; group norm 1.7e-7; the convolutions, pools, SSIM
  and smoothness give the same bits), input and parameter gradients (summed over the space
  group) within 1e-5 (measured at most 2.7e-6, channel_conv3d's bias).
- (c) DepthResNet-18 + PoseNet, 8 rows at 64x96 (data rank 1's rows
  brighter), from JAX's weights, one Adam step, on data 2 x space 2. Against
  JAX's step on ``make_mesh_2d(spatial_shards=2, num_devices=4)``: the mean
  of the data ranks' losses rtol 1e-5 (measured 6.2e-7), the BatchNorm
  running statistics within 1e-5 of their largest (7.7e-7). Against JAX's
  step on the global batch (one device, as tests/test_torch_distributed.py
  runs it): the same two bounds (measured 3.1e-7, 1.4e-6) and the update
  cosine >= 0.9999 (0.999992). JAX's mesh_2d step misses that last bound
  against its own global-batch step (update cosine 0.897: its gradient
  parts from the global batch's by up to 2.5x of a leaf's largest value in
  the ResNet encoder, while its loss agrees to 3e-7), ROADMAP.md §3 (u):
  the port does not copy it, and the test pins it. (JAX's own test runs
  32x64 at space 4; a ResNet band there is less than a row deep at 1/32,
  which the port refuses, so this runs 64x96.)
- (d) PackNetSlim01-1A + PoseNet, 2 rows at 64x96, one Adam step on space
  2 against the port's one-process step (which tests/test_torch_packnet.py
  and test_torch_flagship_step.py hold to JAX): the same bounds (measured
  6.4e-7 and 0.999991); the bands' pack convolutions take the two-step
  path alone, where the one process fuses the first pack layer's.
- (e) the control: (d) with the other bands' rows of every exchange
  replaced by zeros misses both bounds (measured loss off by 5.4e-2, update
  cosine 0.067).
- (f) PackNetSlim01 on space 4 at a height of 64 raises ValueError on every
  rank, before any step.
- (g) the eval step on space 2: each rank's metric rows against one
  process's within rtol 1e-6, atol 1e-7 (measured 7.6e-7 relative at
  most), its post-processed inverse depth within rtol 1e-5 (3.3e-6: the
  group norm's statistics are summed in another order on a band).
"""

import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import merge_config as jax_merge_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.train import TrainState, make_train_step as jax_make_train_step
from packnet_sfm_tpu.engine.train import replicate_state
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from packnet_sfm_tpu.parallel.mesh import shard_batch
from packnet_sfm_tpu_torch.core.config import config_from_dict
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES
from packnet_sfm_tpu_torch.geometry.camera import Camera, project, reconstruct
from packnet_sfm_tpu_torch.parallel import mesh
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.test_torch_distributed import (RESNET, _jax_batch, _jax_init, _jax_step,
                                          _resnet_batch, _smooth)
from tests.torch_spatial_worker import eval_rows, train_step
from tests.torch_cleanup import remove_tmp_path, remove_tree  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_spatial_worker.py")
LAUNCH_TIMEOUT = 120
H, W = 64, 96
PACKNET = {"model": {"name": "SelfSupModel",
                     "depth_net": {"name": "PackNetSlim01", "version": "1A"},
                     "pose_net": {"name": "PoseNet"}, "loss": {"flip_lr_prob": 0.0}}}
OP_NAMES = ("conv2d_k3_s1", "conv2d_k3_s2", "conv2d_k7_s1", "conv2d_k7_s2",
            "conv2d_k7_s1_shallow", "channel_conv3d", "pack_conv_two_step", "fused_pack_conv",
            "max_pool3s2",
            "group_norm", "conv_block_refl", "conv_block_refl_shallow", "ssim", "smoothness")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _flat(state, keys):
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


def _cos(a, b):
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _update_cos(state0, a, b):
    keys = sorted(k for k in state0 if "running_" not in k)
    p0 = _flat(state0, keys)
    return _cos(_flat(a, keys) - p0, _flat(b, keys) - p0)


def _stats_err(a, b):
    keys = sorted(k for k in a if "running_" in k)
    sa, sb = _flat(a, keys), _flat(b, keys)
    return float(np.abs(sa - sb).max() / np.abs(sb).max())


def _batch2():
    """2 smooth rows at 64x96, contexts shifted by 2 px, intrinsics."""
    img = _smooth(np.random.default_rng(1), 2, H, W)
    K = np.zeros((2, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 50.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2 - 0.5, H / 2 - 0.5, 1.0
    return {"rgb": img, "rgb_context": [np.roll(img, 2, axis=2), np.roll(img, -2, axis=2)],
            "intrinsics": K}


def _eval_batch():
    rng = np.random.default_rng(9)
    gt = rng.uniform(1.0, 70.0, size=(2, 75, 124, 1)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.5] = 0.0
    return {"rgb": _smooth(rng, 2, H, W), "depth": gt}


def _save_batch(path, batch):
    np.savez(path, **{k: v for k, v in batch.items() if k != "rgb_context"},
             **{f"ctx{i}": c for i, c in enumerate(batch.get("rgb_context", []))})


def _jax_grid_step(cfg_dict, batch):
    """JAX's Adam step from its initial weights on the (data 2, space 2)
    mesh: (loss, state after, under the port's names)."""
    jcfg = jax_merge_config(jax_default_config(), cfg_dict)
    jmodel = jax_factory.setup_model(jcfg.model)
    jb = _jax_batch(batch)
    variables = init_model(jmodel, jax.random.PRNGKey(0), jb)
    tx = jax_factory.make_optimizer(jcfg.model.optimizer, jcfg.model.scheduler, 1000)
    grid = jax_make_mesh_2d(spatial_shards=2, num_devices=4)
    assert dict(grid.shape) == {"data": 2, "space": 2}
    sharded = shard_batch(jb, grid)
    assert tuple(sharded["rgb"].sharding.spec)[:2] == ("data", "space")
    state = replicate_state(TrainState.create(variables, tx), grid)
    state, acc = jax_make_train_step(jmodel, tx, grid)(state, jax_zero_metrics(), sharded)
    return float(acc["loss"][0]), from_jax(_np_tree(state.params), _np_tree(state.batch_stats))


def _torchrun(n, data):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), WORKER, str(data)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        out, _ = proc.communicate()
        pytest.fail(f"a launch did not finish in {LAUNCH_TIMEOUT} s (deadlock?):\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]


def _run_all(data):
    """Both launches and every reference; ``data`` is an empty directory."""
    batch8, batch2, eval2 = _resnet_batch(), _batch2(), _eval_batch()
    for name, batch in (("batch8", batch8), ("batch2", batch2), ("eval2", eval2)):
        _save_batch(data / f"{name}.npz", batch)
    torch.save({"resnet": RESNET, "packnet": PACKNET}, data / "configs.pt")
    packnet_state0 = setup_model(config_from_dict(PACKNET).model, device="cpu").state_dict()
    torch.save(packnet_state0, data / "packnet_state0.pt")
    resnet_state0 = _jax_init(RESNET, batch8)
    torch.save(resnet_state0, data / "resnet_state0.pt")
    # one launch at a time, each beside one reference computation, so that
    # the file loads the machine with at most five busy processes
    proc = _torchrun(2, data)
    j_loss, j_after = _jax_step(RESNET, batch8)
    j2_loss, j2_after = _jax_grid_step(RESNET, batch8)
    _finish(proc)
    proc = _torchrun(4, data)
    one = dict(packnet=train_step(PACKNET, packnet_state0, batch2),
               eval=eval_rows(PACKNET, packnet_state0, eval2))
    _finish(proc)
    load = lambda r, n: torch.load(data / f"rank{r}_world{n}.pt", weights_only=False)  # noqa
    return dict(two=[load(r, 2) for r in range(2)], four=[load(r, 4) for r in range(4)],
                one=one, packnet_state0=packnet_state0, resnet_state0=resnet_state0,
                j_loss=j_loss, j_after=j_after, j2_loss=j2_loss, j2_after=j2_after)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    yield _run_all(root)
    remove_tree(root)


# --- (a) one process ------------------------------------------------------------------

def _band_camera_err():
    """The largest error of a band's reconstruct/project against the same
    rows of the whole image's, relative to its largest coordinate."""
    rng = np.random.default_rng(2)
    depth = torch.from_numpy(rng.uniform(1.0, 20.0, size=(2, 16, 12, 1)).astype(np.float32))
    K = torch.tensor([[[10.0, 0.0, 5.5], [0.0, 11.0, 7.5], [0.0, 0.0, 1.0]]]).repeat(2, 1, 1)
    T = torch.eye(4).repeat(2, 1, 1)
    T[:, :3, 3] = torch.tensor([0.1, -0.05, 0.2])
    cam, ref = Camera(K=K), Camera(K=K, Tcw=T)
    whole = project(ref, reconstruct(cam, depth))
    errs = []
    for r0, h in ((0, 4), (4, 4), (12, 4), (6, 3)):
        band = project(ref, reconstruct(cam, depth[:, r0:r0 + h], row0=r0), height=16)
        errs.append(float((band - whole[:, r0:r0 + h]).abs().max() / whole.abs().max()))
    # without the offset and the height the band's rows would be wrong
    wrong = project(ref, reconstruct(cam, depth[:, 4:8]))
    return max(errs), float((wrong - whole[:, 4:8]).abs().max())


def test_a_band_reconstructs_and_projects_its_rows_of_the_whole_image():
    err, wrong = _band_camera_err()
    assert err <= 1e-6 and wrong > 0.1, (err, wrong)


def test_the_grid_refuses_what_it_cannot_split():
    with pytest.raises(ValueError, match="not divisible by 2"):
        mesh.make_mesh_2d(spatial_shards=2)          # one process
    grid = mesh.make_mesh_2d(spatial_shards=1)
    assert (grid.data_count, grid.space_count) == (1, 1) and grid.band() is None
    from packnet_sfm_tpu_torch.parallel import spatial

    with pytest.raises(ValueError, match="64 does not split into 4 bands.*128"):
        spatial.check_rows(64, 4, 32)
    spatial.check_rows(64, 2, 32)
    model = setup_model(config_from_dict(PACKNET).model, device="cpu")
    assert spatial.network_stride(model.depth_net) == 32
    with pytest.raises(ValueError, match="does not run on a space axis"):
        spatial.network_stride(model.pose_net)


# --- (b) the ops on two ranks ----------------------------------------------------------

@pytest.mark.parametrize("op", OP_NAMES)
def test_b_each_halo_op_matches_the_whole_op(runs, op):
    for r in runs["two"]:
        got = r["ops"][op]
        assert got["forward"] <= 1e-6, (op, got)
        assert got["input_grad"] <= 1e-5, (op, got)
        assert all(g <= 1e-5 for g in got["param_grads"]), (op, got)


def test_grid_indices(runs):
    assert [(r["grid"]["data_index"], r["grid"]["space_index"]) for r in runs["two"]] == [
        (0, 0), (0, 1)]
    assert [(r["grid"]["data_index"], r["grid"]["space_index"]) for r in runs["four"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in runs["four"]:
        assert (r["grid"]["data_count"], r["grid"]["space_count"]) == (2, 2)


# --- (c) four ranks against JAX's make_mesh_2d step -------------------------------------

def _grid_loss(runs):
    four = runs["four"]
    return float(np.mean([four[0]["resnet"]["loss"], four[2]["resnet"]["loss"]]))


def test_c_resnet_step_on_data_2_space_2_matches_jax(runs):
    four = runs["four"]
    for r in four[1:]:                          # the ranks stay one model
        for key, v in four[0]["resnet"]["state"].items():
            assert torch.equal(v, r["resnet"]["state"][key]), key
    # every rank of a space group reports its data rank's loss
    assert four[0]["resnet"]["loss"] == four[1]["resnet"]["loss"]
    got = four[0]["resnet"]["state"]
    for loss, after in ((runs["j2_loss"], runs["j2_after"]), (runs["j_loss"], runs["j_after"])):
        np.testing.assert_allclose(_grid_loss(runs), loss, rtol=1e-5)
        assert _stats_err(got, after) <= 1e-5
    assert _update_cos(runs["resnet_state0"], got, runs["j_after"]) >= 0.9999


def test_c_jax_mesh_2d_update_parts_from_its_global_batch_step(runs):
    """ROADMAP.md §3 (u), a fault of the JAX package that the port does not
    copy: its loss agrees, its update does not."""
    np.testing.assert_allclose(runs["j2_loss"], runs["j_loss"], rtol=1e-5)
    state0 = runs["resnet_state0"]
    assert _update_cos(state0, runs["j2_after"], runs["j_after"]) < 0.9999
    assert _update_cos(state0, runs["j2_after"], runs["four"][0]["resnet"]["state"]) < 0.9999


# --- (d), (e), (g): two ranks against one process ---------------------------------------

def test_d_packnet_step_on_space_2_matches_one_process(runs):
    a, b = (r["packnet"] for r in runs["two"])
    one = runs["one"]["packnet"]
    # a band takes the two-step pack conv where one process takes the fused one
    assert a["pack_paths"]["fused"] == 0 and a["pack_paths"]["two_step"] > 0
    assert one["pack_paths"]["fused"] > 0
    for key, v in a["state"].items():
        assert torch.equal(v, b["state"][key]), key
    assert a["loss"] == b["loss"]
    np.testing.assert_allclose(a["loss"], one["loss"], rtol=1e-5)
    for k in ("photometric_loss", "smoothness_loss"):
        np.testing.assert_allclose(a["metrics"][k], one["metrics"][k], rtol=1e-5)
    assert _update_cos(runs["packnet_state0"], a["state"], one["state"]) >= 0.9999


def test_e_control_zero_padding_instead_of_the_exchange_misses(runs):
    got = runs["two"][0]["zero_pad"]
    one = runs["one"]["packnet"]
    assert abs(got["loss"] - one["loss"]) / one["loss"] > 1e-5
    assert _update_cos(runs["packnet_state0"], got["state"], one["state"]) < 0.9999


def test_f_an_indivisible_height_raises_on_every_rank(runs):
    for r in runs["four"]:
        assert r["refused"] is not None and "64 does not split into 4 bands" in r["refused"]


def test_g_eval_step_on_space_2_matches_one_process(runs):
    one = runs["one"]["eval"]
    for r in runs["two"]:
        for mode in EVAL_MODES:
            np.testing.assert_allclose(r["eval"][mode], one[mode], rtol=1e-6, atol=1e-7,
                                       err_msg=mode)
        np.testing.assert_allclose(r["eval"]["inv_depth"], one["inv_depth"], rtol=1e-5)


if __name__ == "__main__":
    import pathlib
    import tempfile

    import tests.conftest  # noqa: F401 (JAX on the CPU, with the 8 devices of the tests)

    with tempfile.TemporaryDirectory() as tmp:
        res = _run_all(pathlib.Path(tmp))
    for op in OP_NAMES:
        print(op, {r: res["two"][r]["ops"][op] for r in range(2)})
    print("(a)", _band_camera_err())
    four, one = res["four"], res["one"]
    for name, key in (("mesh_2d", "j2"), ("global batch", "j")):
        print(f"(c) against JAX's {name} step: loss rel",
              abs(_grid_loss(res) - res[key + "_loss"]) / res[key + "_loss"], "update cos",
              _update_cos(res["resnet_state0"], four[0]["resnet"]["state"], res[key + "_after"]),
              "stats", _stats_err(four[0]["resnet"]["state"], res[key + "_after"]))
    print("(u) JAX's mesh_2d against its global batch: update cos",
          _update_cos(res["resnet_state0"], res["j2_after"], res["j_after"]))
    for case in ("packnet", "zero_pad"):
        got = res["two"][0][case]
        print(f"({'d' if case == 'packnet' else 'e'}) loss rel",
              abs(got["loss"] - one["packnet"]["loss"]) / one["packnet"]["loss"], "update cos",
              _update_cos(res["packnet_state0"], got["state"], one["packnet"]["state"]))
    print("(f)", four[0]["refused"])
    for keys in (EVAL_MODES, ("inv_depth",)):
        print("(g)", keys, "max rel", max(
            float(np.max(np.abs(res["two"][r]["eval"][m] - one["eval"][m])
                         / np.maximum(np.abs(one["eval"][m]), 1e-12)))
            for r in range(2) for m in keys))
