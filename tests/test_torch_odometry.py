"""The port's odometry pipeline against the JAX package, float32 on the
CPU: DepthResNet-18 + PoseNet at 64x96 with the same weights (JAX's
initial draw, carried over by ``utils/convert.from_jax``), on seeded
frames of a textured scene panning a few pixels a frame. Then
``cli.odometry.run_odometry`` end to end on a port checkpoint.

Tolerances, each beside what was measured (``PYTHONPATH=. python
tests/test_torch_odometry.py`` prints the figures):
- PoseNet's poses: the same float32 convolutions in other orders: atol
  1e-6 (measured 6.0e-8, consecutive and skip-3 pairs);
- the direct refinement of each pair (4 Gauss-Newton steps on the predicted
  depth): the largest twist coordinate between the two results within
  1e-4 (measured 3.6e-7; the refinement moved the poses by up to 2.8e-2);
- the windowed pose graph on the same relative poses: atol 1e-5 (measured
  7.5e-9 with the composed skip-2 edges, 6.0e-8 with extra edges).
The end-to-end run keeps ``tests/test_cli.py``'s relative assertion (bundle
adjustment lowers ATE by 10% on a loop with noisy pose measurements), not
its absolute pins.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.egomotion import odometry as jodo
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.geometry.se3 import se3_exp as jax_se3_exp
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu_torch.cli import odometry as odo_cli
from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.egomotion import odometry as todo
from packnet_sfm_tpu_torch.egomotion.evaluation import (
    absolute_trajectory_error,
    load_kitti_odometry_poses,
    save_kitti_odometry_poses,
)
from packnet_sfm_tpu_torch.engine.checkpoint import save_checkpoint
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.geometry.se3 import se3_log
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

H, W, N = 64, 96, 6
TOL_POSE = 1e-6
TOL_REFINED = 1e-4
TOL_WINDOW = 1e-5
DIRECT_ITERATIONS = 4


def _config(h=H, w=W):
    c = jax_default_config()
    c.model.name = "SelfSupModel"
    c.model.depth_net.name = "DepthResNet"
    c.model.depth_net.version = "18"
    c.model.pose_net.name = "PoseNet"
    c.datasets.augmentation.image_shape = (h, w)
    return c


def _frames(n=N, h=H, w=W, seed=0):
    """A smooth random texture panning 2 px a frame, float32 [n, h, w, 3]."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(size=(h // 8 + 1, (w + 2 * n) // 8 + 1, 3)), np.ones((8, 8, 1)))
    base = base + 0.05 * rng.uniform(size=base.shape)
    return np.stack([base[:h, 2 * k:2 * k + w] for k in range(n)]).astype(np.float32)


def _models():
    """The JAX model and variables, the port model with the same weights,
    and the frames."""
    c = _config()
    jmodel = jax_factory.setup_model(c.model)
    sample = {"rgb": np.zeros((1, H, W, 3), np.float32),
              "rgb_context": [np.zeros((1, H, W, 3), np.float32)] * 2}
    variables = jax.tree_util.tree_map(np.asarray, init_model(jmodel, jax.random.PRNGKey(0),
                                                              sample))
    model = setup_model(ConfigNode.from_dict(c.to_dict()).model, device="cpu")
    model.load_state_dict(from_jax(variables["params"], variables.get("batch_stats")))
    return jmodel, variables, model, _frames()


@pytest.fixture(scope="module")
def models():
    return _models()


def _twist_between(a, b):
    return float(se3_log(torch.linalg.inv(torch.from_numpy(a)) @ torch.from_numpy(b))
                 .abs().max())


def odometry_figures(models):
    jmodel, variables, model, frames = models
    rel_j = jodo.predict_relative_poses(jmodel, variables, frames)
    rel_t = todo.predict_relative_poses(model, frames)
    skip_j = jodo.predict_skip_poses(jmodel, variables, frames, stride=3)
    skip_t = todo.predict_skip_poses(model, frames, stride=3)
    K = odo_cli.kitti_intrinsics(H, W)
    ref_j = jodo.refine_relative_poses(jmodel, variables, frames, K, rel_j,
                                       num_iterations=DIRECT_ITERATIONS)
    ref_t = todo.refine_relative_poses(model, frames, K, rel_j,
                                       num_iterations=DIRECT_ITERATIONS)
    traj = jodo.trajectory_from_relative(rel_j)
    windows = {}
    for name, extra in (("skip2", None), ("extra", skip_j)):
        w_j = jodo.refine_trajectory_windowed(traj, rel_j, window=4, overlap=2,
                                              extra_edges=extra)
        w_t = todo.refine_trajectory_windowed(traj, rel_j, window=4, overlap=2,
                                              extra_edges=extra, device="cpu")
        windows[name] = (w_t, w_j)
    return dict(rel=(rel_t, rel_j), skip=(skip_t, skip_j), refined=(ref_t, ref_j),
                traj=(todo.trajectory_from_relative(rel_j), traj), windows=windows)


@pytest.fixture(scope="module")
def figures(models):
    return odometry_figures(models)


def test_pose_net_odometry_matches_jax(figures):
    rel_t, rel_j = figures["rel"]
    assert rel_t.shape == (N - 1, 4, 4)
    np.testing.assert_allclose(rel_t, rel_j, atol=TOL_POSE)
    skip_t, skip_j = figures["skip"]
    assert [(i, j, w) for i, j, _, w in skip_t] == [(i, j, w) for i, j, _, w in skip_j]
    np.testing.assert_allclose(np.stack([z for _, _, z, _ in skip_t]),
                               np.stack([z for _, _, z, _ in skip_j]), atol=TOL_POSE)


def test_direct_refinement_matches_jax(figures):
    ref_t, ref_j = figures["refined"]
    assert ref_t.shape == (N - 1, 4, 4)
    for a, b in zip(ref_t, ref_j):
        assert _twist_between(a, b) < TOL_REFINED
    # it moved the poses (the refinement did something)
    assert max(_twist_between(a, b) for a, b in zip(ref_t, figures["rel"][1])) > 1e-4


def test_trajectory_and_windows_match_jax(figures):
    np.testing.assert_allclose(*figures["traj"], atol=1e-6)
    for name, (w_t, w_j) in figures["windows"].items():
        np.testing.assert_allclose(w_t, w_j, atol=TOL_WINDOW, err_msg=name)


# --- cli.odometry end to end ------------------------------------------------------------

def _loop_trajectory(n=24):
    """A loop: forward motion with a steady yaw that closes a circle."""
    poses = [np.eye(4, dtype=np.float32)]
    yaw = 2 * np.pi / (n - 1)
    for _ in range(n - 1):
        xi = np.array([0, 0, 1.0, 0, yaw, 0], np.float32)
        poses.append(poses[-1] @ np.asarray(jax_se3_exp(jnp.asarray(xi[None])))[0])
    return np.stack(poses)


@pytest.fixture
def checkpoint(tmp_path):
    c = _config(32, 64)
    model = setup_model(ConfigNode.from_dict(c.to_dict()).model, device="cpu")
    return save_checkpoint(str(tmp_path / "ckpt"), model, c.to_dict(), epoch=0)


def test_run_odometry_writes_the_trajectory_and_refines(checkpoint, tmp_path, capsys):
    frames_dir = tmp_path / "frames"
    os.makedirs(frames_dir)
    base = (np.random.default_rng(2).uniform(size=(32, 64, 3)) * 255).astype(np.uint8)
    for k in range(5):
        Image.fromarray(np.roll(base, k * 2, axis=1)).save(frames_dir / f"{k:06d}.png")
    gt = str(tmp_path / "gt.txt")
    save_kitti_odometry_poses(gt, _loop_trajectory(5))
    out = str(tmp_path / "poses.txt")
    traj = odo_cli.run_odometry(checkpoint, str(frames_dir), output=out, gt=gt,
                                refine_direct=True, refine_ba=True, window=5, device="cpu")
    assert traj.shape == (5, 4, 4) and np.isfinite(traj).all()
    np.testing.assert_allclose(load_kitti_odometry_poses(out), traj, atol=1e-6)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"ate_rmse_m", "rpe_trans_m", "rpe_rot_deg", "frames"}
    assert line["frames"] == 5


def test_refine_ba_lowers_ate_through_the_cli(checkpoint, tmp_path, monkeypatch):
    """As tests/test_cli.py's BA proof: the pose net replaced by independent
    noisy measurements of a loop's true relative motion (consecutive and
    skip pairs); chaining, the windowed Schur BA, splicing, the KITTI files
    and ATE run for real. BA must lower ATE by 10%."""
    n = 24
    gt = _loop_trajectory(n)
    frames_dir = tmp_path / "loop"
    os.makedirs(frames_dir)
    rng_img = np.random.default_rng(0)
    for k in range(n):
        Image.fromarray((rng_img.uniform(size=(32, 64, 3)) * 255).astype(np.uint8)).save(
            frames_dir / f"{k:06d}.png")
    gt_path = str(tmp_path / "gt.txt")
    save_kitti_odometry_poses(gt_path, gt)
    rng = np.random.default_rng(11)

    def noisy_rel(i, j, sigma=0.03):
        true = np.linalg.inv(gt[i]) @ gt[j]
        xi = (sigma * rng.normal(size=6)).astype(np.float32)
        return (true @ np.asarray(jax_se3_exp(jnp.asarray(xi[None])))[0]).astype(np.float32)

    monkeypatch.setattr(todo, "predict_relative_poses", lambda model, frames, **kw: np.stack(
        [noisy_rel(k, k + 1) for k in range(n - 1)]))
    monkeypatch.setattr(todo, "predict_skip_poses", lambda model, frames, stride=2, **kw: [
        (k, k + stride, noisy_rel(k, k + stride), 0.7) for k in range(n - stride)])
    traj_raw = odo_cli.run_odometry(checkpoint, str(frames_dir), device="cpu")
    traj_ba = odo_cli.run_odometry(checkpoint, str(frames_dir), gt=gt_path,
                                   output=str(tmp_path / "pred.txt"), refine_ba=True,
                                   window=8, device="cpu")
    ate_raw = absolute_trajectory_error(traj_raw, gt, align_scale=False)
    ate_ba = absolute_trajectory_error(traj_ba, gt, align_scale=False)
    assert np.isfinite(ate_raw) and np.isfinite(ate_ba)
    assert ate_ba < ate_raw * 0.9, (ate_raw, ate_ba)


def test_odometry_cli_arguments():
    a = odo_cli.parse_args(["--checkpoint", "c", "--input", "i", "--refine-direct",
                            "--refine-ba", "--window", "6", "--max-frames", "9",
                            "--image_shape", "32", "64"])
    assert (a.refine_direct, a.refine_ba, a.window, a.max_frames, a.image_shape, a.device) == (
        True, True, 6, 9, [32, 64], "cuda")


if __name__ == "__main__":
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    jax.config.update("jax_platforms", "cpu")
    f = odometry_figures(_models())
    print(json.dumps({
        "rel": float(np.abs(f["rel"][0] - f["rel"][1]).max()),
        "skip": float(max(np.abs(a[2] - b[2]).max() for a, b in zip(*f["skip"]))),
        "refined": max(_twist_between(a, b) for a, b in zip(*f["refined"])),
        "moved": max(_twist_between(a, b) for a, b in zip(f["refined"][0], f["rel"][1])),
        "windows": {k: float(np.abs(a - b).max()) for k, (a, b) in f["windows"].items()}},
        indent=1))
