"""The port's ego-motion math against the JAX package, float32 on the CPU,
on the same numpy-seeded inputs: the SE(3) maps and their forward
Jacobians at a twist of 0, the warp's forward mode (the plain version of
the ``warp_jvp`` kernel) and its rule in the CUDA autograd function, the
pose graph on one process and on two gloo ranks, the direct alignment, the
trajectory metrics.

Tolerances, each beside what was measured (``PYTHONPATH=. python
tests/test_torch_egomotion.py`` prints the figures):
- SE(3) maps: the same float32 formulas, differing only by the order of
  XLA's fused sums: atol 1e-6 (measured 1.2e-7); the forward Jacobians at
  0: atol 1e-6 (measured 6.0e-8);
- the warp's tangent: rtol 1e-5 with an atol of 1e-6 of its largest
  magnitude;
- the pose graph: two float32 Gauss-Newton solves of up to 60x60 systems,
  in other summation orders (an einsum over the edges here, a vmap and a
  sum there): poses atol 1e-5 (measured 9.5e-7), scales atol 1e-5
  (measured 3.4e-7), cost rtol 1e-5 of a cost of ~112 (measured 1.3e-7);
  two ranks against JAX's one process: the same bounds;
- the direct alignment: 20 Gauss-Newton steps, each a float32 6x6 solve of
  J^T J over 9216 residuals: the largest twist coordinate between the two
  results within 5e-4 (measured 4.7e-5), the mean residual within rtol
  1e-3 (measured 7.4e-5), and the recovery bounds of JAX's own test.
"""

import ctypes
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.egomotion import alignment as jalign
from packnet_sfm_tpu.egomotion import evaluation as jeval
from packnet_sfm_tpu.egomotion import posegraph as jpg
from packnet_sfm_tpu.geometry import se3 as jse3
from packnet_sfm_tpu.ops import warp as jwarp
from packnet_sfm_tpu_torch.egomotion import alignment as talign
from packnet_sfm_tpu_torch.egomotion import evaluation as teval
from packnet_sfm_tpu_torch.egomotion import posegraph as tpg
from packnet_sfm_tpu_torch.geometry import se3 as tse3
from packnet_sfm_tpu_torch.geometry.pose import compose_poses
from packnet_sfm_tpu_torch.ops import warp as twarp
from tests.test_egomotion import make_edges, make_trajectory
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_SE3 = 1e-6
TOL_JAC0 = 1e-6
TOL_JVP = 1e-6            # of the tangent's largest magnitude
TOL_POSES = 1e-5
TOL_SCALES = 1e-5
TOL_COST = 1e-5
TOL_ALIGN_XI = 5e-4
TOL_ALIGN_RES = 1e-3
LAUNCH_TIMEOUT = 120


def _twists(seed=0):
    """Random twists, with theta = 0 and theta^2 < 1e-10 among them."""
    xi = np.random.default_rng(seed).uniform(-0.8, 0.8, size=(16, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = [3e-6, -4e-6, 2e-6]           # theta^2 = 2.9e-11
    xi[2, 3:] = 0.0
    return xi


# --- SE(3) ------------------------------------------------------------------------

def se3_figures():
    xi = _twists()
    T_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T_t = tse3.se3_exp(torch.from_numpy(xi)).numpy()
    R_j = np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:])))
    R_t = tse3.so3_exp(torch.from_numpy(xi[:, 3:])).numpy()
    log_j = np.asarray(jse3.se3_log(jnp.asarray(T_j)))
    log_t = tse3.se3_log(torch.from_numpy(T_j)).numpy()
    w_j = np.asarray(jse3.so3_log(jnp.asarray(R_j)))
    w_t = tse3.so3_log(torch.from_numpy(R_j)).numpy()
    return {name: float(np.abs(a - b).max()) for name, (a, b) in
            dict(se3_exp=(T_t, T_j), so3_exp=(R_t, R_j), se3_log=(log_t, log_j),
                 so3_log=(w_t, w_j)).items()}


def test_se3_maps_match_jax():
    for name, err in se3_figures().items():
        assert err < TOL_SE3, (name, err)


def _jacobians_at_zero():
    """d/d xi at xi = 0 of se3_exp, and of se3_log(exp(xi) T) at a pose T,
    in both packages (jax.jacfwd, torch.func.jacfwd)."""
    T = np.asarray(jse3.se3_exp(jnp.asarray(_twists(1)[3:4])))[0]
    zero = np.zeros(6, np.float32)
    j_exp = np.asarray(jax.jacfwd(lambda x: jse3.se3_exp(x[None])[0])(jnp.asarray(zero)))
    t_exp = torch.func.jacfwd(lambda x: tse3.se3_exp(x[None])[0])(torch.from_numpy(zero))
    j_log = np.asarray(jax.jacfwd(
        lambda x: jse3.se3_log((jse3.se3_exp(x[None])[0] @ T)[None])[0])(jnp.asarray(zero)))
    t_log = torch.func.jacfwd(
        lambda x: tse3.se3_log((tse3.se3_exp(x[None])[0] @ torch.from_numpy(T))[None])[0])(
        torch.from_numpy(zero))
    return (t_exp.numpy(), j_exp), (t_log.numpy(), j_log)


def test_forward_jacobians_at_zero_are_finite_and_match_jax():
    for ours, theirs in _jacobians_at_zero():
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours, theirs, atol=TOL_JAC0)
    # reverse mode through the theta = 0 branch is NaN-free too
    x = torch.zeros(1, 6, requires_grad=True)
    tse3.se3_exp(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_compose_and_small_angle():
    xi = torch.from_numpy(_twists(2)[3:5])
    Ta, Tb = tse3.se3_exp(xi)
    assert torch.equal(compose_poses(Ta, Tb), Ta @ Tb)
    T = tse3.se3_exp(torch.tensor([[1e-7, 2e-7, 0, 0, 0, 1e-8]]))
    assert torch.isfinite(T).all()
    np.testing.assert_allclose(T[0, :3, 3].numpy(), [1e-7, 2e-7, 0], atol=1e-9)


# --- the warp's forward mode -------------------------------------------------------

def _warp_inputs(seed=0, b=2, h=12, w=20, c=3, ho=10, wo=16):
    """Image, coordinates that leave the image on every side (exact integer
    positions and -1/+1 among them) and a coordinate tangent."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(b, h, w, c)).astype(np.float32)
    coords = (rng.uniform(-1, 1, size=(b, ho, wo, 2)) * 1.4).astype(np.float32)
    coords[0, 0, :8] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0],
                        [2 * 3 / (w - 1) - 1, 2 * 2 / (h - 1) - 1], [5, 5], [-5, 0]]
    tangent = rng.normal(size=(b, ho, wo, 2)).astype(np.float32)
    return image, coords, tangent


def _plain_jvp(image, coords, tangent, padding_mode):
    return torch.func.jvp(lambda c: twarp.grid_sample_plain(image, c, padding_mode),
                          (coords,), (tangent,))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_plain_warp_forward_mode_matches_jax(padding_mode):
    image, coords, tangent = _warp_inputs()
    want, want_t = jax.jvp(lambda c: jwarp.grid_sample(image, c, padding_mode),
                           (coords,), (tangent,))
    got, got_t = _plain_jvp(*(torch.from_numpy(a) for a in (image, coords, tangent)),
                            padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want_t = np.asarray(want_t)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-5,
                               atol=TOL_JVP * np.abs(want_t).max())


def _kernel_formula(image, coords, tangent, padding_mode="zeros"):
    """What ``warp_jvp`` computes, written out on the plain version's taps:
    t = (W-1)/2 tx ((1-wy)(v01-v00) + wy(v11-v10)) + (H-1)/2 ty (bot-top)."""
    b, h, w, c = image.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def tap(dx, dy):
        corner = torch.stack([x0 + dx, y0 + dy], -1)
        # the plain warp at the tap's exact position returns the tap
        return twarp.grid_sample_plain(image, torch.stack(
            [corner[..., 0] / (0.5 * (w - 1)) - 1.0, corner[..., 1] / (0.5 * (h - 1)) - 1.0], -1),
            padding_mode)

    v00, v01, v10, v11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    sx = tangent[..., 0:1] * (0.5 * (w - 1))
    sy = tangent[..., 1:2] * (0.5 * (h - 1))
    return sx * ((1 - wy) * (v01 - v00) + wy * (v11 - v10)) + sy * (bot - top)


@pytest.mark.parametrize("mode", ["torch.func", "forward_ad"])
def test_cuda_autograd_function_routes_the_tangent_to_warp_jvp(monkeypatch, mode):
    """``_WarpCuda``'s forward-mode rule, on the CPU with the launchers
    replaced by the plain warp and the kernel's formula (which read each
    tensor's storage, as the launchers do): the coordinate tangent goes to
    ``warp_jvp`` with the saved inputs, in both forward-mode APIs. An image
    tangent (which raised once) goes to ``warp_fwd``, the warp being linear
    in the image, and its value is the plain version's; with a coordinate
    tangent beside it, the two parts add."""
    calls = []

    def launched(name, out, result, *inputs):
        # as the wrappers: every pointer through _with_storage, and the
        # result written into the new output's storage by address
        calls.append(name)
        for t in inputs:
            twarp._with_storage(t).data_ptr()
        result = twarp._with_storage(result.contiguous())
        ctypes.memmove(twarp._with_storage(out).data_ptr(), result.data_ptr(),
                       result.numel() * result.element_size())
        return out

    def fake_fwd(image, coords, padding_mode="zeros"):
        out = torch.empty(coords.shape[:3] + image.shape[3:], dtype=torch.float32)
        result = twarp.grid_sample_plain(twarp._with_storage(image),
                                         twarp._with_storage(coords), padding_mode)
        return launched("fwd", out, result, image, coords)

    def fake_jvp(image, coords, coords_tangent, padding_mode="zeros"):
        assert coords_tangent.dtype == torch.float32 and coords_tangent.is_contiguous()
        out = torch.empty(coords.shape[:3] + image.shape[3:], dtype=torch.float32)
        result = _kernel_formula(image, coords, coords_tangent, padding_mode)
        return launched("jvp", out, result, image, coords, coords_tangent)

    monkeypatch.setattr(twarp, "warp_fwd_cuda", fake_fwd)
    monkeypatch.setattr(twarp, "warp_jvp_cuda", fake_jvp)
    image, coords, tangent = (torch.from_numpy(a) for a in _warp_inputs(1))
    _, want = _plain_jvp(image, coords, tangent, "zeros")
    if mode == "torch.func":
        _, got = torch.func.jvp(lambda c: twarp._WarpCuda.apply(image, c, "zeros"),
                                (coords,), (tangent,))
    else:
        import torch.autograd.forward_ad as fwAD
        with fwAD.dual_level():
            out = twarp._WarpCuda.apply(image, fwAD.make_dual(coords, tangent), "zeros")
            got = fwAD.unpack_dual(out).tangent
    assert calls == ["fwd", "jvp"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=TOL_JVP * want.abs().max().item())
    image_t = torch.from_numpy(np.random.default_rng(7).normal(size=image.shape)
                               .astype(np.float32))
    for primals, tangents, launches in (((image,), (image_t,), ["fwd", "fwd"]),
                                        ((image, coords), (image_t, tangent),
                                         ["fwd", "fwd", "jvp"])):
        calls.clear()
        f = (lambda im: twarp._WarpCuda.apply(im, coords, "zeros")) if len(primals) == 1 \
            else (lambda im, c: twarp._WarpCuda.apply(im, c, "zeros"))
        g = (lambda im: twarp.grid_sample_plain(im, coords)) if len(primals) == 1 \
            else (lambda im, c: twarp.grid_sample_plain(im, c))
        _, got = torch.func.jvp(f, primals, tangents)
        _, want = torch.func.jvp(g, primals, tangents)
        assert calls == launches
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=TOL_JVP * want.abs().max().item())


# --- the pose graph ----------------------------------------------------------------

def _graph(seed, n, noise=0.02, loop=True):
    rng = np.random.default_rng(seed)
    gt = make_trajectory(rng, n)
    edges = make_edges(gt, rng, noise=noise, loop=loop)
    T_init = np.asarray(jpg.chain_relative_poses(edges["Z"][:n - 1]))
    return gt, {k: np.asarray(v) for k, v in edges.items()}, T_init


def _solve_both(T_init, edges, cfg):
    T_j, s_j, c_j = jpg.optimize_pose_graph(
        jnp.asarray(T_init), {k: jnp.asarray(v) for k, v in edges.items()},
        jpg.PoseGraphConfig(**cfg))
    T_t, s_t, c_t = tpg.optimize_pose_graph(
        torch.from_numpy(T_init), {k: torch.from_numpy(v) for k, v in edges.items()},
        tpg.PoseGraphConfig(**cfg))
    return (T_t.numpy(), s_t.numpy(), float(c_t)), (np.asarray(T_j), np.asarray(s_j), float(c_j))


GRAPHS = {"scales": (5, 8, dict(num_iterations=10, optimize_scales=True)),
          "no_scales": (3, 10, dict(num_iterations=15, optimize_scales=False))}


def pose_graph_figures():
    out = {}
    for name, (seed, n, cfg) in GRAPHS.items():
        _, edges, T_init = _graph(seed, n)
        (T_t, s_t, c_t), (T_j, s_j, c_j) = _solve_both(T_init, edges, cfg)
        out[name] = dict(poses=float(np.abs(T_t - T_j).max()),
                         scales=float(np.abs(s_t - s_j).max()),
                         cost_rel=abs(c_t - c_j) / c_j, cost=c_j)
    return out


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pose_graph_matches_jax(name):
    seed, n, cfg = GRAPHS[name]
    gt, edges, T_init = _graph(seed, n)
    (T_t, s_t, c_t), (T_j, s_j, c_j) = _solve_both(T_init, edges, cfg)
    np.testing.assert_allclose(T_t, T_j, atol=TOL_POSES)
    np.testing.assert_allclose(s_t, s_j, atol=TOL_SCALES)
    np.testing.assert_allclose(c_t, c_j, rtol=TOL_COST)
    # and it refines: ATE below the chained odometry's
    assert (teval.absolute_trajectory_error(T_t, gt, align_scale=False)
            < teval.absolute_trajectory_error(T_init, gt, align_scale=False))


def test_zero_noise_graph_stays_optimal():
    gt, edges, _ = _graph(2, 8, noise=0.0, loop=False)
    T, _, cost = tpg.optimize_pose_graph(
        torch.from_numpy(gt), {k: torch.from_numpy(v) for k, v in edges.items()},
        tpg.PoseGraphConfig(num_iterations=5, optimize_scales=False))
    assert float(cost) < 1e-6
    np.testing.assert_allclose(T.numpy(), gt, atol=1e-4)


def test_padding_is_exact_and_chain_matches_jax():
    _, edges, T_init = _graph(6, 10)
    e = {k: torch.from_numpy(v) for k, v in edges.items()}
    padded = tpg._pad_edges(e, 4)
    assert padded["i"].shape[0] % 4 == 0 and padded["i"].shape[0] > e["i"].shape[0]
    cfg = tpg.PoseGraphConfig(num_iterations=4)
    T_a, s_a, c_a = tpg.optimize_pose_graph(torch.from_numpy(T_init), e, cfg)
    T_b, s_b, c_b = tpg.optimize_pose_graph(torch.from_numpy(T_init), padded, cfg)
    np.testing.assert_allclose(T_b.numpy(), T_a.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(c_b), float(c_a), rtol=1e-6)
    np.testing.assert_allclose(tpg.chain_relative_poses(e["Z"][:9]).numpy(),
                               np.asarray(jpg.chain_relative_poses(jnp.asarray(edges["Z"][:9]))),
                               atol=1e-5)


def _two_ranks(tmp_path, T_init, edges, cfg):
    np.savez(tmp_path / "graph.npz", T_init=T_init, **edges,
             num_iterations=cfg["num_iterations"], optimize_scales=cfg["optimize_scales"])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", os.path.join(ROOT, "tests", "torch_posegraph_worker.py"), str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]


def test_sharded_pose_graph_on_two_ranks_matches_jax(tmp_path):
    """21 edges split over two gloo ranks (padded to 22) against JAX's one
    solve on the 21; both ranks return the same result."""
    seed, n, cfg = 5, 10, dict(num_iterations=10, optimize_scales=True)
    _, edges, T_init = _graph(seed, n)
    assert edges["i"].shape[0] % 2 == 1
    T_j, s_j, c_j = jpg.optimize_pose_graph(
        jnp.asarray(T_init), {k: jnp.asarray(v) for k, v in edges.items()},
        jpg.PoseGraphConfig(**cfg))
    r0, r1 = _two_ranks(tmp_path, T_init, edges, cfg)
    assert int(r0["world"]) == 2
    for r in (r0, r1):
        np.testing.assert_allclose(r["T"], np.asarray(T_j), atol=TOL_POSES)
        np.testing.assert_allclose(r["scales"], np.asarray(s_j), atol=TOL_SCALES)
        np.testing.assert_allclose(float(r["cost"]), float(c_j), rtol=TOL_COST)
    np.testing.assert_array_equal(r0["T"], r1["T"])


# --- the direct alignment -----------------------------------------------------------

def _plane_scene():
    """JAX's test_recovers_known_pose scene: a plane at Z = 5 with an
    analytic texture, the reference view rendered through the exact
    homography of a known small transform."""
    h, w, fx = 48, 64, 40.0
    K = np.array([[fx, 0, w / 2 - 0.5], [0, fx, h / 2 - 0.5], [0, 0, 1]], np.float64)

    def texture(u, v):
        return np.stack([0.5 + 0.4 * np.sin(u / 2.5) * np.cos(v / 3.5),
                         0.5 + 0.4 * np.sin(u / 4.0 + 1.0) * np.sin(v / 2.0),
                         0.5 + 0.4 * np.cos(u / 3.0 + v / 5.0)], -1)

    ys, xs = np.mgrid[:h, :w].astype(np.float64)
    target = texture(xs, ys).astype(np.float32)[None]
    inv_depth = np.full((1, h, w, 1), 1 / 5.0, np.float32)
    xi_true = np.array([0.05, -0.03, 0.06, 0.003, -0.004, 0.002], np.float32)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(xi_true[None])))[0].astype(np.float64)
    R, t = T_true[:3, :3], T_true[:3, 3]
    Hinv = np.linalg.inv(K @ (R + np.outer(t, [0, 0, 1]) / 5.0) @ np.linalg.inv(K))
    q = np.stack([xs, ys, np.ones_like(xs)], -1) @ Hinv.T
    ref = texture(q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]).astype(np.float32)[None]
    return target, ref, inv_depth, K.astype(np.float32)[None], T_true.astype(np.float32)


def alignment_figures(iterations=20):
    target, ref, inv_depth, K, T_true = _plane_scene()
    T_j, res_j = jalign.refine_pose_photometric(
        jnp.asarray(target), jnp.asarray(ref), jnp.asarray(inv_depth), jnp.asarray(K),
        jnp.eye(4), num_iterations=iterations)
    T_t, res_t = talign.refine_pose_photometric(
        *(torch.from_numpy(a) for a in (target, ref, inv_depth, K)), torch.eye(4),
        num_iterations=iterations)
    between = tse3.se3_log((torch.linalg.inv(T_t) @ torch.from_numpy(np.asarray(T_j)))[None])[0]
    err = tse3.se3_log((torch.linalg.inv(T_t) @ torch.from_numpy(T_true))[None])[0].numpy()
    return dict(between=float(between.abs().max()), res_t=float(res_t), res_j=float(res_j),
                trans_err=float(np.linalg.norm(err[:3])), rot_err=float(np.linalg.norm(err[3:])))


def test_direct_alignment_matches_jax_and_recovers_the_pose():
    f = alignment_figures()
    assert f["between"] < TOL_ALIGN_XI, f
    np.testing.assert_allclose(f["res_t"], f["res_j"], rtol=TOL_ALIGN_RES)
    # JAX's own recovery bounds (about 3x better than the start, 0.085)
    assert f["res_t"] < 0.03, f
    assert f["trans_err"] < 0.035, f
    assert f["rot_err"] < 0.006, f


# --- trajectory metrics -------------------------------------------------------------

def test_trajectory_metrics_are_the_jax_packages():
    rng = np.random.default_rng(8)
    gt = make_trajectory(rng, 12)
    pred = gt.copy()
    pred[:, :3, 3] += 0.05 * rng.normal(size=(12, 3))
    for scale in (True, False):
        assert (teval.absolute_trajectory_error(pred, gt, align_scale=scale)
                == jeval.absolute_trajectory_error(pred, gt, align_scale=scale))
    assert teval.relative_pose_error(pred, gt, 2) == jeval.relative_pose_error(pred, gt, 2)
    pts = rng.normal(size=(20, 3))
    for a, b in zip(teval.align_umeyama(pts, 2 * pts + 1), jeval.align_umeyama(pts, 2 * pts + 1)):
        np.testing.assert_array_equal(a, b)


def test_kitti_pose_files_round_trip(tmp_path):
    gt = make_trajectory(np.random.default_rng(9), 6)
    teval.save_kitti_odometry_poses(str(tmp_path / "p.txt"), gt)
    loaded = teval.load_kitti_odometry_poses(str(tmp_path / "p.txt"))
    np.testing.assert_array_equal(loaded, jeval.load_kitti_odometry_poses(str(tmp_path / "p.txt")))
    np.testing.assert_allclose(loaded, gt, atol=1e-6)


if __name__ == "__main__":
    import json

    print(json.dumps({"se3": se3_figures(),
                      "jacobians_at_zero": [float(np.abs(a - b).max())
                                            for a, b in _jacobians_at_zero()],
                      "pose_graph": pose_graph_figures(),
                      "alignment": alignment_figures()}, indent=1))
