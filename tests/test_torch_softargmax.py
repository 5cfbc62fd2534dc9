"""Port soft-argmax (plain PyTorch version of kernels K6f/K6b) vs the JAX
Pallas kernel in interpret mode, at the shapes of tests/test_pallas.py, and
the port's ``generic_project`` vs JAX ``generic_project(projector="xla")``.

Tolerances (as tests/test_pallas.py holds the Pallas kernel to its dense
reference): forward rtol 1e-5 / atol 1e-4; at T = 1e-4 atol 2e-3, where
the sharp softmax turns f32 rounding of the logits into larger coordinate
shifts; gradients 1e-3, the distance both f32 forms sit from the f64 truth.
``generic_project`` with the downsample detour: 1e-4.

The forward kernel's cut-off (it takes no exponential of a window position
whose logit lies more than CUTOFF of csrc/softargmax.cu, and in a second
case the 87.3 of float32 underflow, below the pixel's largest) is written out in
plain PyTorch here and held to the uncut softmax: in float64 it changes
nothing above 1e-6 px, against its own uncut form and against the plain
version's formulation run in float64; in float32 it agrees with the plain version within
2e-5 px at T = 0.05, a few float32 roundings of coordinates up to 50 (the
sums run in another order than torch.softmax's), and within 2e-2 px at
T = 1e-4, where the two forms' logits (magnitudes up to 1e4, float32 spacing
1e-3) round differently and near-tied positions trade weight.

The backward kernel's formulation (two gathers: d direction by pixel over
its window, d rays by ray position over the pixels whose windows hold it,
``transposed_window_bounds``, both with the forward's cut-off) is written
out in plain PyTorch too and held to autograd of the plain version's
formulation: in float64 within 1e-8 of the largest gradient; in float32
against autograd of ``softargmax_coords_plain`` within 1e-4 of the largest
gradient at T = 0.05 (sums of up to 1681 float32 terms in another order;
measured 1.7e-5) and within 5e-3 at T = 1e-4 (measured 7.7e-4), where the
two forms' float32 logits round differently and near-tied positions trade
weight, as in the forward; both float32 forms sit as far from the float64
gradient as from each other.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
and chip_smoke.py hold them to the plain version there.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.geometry.camera_generic import GenericCamera as JaxCamera
from packnet_sfm_tpu.geometry.camera_generic import generic_project as jax_project
from packnet_sfm_tpu.ops.pallas_softargmax import softargmax_coords as jax_softargmax
from packnet_sfm_tpu_torch.geometry.camera_generic import GenericCamera, generic_project
from packnet_sfm_tpu_torch.ops.softargmax import (
    softargmax_coords,
    softargmax_coords_plain,
    transposed_window_bounds,
)

torch.set_num_threads(1)

B, H, W, P = 2, 24, 48, 4
TEMP = 0.05


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True).clip(1e-8)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return _unit(rng, (B, 3, H, W)), _unit(rng, (B, 3, H, W))


@pytest.mark.parametrize("temperature,rtol,atol", [(TEMP, 1e-5, 1e-4), (1e-4, 1e-4, 2e-3)],
                         ids=["T0.05", "T1e-4"])
def test_forward_matches_pallas_interpret(inputs, temperature, rtol, atol):
    direction, rays = inputs
    ex_j, ey_j = jax_softargmax(jnp.asarray(direction), jnp.asarray(rays),
                                temperature, P, True)
    ex, ey = softargmax_coords(torch.from_numpy(direction), torch.from_numpy(rays),
                               temperature, P)
    assert tuple(ex.shape) == (B, H, W)
    assert np.isfinite(ex.numpy()).all()
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ey.numpy(), np.asarray(ey_j), rtol=rtol, atol=atol)


def test_gradients_match_pallas_interpret(inputs):
    direction, rays = inputs

    def loss_jax(d, r):
        ex, ey = jax_softargmax(d, r, TEMP, P, True)
        return jnp.sum(jnp.sin(ex) + 0.5 * jnp.cos(ey))

    gd_j, gr_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(direction),
                                                    jnp.asarray(rays))
    d = torch.from_numpy(direction).requires_grad_()
    r = torch.from_numpy(rays).requires_grad_()
    ex, ey = softargmax_coords(d, r, TEMP, P)
    (torch.sin(ex) + 0.5 * torch.cos(ey)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd_j), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr_j), rtol=1e-3, atol=1e-3)


def test_row_chunk_does_not_change_the_result(inputs):
    direction, rays = (torch.from_numpy(a) for a in inputs)
    ex1, ey1 = softargmax_coords_plain(direction, rays, TEMP, P, row_chunk=5)
    ex2, ey2 = softargmax_coords_plain(direction, rays, TEMP, P, row_chunk=H)
    torch.testing.assert_close(ex1, ex2, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(ey1, ey2, rtol=1e-6, atol=1e-5)


def test_window_and_temperature_are_checked(inputs):
    direction, rays = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError):
        softargmax_coords(direction[:, :, :5], rays[:, :, :5], TEMP, P)
    with pytest.raises(ValueError):
        softargmax_coords(direction, rays, torch.tensor(TEMP), P)


def test_generic_project_matches_jax_xla():
    rng = np.random.default_rng(1)
    rays = _unit(rng, (B, 3, 2 * H, 2 * W)).transpose(0, 2, 3, 1).copy()
    X = rng.normal(size=(B, 2 * H, 2 * W, 3)).astype(np.float32)
    X[..., 2] += 4.0  # mostly-forward points
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    pose[:, :3, 3] = [0.1, -0.05, 0.02]
    out_j = jax_project(JaxCamera(rays=jnp.asarray(rays), Tcw=jnp.asarray(pose)),
                        jnp.asarray(X), TEMP, patch=P, projector="xla")
    cam = GenericCamera(rays=torch.from_numpy(rays), Tcw=torch.from_numpy(pose))
    out = generic_project(cam, torch.from_numpy(X), TEMP, patch=P)
    out_plain = generic_project(cam, torch.from_numpy(X), TEMP, patch=P, projector="plain")
    assert tuple(out.shape) == (B, 2 * H, 2 * W, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out, out_plain, rtol=0, atol=0)


def _kernel_cutoff():
    src = (pathlib.Path(__file__).resolve().parents[1] / "packnet_sfm_tpu_torch" / "csrc"
           / "softargmax.cu").read_text()
    return float(re.search(r"constexpr float CUTOFF = ([0-9.]+)f;", src).group(1))


def _two_pass_cutoff(direction, rays, temperature, patch, cutoff):
    """The forward kernel's algorithm in plain PyTorch, in the inputs' dtype:
    pass 1 the largest logit of each clamped window, pass 2 the sums over the
    positions within ``cutoff`` of it (``cutoff=None``: over all of them)."""
    b, _, h, w = direction.shape
    k = 2 * patch + 1
    kk = torch.arange(k)
    sy = (torch.arange(h) - patch).clamp(0, h - k)
    sx = (torch.arange(w) - patch).clamp(0, w - k)
    rows = (sy[:, None] + kk[None, :])[:, None, :, None]             # [h, 1, k, 1]
    cols = (sx[:, None] + kk[None, :])[None, :, None, :]             # [1, w, 1, k]
    win = rays.permute(0, 2, 3, 1)[:, rows, cols]                    # [B, h, w, k, k, 3]
    logits = torch.einsum("bhwc,bhwyxc->bhwyx", direction.permute(0, 2, 3, 1), win) / temperature
    m = logits.amax(dim=(3, 4), keepdim=True)
    z = logits - m
    e = torch.exp(z)
    if cutoff is not None:
        e = torch.where(z >= -cutoff, e, torch.zeros_like(e))
    s = e.sum(dim=(3, 4))
    cx = cols.to(e.dtype).reshape(1, 1, w, 1, k)
    cy = rows.to(e.dtype).reshape(1, h, 1, k, 1)
    return (e * cx).sum(dim=(3, 4)) / s, (e * cy).sum(dim=(3, 4)) / s, (z < -cutoff
                                                                        if cutoff else z < z).sum()


@pytest.mark.parametrize("cutoff", ["kernel", 87.3])
@pytest.mark.parametrize("temperature", [0.05, 1e-4], ids=["T0.05", "T1e-4"])
@pytest.mark.parametrize("patch,hw", [(4, (24, 48)), (20, (44, 50))], ids=["p4", "p20"])
def test_cutoff_two_pass_equals_the_plain_softmax(patch, hw, temperature, cutoff):
    cutoff = _kernel_cutoff() if cutoff == "kernel" else cutoff
    assert 30.0 <= cutoff <= 87.3
    rng = np.random.default_rng(5)
    direction = torch.from_numpy(_unit(rng, (1, 3) + hw))
    rays = torch.from_numpy(_unit(rng, (1, 3) + hw))
    # float64: dropping the positions below the cut-off changes nothing
    ex_c, ey_c, dropped = _two_pass_cutoff(direction.double(), rays.double(), temperature, patch,
                                           cutoff)
    ex_a, ey_a, _ = _two_pass_cutoff(direction.double(), rays.double(), temperature, patch, None)
    assert (ex_c - ex_a).abs().max().item() <= 1e-6
    assert (ey_c - ey_a).abs().max().item() <= 1e-6
    # at the path's temperature nearly every position is dropped, at 0.05 none
    n = dropped.item() / ex_c.numel() / (2 * patch + 1) ** 2
    assert n > 0.9 if temperature < 1e-3 else n == 0.0
    # float32: the cut two-pass form against the plain version
    ex, ey, _ = _two_pass_cutoff(direction, rays, temperature, patch, cutoff)
    ex_p, ey_p = softargmax_coords_plain(direction, rays, temperature, patch)
    tol = 2e-5 if temperature > 1e-3 else 2e-2
    assert (ex - ex_p).abs().max().item() <= tol
    assert (ey - ey_p).abs().max().item() <= tol


def _plain_in(dtype, direction, rays, temperature, patch):
    """``softargmax_coords_plain``'s formulation (dense window logits, one
    ``torch.softmax``, expectation by matrix product) computed in ``dtype``:
    the plain version itself computes in float32 whatever it is given."""
    b, _, h, w = direction.shape
    k = 2 * patch + 1
    kk = torch.arange(k)
    sy = (torch.arange(h) - patch).clamp(0, h - k)
    sx = (torch.arange(w) - patch).clamp(0, w - k)
    dirs = direction.permute(0, 2, 3, 1).to(dtype)
    rows = rays.permute(0, 2, 3, 1).to(dtype)[:, sy[:, None] + kk[None, :]]
    win = rows[:, :, :, sx[:, None] + kk[None, :]]                   # [B, h, k, w, k, 3]
    logits = torch.einsum("brwc,brywxc->brwyx", dirs, win)
    prob = torch.softmax(logits.reshape(b, h, w, k * k) / temperature, dim=-1)
    prob = prob.reshape(b, h, w, k, k)
    kf = kk.to(dtype)
    return (prob.sum(3) @ kf + sx.to(dtype)[None, None, :],
            prob.sum(4) @ kf + sy.to(dtype)[None, :, None])


@pytest.mark.parametrize("cutoff", ["kernel", 87.3])
@pytest.mark.parametrize("temperature", [0.05, 1e-4], ids=["T0.05", "T1e-4"])
@pytest.mark.parametrize("patch,hw", [(4, (24, 48)), (20, (44, 50))], ids=["p4", "p20"])
def test_cutoff_two_pass_equals_the_plain_version_in_float64(patch, hw, temperature, cutoff):
    cutoff = _kernel_cutoff() if cutoff == "kernel" else cutoff
    rng = np.random.default_rng(5)
    direction = torch.from_numpy(_unit(rng, (1, 3) + hw))
    rays = torch.from_numpy(_unit(rng, (1, 3) + hw))
    # the float64 formulation is the plain version's: in float32 it is the same
    ex_p, ey_p = softargmax_coords_plain(direction, rays, temperature, patch, row_chunk=hw[0])
    ex_f, ey_f = _plain_in(torch.float32, direction, rays, temperature, patch)
    torch.testing.assert_close(ex_f, ex_p, rtol=0, atol=0)
    torch.testing.assert_close(ey_f, ey_p, rtol=0, atol=0)
    ex_c, ey_c, _ = _two_pass_cutoff(direction.double(), rays.double(), temperature, patch, cutoff)
    ex_d, ey_d = _plain_in(torch.float64, direction, rays, temperature, patch)
    assert (ex_c - ex_d).abs().max().item() <= 1e-6
    assert (ey_c - ey_d).abs().max().item() <= 1e-6


@pytest.mark.parametrize("n,patch", [(192, 20), (96, 20), (82, 20), (81, 20), (70, 20), (61, 20),
                                     (45, 20), (41, 20), (260, 90), (7, 1), (3, 0)])
def test_transposed_window_bounds_match_brute_force(n, patch):
    k = 2 * patch + 1
    start = (torch.arange(n) - patch).clamp(0, n - k)                # window start of pixel x
    r = torch.arange(n)
    holds = (start[None, :] <= r[:, None]) & (r[:, None] < start[None, :] + k)    # [r, x]
    lo, hi = transposed_window_bounds(n, patch)
    x = torch.arange(n)[None, :]
    # the pixels that hold r are exactly the interval [lo, hi]
    assert torch.equal(holds, (lo[:, None] <= x) & (x <= hi[:, None]))
    assert int(holds.sum()) == n * k
    # 3p + 1 pixels hold the ray at 2p; all n do where a ray is in reach of both borders
    assert int((hi - lo + 1).max()) == (n if n <= 4 * patch + 1 else 3 * patch + 1)
    with pytest.raises(ValueError):
        transposed_window_bounds(k - 1, patch)


def _backward_two_gathers(direction, rays, gex, gey, temperature, patch, cutoff, row_chunk=8):
    """The backward kernel's algorithm in plain PyTorch, in the inputs' dtype:
    the forward's statistics (m in dot units, s, ex, ey, with the cut-off),
    then d direction gathered by pixel over its window and d rays gathered by
    ray position over the pixels of ``transposed_window_bounds``."""
    b, _, h, w = direction.shape
    k = 2 * patch + 1
    cut = cutoff * temperature
    kk = torch.arange(k)
    sy = (torch.arange(h) - patch).clamp(0, h - k)
    sx = (torch.arange(w) - patch).clamp(0, w - k)
    rows = (sy[:, None] + kk[None, :])[:, None, :, None]             # [h, 1, k, 1]
    cols = (sx[:, None] + kk[None, :])[None, :, None, :]             # [1, w, 1, k]
    dirs = direction.permute(0, 2, 3, 1)                             # [B, h, w, 3]
    rayt = rays.permute(0, 2, 3, 1)
    win = rayt[:, rows, cols]                                        # [B, h, w, k, k, 3]
    dot = torch.einsum("bhwc,bhwyxc->bhwyx", dirs, win)
    m = dot.amax(dim=(3, 4))
    counted = dot >= (m - cut)[..., None, None]
    e = torch.where(counted, torch.exp((dot - m[..., None, None]) / temperature),
                    torch.zeros_like(dot))
    s = e.sum(dim=(3, 4))
    cx, cy = cols.to(e.dtype), rows.to(e.dtype)
    ex, ey = (e * cx).sum(dim=(3, 4)) / s, (e * cy).sum(dim=(3, 4)) / s
    gx, gy = gex / (s * temperature), gey / (s * temperature)

    def at(t):
        return t[..., None, None]

    # d direction: by pixel, over its window
    wgt = e * (at(gx) * (cx - at(ex)) + at(gy) * (cy - at(ey)))
    d_dir = torch.einsum("bhwyx,bhwyxc->bchw", wgt, win)

    # d rays: by ray position (ry, rx), over the pixels [lo, hi] of both axes
    lo_y, hi_y = transposed_window_bounds(h, patch)
    lo_x, hi_x = transposed_window_bounds(w, patch)
    jy, jx = torch.arange(int((hi_y - lo_y).max()) + 1), torch.arange(int((hi_x - lo_x).max()) + 1)
    ys, xs = lo_y[:, None] + jy[None, :], lo_x[:, None] + jx[None, :]          # [h, ny], [w, nx]
    ok_y, ok_x = ys <= hi_y[:, None], xs <= hi_x[:, None]
    ys, xs = ys.clamp(max=h - 1), xs.clamp(max=w - 1)
    d_ray = torch.zeros_like(rays)
    for r0 in range(0, h, row_chunk):
        yi = ys[r0:r0 + row_chunk][:, None, :, None]                 # [rc, 1, ny, 1]
        xi = xs[None, :, None, :]                                    # [1, w, 1, nx]
        ok = ok_y[r0:r0 + row_chunk][:, None, :, None] & ok_x[None, :, None, :]
        dq = dirs[:, yi, xi]                                         # [B, rc, w, ny, nx, 3]
        dotq = torch.einsum("brwyxc,brwc->brwyx", dq, rayt[:, r0:r0 + row_chunk])
        mq = m[:, yi, xi]
        counts = ok & (dotq >= mq - cut)
        eq = torch.where(counts, torch.exp((dotq - mq) / temperature), torch.zeros_like(dotq))
        rx = torch.arange(w).to(e.dtype)[None, None, :, None, None]
        ry = torch.arange(r0, min(r0 + row_chunk, h)).to(e.dtype)[None, :, None, None, None]
        wq = eq * (gx[:, yi, xi] * (rx - ex[:, yi, xi]) + gy[:, yi, xi] * (ry - ey[:, yi, xi]))
        d_ray[:, :, r0:r0 + row_chunk] = torch.einsum("brwyx,brwyxc->bcrw", wq, dq)
    return d_dir, d_ray


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("temperature", [0.05, 1e-4], ids=["T0.05", "T1e-4"])
@pytest.mark.parametrize("patch,hw", [(4, (24, 48)), (20, (44, 50)), (20, (41, 41)),
                                      (20, (45, 70)), (1, (7, 35)), (0, (3, 3))],
                         ids=["p4", "p20", "p20-one-window", "p20-w70", "p1", "p0"])
def test_backward_two_gathers_equal_autograd(patch, hw, temperature, dtype):
    rng = np.random.default_rng(11)
    direction = torch.from_numpy(_unit(rng, (1, 3) + hw))
    rays = torch.from_numpy(_unit(rng, (1, 3) + hw))
    gex, gey = (torch.from_numpy(rng.normal(size=(1,) + hw).astype(np.float32)) for _ in range(2))
    d, r = direction.to(dtype).clone().requires_grad_(), rays.to(dtype).clone().requires_grad_()
    if dtype == torch.float64:
        ex, ey = _plain_in(dtype, d, r, temperature, patch)
        tol = 1e-8
    else:
        ex, ey = softargmax_coords_plain(d, r, temperature, patch)
        tol = 1e-4 if temperature > 1e-3 else 5e-3
    ((ex * gex).sum() + (ey * gey).sum()).backward()
    d_dir, d_ray = _backward_two_gathers(direction.to(dtype), rays.to(dtype), gex.to(dtype),
                                         gey.to(dtype), temperature, patch, _kernel_cutoff())
    for got, want in ((d_dir, d.grad), (d_ray, r.grad)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    if patch > 0:
        assert d.grad.abs().max().item() > 0 and r.grad.abs().max().item() > 0
