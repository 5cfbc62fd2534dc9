"""Port soft-argmax (plain PyTorch version of kernels K6f/K6b) vs the JAX
Pallas kernel in interpret mode, at the shapes of tests/test_pallas.py, and
the port's ``generic_project`` vs JAX ``generic_project(projector="xla")``.

Tolerances (as tests/test_pallas.py holds the Pallas kernel to its dense
reference): forward rtol 1e-5 / atol 1e-4; at T = 1e-4 atol 2e-3, where
the sharp softmax turns f32 rounding of the logits into larger coordinate
shifts; gradients 1e-3, the distance both f32 forms sit from the f64 truth.
``generic_project`` with the downsample detour: 1e-4.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
and chip_smoke.py hold them to the plain version there.
"""

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
