"""Port geometry and image ops vs the JAX package on the same numpy inputs:
``pose_vec_to_mat``, ``invert_pose``, ``transform_points``,
``interpolate_image`` (align-corners bilinear from an explicit grid),
``grid_sample`` (values and coordinate gradients), and the canonical ray
template. Tolerance rtol 1e-5 (float32, same formulas; atol 1e-6 for
entries near zero). ``interpolate_image`` takes atol 1e-5: XLA on the CPU
rounds some of linspace's grid points one ulp lower than the formula does
(numpy and torch agree with each other), which moves a [0, 1] image sample
by up to ~3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.geometry import camera_generic as jcg
from packnet_sfm_tpu.geometry import pose as jpose
from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu.ops import warp as jwarp
from packnet_sfm_tpu_torch.geometry import camera_generic as tcg
from packnet_sfm_tpu_torch.geometry import pose as tpose
from packnet_sfm_tpu_torch.ops import image as timage
from packnet_sfm_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(ours, theirs, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=rtol, atol=atol)


def test_pose_vec_to_mat_and_inverse():
    vec = np.random.default_rng(0).normal(scale=0.3, size=(4, 6)).astype(np.float32)
    T = tpose.pose_vec_to_mat(torch.from_numpy(vec))
    _close(T, jpose.pose_vec_to_mat(jnp.asarray(vec)))
    _close(tpose.invert_pose(T), jpose.invert_pose(jpose.pose_vec_to_mat(jnp.asarray(vec))))
    with pytest.raises(ValueError):
        tpose.pose_vec_to_mat(torch.from_numpy(vec), mode="quat")


def test_transform_points():
    rng = np.random.default_rng(1)
    T = np.array(jpose.pose_vec_to_mat(
        jnp.asarray(rng.normal(scale=0.3, size=(2, 6)).astype(np.float32))))
    pts = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    _close(tpose.transform_points(torch.from_numpy(T), torch.from_numpy(pts)),
           jpose.transform_points(jnp.asarray(T), jnp.asarray(pts)))


@pytest.mark.parametrize("shape", [(12, 20), (48, 80), (24, 40)], ids=["down", "up", "same"])
def test_interpolate_image(shape):
    img = np.random.default_rng(2).uniform(size=(2, 24, 40, 3)).astype(np.float32)
    ours = timage.interpolate_image(torch.from_numpy(img), shape)
    assert tuple(ours.shape) == (2,) + shape + (3,)
    _close(ours, jimage.interpolate_image(jnp.asarray(img), shape), atol=1e-5)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_values_and_coord_grads(padding_mode):
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(2, 16, 24, 3)).astype(np.float32)
    # in and out of range, so both the taps and the zero padding are hit
    coords = rng.uniform(-1.2, 1.2, size=(2, 10, 14, 2)).astype(np.float32)
    wts = rng.normal(size=(2, 10, 14, 3)).astype(np.float32)

    def f(c):
        return jnp.sum(jwarp.grid_sample(jnp.asarray(img), c, padding_mode) * wts)

    theirs = jwarp.grid_sample(jnp.asarray(img), jnp.asarray(coords), padding_mode)
    g_theirs = jax.grad(f)(jnp.asarray(coords))
    c = torch.from_numpy(coords).requires_grad_()
    ours = twarp.grid_sample(torch.from_numpy(img), c, padding_mode)
    (ours * torch.from_numpy(wts)).sum().backward()
    _close(ours, theirs)
    _close(c.grad, g_theirs, rtol=1e-4, atol=1e-4)


def test_canonical_rays_and_temperature():
    _close(tcg.canonical_pinhole_rays(12, 20, device="cpu"), jcg.canonical_pinhole_rays(12, 20),
           rtol=0, atol=0)
    for progress in (0.0, 0.3, 1.0):
        assert tcg.projection_temperature(progress) == pytest.approx(
            jcg.projection_temperature(progress), rel=1e-12)
