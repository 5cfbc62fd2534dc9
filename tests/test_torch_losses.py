"""Port losses vs the JAX package on the same numpy inputs: SSIM, the
photometric map with its std clip, the (not halved) smoothness loss, and
the NRS ``generic_multiview_photometric_loss`` with its gradients.

Tolerance rtol 1e-5, the JAX suite's own loss parity bound
(docs/PARITY.md); the 1e-3 used before hid a factor-2 bug in smoothness.

Gradients of the generic loss, at the path's T ~ 1e-4: update cosine
>= 0.9999, and 99% of the entries within 1e-3 of the gradient's largest
magnitude. Not all of them: the two frameworks' projected coordinates
differ by ~1e-6 (f32 rounding), and where one lands on the other side of
an integer pixel position, bilinear sampling's coordinate gradient jumps;
the soft-argmax backward (x 1/T) then carries that jump into a small patch
of depth and ray gradients. Smooth images, as tests/test_lockstep.py uses,
keep those jumps small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.geometry.camera_generic import canonical_pinhole_rays as jax_rays
from packnet_sfm_tpu.losses import generic_photometric as jgp
from packnet_sfm_tpu.losses import photometric as jph
from packnet_sfm_tpu.losses.smoothness import smoothness_loss as jax_smoothness
from packnet_sfm_tpu.ops.ssim import ssim as jax_ssim
from packnet_sfm_tpu_torch.geometry.camera_generic import (
    canonical_pinhole_rays,
    projection_temperature,
)
from packnet_sfm_tpu_torch.losses import generic_photometric as tgp
from packnet_sfm_tpu_torch.losses import photometric as tph
from packnet_sfm_tpu_torch.losses.smoothness import smoothness_loss
from packnet_sfm_tpu_torch.ops.ssim import ssim

torch.set_num_threads(1)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth(rng, b, h, w):
    """Low-res noise, bilinear-upsampled x8 (NHWC)."""
    base = torch.from_numpy(rng.uniform(size=(b, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def _close(ours, theirs, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.uniform(size=(2, 20, 28, 3)).astype(np.float32) for _ in range(2)]


def test_ssim(images):
    x, y = images
    _close(ssim(_t(x), _t(y)), jax_ssim(jnp.asarray(x), jnp.asarray(y)), atol=1e-6)


@pytest.mark.parametrize("clip_loss,ssim_w", [(0.0, 0.85), (0.5, 0.85), (0.5, 0.0)],
                         ids=["noclip", "clip", "l1-clip"])
def test_photometric_map(images, clip_loss, ssim_w):
    x, y = images
    j_cfg = jph.MultiViewPhotometricConfig(clip_loss=clip_loss, ssim_loss_weight=ssim_w)
    t_cfg = tph.MultiViewPhotometricConfig(clip_loss=clip_loss, ssim_loss_weight=ssim_w)
    theirs = jph._photometric_map(jnp.asarray(x), jnp.asarray(y), j_cfg)
    ours = tph._photometric_map(_t(x), _t(y), t_cfg)
    _close(ours, theirs)
    if clip_loss:
        # the clip bites, and at mean + 0.5 * std with ddof 0
        assert float(ours.max()) < float(tph._photometric_map(
            _t(x), _t(y), tph.MultiViewPhotometricConfig(ssim_loss_weight=ssim_w)).max())


def test_smoothness_not_halved():
    rng = np.random.default_rng(1)
    invs = [rng.uniform(0.1, 1.0, size=(2, 20 // 2 ** i, 28 // 2 ** i, 1)).astype(np.float32)
            for i in range(3)]
    imgs = [rng.uniform(size=(2, 20 // 2 ** i, 28 // 2 ** i, 3)).astype(np.float32)
            for i in range(3)]
    theirs = jax_smoothness([jnp.asarray(a) for a in invs], [jnp.asarray(a) for a in imgs], 0.1)
    ours = smoothness_loss([_t(a) for a in invs], [_t(a) for a in imgs], 0.1)
    _close(ours, theirs)


@pytest.mark.parametrize("reduce,automask", [("mean", False), ("min", True)],
                         ids=["omnicam-mean", "min-automask"])
def test_generic_multiview_photometric_loss(reduce, automask):
    # patch 20 needs h/2 >= 41; the JAX loss always projects with patch 20.
    rng = np.random.default_rng(2)
    b, h, w = 1, 96, 96
    img = _smooth(rng, b, h, w)
    ctx = [_smooth(rng, b, h, w) for _ in range(2)]
    inv = (rng.uniform(size=(b, h, w, 1)) * 0.2 + 0.05).astype(np.float32)
    res = rng.normal(scale=0.05, size=(b, h, w, 3)).astype(np.float32)
    poses = []
    for tx in (-0.1, 0.1):
        T = np.eye(4, dtype=np.float32)[None].copy()
        T[0, 0, 3] = tx
        poses.append(T)
    progress = 0.3
    temperature = projection_temperature(progress)
    kw = dict(clip_loss=0.5, smooth_loss_weight=0.1, photometric_reduce_op=reduce,
              automask_loss=automask)

    def f_jax(d, r):
        return jgp.generic_multiview_photometric_loss(
            jnp.asarray(img), [jnp.asarray(c) for c in ctx], [d], r,
            jax_rays(h, w), [jnp.asarray(p) for p in poses],
            jgp.GenericPhotometricConfig(**kw), progress, temperature)

    (l_j, m_j), (gd_j, gr_j) = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1), has_aux=True))(
        jnp.asarray(inv), jnp.asarray(res))

    d, r = _t(inv).requires_grad_(), _t(res).requires_grad_()
    loss, metrics = tgp.generic_multiview_photometric_loss(
        _t(img), [_t(c) for c in ctx], [d], r, canonical_pinhole_rays(h, w),
        [_t(p) for p in poses], tgp.GenericPhotometricConfig(**kw), progress, temperature)
    loss.backward()
    _close(loss, l_j)
    for key in ("photometric_loss", "smoothness_loss"):
        _close(metrics[key], m_j[key])
    for ours, theirs in ((d.grad.numpy(), np.asarray(gd_j)), (r.grad.numpy(), np.asarray(gr_j))):
        cos = float((ours * theirs).sum() / np.linalg.norm(ours) / np.linalg.norm(theirs))
        assert cos >= 0.9999, cos
        err = np.abs(ours - theirs) / np.abs(theirs).max()
        assert np.quantile(err, 0.99) <= 1e-3, np.quantile(err, 0.99)


def test_blend_ray_surface_is_unit():
    res = _t(np.random.default_rng(3).normal(scale=0.1, size=(1, 8, 8, 3)).astype(np.float32))
    rays = tgp.blend_ray_surface(canonical_pinhole_rays(8, 8), res, 0.5)
    torch.testing.assert_close(torch.linalg.norm(rays, dim=-1), torch.ones(1, 8, 8))
