"""The port's bilinear warp (its plain version, which the CUDA kernels are
held to on the card) and pinhole camera against the JAX package, on the same
numpy-seeded inputs, float32 on the CPU.

Tolerances: both sides do the same float32 arithmetic on the same taps, in
the same order up to XLA's fusion, so values agree to rtol 1e-5 / atol 1e-6;
gradients are sums of a few such products (d coords over the channels,
d image over the pixels that hit a tap) and get rtol 1e-4 with an atol of
1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.geometry import camera as jcam
from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu.ops import warp as jwarp
from packnet_sfm_tpu_torch.geometry import camera as tcam
from packnet_sfm_tpu_torch.ops import image as timage
from packnet_sfm_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)

B, H, W, C = 2, 12, 20, 3
HO, WO = 10, 16


def _close(ours, theirs, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=rtol, atol=atol)


def _grad_close(ours, theirs):
    theirs = np.asarray(theirs)
    _close(ours, theirs, rtol=1e-4, atol=1e-5 * np.abs(theirs).max())


def _inputs(seed=0, spread=1.4, special=True):
    """Image, coordinates that leave the image on every side (with exact
    integer positions, the corners and far-away points among them) and a
    cotangent."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    coords = (rng.uniform(-1, 1, size=(B, HO, WO, 2)) * spread).astype(np.float32)
    if special:
        coords[0, 0, :9] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0],
                            [2 * 3 / (W - 1) - 1, 2 * 2 / (H - 1) - 1],
                            [5, 5], [-5, 0], [0.5, -7]]
    grad = rng.normal(size=(B, HO, WO, C)).astype(np.float32)
    return image, coords, grad


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(padding_mode):
    image, coords, grad = _inputs()

    def loss(im, co):
        return jnp.sum(jwarp.grid_sample(im, co, padding_mode) * grad)

    want = jwarp.grid_sample(image, coords, padding_mode)
    want_di, want_dc = jax.grad(loss, argnums=(0, 1))(image, coords)

    im = torch.from_numpy(image).requires_grad_()
    co = torch.from_numpy(coords).requires_grad_()
    twarp.reset_launch_counts()
    got = twarp.grid_sample(im, co, padding_mode)
    (got * torch.from_numpy(grad)).sum().backward()
    assert tuple(got.shape) == (B, HO, WO, C)
    _close(got, want)
    _grad_close(co.grad, want_dc)
    _grad_close(im.grad, want_di)
    # on CPU tensors the entry point is the plain version
    assert torch.equal(got, twarp.grid_sample_plain(im, co, padding_mode))
    assert twarp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0, "warp_jvp": 0}


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_data_matches_jax(padding_mode):
    """The image is data: same forward, d coords as the JAX package's
    analytic backward, and no gradient reaches the image."""
    image, coords, grad = _inputs(seed=1)
    want = jwarp.grid_sample_data(image, coords, padding_mode)
    want_dc = jax.grad(lambda co: jnp.sum(
        jwarp.grid_sample_data(image, co, padding_mode) * grad))(coords)

    im = torch.from_numpy(image).requires_grad_()
    co = torch.from_numpy(coords).requires_grad_()
    got = twarp.grid_sample_data(im, co, padding_mode)
    (got * torch.from_numpy(grad)).sum().backward()
    _close(got, want)
    _grad_close(co.grad, want_dc)
    assert im.grad is None


def test_d_coords_come_back_in_the_coords_dtype():
    """The JAX package's analytic backward returns float32 d coords whatever
    the coords' dtype (ROADMAP.md section 3); the port returns the coords'
    own dtype (float64 agrees with float32 up to float32's rounding)."""
    # no exact integer positions here: floor there depends on the dtype
    image, coords, grad = _inputs(seed=2, spread=0.9, special=False)
    im = torch.from_numpy(image)
    co32 = torch.from_numpy(coords).requires_grad_()
    (twarp.grid_sample_data(im, co32) * torch.from_numpy(grad)).sum().backward()
    co64 = torch.from_numpy(coords).double().requires_grad_()
    (twarp.grid_sample_data(im.double(), co64) * torch.from_numpy(grad).double()).sum().backward()
    assert co64.grad.dtype == torch.float64
    np.testing.assert_allclose(co64.grad.float().numpy(), co32.grad.numpy(), rtol=1e-4,
                               atol=1e-4 * co32.grad.abs().max().item())
    co16 = torch.from_numpy(coords).bfloat16().requires_grad_()
    twarp.grid_sample_data(im, co16).sum().backward()
    assert co16.grad.dtype == torch.bfloat16
    assert co32.grad.dtype == torch.float32


@pytest.mark.parametrize("image_dtype,coords_dtype", [
    ("bfloat16", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
    ("float16", "float32"), ("float32", "float32")])
def test_result_dtype_is_the_promoted_dtype_as_in_jax(image_dtype, coords_dtype):
    """The result comes back in the dtype the image's and the coordinates'
    promote to, as the JAX function's does (the card path casts its float32
    result back to it; tests/test_torch_cuda.py pins that on the card)."""
    image, coords, _ = _inputs(seed=3, spread=0.9, special=False)
    want = jwarp.grid_sample(jnp.asarray(image, getattr(jnp, image_dtype)),
                             jnp.asarray(coords, getattr(jnp, coords_dtype))).dtype
    im = torch.from_numpy(image).to(getattr(torch, image_dtype))
    co = torch.from_numpy(coords).to(getattr(torch, coords_dtype))
    for fn in (twarp.grid_sample, twarp.grid_sample_plain, twarp.grid_sample_data):
        got = fn(im, co).dtype
        assert got == torch.promote_types(im.dtype, co.dtype)
        assert str(got).removeprefix("torch.") == str(want)


def test_warp_argument_checks():
    image, coords, _ = _inputs()
    im, co = torch.from_numpy(image), torch.from_numpy(coords)
    with pytest.raises(ValueError, match="padding_mode"):
        twarp.grid_sample(im, co, "reflection")
    with pytest.raises(ValueError, match="expected image"):
        twarp.grid_sample(im, co[..., :1])
    with pytest.raises(ValueError, match="expected image"):
        twarp.grid_sample(im[:1], co)


def _cameras(rng):
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(10, 14, B)
    K[:, 1, 1] = rng.uniform(10, 14, B)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2 - 0.5, H / 2 - 0.3, 1.0
    vec = (rng.normal(size=(B, 6)) * [0.3, 0.1, 0.2, 0.02, 0.03, 0.02]).astype(np.float32)
    from packnet_sfm_tpu.geometry.pose import pose_vec_to_mat
    return K, np.array(pose_vec_to_mat(vec))


def test_intrinsics_helpers_match_jax():
    K, _ = _cameras(np.random.default_rng(3))
    Kt = torch.from_numpy(K)
    _close(tcam.scale_intrinsics(Kt, 0.5), jcam.scale_intrinsics(K, 0.5))
    _close(tcam.scale_intrinsics(Kt, 0.25, 0.5), jcam.scale_intrinsics(K, 0.25, 0.5))
    _close(tcam.invert_intrinsics(Kt), jcam.invert_intrinsics(K))
    _close(tcam.invert_intrinsics(Kt) @ Kt, np.broadcast_to(np.eye(3, dtype=np.float32), K.shape))
    _close(timage.image_grid(H, W, device="cpu"), jimage.image_grid(H, W))
    _close(timage.image_grid(H, W, normalized=True, device="cpu"),
           jimage.image_grid(H, W, normalized=True))


def test_reconstruct_and_project_match_jax():
    rng = np.random.default_rng(4)
    K, T = _cameras(rng)
    depth = rng.uniform(2, 9, size=(B, H, W, 1)).astype(np.float32)
    Kt, Tt, dt = torch.from_numpy(K), torch.from_numpy(T), torch.from_numpy(depth)
    for jT, tT in ((None, None), (T, Tt)):
        pts_j = jcam.reconstruct(jcam.Camera(K=K, Tcw=jT), depth)
        pts_t = tcam.reconstruct(tcam.Camera(K=Kt, Tcw=tT), dt)
        _close(pts_t, pts_j, rtol=1e-5, atol=1e-5)
        # points behind the camera exercise the z clamp at 1e-5
        pts = np.asarray(pts_j).copy()
        pts[0, 0, :4, 2] = -1.0
        _close(tcam.project(tcam.Camera(K=Kt, Tcw=tT), torch.from_numpy(pts)),
               jcam.project(jcam.Camera(K=K, Tcw=jT), pts), rtol=1e-4, atol=1e-4)
    # a camera reprojects its own reconstruction onto the pixel grid
    coords = tcam.project(tcam.Camera(K=Kt, Tcw=Tt),
                          tcam.reconstruct(tcam.Camera(K=Kt, Tcw=Tt), dt))
    xs = torch.linspace(-1, 1, W)[None, None, :].expand(B, H, W)
    np.testing.assert_allclose(coords[..., 0].numpy(), xs.numpy(), atol=1e-4)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_view_synthesis_matches_jax(padding_mode):
    """Value, and the gradient to the depth and the pose through the warp's
    d coords."""
    rng = np.random.default_rng(5)
    K, T = _cameras(rng)
    ref = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    depth = rng.uniform(2, 9, size=(B, H, W, 1)).astype(np.float32)
    grad = rng.normal(size=(B, H, W, C)).astype(np.float32)

    def jloss(d, pose):
        out = jcam.view_synthesis(ref, d, jcam.Camera(K=K, Tcw=pose), jcam.Camera(K=K),
                                  padding_mode)
        return jnp.sum(out * grad), out

    (_, want), (want_dd, want_dp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        depth, T)
    d = torch.from_numpy(depth).requires_grad_()
    pose = torch.from_numpy(T).requires_grad_()
    Kt = torch.from_numpy(K)
    got = tcam.view_synthesis(torch.from_numpy(ref), d, tcam.Camera(K=Kt, Tcw=pose),
                              tcam.Camera(K=Kt), padding_mode)
    (got * torch.from_numpy(grad)).sum().backward()
    _close(got, want, rtol=1e-4, atol=1e-5)
    _grad_close(d.grad, want_dd)
    _grad_close(pose.grad, want_dp)
