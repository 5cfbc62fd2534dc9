"""The port's bilinear warp (its plain version, which the CUDA kernels are
held to on the card) and pinhole camera against the JAX package, on the same
numpy-seeded inputs, float32 on the CPU.

Tolerances: both sides do the same float32 arithmetic on the same taps, in
the same order up to XLA's fusion, so values agree to rtol 1e-5 / atol 1e-6;
gradients are sums of a few such products (d coords over the channels,
d image over the pixels that hit a tap) and get rtol 1e-4 with an atol of
1e-5 of their largest magnitude, also where 4800 taps land on one pixel.
A bfloat16 image's gradient is JAX's float32 one of the widened image
rounded once: within one bfloat16 spacing of its largest magnitude. The
tangents: the image's is the warp of the tangent (rtol 1e-5), with the
coordinates' beside it a sum of tap differences (the gradients' bounds).
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
    assert twarp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0, "warp_jvp": 0,
                                  "warp_bwd_image": 0}


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


# --- the image's gradient and tangent ----------------------------------------------

def _image_inputs(c, seed=6, collapsed=False):
    """``_inputs``' coordinates (off every side, exact integers, the corners)
    at C channels; ``collapsed`` sends 1200 of the samples far past the
    bottom-right corner, where 'border' clamps all four of their taps onto
    that one pixel."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(B, H, W, c)).astype(np.float32)
    _, coords, _ = _inputs(seed)
    if collapsed:
        coords = (rng.uniform(-1, 1, size=(B, 40, 48, 2)) * 1.4).astype(np.float32)
        coords.reshape(-1, 2)[:1200] = [3.0, 2.5]
    grad = rng.normal(size=coords.shape[:3] + (c,)).astype(np.float32)
    return image, coords, grad


def _jax_image_grad(image, coords, grad, padding_mode):
    return jax.jit(jax.grad(
        lambda im: jnp.sum(jwarp.grid_sample(im, coords, padding_mode) * grad)))(image)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("c,collapsed", [(1, False), (3, False), (4, False), (3, True)])
def test_image_gradient_matches_jax(padding_mode, c, collapsed):
    """d image (the transposed warp) against ``jax.grad`` of JAX's float32
    ``grid_sample``, C = 1, 3 and 4, and with 1200 samples collapsed onto
    one pixel (4800 taps on it under 'border')."""
    image, coords, grad = _image_inputs(c, collapsed=collapsed)
    want = _jax_image_grad(image, coords, grad, padding_mode)
    im = torch.from_numpy(image).requires_grad_()
    (twarp.grid_sample(im, torch.from_numpy(coords), padding_mode)
     * torch.from_numpy(grad)).sum().backward()
    _grad_close(im.grad, want)
    if collapsed and padding_mode == "border":
        # the corner pixel of the first image takes the collapsed samples' taps
        assert abs(float(want[0, -1, -1].sum())) > 0
        np.testing.assert_allclose(im.grad[0, -1, -1].numpy(), np.asarray(want[0, -1, -1]),
                                   rtol=1e-5)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bf16_image_gradient_is_jax_float32_gradient_rounded(padding_mode):
    """A bfloat16 image's d image: JAX's float32 gradient of the exactly
    widened image, within one bfloat16 spacing of its largest magnitude,
    in the image's dtype."""
    image, coords, grad = _image_inputs(3, seed=8, collapsed=True)
    image = np.array(jnp.asarray(image, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(_jax_image_grad(image, coords, grad, padding_mode))
    im = torch.from_numpy(image).bfloat16().requires_grad_()
    (twarp.grid_sample(im, torch.from_numpy(coords), padding_mode)
     * torch.from_numpy(grad)).sum().backward()
    assert im.grad.dtype == torch.bfloat16
    largest = np.abs(want).max()
    spacing = 2.0 ** (np.floor(np.log2(largest)) - 7)
    assert np.abs(im.grad.float().numpy() - want).max() <= spacing


def test_jax_bf16_zeros_warp_gives_the_image_no_derivative_and_the_port_does():
    """JAX fault (w): its bfloat16 'zeros' warp gathers through a bitcast
    that no derivative crosses, so the image's gradient and tangent are 0
    with no error ('border' is right). The port gives the float32 ones."""
    image, coords, grad = _image_inputs(3, seed=9)
    im16 = jnp.asarray(image, jnp.bfloat16)
    widened = np.array(im16.astype(jnp.float32))
    tangent = np.random.default_rng(10).normal(size=image.shape).astype(np.float32)

    def jgrad(im, pad):
        return jax.grad(lambda i: jnp.sum(jwarp.grid_sample(i, coords, pad).astype(jnp.float32)
                                          * grad))(im)

    def jtangent(im, t, pad):
        return jax.jvp(lambda i: jwarp.grid_sample(i, coords, pad), (im,), (t,))[1]

    t16 = jnp.asarray(tangent, jnp.bfloat16)
    assert not np.any(np.asarray(jgrad(im16, "zeros"), np.float32))
    assert not np.any(np.asarray(jtangent(im16, t16, "zeros"), np.float32))
    assert np.any(np.asarray(jgrad(im16, "border"), np.float32))
    want_grad = np.asarray(jgrad(widened, "zeros"))
    want_t = np.asarray(jtangent(widened, np.asarray(t16.astype(jnp.float32)), "zeros"))
    assert np.abs(want_grad).max() > 0.1 and np.abs(want_t).max() > 0.1

    im = torch.from_numpy(widened).bfloat16().requires_grad_()
    co = torch.from_numpy(coords)
    (twarp.grid_sample(im, co) * torch.from_numpy(grad)).sum().backward()
    got_t = torch.func.jvp(lambda i: twarp.grid_sample(i, co), (im.detach(),),
                           (torch.from_numpy(tangent).bfloat16(),))[1]
    assert np.abs(im.grad.float().numpy() - want_grad).max() <= \
        2.0 ** (np.floor(np.log2(np.abs(want_grad).max())) - 7)
    _grad_close(got_t, want_t)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_tangents_match_jax_jvp(padding_mode):
    """The warp's tangent against ``jax.jvp`` of JAX's float32 warp: along
    the image (the warp of the tangent), along image and coordinates
    together, and along the coordinates of a bfloat16 image (the float32
    image's tangent: its taps widen exactly)."""
    image, coords, _ = _image_inputs(3, seed=11)
    rng = np.random.default_rng(12)
    image_t = rng.normal(size=image.shape).astype(np.float32)
    coords_t = rng.normal(size=coords.shape).astype(np.float32)
    im, co = torch.from_numpy(image), torch.from_numpy(coords)
    im_t, co_t = torch.from_numpy(image_t), torch.from_numpy(coords_t)

    want = jax.jvp(lambda i: jwarp.grid_sample(i, coords, padding_mode), (image,), (image_t,))[1]
    got = torch.func.jvp(lambda i: twarp.grid_sample(i, co, padding_mode), (im,), (im_t,))[1]
    _close(got, want)
    want = jax.jvp(lambda i, c: jwarp.grid_sample(i, c, padding_mode), (image, coords),
                   (image_t, coords_t))[1]
    got = torch.func.jvp(lambda i, c: twarp.grid_sample(i, c, padding_mode), (im, co),
                         (im_t, co_t))[1]
    _grad_close(got, want)

    widened = np.array(jnp.asarray(image, jnp.bfloat16).astype(jnp.float32))
    want = jax.jvp(lambda c: jwarp.grid_sample(widened, c, padding_mode), (coords,),
                   (coords_t,))[1]
    got = torch.func.jvp(lambda c: twarp.grid_sample(im.bfloat16(), c, padding_mode), (co,),
                         (co_t,))[1]
    assert got.dtype == torch.float32
    _grad_close(got, want)


class _FakeWarpLib:
    """The launchers of ``csrc/warp.cu`` as a record of the calls, for the
    wrappers' routing on the CPU: each returns 0 and writes nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 0
        return launch


@pytest.fixture
def fake_warp_lib(monkeypatch):
    import contextlib

    from packnet_sfm_tpu_torch.ops import _cuda

    lib = _FakeWarpLib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    monkeypatch.setattr(_cuda, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    twarp.reset_launch_counts()
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_image_gradient_routes_to_warp_bwd_image(fake_warp_lib, dtype):
    """``_WarpCuda``'s backward with the launchers recorded: an image that
    requires a gradient reaches ``warp_bwd_image`` (``_bf16`` for a
    bfloat16 image, whose d image comes back bfloat16) after the count pass,
    d coords ``warp_bwd`` only where the coordinates require one."""
    image, coords, grad = (torch.from_numpy(a) for a in _inputs(13))
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    im = image.to(dtype).requires_grad_()
    for co, want in ((coords.clone().requires_grad_(),
                      ["warp_bwd", "warp_bwd_image_count", "warp_bwd_image"]),
                     (coords, ["warp_bwd_image_count", "warp_bwd_image"])):
        fake_warp_lib.calls.clear()
        im.grad = None
        out = twarp._WarpCuda.apply(im, co, "border")
        (out * grad).sum().backward()
        assert fake_warp_lib.calls == ["warp_fwd" + suffix] + [
            n if n.endswith("count") else n + suffix for n in want]
        assert im.grad.dtype == dtype and im.grad.shape == im.shape
        assert (co.grad is not None) == co.requires_grad
    counts = twarp.bf16_launch_counts if suffix else twarp.launch_counts
    assert counts["warp_bwd_image" + suffix] == 2 and counts["warp_fwd" + suffix] == 2


def test_the_image_tangent_routes_to_warp_fwd(fake_warp_lib):
    """``_WarpCuda``'s forward-mode rule with the launchers recorded: an
    image tangent is ``warp_fwd`` of it; with a coordinate tangent beside
    it ``warp_jvp`` is added; a bfloat16 image's coordinate tangent is
    ``warp_jvp`` (of the widened image)."""
    image, coords, _ = (torch.from_numpy(a) for a in _inputs(14))
    for im, tangents, want in (
            (image, (torch.ones_like(image),), ["warp_fwd", "warp_fwd"]),
            (image, (torch.ones_like(image), torch.ones_like(coords)),
             ["warp_fwd", "warp_fwd", "warp_jvp"]),
            (image.bfloat16(), (None, torch.ones_like(coords)), ["warp_fwd_bf16", "warp_jvp"]),
            (image.bfloat16(), (torch.ones_like(image).bfloat16(),),
             ["warp_fwd_bf16", "warp_fwd_bf16"])):
        fake_warp_lib.calls.clear()
        if len(tangents) == 1:
            torch.func.jvp(lambda i: twarp._WarpCuda.apply(i, coords, "zeros"), (im,), tangents)
        elif tangents[0] is None:
            torch.func.jvp(lambda c: twarp._WarpCuda.apply(im, c, "zeros"), (coords,),
                           tangents[1:])
        else:
            torch.func.jvp(lambda i, c: twarp._WarpCuda.apply(i, c, "zeros"), (im, coords),
                           tangents)
        assert fake_warp_lib.calls == want
