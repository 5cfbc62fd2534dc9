"""The port's PackNet pieces against the JAX package on the same
numpy-seeded inputs and weights, float32 on the CPU: packing, the nearest
resize, the folded 3D conv, the fused pack conv (fused == two-step == JAX,
borders included), the layer blocks, and the PackNet networks at 64x96 with
weights carried from JAX ``init`` through ``utils/convert.from_jax``.

Tolerances. Packing and the nearest resize move values: exact. A single
convolution or block: rtol 1e-4 / atol 1e-5 (XLA's and oneDNN's convolutions
sum in different orders). The fused pack conv sums (k+2)^2 * Cp products per
output where the two-step path sums 27 and then k^2 * d * Cp, so the two
agree to 2e-5 of the output's largest magnitude. Whole networks (some 60
convolutions and GroupNorms deep, sigmoid heads): rtol 1e-3 / atol 1e-4 on
inverse depths of order 1.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.nn import layers as jlayers
from packnet_sfm_tpu.nn import packnet as jpacknet
from packnet_sfm_tpu.ops import fold_conv as jfold
from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu.ops import packing as jpacking
from packnet_sfm_tpu_torch.nn import layers as tlayers
from packnet_sfm_tpu_torch.nn import packnet as tpacknet
from packnet_sfm_tpu_torch.ops import fold_conv as tfold
from packnet_sfm_tpu_torch.ops import image as timage
from packnet_sfm_tpu_torch.ops import packing as tpacking
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(ours, theirs, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=rtol, atol=atol)


def _w2(kernel):
    """flax [kh, kw, in, out] -> torch [out, in, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))


def _w3(kernel):
    """flax [kz, kh, kw, 1, d] -> torch [d, 1, kz, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (4, 3, 0, 1, 2))))


def test_packing_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 6, 8, 5)).astype(np.float32)
    packed = tpacking.space_to_depth(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacking.space_to_depth(x, 2)))
    assert tuple(packed.shape) == (2, 3, 4, 20)
    np.testing.assert_array_equal(tpacking.depth_to_space(packed, 2).numpy(), x)
    y = np.random.default_rng(1).normal(size=(2, 3, 4, 12)).astype(np.float32)
    np.testing.assert_array_equal(tpacking.depth_to_space(torch.from_numpy(y), 2).numpy(),
                                  np.asarray(jpacking.depth_to_space(y, 2)))


@pytest.mark.parametrize("shape", [(12, 16), (24, 32), (9, 13), (5, 7), (48, 64), (7, 32)])
def test_nearest_resize_matches_jax(shape):
    """x2 (the PackNet decoder), x4/x8 (upsample_depth_maps) and factors that
    are not integers, where F.interpolate's 'nearest' is another function."""
    x = np.random.default_rng(2).normal(size=(2, 6, 8, 3)).astype(np.float32)
    got = timage.interpolate_image(torch.from_numpy(x), shape, mode="nearest")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jimage.interpolate_image(x, shape, mode="nearest")))
    assert timage.interpolate_image(torch.from_numpy(x), (6, 8), mode="nearest").shape == x.shape
    with pytest.raises(ValueError):
        timage.interpolate_image(torch.from_numpy(x), shape, mode="cubic")


def test_flip_lr_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.flip_lr(torch.from_numpy(x)).numpy(),
                                  np.asarray(jimage.flip_lr(x)))


@pytest.mark.parametrize("cp,d", [(6, 4), (16, 8), (516, 2)], ids=["cp6", "cp16", "cp516"])
def test_channel_conv3d_matches_jax(cp, d):
    """Both JAX formulations (banded conv for Cp <= 512, shifted FMAs above)
    compute what the port's one Conv3d does."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 7, cp)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, 3, 1, d)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    got = tfold.channel_conv3d(torch.from_numpy(x), _w3(kernel), torch.from_numpy(bias))
    assert tuple(got.shape) == (2, 5, 7, d * cp)
    _close(got, jfold.channel_conv3d(x, kernel, bias))


def _pack_case(k, cp=8, d=4, cout=6, b=2, h=9, w=11, seed=5):
    rng = np.random.default_rng(seed + k)
    x = rng.normal(size=(b, h, w, cp)).astype(np.float32)
    w3 = (rng.normal(size=(3, 3, 3, 1, d)) * 0.3).astype(np.float32)
    b3 = rng.normal(size=(d,)).astype(np.float32)
    w2 = (rng.normal(size=(k, k, d * cp, cout)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(cout,)).astype(np.float32)
    return x, w3, b3, w2, b2


@pytest.mark.parametrize("k", [3, 5])
def test_fused_pack_conv_matches_two_step_and_jax(k):
    x, w3, b3, w2, b2 = _pack_case(k)
    want = np.asarray(jfold.pack_conv_two_step(x, w3, b3, w2, b2))
    want_fused = np.asarray(jfold.fused_pack_conv(x, w3, b3, w2, b2, mode="fused"))
    args = (torch.from_numpy(x), _w3(w3), torch.from_numpy(b3), _w2(w2), torch.from_numpy(b2))
    two = tfold.pack_conv_two_step(*args)
    fused = tfold.fused_pack_conv(*args, mode="fused")
    tol = 2e-5 * np.abs(want).max()
    _close(two, want, rtol=1e-4, atol=tol)
    # every pixel, the border rings and corners included
    _close(fused, want, rtol=0, atol=tol)
    _close(fused, want_fused, rtol=0, atol=tol)
    m = k // 2
    assert np.abs(fused.numpy() - want)[:, m:-m, m:-m].max() <= tol
    assert torch.equal(tfold.fused_pack_conv(*args, mode="two_step"), two)
    with pytest.raises(ValueError):
        tfold.fused_pack_conv(*args, mode="merged")


def test_fused_pack_conv_auto_rule_and_small_images():
    """'auto' takes the two-step path below 2048 positions, as the JAX
    package does, and an image too small for disjoint borders always does."""
    assert tfold._FUSE_MIN_POSITIONS == jfold._FUSE_MIN_POSITIONS == 2048
    x, w3, b3, w2, b2 = _pack_case(3)
    args = (torch.from_numpy(x), _w3(w3), torch.from_numpy(b3), _w2(w2), torch.from_numpy(b2))
    assert torch.equal(tfold.fused_pack_conv(*args, mode="auto"),
                       tfold.pack_conv_two_step(*args))          # 2*9*11 < 2048
    xb = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 24, 30, 8)).astype(np.float32))
    big = (xb,) + args[1:]
    assert torch.equal(tfold.fused_pack_conv(*big, mode="auto"),
                       tfold.fused_pack_conv(*big, mode="fused"))  # 3*24*30 >= 2048
    assert not torch.equal(tfold.fused_pack_conv(*big, mode="auto"),
                           tfold.pack_conv_two_step(*big))
    tiny = (args[0][:, :3, :3],) + args[1:]
    assert torch.equal(tfold.fused_pack_conv(*tiny, mode="fused"),
                       tfold.pack_conv_two_step(*tiny))


@pytest.mark.parametrize("k", [3, 5])
def test_fused_pack_conv_gradients_match_two_step(k):
    """Autograd sees the border slice updates: the gradients to the input
    and to all four weights equal the two-step path's, and the JAX fused
    path's."""
    x, w3, b3, w2, b2 = _pack_case(k, seed=9)
    cot = np.random.default_rng(7).normal(size=(2, 9, 11, 6)).astype(np.float32)

    def grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_(), _w3(w3).requires_grad_(),
                  torch.from_numpy(b3).requires_grad_(), _w2(w2).requires_grad_(),
                  torch.from_numpy(b2).requires_grad_()]
        (fn(*leaves) * torch.from_numpy(cot)).sum().backward()
        return [leaf.grad for leaf in leaves]

    two = grads(tfold.pack_conv_two_step)
    fused = grads(partial(tfold.fused_pack_conv, mode="fused"))
    # one XLA program: eagerly, every op of the transpose would compile on its own
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfold.fused_pack_conv(*a, mode="fused") * cot),
                              argnums=(0, 1, 2, 3, 4)))(x, w3, b3, w2, b2)
    theirs = [jgrads[0], np.transpose(jgrads[1], (4, 3, 0, 1, 2)), jgrads[2],
              np.transpose(jgrads[3], (3, 2, 0, 1)), jgrads[4]]
    for f, t, j in zip(fused, two, theirs):
        tol = 5e-5 * t.abs().max().item()
        _close(f, t.numpy(), rtol=1e-4, atol=tol)
        _close(f, j, rtol=1e-4, atol=tol)


def _init(net, *args, **kw):
    return _np(jax.jit(partial(net.init, **kw))(jax.random.PRNGKey(0), *args))


def test_conv2d_block_matches_jax():
    x = np.random.default_rng(8).normal(size=(2, 9, 12, 5)).astype(np.float32)
    for k, stride in ((3, 1), (5, 2), (7, 1)):
        net = jlayers.Conv2dBlock(32, k, stride)
        variables = _init(net, x)
        port = tlayers.Conv2dBlock(5, 32, k, stride)
        port.load_state_dict(from_jax(variables["params"]), strict=True)
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _close(got, net.apply(variables, x))


def test_residual_block_matches_jax():
    x = np.random.default_rng(9).normal(size=(2, 8, 12, 16)).astype(np.float32)
    net = jlayers.ResidualBlock(32, 3, 2)
    variables = _init(net, x, train=True)
    port = tlayers.ResidualBlock(16, 32, 3, 2)
    port.load_state_dict(from_jax(variables["params"]), strict=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 4, 6, 32)
    _close(got, net.apply(variables, x, train=True))
    # dropout builds, is the identity in eval, and refuses a training
    # forward (JAX's model_loss gives flax no dropout generator)
    dropped = tlayers.ResidualBlock(16, 32, 3, 2, dropout=0.5)
    dropped.load_state_dict(port.state_dict(), strict=True)
    _close(dropped.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
           net.apply(variables, x, train=True))
    with pytest.raises(RuntimeError, match="dropout"):
        dropped.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    tlayers.ResidualBlock(16, 32, 1, 1, dropout=0.0)


def test_inv_depth_head_matches_jax():
    x = np.random.default_rng(10).normal(size=(2, 6, 7, 16)).astype(np.float32)
    net = jlayers.InvDepthHead(1, min_depth=0.5)
    variables = _init(net, x)
    port = tlayers.InvDepthHead(16, 1, min_depth=0.5)
    port.load_state_dict(from_jax(variables["params"]), strict=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, net.apply(variables, x))
    assert got.max().item() < 2.0


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_pack_and_unpack_layers_match_jax(fuse):
    """The pack layer holds the same parameters fused or not (its fused
    block keeps the tree Conv_0 + Conv2dBlock_0/Conv_0), and from_jax carries
    the 5-D kernel of the 3D conv."""
    x = np.random.default_rng(11).normal(size=(2, 12, 16, 16)).astype(np.float32)
    net = jpacknet.PackLayerConv3d(16, 3, d=4, fuse=fuse, mode="fused")
    variables = _init(net, x)
    assert variables["params"]["Conv_0"]["kernel"].shape == (3, 3, 3, 1, 4)
    state = from_jax(variables["params"])
    assert tuple(state["conv.weight"].shape) == (4, 1, 3, 3, 3)
    port = tpacknet.PackLayerConv3d(16, 3, d=4, fuse=fuse, mode="fused")
    port.load_state_dict(state, strict=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 6, 8, 16)
    _close(got, net.apply(variables, x), rtol=1e-4, atol=1e-4)

    unet = jpacknet.UnpackLayerConv3d(16, 3, d=4)
    uvars = _init(unet, x)
    uport = tpacknet.UnpackLayerConv3d(16, 16, 3, d=4)
    uport.load_state_dict(from_jax(uvars["params"]), strict=True)
    ugot = uport(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(ugot.shape) == (2, 24, 32, 16)
    _close(ugot, unet.apply(uvars, x))


def test_from_jax_refuses_a_kernel_it_has_no_rule_for():
    with pytest.raises(ValueError, match="3-D kernel"):
        from_jax({"Conv_0": {"kernel": np.zeros((3, 4, 5), np.float32)}})


class _JaxNarrowB(jpacknet.PackNetBase):
    """A narrow plan that version B admits (ni == n1 == n2, each later width
    twice the one before); PackNetSlim01's own plan does not, in either
    package (its unpack2 has 64 channels, its skip 32)."""

    ni: int = 16
    channels: tuple = (16, 16, 32, 64, 128)
    num_3d_feat: int = 4


class _PortNarrowB(tpacknet.PackNetBase):
    ni = 16
    channels = (16, 16, 32, 64, 128)
    num_3d_feat = 4


NETS = {
    "slim-A": (lambda: jpacknet.PackNetSlim01(version="A"),
               lambda: tpacknet.PackNetSlim01(version="A"), 2),
    "narrow-B": (lambda: _JaxNarrowB(version="B"), lambda: _PortNarrowB(version="B"), 2),
    "packnet01-1A": (lambda: jpacknet.PackNet01(version="A"),
                     lambda: tpacknet.PackNet01(version="A"), 1),
}


@pytest.mark.parametrize("name", list(NETS))
def test_packnet_forward_matches_jax(name):
    make_jax, make_port, batch = NETS[name]
    x = np.random.default_rng(12).uniform(size=(batch, 64, 96, 3)).astype(np.float32)
    net = make_jax()
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(0), x)
    theirs = jax.jit(partial(net.apply, train=True))(variables, x)
    port = make_port()
    port.load_state_dict(from_jax(_np(variables["params"])), strict=True)
    del variables
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    assert [tuple(o.shape) for o in ours] == [(batch, 64 >> i, 96 >> i, 1) for i in range(4)]
    for o, t in zip(ours, theirs):
        _close(o, t, rtol=1e-3, atol=1e-4)


def test_packnet_slim_version_b_is_refused_by_both_packages():
    x = np.zeros((1, 64, 96, 3), np.float32)
    with pytest.raises(Exception):
        jax.eval_shape(lambda: jpacknet.PackNetSlim01(version="B").init(
            jax.random.PRNGKey(0), x))
    with pytest.raises(RuntimeError):
        tpacknet.PackNetSlim01(version="B")(torch.from_numpy(x))
    with pytest.raises(ValueError):
        tpacknet.PackNetSlim01(version="C")


def test_remat_equals_no_remat_in_value_and_gradient():
    x = torch.from_numpy(np.random.default_rng(13).uniform(size=(1, 64, 96, 3)).astype(np.float32))
    plain = _PortNarrowB(version="B")
    plain.init_weights(torch.Generator().manual_seed(0))
    remat = _PortNarrowB(version="B", remat=True)
    remat.load_state_dict(plain.state_dict())
    outs = []
    for net in (plain, remat):
        out = net(x)
        sum((o * o).mean() for o in out).backward()
        outs.append(out)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for (ka, pa), (_, pb) in zip(plain.named_parameters(), remat.named_parameters()):
        assert pa.grad is not None and torch.equal(pa.grad, pb.grad), ka


def test_port_init_is_xavier_uniform_from_the_generator():
    a, b = tpacknet.PackNetSlim01(), tpacknet.PackNetSlim01()
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    w = a.pack1.conv.weight                      # [4, 1, 3, 3, 3]: fan_in 27, fan_out 108
    bound = (6.0 / (27 + 108)) ** 0.5
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.8 * bound
    assert all(torch.count_nonzero(m.bias) == 0 for m in a.modules()
               if isinstance(m, torch.nn.Conv2d))
