"""Port networks vs the JAX package on the same weights: RaySurfaceResNet-18
and DepthResNet-18 (train and eval mode, with the BatchNorm running-statistics
update) and PoseNet at 64x64, weights carried from JAX ``init`` through
``utils/convert.from_jax``; DepthResNet at 32x64 too, where the deepest
feature is one pixel tall.

Tolerance: rtol 1e-4 / atol 1e-5. Both sides compute in float32 on the CPU,
but XLA's and oneDNN's convolutions sum in different orders, and the
rounding grows through the 18-layer encoder and two BatchNorm'd decoders.

Group norm at adversarial means (1e3-3e4, std 1 and 0.1), against a float64
two-pass oracle on the same float32 input, as tests/test_layers.py holds
JAX's: on a contiguous NCHW input the port's error is within 3x JAX's
(measured at most 2.4x, at mean 1e4 and std 0.1: 2.2e-2 against 9.1e-3).
PyTorch's CPU kernel for a channels-last input sums E[x²] - E[x]² in one
pass and is off by ~1e3 there, so the port's group norm hands the CPU a
contiguous tensor: a channels-last input (what a convolution of a permuted
NHWC image returns) is held to the same bound (ROADMAP.md §3 (c)).
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.nn.depth_resnet import DepthResNet as JaxDepthResNet
from packnet_sfm_tpu.nn.layers import FastGroupNorm as JaxGroupNorm
from packnet_sfm_tpu.nn.posenet import PoseNet as JaxPoseNet
from packnet_sfm_tpu.nn.raysurface import RaySurfaceResNet as JaxRaySurfaceResNet
from packnet_sfm_tpu_torch.nn.depth_resnet import DepthResNet
from packnet_sfm_tpu_torch.nn.layers import FastGroupNorm
from packnet_sfm_tpu_torch.nn.posenet import PoseNet
from packnet_sfm_tpu_torch.nn.raysurface import RaySurfaceResNet
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
B, H, W = 2, 64, 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(ours, theirs, **kw):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL))


@pytest.fixture(scope="module")
def raysurface():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    net = JaxRaySurfaceResNet(version="18")
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(0), x)
    port = RaySurfaceResNet("18")
    port.load_state_dict(from_jax(_np(variables["params"]),
                                  _np(variables["batch_stats"])), strict=True)
    return x, net, variables, port


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_raysurface_resnet_matches_jax(raysurface, train):
    x, net, variables, port = raysurface
    port = port if not train else _fresh_copy(port)
    port.train(train)
    if train:
        theirs, updates = jax.jit(partial(net.apply, train=True, mutable=["batch_stats"]))(
            variables, x)
    else:
        theirs = jax.jit(partial(net.apply, train=False))(variables, x)
    ours = port(torch.from_numpy(x))
    assert len(ours["inv_depths"]) == 4
    for o, t in zip(ours["inv_depths"], theirs["inv_depths"]):
        assert tuple(o.shape) == t.shape
        _close(o, t)
    _close(ours["ray_surface"], theirs["ray_surface"])
    if train:
        # flax moves the running variance towards the BIASED batch variance.
        want = from_jax({}, _np(updates["batch_stats"]))
        got = port.state_dict()
        for key, value in want.items():
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def _fresh_copy(port):
    fresh = RaySurfaceResNet("18")
    fresh.load_state_dict(port.state_dict())
    return fresh


def test_posenet_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    ctx = [rng.uniform(size=(B, H, W, 3)).astype(np.float32) for _ in range(2)]
    net = JaxPoseNet()
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(1), img, ctx)
    port = PoseNet()
    port.load_state_dict(from_jax(_np(variables["params"])), strict=True)
    theirs = jax.jit(partial(net.apply, train=True))(variables, img, ctx)
    ours = port(torch.from_numpy(img), [torch.from_numpy(c) for c in ctx])
    assert tuple(ours.shape) == (B, 2, 6)
    _close(ours, theirs)


def test_port_init_draws_from_generator():
    """setup's initializers are seeded by an explicit generator: same seed,
    same weights; and the conv shapes match the JAX tree (strict load)."""
    a, b = RaySurfaceResNet("18"), RaySurfaceResNet("18")
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka
    # the whole ResNet family builds (tests/test_torch_resnet_family.py holds
    # it to JAX); a depth that no ResNet has is refused
    assert RaySurfaceResNet("34").encoder.num_ch_enc == (64, 64, 128, 256, 512)
    with pytest.raises(ValueError, match="no ResNet-20"):
        RaySurfaceResNet("20")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("hw", [(64, 64), (32, 64)], ids=["64x64", "32x64"])
def test_depth_resnet_matches_jax(train, hw):
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(B,) + hw + (3,)).astype(np.float32)
    net = JaxDepthResNet(version="18pt")
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(2), x)
    port = DepthResNet("18pt")
    port.load_state_dict(from_jax(_np(variables["params"]), _np(variables["batch_stats"])),
                         strict=True)
    port.train(train)
    if train:
        theirs, updates = jax.jit(partial(net.apply, train=True, mutable=["batch_stats"]))(
            variables, x)
    else:
        theirs = jax.jit(partial(net.apply, train=False))(variables, x)
    ours = port(torch.from_numpy(x))
    assert len(ours) == len(theirs) == 4
    for o, t in zip(ours, theirs):
        assert tuple(o.shape) == t.shape
        _close(o, t)
    if train:
        got = port.state_dict()
        for key, value in from_jax({}, _np(updates["batch_stats"])).items():
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=key)


def _group_norm_oracle(x, g=16, eps=1e-5):
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, g, c // g).astype(np.float64)
    mean = xg.mean(axis=(1, 2, 4), keepdims=True)
    var = ((xg - mean) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    return ((xg - mean) / np.sqrt(var + eps)).reshape(b, h, w, c)


@pytest.mark.parametrize("mean,std", [(1e3, 1.0), (1e3, 0.1), (1e4, 1.0), (1e4, 0.1),
                                      (3e4, 1.0), (3e4, 0.1)])
def test_group_norm_at_large_means_within_jax_error(mean, std):
    x = np.random.default_rng(0).normal(mean, std, size=(2, 8, 12, 64)).astype(np.float32)
    want = _group_norm_oracle(x)
    variables = {"params": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}}
    theirs = np.asarray(JaxGroupNorm(num_groups=16).apply(variables, x), np.float64)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        ours = FastGroupNorm(64)(nchw).permute(0, 2, 3, 1).numpy().astype(np.float64)
    jax_err = np.abs(theirs - want).max()
    assert 0 < jax_err < 0.05
    assert np.abs(ours - want).max() <= 3 * jax_err


@pytest.mark.parametrize("mean,std", [(1e3, 1.0), (1e4, 1.0), (1e4, 0.1), (3e4, 0.1)])
def test_group_norm_of_a_channels_last_input_within_jax_error(mean, std):
    x = np.random.default_rng(0).normal(mean, std, size=(2, 8, 12, 64)).astype(np.float32)
    want = _group_norm_oracle(x)
    variables = {"params": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}}
    theirs = np.asarray(JaxGroupNorm(num_groups=16).apply(variables, x), np.float64)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)        # strided as a channels-last tensor
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ours = FastGroupNorm(64)(nchw).permute(0, 2, 3, 1).numpy().astype(np.float64)
    assert np.abs(ours - want).max() <= 3 * np.abs(theirs - want).max()
