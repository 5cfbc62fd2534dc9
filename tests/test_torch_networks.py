"""Port networks vs the JAX package on the same weights: RaySurfaceResNet-18
(train and eval mode, with the BatchNorm running-statistics update) and
PoseNet at 64x64, weights carried from JAX ``init`` through
``utils/convert.from_jax``.

Tolerance: rtol 1e-4 / atol 1e-5. Both sides compute in float32 on the CPU,
but XLA's and oneDNN's convolutions sum in different orders, and the
rounding grows through the 18-layer encoder and two BatchNorm'd decoders.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.nn.posenet import PoseNet as JaxPoseNet
from packnet_sfm_tpu.nn.raysurface import RaySurfaceResNet as JaxRaySurfaceResNet
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
    with pytest.raises(NotImplementedError):
        RaySurfaceResNet("34")
