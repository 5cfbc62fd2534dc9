"""The rest of the ResNet family in the port against the JAX package, on the
same weights (carried by ``utils/convert.from_jax``) and the same seeded
inputs, float32 on the CPU, 64x96, batch 2:

- ``ResNetEncoder`` at 34 (BasicBlock) and 50 (Bottleneck), train mode
  (with the BatchNorm running statistics it moves) and eval mode;
- DepthResNet-50, RaySurfaceResNet-34 and PoseResNet-18 and -50 (the
  two-image encoder, one call a context frame), train and eval;
- the ImageNet encoder graft (``engine/checkpoint.load_pretrained_encoder``)
  at 34 and 50, the two-image conv1 of PoseResNet included, against the JAX
  package's graft of the same artifact.

Tolerance, as a share of the largest magnitude of the JAX tensor (XLA's
and oneDNN's convolutions sum in different orders, and the rounding grows
through 34-50 layers): eval mode 1e-4 (measured at most 7.7e-6, DepthResNet
-50's coarsest scale); train mode 2e-3 (measured 7.1e-4, ResNet-50's
layer4): there BatchNorm normalizes layer4 by statistics of 2 x 2 x 3
values a channel, which amplifies the rounding of its input, while the same
weights in eval mode agree to 2.4e-6. The running statistics: the train
tolerance. The graft is exact: the same numbers land in the same places.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.engine.checkpoint import load_pretrained_encoder as jax_graft
from packnet_sfm_tpu.nn.depth_resnet import DepthResNet as JaxDepthResNet
from packnet_sfm_tpu.nn.pose_resnet import PoseResNet as JaxPoseResNet
from packnet_sfm_tpu.nn.raysurface import RaySurfaceResNet as JaxRaySurfaceResNet
from packnet_sfm_tpu.nn.resnet import ResNetEncoder as JaxResNetEncoder
from packnet_sfm_tpu.utils.torch_import import save_encoder_artifact
from packnet_sfm_tpu_torch.engine.checkpoint import load_pretrained_encoder
from packnet_sfm_tpu_torch.nn.depth_resnet import DepthResNet
from packnet_sfm_tpu_torch.nn.pose_resnet import PoseResNet
from packnet_sfm_tpu_torch.nn.raysurface import RaySurfaceResNet
from packnet_sfm_tpu_torch.nn.resnet import ResNetEncoder
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

TOL = {False: 1e-4, True: 2e-3}       # by train mode, of the largest magnitude
B, H, W = 2, 64, 96


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(ours, theirs, train, what=""):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=TOL[train] * np.abs(theirs).max(), err_msg=what)


def _image(seed, channels=3):
    return np.random.default_rng(seed).uniform(size=(B, H, W, channels)).astype(np.float32)


_INITS = {}


def _init(label, jnet, seed, args):
    """JAX's initial variables of ``jnet`` at ``args`` from ``PRNGKey(seed)``,
    drawn once a module under ``label`` (the network and its inputs): the
    train and eval cases, and the grafts, share the draw."""
    if (label, seed) not in _INITS:
        _INITS[label, seed] = jax.jit(partial(jnet.init, train=True))(
            jax.random.PRNGKey(seed), *args)
    return _INITS[label, seed]


def _run_both(label, jnet, port, args, train, call=None):
    """(JAX output, its batch_stats updates or None, the port's output) on
    the same inputs, the port loaded from JAX's init (and run through
    ``call`` where given)."""
    variables = _init(label, jnet, 0, args)
    port.load_state_dict(from_jax(_np(variables["params"]), _np(variables["batch_stats"])),
                         strict=True)
    port.train(train)
    if train:
        theirs, upd = jax.jit(partial(jnet.apply, train=True, mutable=["batch_stats"]))(
            variables, *args)
    else:
        theirs, upd = jax.jit(partial(jnet.apply, train=False))(variables, *args), None
    t_args = [[torch.from_numpy(a) for a in x] if isinstance(x, list) else torch.from_numpy(x)
              for x in args]
    return theirs, upd, (call or port)(*t_args)


def _check_stats(port, upd):
    """The running statistics that one training forward moved, as flax moves
    them (towards the biased batch variance)."""
    got = port.state_dict()
    for key, value in from_jax({}, _np(upd["batch_stats"])).items():
        _close(got[key], value.numpy(), True, key)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layers", [34, 50])
def test_resnet_encoder_matches_jax(layers, train):
    x = _image(layers)
    port = ResNetEncoder(layers)
    theirs, upd, ours = _run_both(f"encoder-{layers}", JaxResNetEncoder(num_layers=layers),
                                  port, [x], train, call=lambda t: port(t.permute(0, 3, 1, 2)))
    assert port.num_ch_enc == JaxResNetEncoder(num_layers=layers).num_ch_enc
    assert len(ours) == 5
    for i, (o, t) in enumerate(zip(ours, theirs)):
        # the port's features are NCHW, JAX's NHWC
        assert o.shape[1] == port.num_ch_enc[i]
        _close(o.permute(0, 2, 3, 1), t, train, f"feature {i}")
    if train:
        _check_stats(port, upd)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("net", ["DepthResNet-50", "RaySurfaceResNet-34"])
def test_depth_networks_match_jax(net, train):
    x = _image(3)
    name, version = net.split("-")
    if name == "DepthResNet":
        jnet, port = JaxDepthResNet(version=version + "pt"), DepthResNet(version)
    else:
        jnet, port = JaxRaySurfaceResNet(version=version), RaySurfaceResNet(version + "pt")
    theirs, upd, ours = _run_both(net, jnet, port, [x], train)
    if name == "RaySurfaceResNet":
        _close(ours["ray_surface"], theirs["ray_surface"], train, "ray_surface")
        ours, theirs = ours["inv_depths"], theirs["inv_depths"]
    assert len(ours) == 4
    for i, (o, t) in enumerate(zip(ours, theirs)):
        assert tuple(o.shape) == t.shape
        _close(o, t, train, f"scale {i}")
    if train:
        _check_stats(port, upd)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("version", ["18", "50"])
def test_pose_resnet_matches_jax(version, train):
    img, ctx = _image(5), [_image(6), _image(7)]
    port = PoseResNet(version)
    theirs, upd, ours = _run_both(f"PoseResNet-{version}", JaxPoseResNet(version=version), port,
                                  [img, ctx], train)
    assert tuple(ours.shape) == (B, 2, 6)
    assert port.encoder.conv1.weight.shape[1] == 6
    _close(ours, theirs, train)
    if train:
        # the shared encoder moved its statistics once a context frame
        _check_stats(port, upd)


@pytest.mark.parametrize("net,layers", [("DepthResNet", 34), ("DepthResNet", 50),
                                        ("PoseResNet", 34), ("PoseResNet", 50),
                                        ("RaySurfaceResNet", 50)])
def test_encoder_graft_matches_jax(tmp_path, net, layers):
    """An ImageNet encoder artifact (the JAX package's npz layout) grafted
    onto a '<N>pt' network: the same tensors as the JAX package's graft,
    PoseResNet's conv1 widened to two images."""
    # the encoder test's draw (a stand-in for ImageNet weights)
    enc_vars = _init(f"encoder-{layers}", JaxResNetEncoder(num_layers=layers), 0,
                     [_image(layers)])
    artifact = str(tmp_path / f"resnet{layers}.npz")
    save_encoder_artifact(artifact, _np(enc_vars["params"]), _np(enc_vars["batch_stats"]))

    n_images = 2 if net == "PoseResNet" else 1
    jnet, port = {
        "DepthResNet": (JaxDepthResNet(version=f"{layers}"), DepthResNet(f"{layers}pt")),
        "PoseResNet": (JaxPoseResNet(version=f"{layers}"), PoseResNet(f"{layers}")),
        "RaySurfaceResNet": (JaxRaySurfaceResNet(version=f"{layers}"),
                             RaySurfaceResNet(f"{layers}pt")),
    }[net]
    args = [_image(2), [_image(3)] * 2] if net == "PoseResNet" else [_image(2)]
    variables = _init(f"graft-{net}-{layers}", jnet, 1, args)
    grafted = jax_graft(artifact, {"params": {"depth_net": _np(variables["params"])},
                                   "batch_stats": {"depth_net": _np(variables["batch_stats"])}},
                        "depth_net", num_input_images=n_images)

    class Holder(torch.nn.Module):
        def __init__(self, depth_net):
            super().__init__()
            self.depth_net = depth_net

    model = Holder(port)
    model.depth_net.load_state_dict(from_jax(_np(variables["params"]),
                                             _np(variables["batch_stats"])), strict=True)
    count = load_pretrained_encoder(artifact, model, "depth_net", num_input_images=n_images)
    want = from_jax(_np(grafted["params"]), _np(grafted["batch_stats"]))
    got = model.state_dict()
    assert count == len([k for k in want if ".encoder." in k])
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    if n_images == 2:
        conv1 = got["depth_net.encoder.conv1.weight"]
        assert conv1.shape[1] == 6
        torch.testing.assert_close(conv1[:, :3], conv1[:, 3:], rtol=0, atol=0)
