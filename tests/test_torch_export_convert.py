"""Reference checkpoints into the port, and the depth forward out of it.

- The converters of ``utils/torch_import.py`` on reference-named state
  dicts that the tests build themselves (each port network's tensors under
  the PyTorch reference's names, seeded values): the port's result must
  equal the JAX package's converter followed by ``utils/convert.from_jax``
  bit for bit, and give back the tensors it was built from.
- ``cli/convert_checkpoint.py`` on a reference-format ``.ckpt`` written here
  (and a legacy ``.pth.tar``): the converted checkpoint's inverse depth
  equals the original model's, and ``cli.eval`` evaluates it; the ImageNet
  artifact equals the JAX CLI's, array for array.
- ``cli/export.py``: a round trip of PackNetSlim01 at 64x96, float32 and
  ``--half``, loaded in a process that imports only ``torch``, against
  infer's forward of the same checkpoint (``TOL_EXPORT``).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from packnet_sfm_tpu.utils import torch_import as jti
from packnet_sfm_tpu_torch.cli import convert_checkpoint as convert_cli
from packnet_sfm_tpu_torch.cli import export as export_cli
from packnet_sfm_tpu_torch.cli.infer import make_depth_fn
from packnet_sfm_tpu_torch.core.config import ConfigNode, get_default_config
from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.nn.depth_resnet import DepthResNet
from packnet_sfm_tpu_torch.nn.pose_resnet import PoseResNet
from packnet_sfm_tpu_torch.nn.posenet import PoseNet
from packnet_sfm_tpu_torch.utils import torch_import as ti
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

H, W = 64, 96
# The exported graph against infer's forward, relative to the largest
# inverse depth: the same ATen operators, but the loading process runs them
# with its own thread count, which may split the convolutions' sums
# otherwise (measured 0.0 in bfloat16, 6.1e-7 in float32).
TOL_EXPORT = {False: 1e-5, True: 1e-5}


# --- the reference's names for each port network's tensors --------------------------
#
# ``utils/torch_import.reference_name`` is the converters' inverse; the JAX
# package's converters, which read the reference's names, check it
# independently (a name they do not know raises KeyError there).

def _naming(net):
    return lambda key: ti.reference_name(net, key)


def _reference_sd(net: torch.nn.Module, seed: int):
    """The network's tensors under the reference's names, seeded values."""
    rng = np.random.default_rng(seed)
    own = net.state_dict()
    name = _naming(net)
    return ({name(k): rng.standard_normal(v.shape).astype(np.float32) for k, v in own.items()},
            {k: name(k) for k in own})


def _packnet():
    from packnet_sfm_tpu_torch.core.config import OVERFIT_PACKNET_SYNTHETIC, config_from_dict
    return setup_model(config_from_dict(OVERFIT_PACKNET_SYNTHETIC).model, device="cpu").depth_net


NETWORKS = {
    # name: (builder, port converter, JAX converter -> (params, stats))
    "packnet_slim": (_packnet, ti.packnet_from_torch,
                     lambda sd: (jti.packnet_from_torch(sd), None)),
    "posenet": (lambda: PoseNet(), ti.posenet_from_torch,
                lambda sd: (jti.posenet_from_torch(sd), None)),
    "depth_resnet18": (lambda: DepthResNet(version="18"), ti.depth_resnet_from_torch,
                       jti.depth_resnet_from_torch),
    "pose_resnet18": (lambda: PoseResNet(version="18"), ti.pose_resnet_from_torch,
                      jti.pose_resnet_from_torch),
}


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == torch.float32, k
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("name", list(NETWORKS))
def test_converters_equal_jax_then_from_jax(name):
    build, port_convert, jax_convert = NETWORKS[name]
    net = build()
    sd, names = _reference_sd(net, seed=len(name))
    ours = port_convert(sd)
    params, stats = jax_convert(sd)
    _assert_same(ours, from_jax(params, stats))
    # the round trip: the tensors it was built from, under the port's keys
    _assert_same(ours, {k: torch.from_numpy(sd[names[k]]) for k in net.state_dict()})
    net.load_state_dict(ours, strict=True)


def test_packnet_dropout_shortcut_names_and_legacy_names():
    net = _packnet()
    sd, _ = _reference_sd(net, seed=3)
    wrapped = {re.sub(r"^(conv\d\.\d+\.conv3)\.", r"\1.0.", k): v for k, v in sd.items()}
    assert wrapped != sd
    _assert_same(ti.packnet_from_torch(wrapped), ti.packnet_from_torch(sd))
    legacy = {"disp_network.conv2.0.conv3.0.weight": 1, "disp_network.conv2.0.conv3.0.bias": 2,
              "pose_network.conv1.0.weight": 3, "model.depth_net.x": 4}
    assert ti.legacy_state_dict(legacy) == jti.legacy_state_dict(legacy)
    assert set(ti.legacy_state_dict(legacy)) == {
        "model.depth_net.conv2.0.conv3.weight", "model.depth_net.conv2.0.conv3.bias",
        "model.pose_net.conv1.0.weight", "model.depth_net.x"}
    t = {"w": torch.ones(2)}
    copied = ti.state_dict_to_numpy(t)
    t["w"] += 1
    assert copied["w"].tolist() == [1.0, 1.0]


# --- cli.convert_checkpoint ---------------------------------------------------------

def _config(depth, version, pose):
    c = get_default_config()
    c.model.name = "SelfSupModel"
    c.model.depth_net.name, c.model.depth_net.version = depth, version
    c.model.pose_net.name = pose
    c.datasets.augmentation.image_shape = (H, W)
    return c


def _write_reference_ckpt(path, model, config, legacy=False):
    """A reference-format checkpoint of ``model``'s weights: torch.save of
    {config, epoch, state_dict} with 'model.depth_net.' / 'model.pose_net.'
    names (the legacy 'disp_network.' / 'pose_network.' names where asked)."""
    state = ti.reference_state_dict(model)
    if legacy:
        state = {k.replace("model.depth_net.", "disp_network.")
                 .replace("model.pose_net.", "pose_network."): v for k, v in state.items()}
    torch.save({"config": config, "epoch": 7, "state_dict": state}, path)


def _inv_depth(model, seed=0):
    rgb = torch.from_numpy(np.random.default_rng(seed).uniform(size=(1, H, W, 3)).astype(np.float32))
    return make_depth_fn(model)(rgb)


CONVERSIONS = {
    # name: ((depth net, version, pose net), with the config, legacy names)
    "packnet_slim_posenet": (("PackNetSlim01", "1A", "PoseNet"), True, False),
    "resnet18_poseresnet18": (("DepthResNet", "18", "PoseResNet"), True, False),
    "resnet18_sniffed_legacy": (("DepthResNet", "18", ""), False, True),
}


@pytest.mark.parametrize("case", list(CONVERSIONS))
def test_convert_checkpoint_keeps_the_inverse_depth(case, tmp_path):
    (depth, version, pose), with_config, legacy = CONVERSIONS[case]
    cfg = _config(depth, version, pose)
    model = setup_model(ConfigNode.from_dict(cfg.to_dict()).model, device="cpu", seed=5)
    src = str(tmp_path / ("ref.pth.tar" if legacy else "ref.ckpt"))
    ref_cfg = {"model": {"name": "SelfSupModel", "depth_net": {"name": depth, "version": version},
                         "pose_net": {"name": pose}}} if with_config else None
    _write_reference_ckpt(src, model, ref_cfg, legacy=legacy)
    path = convert_cli.convert(src, str(tmp_path / "converted"))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["epoch"] == 7
    assert (meta["config"]["model"]["depth_net"]["name"],
            meta["config"]["model"]["depth_net"]["version"]) == (depth, version)
    restored = setup_model(ConfigNode.from_dict(meta["config"]).model, device="cpu", seed=9)
    restore_checkpoint(path, restored)
    assert torch.equal(_inv_depth(restored), _inv_depth(model))
    if pose:
        assert all(torch.equal(a, b) for a, b in zip(restored.pose_net.state_dict().values(),
                                                     model.pose_net.state_dict().values()))


def test_a_converted_checkpoint_evaluates(tmp_path):
    from packnet_sfm_tpu_torch.cli.eval import evaluate

    cfg = _config("DepthResNet", "18", "PoseNet")
    model = setup_model(ConfigNode.from_dict(cfg.to_dict()).model, device="cpu")
    src = str(tmp_path / "ref.ckpt")
    _write_reference_ckpt(src, model, None)
    path = convert_cli.convert(src, str(tmp_path / "converted"))
    test_split = {"dataset": ["Synthetic"], "path": [""], "split": [""], "depth_type": [""],
                  "batch_size": 2, "num_workers": 1, "synthetic_length": 3,
                  "synthetic_height": H, "synthetic_width": W}
    # a dict config is filled in from the defaults before it is merged over
    # the checkpoint's, so it names the converted model's config too
    meta = json.load(open(os.path.join(path, "meta.json")))
    tables = evaluate(path, {"model": meta["config"]["model"],
                             "datasets": {"augmentation": {"image_shape": [H, W]},
                                          "test": test_split}}, device="cpu")
    assert len(tables) == 1 and all(np.isfinite(v).all() for v in tables[0].values())


def test_imagenet_artifact_equals_the_jax_clis(tmp_path):
    from packnet_sfm_tpu.cli.convert_checkpoint import convert_imagenet_encoder as jax_artifact
    from packnet_sfm_tpu_torch.engine.checkpoint import load_pretrained_encoder

    encoder = DepthResNet(version="18").encoder
    sd, names = _reference_sd(encoder, seed=11)
    src = str(tmp_path / "resnet18.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    convert_cli.convert_imagenet_encoder(src, ours)
    jax_artifact(src, theirs)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    model = setup_model(ConfigNode.from_dict(_config("DepthResNet", "18", "").to_dict()).model,
                        device="cpu")
    assert load_pretrained_encoder(ours, model, "depth_net") == len(sd)
    for k, v in model.depth_net.encoder.state_dict().items():
        assert torch.equal(v, torch.from_numpy(sd[names[k]])), k


# --- cli.export ---------------------------------------------------------------------

_LOADER = """
import sys, torch
fn = torch.export.load(sys.argv[1]).module()
out = fn(torch.load(sys.argv[2]))
torch.save(out, sys.argv[3])
print(sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k.startswith("packnet_sfm_tpu")))
"""


@pytest.fixture(scope="module")
def packnet_checkpoint(tmp_path_factory):
    from packnet_sfm_tpu_torch.core.config import OVERFIT_PACKNET_SYNTHETIC, config_from_dict

    root = tmp_path_factory.mktemp("export")
    cfg = config_from_dict(OVERFIT_PACKNET_SYNTHETIC)
    model = setup_model(cfg.model, device="cpu", seed=2)
    yield root, save_checkpoint(str(root / "ckpt"), model, cfg.to_dict(), epoch=0), cfg
    from tests.torch_cleanup import remove_tree
    remove_tree(root)


@pytest.mark.parametrize("half", [False, True], ids=["float32", "half"])
def test_export_round_trip_in_a_torch_only_process(packnet_checkpoint, half):
    root, ckpt, cfg = packnet_checkpoint
    out = root / f"depth_{int(half)}.pt2"
    size = export_cli.export_checkpoint(ckpt, str(out), image_shape=(H, W), half=half,
                                        device="cpu")
    assert size == out.stat().st_size
    rgb = torch.from_numpy(np.random.default_rng(1).uniform(size=(1, H, W, 3)).astype(np.float32))
    torch.save(rgb, root / "rgb.pt")
    proc = subprocess.run([sys.executable, "-c", _LOADER, str(out), str(root / "rgb.pt"),
                           str(root / "out.pt")], cwd=str(root), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    got = torch.load(root / "out.pt")
    model = setup_model(cfg.model, device="cpu", dtype=torch.bfloat16 if half else None)
    restore_checkpoint(ckpt, model)
    want = make_depth_fn(model)(rgb)
    assert got.dtype == torch.float32 and got.shape == (1, H, W, 1)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= TOL_EXPORT[half], err
    out.unlink()


def test_export_arguments():
    a = export_cli.parse_args(["--checkpoint", "c", "--output", "o.pt2", "--half",
                               "--image_shape", "32", "64", "--batch", "2"])
    assert (a.half, a.image_shape, a.batch, a.device) == (True, [32, 64], 2, "cuda")
    assert not hasattr(a, "platforms")
