"""The bfloat16 policy at the entry points, on the CPU: ``Trainer`` with
``arch.dtype: bfloat16``, ``cli.eval --half`` and ``cli.infer --half``, and
the two JAX faults the port does not copy.

- ``Trainer`` takes the KITTI and OMNICAM recipe dicts as written (their
  networks, ``arch.dtype: bfloat16``) with small Synthetic splits: the
  networks that take a dtype compute in bfloat16, the ResNet in float32,
  parameters stay float32, a train step gives a finite float32 loss; a
  checkpoint saved by the bfloat16 trainer evaluates, through
  ``cli.eval.evaluate``, to what the trainer's own ``test`` gives
  (the same computation: exactly).
- ``cli.eval.evaluate(half=True)`` against the JAX CLI's ``--half`` on the
  same weights (PackNetSlim01-1A at 64x96, 5 Synthetic samples in a batch
  of 8, the JAX mesh's size on the CPU, 3 of them pad): both build
  the model with the bfloat16 compute dtype. Continuous metrics rtol 1e-2
  (measured 1.8e-3; a1-a3 9.0e-4: the two round each layer's bfloat16 output apart where
  a sum lands near a boundary), a1-a3 within 4 / n_valid (a pixel on a
  threshold may flip).
- ``cli.infer --half`` builds the bfloat16 model, as eval's ``--half`` does,
  and its depth is the bfloat16 eval step's straight half: inverse depths
  within 3e-2 of the largest (measured 1.0e-2 here, 6.4e-3 on an H100 in
  chip_smoke.py: one image against the first half of the flip-fused batch
  of two, whose bfloat16 convolutions block and round the sums otherwise;
  the float32 pair agrees to 1e-5).
- Fault (i) (ROADMAP.md §3): the JAX CLI's ``--half`` builds a float32 model
  and only rounds the image to bfloat16, so it computes in float32: its
  depth is JAX's float32 forward of the rounded image (rtol 1e-6), and
  differs from the port's ``--half``, which computes in bfloat16, by more
  than 1e-4 of the largest inverse depth.
- Fault (h): JAX's train step casts every floating leaf of the batch to
  bfloat16, the intrinsics too (fx = fy = 721.5377 become 720, cx = 609.5593
  608; at 192x640 the scaled fx 371.81 and fy 369.43 become 372 and 370);
  the port's ``cast_batch`` keeps them float32, bit for bit, and casts the
  images.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from packnet_sfm_tpu.cli.eval import evaluate as jax_evaluate
from packnet_sfm_tpu.cli.infer import infer_and_save as jax_infer_and_save
from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import parse_train_config as jax_parse_train_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from packnet_sfm_tpu.engine.train import _cast_tree
from packnet_sfm_tpu.engine.trainer import Trainer as JaxTrainer
from packnet_sfm_tpu.models.sfm import model_forward as jax_model_forward
from packnet_sfm_tpu_torch.cli import eval as eval_cli
from packnet_sfm_tpu_torch.cli import infer as infer_cli
from packnet_sfm_tpu_torch.core.config import (
    KITTI,
    OMNICAM,
    ConfigNode,
    config_from_dict,
    parse_train_config,
)
from packnet_sfm_tpu_torch.datasets.augmentations import resize_image
from packnet_sfm_tpu_torch.datasets.kitti import load_image
from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.metrics import garg_crop_mask
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, cast_batch, eval_forward
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_cleanup import remove_tmp_path, remove_tree  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

H, W = 64, 96
EVAL_LENGTH = 5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _synthetic(cfg, h, w, length=2, batch=1):
    for mode in ("train", "validation", "test"):
        d = cfg.datasets[mode]
        d.dataset, d.path, d.split, d.depth_type = ["Synthetic"], [""], [""], [""]
        d.synthetic_length, d.synthetic_height, d.synthetic_width = length, h, w
        d.batch_size, d.num_workers = batch, 1
        if mode == "train":
            d.repeat = [1]
    cfg.datasets.augmentation.image_shape = (h, w)
    return cfg


# --- Trainer on the recipes as written -------------------------------------------

@pytest.mark.parametrize("recipe,hw", [("kitti", (32, 64)), ("omnicam", (96, 96))])
def test_trainer_takes_the_recipes_in_bf16(recipe, hw, tmp_path):
    cfg = config_from_dict(KITTI if recipe == "kitti" else OMNICAM)
    assert cfg.arch.dtype == "bfloat16"
    cfg = parse_train_config(_synthetic(cfg, *hw, length=1))
    trainer = Trainer(cfg, device="cpu")
    depth_net, pose_net = trainer.model.depth_net, trainer.model.pose_net
    assert pose_net.conv1.conv.compute_dtype == torch.bfloat16
    if recipe == "kitti":
        assert depth_net.dtype == torch.bfloat16
        assert depth_net.pack1.Conv2dBlock_0.norm.dtype == torch.bfloat16
    else:
        assert not hasattr(depth_net, "dtype")     # the ResNet takes none: float32
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    got = trainer.train_epoch(0)
    assert trainer.step == 1 and np.isfinite(got["loss"])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())

    want = trainer.test()
    path = save_checkpoint(str(tmp_path / "ckpt"), trainer.model, cfg.to_dict(), epoch=0)
    assert json.load(open(os.path.join(path, "meta.json")))["config"]["arch"]["dtype"] == \
        "bfloat16"
    table = eval_cli.evaluate(path, device="cpu")
    for mode, row in want[0].items():
        assert np.all(np.isfinite(row))
        np.testing.assert_array_equal(table[0][mode], row, err_msg=mode)


# --- eval and infer --half ---------------------------------------------------------

def _jax_config():
    c = jax_default_config()
    c.model.name = "SelfSupModel"
    c.model.depth_net.name = "PackNetSlim01"
    c.model.depth_net.version = "1A"
    c.model.pose_net.name = "PoseNet"
    c.model.params.crop = "garg"
    c = _synthetic(c, H, W, length=EVAL_LENGTH, batch=8)     # 8: the CPU mesh's size
    c.datasets.train.synthetic_length = 8                   # one whole train batch
    return jax_parse_train_config(c)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same weights in a JAX and a port checkpoint, and an 80x120 PNG."""
    root = tmp_path_factory.mktemp("half")
    c = _jax_config()
    jt = JaxTrainer(c)
    jt.init_state(next(iter(jt.train_loaders[0].epoch(0))))
    jax_path = jax_save_checkpoint(str(root / "jax_ckpt"), jt.state, c.to_dict(), epoch=0)
    jmodel = jax_factory.setup_model(c.model)
    variables = {"params": _np_tree(jt.state.params)}
    model = setup_model(ConfigNode.from_dict(c.to_dict()).model, device="cpu")
    model.load_state_dict(from_jax(variables["params"], variables.get("batch_stats")))
    port_path = save_checkpoint(str(root / "port_ckpt"), model, c.to_dict(), epoch=0)
    rng = np.random.default_rng(0)
    img = np.kron(rng.uniform(size=(10, 15, 3)), np.ones((8, 8, 1))) \
        + 0.1 * rng.uniform(size=(80, 120, 3))
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(root / "im.png")
    yield root, jax_path, port_path, jmodel, variables
    remove_tree(root)


def test_eval_half_matches_the_jax_cli(checkpoints):
    _, jax_path, port_path, _, _ = checkpoints
    want = jax_evaluate(jax_path, half=True)
    got = eval_cli.evaluate(port_path, half=True, device="cpu")
    # the fewest valid ground-truth pixels of a sample, under the Garg crop
    trainer = Trainer(parse_train_config(ConfigNode.from_dict(_jax_config().to_dict())),
                      device="cpu")
    gt = np.stack([trainer.test_datasets[0][i]["depth"] for i in range(EVAL_LENGTH)])
    valid = (gt[..., 0] > 0) & (gt[..., 0] < 80) & (garg_crop_mask(H, W).numpy() > 0)
    n_valid = int(valid.reshape(EVAL_LENGTH, -1).sum(axis=1).min())
    assert len(got) == len(want) == 1
    for mode in EVAL_MODES:
        g, w = np.asarray(got[0][mode]), np.asarray(want[0][mode])
        np.testing.assert_allclose(g[:4], w[:4], rtol=1e-2, err_msg=mode)
        np.testing.assert_allclose(g[4:], w[4:], rtol=0, atol=4.0 / n_valid, err_msg=mode)


def _port_half_inverse_depth(root, port_path, name):
    out = root / name
    infer_cli.infer_and_save(port_path, str(root / "im.png"), str(out), half=True,
                             save="npz", device="cpu")
    return 1.0 / np.load(out)["depth"]


def test_infer_half_is_the_bf16_eval_steps_straight_half(checkpoints):
    root, _, port_path, _, _ = checkpoints
    got = _port_half_inverse_depth(root, port_path, "port_half.npz")
    meta = json.load(open(os.path.join(port_path, "meta.json")))
    model = setup_model(ConfigNode.from_dict(meta["config"]).model, device="cpu",
                        dtype=torch.bfloat16)
    restore_checkpoint(port_path, model)
    rgb = resize_image(load_image(str(root / "im.png")), (H, W))
    want = eval_forward(model, torch.from_numpy(rgb[None]))[0, ..., 0].numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_jax_infer_half_computes_in_float32(checkpoints):
    """Fault (i): JAX's --half is its float32 forward of the rounded image."""
    root, jax_path, port_path, jmodel, variables = checkpoints
    out = root / "jax_half.npz"
    jax_infer_and_save(jax_path, str(root / "im.png"), str(out), half=True, save="npz")
    jax_half = 1.0 / np.load(out)["depth"]
    rgb = resize_image(load_image(str(root / "im.png")), (H, W))
    rounded = jnp.asarray(rgb[None]).astype(jnp.bfloat16).astype(jnp.float32)
    forward = jax.jit(lambda v, x: jax_model_forward(jmodel, v, {"rgb": x},
                                                     train=False)[0]["inv_depths"][0])
    want = np.asarray(forward({"params": variables["params"]}, rounded))[0, ..., 0]
    np.testing.assert_allclose(jax_half, want, rtol=1e-6)
    port_half = _port_half_inverse_depth(root, port_path, "port_half_i.npz")
    assert np.abs(port_half - jax_half).max() > 1e-4 * np.abs(jax_half).max()


def test_intrinsics_stay_float32_in_the_bf16_step():
    """Fault (h): JAX rounds the intrinsics with the images; the port does not."""
    K = np.array([[[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]]],
                 np.float32)
    rounded = np.asarray(_cast_tree({"intrinsics": K}, jnp.bfloat16)["intrinsics"], np.float32)
    assert rounded[0, 0, 0] == 720.0 and rounded[0, 0, 2] == 608.0
    scaled = K.copy()
    scaled[:, 0, 0], scaled[:, 1, 1] = 721.5377 * 640 / 1242, 721.5377 * 192 / 375
    small = np.asarray(_cast_tree({"intrinsics": scaled}, jnp.bfloat16)["intrinsics"],
                       np.float32)
    assert small[0, 0, 0] == 372.0 and small[0, 1, 1] == 370.0
    rgb = torch.rand(1, 8, 12, 3)
    batch = {"rgb": rgb, "rgb_original": rgb, "rgb_context": [rgb], "intrinsics":
             torch.from_numpy(K)}
    cast = cast_batch(batch, torch.bfloat16)
    assert cast["intrinsics"].dtype == torch.float32
    assert torch.equal(cast["intrinsics"], batch["intrinsics"])
    assert cast["rgb"].dtype == cast["rgb_context"][0].dtype == torch.bfloat16
    assert cast["rgb"] is cast["rgb_original"]          # one image, cast once
