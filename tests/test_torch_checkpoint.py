"""Checkpoints and the two CLIs of the port (engine/checkpoint.py,
cli/eval.py, cli/infer.py), on the CPU.

- save -> restore gives the model's, Adam's and the scheduler's state back
  bit for bit, and meta.json has the JAX package's keys;
- ``load_network`` loads one network's tensors by prefix, skips a shape
  mismatch and a missing entry, and counts;
- ``cli.eval.evaluate`` on a saved checkpoint returns the table of
  ``Trainer.test`` on the same weights (exactly: the same computation);
- ``cli.infer.infer_and_save`` on PNGs written here with Pillow (a single
  file and a folder; npz, png and the rgb+viz image) against the JAX
  package's ``infer_and_save`` on the same image and weights (one JAX
  checkpoint saved from a ``TrainState`` of the same variables): npz depths
  within rtol 1e-3 (measured 2.9e-6; the LANCZOS resize and the decode are
  the same Pillow calls); the png depth is the npz depth in steps of 1/256;
  the rgb+viz images differ by under 1 of 255 on average (a colormap entry
  may flip where the inverse depth sits on a boundary; measured a mean of
  8.1e-5 and a largest difference of 2);
- ``--half`` no longer raises in either CLI (it did until the bfloat16
  policy was ported; tests/test_torch_bf16_step.py holds what it computes).
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from packnet_sfm_tpu.cli.infer import infer_and_save as jax_infer_and_save
from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from packnet_sfm_tpu.engine.train import TrainState
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu_torch.cli import eval as eval_cli
from packnet_sfm_tpu_torch.cli import infer as infer_cli
from packnet_sfm_tpu_torch.core.config import (
    OMNICAM,
    ConfigNode,
    config_from_dict,
    parse_train_config,
)
from packnet_sfm_tpu_torch.engine.checkpoint import (
    load_network,
    restore_checkpoint,
    save_checkpoint,
)
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.utils.convert import from_jax
from packnet_sfm_tpu_torch.utils.save import load_depth
from tests.torch_cleanup import remove_tmp_path, remove_tree  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

H, W = 64, 96
JAX_META_KEYS = {"config", "epoch", "monitor_value", "step"}


def _config():
    """PackNetSlim01-1A + PoseNet at 64x96, a Synthetic test split of 5
    samples in batches of 2 (the last one padded): a JAX ConfigNode, whose
    dict both packages read."""
    c = jax_default_config()
    c.model.name = "SelfSupModel"
    c.model.depth_net.name = "PackNetSlim01"
    c.model.depth_net.version = "1A"
    c.model.pose_net.name = "PoseNet"
    c.model.params.crop = "garg"
    c.datasets.augmentation.image_shape = (H, W)
    for mode in ("validation", "test"):
        d = c.datasets[mode]
        d.dataset = ["Synthetic"]
        d.path, d.split, d.depth_type = [""], [""], [""]
        d.batch_size, d.num_workers = 2, 1
        d.synthetic_length, d.synthetic_height, d.synthetic_width = 5, H, W
    return c


def _omnicam_model(seed):
    return setup_model(config_from_dict(OMNICAM).model, device="cpu", seed=seed)


def _stepped(seed):
    """ResNet-18 NRS model, Adam and its schedule after one step on seeded
    gradients (so that Adam's moments and the step count are not zero)."""
    cfg = config_from_dict(OMNICAM)
    model = _omnicam_model(seed)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                          steps_per_epoch=3)
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    optimizer.step()
    scheduler.step()
    return model, optimizer, scheduler


def test_save_restore_round_trip_is_bit_exact(tmp_path):
    model, optimizer, scheduler = _stepped(0)
    path = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": {"name": "x"}}, epoch=3,
                           monitor_value=0.25, step=1, optimizer=optimizer,
                           scheduler=scheduler)
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    meta = json.loads(open(os.path.join(path, "meta.json")).read())
    assert set(meta) == JAX_META_KEYS
    assert (meta["epoch"], meta["monitor_value"], meta["step"]) == (3, 0.25, 1)

    model2, optimizer2, scheduler2 = _stepped(1)
    state, meta2 = restore_checkpoint(path, model2, optimizer2, scheduler2)
    assert meta2 == meta and set(state) == {"model", "optimizer", "scheduler"}
    for (k, a), (k2, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    s1, s2 = optimizer.state_dict(), optimizer2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for key, value in st.items():
            assert torch.equal(value, s2["state"][i][key]), (i, key)
    assert scheduler.state_dict() == scheduler2.state_dict()
    assert scheduler2.last_epoch == 1
    # a checkpoint saved without optimizer state cannot restore one
    bare = save_checkpoint(str(tmp_path / "bare"), model, {}, epoch=0)
    with pytest.raises(KeyError, match="optimizer"):
        restore_checkpoint(bare, model2, optimizer2)


def test_load_network_loads_a_prefix_skips_mismatches_and_counts(tmp_path, capsys):
    source = _omnicam_model(0)
    path = save_checkpoint(str(tmp_path / "ckpt"), source, {}, epoch=0)
    state = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    depth_keys = [k for k in state["model"] if k.startswith("depth_net.")]
    reshaped, dropped = depth_keys[0], depth_keys[1]
    state["model"][reshaped] = torch.zeros(3)
    del state["model"][dropped]
    torch.save(state, os.path.join(path, "state.pt"))

    target = _omnicam_model(1)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    n = load_network(path, target, "depth_net")
    assert n == len(depth_keys) - 2
    assert f"Loaded {n}/{len(depth_keys)} tensors for depth_net" in capsys.readouterr().out
    after, src = target.state_dict(), source.state_dict()
    for k in after:
        if k.startswith("depth_net.") and k not in (reshaped, dropped):
            assert torch.equal(after[k], src[k]), k
        else:
            assert torch.equal(after[k], before[k]), k


def test_evaluate_reproduces_trainer_test(tmp_path):
    cfg = parse_train_config(config_from_dict(_config().to_dict()))
    trainer = Trainer(cfg, device="cpu")
    with torch.no_grad():       # weights that the seed does not give: the checkpoint's
        for p in trainer.model.parameters():
            p.mul_(1.01)
    want = trainer.test()
    path = save_checkpoint(str(tmp_path / "ckpt"), trainer.model, cfg.to_dict(), epoch=2)
    got = eval_cli.evaluate(path, device="cpu")
    assert len(got) == len(want) == 1
    for mode, row in want[0].items():
        np.testing.assert_array_equal(got[0][mode], row, err_msg=mode)
    eval_cli.main(["--checkpoint", path, "--device", "cpu"])


def test_half_raises_naming_the_roadmap(tmp_path, checkpoints):
    """Named for what ``--half`` did before the bfloat16 policy was ported:
    now both CLIs run it, and nothing refuses naming ROADMAP.md."""
    root, _, port_path = checkpoints
    table = eval_cli.evaluate(port_path, half=True, device="cpu")[0]
    assert all(np.all(np.isfinite(row)) for row in table.values())
    out = tmp_path / "im0.npz"
    infer_cli.infer_and_save(port_path, str(root / "images" / "im0.png"), str(out), half=True,
                             save="npz", device="cpu")
    assert np.all(np.isfinite(np.load(out)["depth"]))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same weights in a JAX checkpoint and in a port checkpoint, and
    three 80x120 PNGs (resized to 64x96 by both CLIs)."""
    root = tmp_path_factory.mktemp("infer")
    c = _config()
    rng = np.random.default_rng(0)
    images = root / "images"
    images.mkdir()
    for i in range(3):
        base = rng.uniform(size=(10, 15, 3))
        img = np.kron(base, np.ones((8, 8, 1))) + 0.1 * rng.uniform(size=(80, 120, 3))
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(images / f"im{i}.png")
    jmodel = jax_factory.setup_model(c.model)
    sample = {"rgb": np.zeros((1, H, W, 3), np.float32),
              "rgb_context": [np.zeros((1, H, W, 3), np.float32)] * 2}
    variables = jax.tree_util.tree_map(np.asarray,
                                       init_model(jmodel, jax.random.PRNGKey(0), sample))
    jax_path = jax_save_checkpoint(str(root / "jax_ckpt"),
                                   TrainState.create(variables, optax.identity()),
                                   c.to_dict(), epoch=0)
    model = setup_model(ConfigNode.from_dict(c.to_dict()).model, device="cpu")
    model.load_state_dict(from_jax(variables["params"], variables.get("batch_stats")))
    port_path = save_checkpoint(str(root / "port_ckpt"), model, c.to_dict(), epoch=0)
    yield root, jax_path, port_path
    remove_tree(root)


def test_meta_keys_match_the_jax_checkpoint(checkpoints):
    _, jax_path, port_path = checkpoints
    keys = [set(json.loads(open(os.path.join(p, "meta.json")).read()))
            for p in (jax_path, port_path)]
    assert keys[0] == keys[1] == JAX_META_KEYS


def test_infer_matches_the_jax_cli(checkpoints):
    root, jax_path, port_path = checkpoints
    image = str(root / "images" / "im0.png")
    for save in ("npz", None):
        name = "single." + (save or "png")
        jax_infer_and_save(jax_path, image, str(root / "jax" / name), save=save)
        infer_cli.infer_and_save(port_path, image, str(root / "port" / name), save=save,
                                 device="cpu")
    want = np.load(root / "jax" / "single.npz")["depth"]
    got = np.load(root / "port" / "single.npz")["depth"]
    assert got.shape == (H, W) and np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    viz = [np.asarray(Image.open(root / d / "single.png")).astype(np.float64)
           for d in ("jax", "port")]
    assert viz[1].shape == viz[0].shape == (2 * H, W, 3)
    assert np.abs(viz[1] - viz[0]).mean() < 1.0


def test_infer_folder_writes_every_output(checkpoints):
    root, _, port_path = checkpoints
    folder = str(root / "images")
    for save in ("npz", "png", None):
        infer_cli.main(["--checkpoint", port_path, "--input", folder, "--output",
                        str(root / f"out_{save}"), "--device", "cpu"]
                       + (["--save", save] if save else []))
    for i in range(3):
        npz = load_depth(str(root / "out_npz" / f"im{i}.npz"))
        png = load_depth(str(root / "out_png" / f"im{i}.png"))
        assert npz.shape == png.shape == (H, W)
        np.testing.assert_allclose(png, npz, atol=1 / 256)
        viz = np.asarray(Image.open(root / "out_None" / f"im{i}.png"))
        assert viz.shape == (2 * H, W, 3) and viz.dtype == np.uint8
