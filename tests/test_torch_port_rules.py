"""Rules of the port package (packnet_sfm_tpu_torch):

- importing any of its modules leaves ``jax`` and ``packnet_sfm_tpu`` out of
  ``sys.modules``, and no source of it (nor chip_smoke.py) imports them;
- entry points (``setup_model``, ``Trainer``, both CLIs) run on CUDA by
  default and raise without it, unless the caller asks for the CPU; the
  kernel wrappers raise on a non-CUDA tensor;
- its own copies of host modules agree with the JAX package's, exactly: the
  OMNICAM and KITTI dicts with configs/train_omnicam.yaml and
  configs/train_kitti.yaml, the synthetic dataset sample for sample, and the
  eval slice's copies (eval transform, depth resizes, crop borders, collate,
  the loader's batch plan and epochs, depth files, the colormap, image
  decode);
- what is not ported yet refuses with a pointer to ROADMAP.md (datasets
  other than Synthetic, the train transform, training, bfloat16, W&B, the
  init-time loads), and a missing Pillow or matplotlib raises ImportError
  only where one is used;
- the package calls no library warp: no source of it mentions
  ``F.grid_sample``;
- every ``extern "C"`` launcher of ``csrc/*.cu`` has its ctypes argument
  types in ``ops/_cuda.SIGNATURES``, kind by kind in order (a mismatch would
  cut a pointer to 32 bits, which no CPU run could see otherwise).
"""

import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from packnet_sfm_tpu_torch.core.config import (
    KITTI,
    OMNICAM,
    config_from_dict,
    load_config,
    parse_train_config,
)
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset, collate_train_batch
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.ops import _cuda
from packnet_sfm_tpu_torch.ops import softargmax as sa
from packnet_sfm_tpu_torch.ops import warp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "packnet_sfm_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_importing_the_port_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'packnet_sfm_tpu' or m.startswith('packnet_sfm_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len(sys.argv))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 20


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"\bpacknet_sfm_tpu\.", src)
    assert not re.search(r"^\s*from\s+packnet_sfm_tpu\s+import", src, re.M)


@pytest.mark.parametrize("config", [OMNICAM, KITTI], ids=["omnicam", "kitti"])
def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, config):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_dict(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_model(cfg.model)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    if config is KITTI:
        cfg.model.depth_net.name = "PackNetSlim01"      # same code path, 0.6 of the weights
    model = setup_model(cfg.model, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert model.kind == cfg.model.name


def test_unported_networks_and_kinds_are_refused():
    cfg = config_from_dict(KITTI)
    cfg.model.depth_net.name = "DepthResNet"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        setup_model(cfg.model, device="cpu")
    cfg = config_from_dict(KITTI)
    cfg.model.name = "SemiSupModel"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        setup_model(cfg.model, device="cpu")
    cfg = config_from_dict(KITTI)
    cfg.model.depth_net.name = "PackNetSlim01"
    cfg.model.depth_net.dropout = 0.5
    with pytest.raises(NotImplementedError, match="dropout"):
        setup_model(cfg.model, device="cpu")


def test_kernel_wrappers_take_only_cuda_tensors():
    d = torch.randn(1, 3, 12, 12)
    with pytest.raises(ValueError, match="CUDA"):
        sa.softargmax_fwd_cuda(d, d, 0.05, 2)
    with pytest.raises(ValueError):
        sa.softargmax_coords(d.to("meta"), d.to("meta"), 0.05, 2)
    # on a CPU tensor the entry point takes the plain version and launches nothing
    sa.reset_launch_counts()
    sa.softargmax_coords(d, d, 0.05, 2)
    assert sa.launch_counts == {"softargmax_fwd": 0, "softargmax_bwd": 0}


def test_warp_wrappers_take_only_cuda_or_cpu_tensors():
    image, coords = torch.rand(1, 6, 8, 3), torch.rand(1, 6, 8, 2) * 2 - 1
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_fwd_cuda(image, coords)
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_bwd_cuda(image, coords, torch.rand(1, 6, 8, 3))
    with pytest.raises(ValueError, match="no path"):
        warp.grid_sample(image.to("meta"), coords.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        warp.grid_sample(image, coords.to("meta"))
    # on CPU tensors the entry points take the plain version and launch nothing
    warp.reset_launch_counts()
    coords.requires_grad_()
    warp.grid_sample(image, coords).sum().backward()
    warp.grid_sample_data(image, coords, "border")
    assert warp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0}


def test_no_source_of_the_package_calls_a_library_warp():
    for path in sorted(PKG.rglob("*.py")):
        src = path.read_text()
        assert "F.grid_sample" not in src, path
        assert "functional.grid_sample" not in src, path
        assert "affine_grid" not in src, path
    assert (PKG / "csrc" / "warp.cu").exists()


def _declared_launchers(source: str):
    """{name: [ctypes kind of each parameter]} of a source's ``extern "C" int``
    functions, from their declarations as text."""
    found = {}
    for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', source):
        kinds = []
        for param in params.split(","):
            param = " ".join(param.split())
            if "*" in param:
                kinds.append(ctypes.c_void_p)
            elif re.match(r"(const )?int\b", param):
                kinds.append(ctypes.c_int)
            elif re.match(r"(const )?float\b", param):
                kinds.append(ctypes.c_float)
            else:
                raise AssertionError(f"{name}: parameter {param!r} has no ctypes kind here")
        found[name] = kinds
    return found


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cu")), ids=lambda p: p.name)
def test_launcher_signatures_match_the_sources(path):
    declared = _declared_launchers(path.read_text())
    assert declared, path
    assert set(declared) == set(_cuda.SIGNATURES[path.stem])
    for name, kinds in declared.items():
        assert _cuda.SIGNATURES[path.stem][name] == kinds, name


def test_signature_parser_sees_a_mismatch():
    src = 'extern "C" int f(const float* a, float* b,\n int n, float t, void* stream) {'
    assert _declared_launchers(src) == {"f": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_void_p]}
    with pytest.raises(AssertionError):
        _declared_launchers('extern "C" int g(long long n) {')


def test_kitti_matches_the_yaml():
    yaml = pytest.importorskip("yaml")
    path = ROOT / "configs" / "train_kitti.yaml"
    assert KITTI == yaml.safe_load(path.read_text())
    loaded = load_config(str(path))
    built = config_from_dict(KITTI)
    built.config = loaded.config
    assert loaded == built
    assert built.datasets.augmentation.image_shape == (192, 640)
    assert built.datasets.train.batch_size == 4
    assert built.model.loss.num_scales == 4 and built.model.loss.automask_loss
    assert parse_train_config(built).prepared


def test_omnicam_matches_the_yaml():
    yaml = pytest.importorskip("yaml")
    path = ROOT / "configs" / "train_omnicam.yaml"
    assert OMNICAM == yaml.safe_load(path.read_text())
    loaded = load_config(str(path))
    built = config_from_dict(OMNICAM)
    built.config = loaded.config
    assert loaded == built
    assert built.datasets.augmentation.image_shape == (384, 384)
    assert parse_train_config(built).prepared


def test_synthetic_dataset_copy_matches_the_jax_package():
    from packnet_sfm_tpu.datasets.synthetic import SyntheticSfmDataset as JaxSynthetic

    ours = SyntheticSfmDataset(length=2, height=32, width=48, seed=3)
    theirs = JaxSynthetic(length=2, height=32, width=48, seed=3)
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in ("rgb", "intrinsics", "depth"):
            np.testing.assert_array_equal(a[key], b[key])
        for x, y in zip(a["rgb_context"], b["rgb_context"]):
            np.testing.assert_array_equal(x, y)


def test_collate_train_batch_stacks_samples():
    ds = SyntheticSfmDataset(length=3, height=32, width=48, seed=1)
    jitter = [np.array([1, 1, 1, 0], np.float32)] * 3
    batch = collate_train_batch([ds[i] for i in range(3)], jitter)
    assert batch["rgb"].shape == (3, 32, 48, 3)
    assert [c.shape for c in batch["rgb_context"]] == [(3, 32, 48, 3)] * 2
    assert batch["intrinsics"].shape == (3, 3, 3) and batch["jitter"].shape == (3, 4)
    np.testing.assert_array_equal(batch["rgb_context"][1][2], ds[2]["rgb_context"][1])
    assert "jitter" not in collate_train_batch([ds[0]])


# --- the eval slice's host copies, refusals and devices --------------------------

def _eval_config(**split):
    cfg = config_from_dict(KITTI)
    cfg.arch.dtype = "float32"
    cfg.model.depth_net.name = "PackNetSlim01"
    for mode in ("validation", "test"):
        d = cfg.datasets[mode]
        d.dataset, d.path, d.split, d.depth_type = ["Synthetic"], [""], [""], [""]
        d.synthetic_length, d.synthetic_height, d.synthetic_width = 3, 32, 48
        d.update(split)
    return parse_train_config(cfg)


@pytest.mark.parametrize("crop,shape", [((), ()), ((0.1, 4, -2, 0.9), (24, 40)),
                                        ((40, 30), (20, 32)), ((), (50, 60))],
                         ids=["none", "crop4-resize", "crop2-resize", "upscale"])
def test_eval_transform_copy_matches_the_jax_package(crop, shape):
    from packnet_sfm_tpu.datasets import augmentations as jaug
    from packnet_sfm_tpu_torch.datasets import augmentations as taug

    for mode in ("validation", "test"):
        rng = np.random.default_rng(0)
        sample = SyntheticSfmDataset(length=1, height=36, width=52, seed=2)[0]
        sample["input_depth"] = sample["depth"] * (rng.uniform(size=sample["depth"].shape) < 0.5)
        sample["rgb_context"] = [(c * 255).astype(np.uint8) for c in sample["rgb_context"]]
        copy = {k: [c.copy() for c in v] if isinstance(v, list) else np.copy(v)
                for k, v in sample.items()}
        ours = taug.eval_transform(sample, shape, crop, depth_preserve_input=mode == "validation")
        theirs = jaug.eval_transform(copy, shape, crop, depth_preserve_input=mode == "validation")
        assert ours.keys() == theirs.keys()
        for key in ("rgb", "intrinsics", "depth", "input_depth"):
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
            assert ours[key].dtype == theirs[key].dtype
        for x, y in zip(ours["rgb_context"], theirs["rgb_context"]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype == np.float32


def test_depth_resizes_and_crop_borders_match_the_jax_package():
    from packnet_sfm_tpu.datasets import augmentations as jaug
    from packnet_sfm_tpu.utils.misc import parse_crop_borders as jax_parse
    from packnet_sfm_tpu_torch.datasets import augmentations as taug
    from packnet_sfm_tpu_torch.utils.misc import parse_crop_borders

    rng = np.random.default_rng(1)
    depth = (rng.uniform(1, 80, size=(75, 124, 1))
             * (rng.uniform(size=(75, 124, 1)) < 0.1)).astype(np.float32)
    for shape in ((37, 62), (20, 33), (75, 124), (90, 130)):
        np.testing.assert_array_equal(taug.resize_depth_preserve(depth, shape),
                                      jaug.resize_depth_preserve(depth, shape))
        np.testing.assert_array_equal(taug.resize_depth(depth, shape),
                                      jaug.resize_depth(depth, shape))
    for borders in [(), (40, 30), (0.5, 0.5), (-10, -6), (0.1, 4, -2, 0.9), (3, 2, 0, 0),
                    (5, 5, 40, 30)]:
        assert parse_crop_borders(borders, (50, 70)) == jax_parse(borders, (50, 70)), borders
    with pytest.raises(ValueError):
        parse_crop_borders((1, 2, 3), (50, 70))


class _Indexed:
    """A dataset of ``n`` samples that are their index; ``shapes`` buckets."""

    def __init__(self, n, shapes=None):
        self.n = n
        if shapes is not None:
            self.sample_shape = lambda i: shapes[i % len(shapes)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": i, "rgb": np.full((2, 3, 3), i, np.float32), "filename": f"s{i}"}


@pytest.mark.parametrize("n", [1, 7, 13, 16])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("buckets", [None, [(4, 5), (2, 3)]], ids=["one-shape", "two-shapes"])
def test_batch_plan_copy_matches_the_jax_package(n, shuffle, count, buckets):
    from packnet_sfm_tpu.datasets.loader import DataLoader as JaxLoader
    from packnet_sfm_tpu_torch.datasets.loader import DataLoader

    for rank in range(count):
        for drop_last in (False, True):
            kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last,
                      num_workers=1, process_index=rank, process_count=count)
            ours = DataLoader(_Indexed(n, buckets), **kw)._batch_plan(3)
            theirs = JaxLoader(_Indexed(n, buckets), **kw)._batch_plan(3)
            assert len(ours) == len(theirs)
            for (a, pa), (b, pb) in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
                assert pa == pb


def test_loader_epochs_and_collate_match_the_jax_package():
    from packnet_sfm_tpu.datasets.loader import DataLoader as JaxLoader
    from packnet_sfm_tpu.datasets.loader import collate as jax_collate
    from packnet_sfm_tpu_torch.datasets.loader import (
        ConcatDataset,
        DataLoader,
        RepeatDataset,
        collate,
    )

    ds = SyntheticSfmDataset(length=3, height=16, width=24, seed=4)
    samples = [ds[i] for i in range(3)]
    ours, theirs = collate(samples), jax_collate(samples)
    assert ours.keys() == theirs.keys()
    for key in ("rgb", "depth", "intrinsics", "idx"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    for a, b in zip(ours["rgb_context"] + ours["pose_context"],
                    theirs["rgb_context"] + theirs["pose_context"]):
        np.testing.assert_array_equal(a, b)
    assert ours["filename"] == theirs["filename"]
    data = ConcatDataset([_Indexed(5), _Indexed(6)])
    assert len(data) == 11 and data[7]["idx"] == 2
    twice = RepeatDataset(_Indexed(5), 2)
    assert len(twice) == 10 and twice[7]["idx"] == 2
    for workers in (1, 3):
        kw = dict(batch_size=4, shuffle=True, seed=1, drop_last=False, num_workers=workers,
                  process_index=0, process_count=1)
        got = list(DataLoader(data, **kw).epoch(2))
        want = list(JaxLoader(data, **kw).epoch(2))
        assert [b.get("pad_count", 0) for b in got] == [b.get("pad_count", 0) for b in want] \
            == [0, 0, 1]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["rgb"], b["rgb"])


def test_depth_files_and_viz_match_the_jax_package(tmp_path):
    from packnet_sfm_tpu.utils import save as jsave
    from packnet_sfm_tpu.utils.viz import viz_inv_depth as jax_viz
    from packnet_sfm_tpu_torch.utils import save as tsave
    from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth

    rng = np.random.default_rng(3)
    depth = (rng.uniform(1, 80, size=(12, 20)) * (rng.uniform(size=(12, 20)) < 0.6)).astype(
        np.float32)
    K = np.eye(3, dtype=np.float32)
    for ext in ("npz", "png"):
        ours, theirs = str(tmp_path / f"ours.{ext}"), str(tmp_path / f"theirs.{ext}")
        tsave.write_depth(ours, depth, intrinsics=K)
        jsave.write_depth(theirs, depth, intrinsics=K)
        for a, b in ((ours, theirs), (theirs, ours)):
            np.testing.assert_array_equal(tsave.load_depth(a), jsave.load_depth(b))
    np.testing.assert_allclose(tsave.load_depth(str(tmp_path / "ours.png")), depth, atol=1 / 256)
    with pytest.raises(NotImplementedError):
        tsave.write_depth(str(tmp_path / "x.jpg"), depth)
    inv = rng.uniform(0, 2, size=(12, 20)).astype(np.float32)
    for kw in ({}, {"filter_zeros": True, "percentile": 50}, {"normalizer": 1.5}):
        np.testing.assert_array_equal(viz_inv_depth(inv, **kw), jax_viz(inv, **kw))


def test_load_image_copy_matches_the_jax_package(tmp_path):
    from PIL import Image

    from packnet_sfm_tpu.datasets.kitti import load_image as jax_load_image
    from packnet_sfm_tpu_torch.datasets.kitti import load_image, load_image_u8

    rng = np.random.default_rng(4)
    path = str(tmp_path / "im.png")
    Image.fromarray(rng.integers(0, 256, size=(9, 13, 3), dtype=np.uint8)).save(path)
    np.testing.assert_array_equal(load_image(path), jax_load_image(path))
    assert load_image_u8(path).dtype == np.uint8


def test_missing_pillow_or_matplotlib_raises_import_error(monkeypatch, tmp_path):
    from packnet_sfm_tpu_torch.datasets.augmentations import resize_image
    from packnet_sfm_tpu_torch.datasets.kitti import load_image
    from packnet_sfm_tpu_torch.utils.save import write_depth
    from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        load_image(str(tmp_path / "im.png"))
    with pytest.raises(ImportError):
        resize_image(np.zeros((4, 6, 3), np.float32), (2, 3))
    with pytest.raises(ImportError):
        write_depth(str(tmp_path / "d.png"), np.ones((2, 3), np.float32))
    with pytest.raises(ImportError):
        viz_inv_depth(np.ones((2, 3), np.float32))
    # where nothing needs them, nothing asks for them: same size, npz
    image = np.zeros((4, 6, 3), np.float32)
    assert resize_image(image, (4, 6)) is image
    write_depth(str(tmp_path / "d.npz"), np.ones((2, 3), np.float32))


def test_unported_eval_pieces_refuse_naming_the_roadmap():
    from packnet_sfm_tpu_torch.datasets.augmentations import resize_image
    from packnet_sfm_tpu_torch.datasets.loader import make_transform, setup_dataset
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    cfg = _eval_config()
    for name in ("KITTI", "Image", "DGP"):
        split = cfg.datasets.test.clone()
        split.dataset = [name]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            setup_dataset(split, "test", cfg.datasets.augmentation)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_transform("train", cfg.datasets.augmentation)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resize_image(np.zeros((4, 6, 3), np.float32), (2, 3), filter="area")
    trainer = Trainer(cfg, device="cpu")
    for call in (trainer.fit, lambda: trainer.train_epoch(0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    trainer.init_state()                     # nothing to load: the seed's weights stay
    for key, value in (("checkpoint_path", "/x.ckpt"), ("version", "18pt")):
        trainer.config.model.depth_net[key] = value
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trainer.init_state()
        trainer.config.model.depth_net[key] = ""
    for key, value in (("arch", {"dtype": "bfloat16"}), ("wandb", {"dry_run": False})):
        bad = cfg.clone()
        bad[key].update(value)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(bad, device="cpu")


def test_trainer_and_clis_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    import json

    from packnet_sfm_tpu_torch.cli import eval as eval_cli
    from packnet_sfm_tpu_torch.cli import infer as infer_cli
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _eval_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.device.type == "cpu"
    # both CLIs read meta.json and build the model (which raises) before
    # they read any weights
    path = tmp_path / "ckpt"
    path.mkdir()
    (path / "meta.json").write_text(json.dumps({"config": cfg.to_dict(), "epoch": 0}))
    path = str(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.evaluate(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_cli.infer_and_save(path, str(tmp_path / "in.png"), str(tmp_path / "out.npz"))
    assert eval_cli.parse_args(["--checkpoint", path]).device == "cuda"
    assert infer_cli.parse_args(["--checkpoint", path, "--input", "a",
                                 "--output", "b"]).device == "cuda"
