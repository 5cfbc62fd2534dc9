"""Rules of the port package (packnet_sfm_tpu_torch):

- importing any of its modules leaves ``jax`` and ``packnet_sfm_tpu`` out of
  ``sys.modules``, and no source of it (nor chip_smoke.py) imports them;
- entry points (``setup_model``, ``Trainer``, both CLIs) run on CUDA by
  default and raise without it, unless the caller asks for the CPU; the
  kernel wrappers raise on a non-CUDA tensor;
- its own copies of host modules agree with the JAX package's, exactly: the
  OMNICAM, KITTI, DDAD, EVAL_KITTI, OVERFIT_SYNTHETIC,
  OVERFIT_PACKNET_SYNTHETIC, OVERFIT_SUPERVISED, OVERFIT_KITTI, SAN_KITTI
  and SAN_DDAD dicts with their yaml files, the synthetic
  dataset sample for sample (its train split too), the eval slice's copies
  (eval transform, depth resizes, crop borders, collate, the loader's batch
  plan and epochs, depth files, the colormap, image decode), the training
  slice's (the encoder artifact's layout and conv1 widening, the console
  helpers; the train transform in tests/test_torch_augmentations.py) and the
  data slice's native decode (``native/image_pipeline.cpp``: the same code
  and exported signatures as the JAX package's ``native/image_pipeline.cpp``,
  and ctypes types that agree with them; the readers in
  tests/test_torch_{datasets,ddad,native}.py);
- ``setup_dataset`` builds the KITTI, Image and DGP readers for every split;
- every config of configs/ builds; a network or kind that neither package
  knows raises ValueError, dropout refuses a training forward, what is not
  ported yet refuses with a pointer to ROADMAP.md (the S3 sync; bfloat16
  and multi-process training are accepted), and a missing Pillow or
  matplotlib raises ImportError only where one is used;
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
    SAN_KITTI,
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
from tests.test_datasets import kitti_root  # noqa: F401 (a fixture)
from tests.test_ddad import ddad_root  # noqa: F401 (a fixture)
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

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
    for module in ("datasets.kitti", "datasets.kitti_utils", "datasets.image_folder",
                   "datasets.ddad", "models.batch_utils", "native", "parallel",
                   "parallel.mesh", "parallel.scaling", "nn.pose_resnet", "nn.sparse",
                   "nn.packnet_san", "losses.supervised", "losses.velocity", "geometry.se3",
                   "egomotion", "egomotion.alignment", "egomotion.posegraph",
                   "egomotion.evaluation", "egomotion.odometry", "cli.odometry", "cli.export",
                   "cli.convert_checkpoint", "utils.torch_import", "parallel.spatial",
                   "tools.hr_2dmesh"):
        assert f"packnet_sfm_tpu_torch.{module}" in MODULES


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
    """Nothing that the JAX package builds is refused any more: every
    network and kind builds (``test_every_config_builds``), and a name that
    neither package knows raises ``ValueError`` as the JAX factory does.
    Dropout builds and evaluates, and refuses a training forward, as JAX in
    effect does (``tests/test_torch_model_kinds.py``)."""
    for net, name in (("depth_net", "DepthResNet9"), ("pose_net", "PoseVGG")):
        cfg = config_from_dict(KITTI)
        cfg.model[net].name = name
        with pytest.raises(ValueError, match="Unknown"):
            setup_model(cfg.model, device="cpu")
    cfg = config_from_dict(KITTI)
    cfg.model.name = "FullySupModel"
    with pytest.raises(ValueError, match="Unknown model"):
        setup_model(cfg.model, device="cpu")
    cfg = config_from_dict(KITTI)
    cfg.model.depth_net.name = "PackNetSlim01"
    cfg.model.depth_net.dropout = 0.5
    model = setup_model(cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="JAX package cannot train"):
        model.depth_net.train()(torch.rand(1, 64, 96, 3))


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")),
                         ids=lambda p: p.stem)
def test_every_config_builds(path):
    """setup_model builds every config of configs/ on the CPU, the networks
    and kind it names, the pose net dropped where the JAX factory drops it."""
    pytest.importorskip("yaml")
    cfg = load_config(str(path))
    model = setup_model(cfg.model, device="cpu")
    assert model.kind == cfg.model.name
    assert type(model.depth_net).__name__ == cfg.model.depth_net.name
    drop = (cfg.model.name in ("SemiSupModel", "SemiSupCompletionModel")
            and cfg.model.loss.supervised_loss_weight >= 1.0)
    want = None if drop or not cfg.model.pose_net.name else cfg.model.pose_net.name
    assert (model.pose_net and type(model.pose_net).__name__) == want


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
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_jvp_cuda(image, coords, torch.rand(1, 6, 8, 2))
    with pytest.raises(ValueError, match="no path"):
        warp.grid_sample(image.to("meta"), coords.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        warp.grid_sample(image, coords.to("meta"))
    # on CPU tensors the entry points take the plain version and launch nothing
    warp.reset_launch_counts()
    coords.requires_grad_()
    warp.grid_sample(image, coords).sum().backward()
    warp.grid_sample_data(image, coords, "border")
    torch.func.jvp(lambda c: warp.grid_sample(image, c), (coords.detach(),), (coords.detach(),))
    assert warp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0, "warp_jvp": 0,
                                 "warp_bwd_image": 0}


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


@pytest.mark.parametrize("name", ["OVERFIT_SYNTHETIC", "OVERFIT_PACKNET_SYNTHETIC"])
def test_overfit_recipes_match_the_yaml(name):
    from packnet_sfm_tpu_torch.core import config

    yaml = pytest.importorskip("yaml")
    path = ROOT / "configs" / f"{name.lower()}.yaml"
    assert getattr(config, name) == yaml.safe_load(path.read_text())
    loaded = load_config(str(path))
    built = config_from_dict(getattr(config, name))
    built.config = loaded.config
    assert loaded == built
    assert built.datasets.train.repeat == [24] and built.arch.max_epochs == 8
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


@pytest.mark.parametrize("name,yaml_name", [
    ("DDAD", "train_ddad"), ("EVAL_KITTI", "eval_kitti"),
    ("OVERFIT_SUPERVISED", "overfit_packnet_supervised"), ("OVERFIT_KITTI", "overfit_kitti"),
    ("SAN_KITTI", "train_packnet_san_kitti"), ("SAN_DDAD", "train_packnet_san_ddad")])
def test_data_configs_match_the_yaml(name, yaml_name):
    from packnet_sfm_tpu_torch.core import config

    yaml = pytest.importorskip("yaml")
    path = ROOT / "configs" / f"{yaml_name}.yaml"
    assert getattr(config, name) == yaml.safe_load(path.read_text())
    loaded = load_config(str(path))
    built = config_from_dict(getattr(config, name))
    built.config = loaded.config
    assert loaded == built
    assert parse_train_config(built).prepared


def _exported(source: str):
    """{name: parameter list as text} of the functions inside a source's
    ``extern "C" { ... }`` block."""
    block = source[source.index('extern "C" {'):]
    return {name: " ".join(params.split())
            for name, params in re.findall(r"^\w[\w\s\*]*?\b(\w+)\(([^)]*)\)\s*\{", block, re.M)}


def test_native_source_copy_matches_the_jax_package():
    """The port's native/image_pipeline.cpp is the JAX package's code (its
    header comment aside), exports the same functions with the same
    parameters, and its ctypes bindings type each parameter by its kind."""
    from packnet_sfm_tpu_torch import native

    ours, theirs = native.SOURCE.read_text(), (ROOT / "native" / "image_pipeline.cpp").read_text()
    body = ours.index("#include")
    assert ours[body:] == theirs[theirs.index("#include"):]
    exported = _exported(ours)
    assert exported == _exported(theirs) == {
        "pn_thread_count": "",
        "pn_decode_image": "const char* path, uint8_t* out, int64_t max_bytes, int* out_w, "
                           "int* out_h",
        "pn_load_batch": "const char** paths, int n, int oh, int ow, float* out"}
    lib = native.load_native()
    if lib is None:
        pytest.skip(f"native toolchain unavailable: {native.build_error()}")
    kinds = {"const char** paths": ctypes.POINTER(ctypes.c_char_p),
             "const char* path": ctypes.c_char_p, "uint8_t* out": ctypes.POINTER(ctypes.c_uint8),
             "int64_t max_bytes": ctypes.c_int64, "float* out": ctypes.POINTER(ctypes.c_float),
             "int* out_w": ctypes.POINTER(ctypes.c_int), "int* out_h": ctypes.POINTER(ctypes.c_int)}
    for name, params in exported.items():
        want = [kinds.get(p, ctypes.c_int if p.startswith("int ") else None)
                for p in params.split(", ") if p]
        assert getattr(lib, name).argtypes == want, name
        assert getattr(lib, name).restype is ctypes.c_int


def test_synthetic_dataset_copy_matches_the_jax_package():
    from packnet_sfm_tpu.datasets.synthetic import SyntheticSfmDataset as JaxSynthetic

    for train in (False, True):          # the eval splits' samples and the train split's
        ours = SyntheticSfmDataset(length=2, height=32, width=48, seed=3, train=train)
        theirs = JaxSynthetic(length=2, height=32, width=48, seed=3, train=train)
        for i in range(2):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys() and "pose_context" in a
            for key in ("rgb", "intrinsics", "depth"):
                np.testing.assert_array_equal(a[key], b[key])
            assert a["idx"] == b["idx"] and a["filename"] == b["filename"]
            for x, y in zip(a["rgb_context"] + a["pose_context"],
                            b["rgb_context"] + b["pose_context"]):
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
    # PackNet-SAN's KITTI crop as its yaml writes it, read as the JAX package
    # reads it ("-352" a float, a 4-tuple (x1, y1, x2, y2)): 188x621 of a
    # 375x1242 frame in both packages, not the 352x1216 its authors meant
    # (ROADMAP.md §3 (q))
    (borders,) = {config_from_dict(SAN_KITTI).datasets.augmentation[k]
                  for k in ("crop_train_borders", "crop_eval_borders")}
    assert borders == (-352.0, 0.5, 0.5, 1216)
    x1, y1, x2, y2 = parse_crop_borders(borders, (375, 1242))
    assert (x1, y1, x2, y2) == jax_parse(borders, (375, 1242))
    assert np.zeros((375, 1242))[y1:y2, x1:x2].shape == (188, 621)


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


def test_unported_eval_pieces_refuse_naming_the_roadmap(tmp_path):
    """What the eval and training slices leave out refuses, naming the
    roadmap item (or, for the S3 sync, what it would need)."""
    from packnet_sfm_tpu_torch.cli.train import train
    from packnet_sfm_tpu_torch.engine.checkpoint import ModelCheckpoint
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    cfg = _eval_config()
    half = cfg.clone()                       # bfloat16 is ported: accepted
    half.arch.dtype = "bfloat16"
    assert Trainer(half, device="cpu").model.depth_net.dtype == torch.bfloat16
    # multi-process training is ported: --distributed asks for this rank's
    # card, and without one it raises instead of training on the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg.to_dict(), distributed=True)
    with pytest.raises(NotImplementedError, match="S3"):
        ModelCheckpoint(str(tmp_path), s3_path="s3://bucket/run")
    # the training half is there: nothing of it refuses any more
    d = cfg.datasets.train
    d.dataset, d.path, d.split, d.depth_type = ["Synthetic"], [""], [""], [""]
    d.synthetic_length, d.synthetic_height, d.synthetic_width = 2, 32, 48
    d.batch_size, d.num_workers, d.repeat = 2, 1, [1]
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()                     # nothing to load: the seed's weights stay
    assert trainer.train_epoch(0)["imgs_per_sec"] > 0 and trainer.step == 1
    # W&B without the package: a line, and no logger
    wandb = cfg.clone()
    wandb.wandb.dry_run = False
    assert Trainer(wandb, device="cpu").logger.dry_run


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_setup_dataset_builds_every_reader(mode, kitti_root, ddad_root, tmp_path):
    """KITTI (split relative to its path), Image (a folder of frames) and
    DGP, each from a config split as the configs write it; a train split
    repeats and hands its loader the images as read (uint8), an eval split
    applies its eval transform (float32 at the image shape)."""
    from PIL import Image

    from packnet_sfm_tpu_torch.datasets.ddad import DDADDataset
    from packnet_sfm_tpu_torch.datasets.image_folder import ImageFolderDataset
    from packnet_sfm_tpu_torch.datasets.kitti import KITTIDataset
    from packnet_sfm_tpu_torch.datasets.loader import RepeatDataset, setup_dataset

    root, split = kitti_root
    for i in range(4):
        Image.fromarray(np.full((40, 56, 3), 20 * i, np.uint8)).save(tmp_path / f"{i:04d}.png")
    cfg = config_from_dict({"datasets": {"augmentation": {"image_shape": (16, 24)}, mode: {
        "dataset": ["KITTI", "Image", "DGP"], "path": [str(root), str(tmp_path), ddad_root],
        "split": [split.name, "", "train"], "depth_type": ["velodyne", "", "LIDAR"],
        "cameras": [[], [], ["CAMERA_01", "CAMERA_05"]], "repeat": [2, 1, 3],
        "back_context": 1, "forward_context": 1}}})
    datasets = setup_dataset(cfg.datasets[mode], mode, cfg.datasets.augmentation,
                             requirements={"gt_pose": True})
    kinds = (KITTIDataset, ImageFolderDataset, DDADDataset)
    if mode == "train":
        assert [type(d) for d in datasets] == [RepeatDataset, ImageFolderDataset,
                                               RepeatDataset]
        assert [len(d) for d in datasets] == [8, 2, 6]
        readers = [datasets[0].dataset, datasets[1], datasets[2].dataset]
    else:
        readers = datasets
        assert [len(d) for d in datasets] == [4, 2, 2]
    assert [type(d) for d in readers] == list(kinds)
    assert readers[0].with_pose and readers[2].cameras == ["CAMERA_01", "CAMERA_05"]
    for d, lead in zip(datasets, ((), (), (2,))):
        s = d[0]
        assert len(s["rgb_context"]) == 2
        if mode == "train":
            assert s["rgb"].dtype == np.uint8 and s["rgb"].shape[:len(lead)] == lead
        else:
            assert s["rgb"].dtype == np.float32 and s["rgb"].shape == lead + (16, 24, 3)


def test_console_helpers_copy_matches_the_jax_package(capsys):
    from packnet_sfm_tpu.utils import logging as jlog
    from packnet_sfm_tpu_torch.utils import logging as tlog

    for args in (("x",), ("y", "red", ["bold", "underline"]), ("z", "nope", ["dark"])):
        assert tlog.pcolor(*args) == jlog.pcolor(*args)
    from packnet_sfm_tpu.core.config import ConfigNode as JaxNode

    cfg = _eval_config()
    tlog.print_config(cfg, prefix="run")
    ours = capsys.readouterr().out
    jlog.print_config(JaxNode.from_dict(cfg.to_dict()), prefix="run")
    assert ours == capsys.readouterr().out and "run" in ours


def test_avg_meter_copy_matches_the_jax_package():
    from packnet_sfm_tpu.utils.logging import AvgMeter as JaxAvgMeter
    from packnet_sfm_tpu_torch.utils.logging import AvgMeter

    ours, theirs = AvgMeter(3), JaxAvgMeter(3)
    assert ours.get() == theirs.get() == 0.0
    for value in (1.0, 2, np.float32(4.5), torch.tensor(7.0), -3.25):
        assert ours(value) == theirs(value)
    assert ours.get_and_reset() == theirs.get_and_reset() == (4.5 + 7.0 - 3.25) / 3
    assert ours.get() == theirs.get() == 0.0


@pytest.mark.parametrize("x,n", [(3, None), (3, 4), ([1], 3), ((1, 2), 2), ([1, 2], None),
                                 ("ab", 2), ([1, 2], 3)])
def test_list_and_shape_helpers_copy_matches_the_jax_package(x, n):
    from packnet_sfm_tpu.utils import misc as jmisc
    from packnet_sfm_tpu_torch.utils import misc as tmisc

    try:
        want = jmisc.make_list(x, n)
    except ValueError:
        with pytest.raises(ValueError, match="list length"):
            tmisc.make_list(x, n)
    else:
        assert tmisc.make_list(x, n) == want
    for a, b in (((2, 3), (2, 3)), ((2, 3), [2, 3]), ((2, 3), (2, 4)), ((2,), (2, 1)), ((), ())):
        assert tmisc.same_shape(a, b) == jmisc.same_shape(a, b)


def test_encoder_artifact_copy_matches_the_jax_package(tmp_path):
    from packnet_sfm_tpu.utils import torch_import as jti
    from packnet_sfm_tpu_torch.utils import torch_import as tti

    rng = np.random.default_rng(6)
    kernel = rng.normal(size=(7, 7, 3, 64)).astype(np.float32)
    for n in (1, 2, 3):
        np.testing.assert_array_equal(tti.adapt_conv1_multiimage(kernel, n),
                                      jti.adapt_conv1_multiimage(kernel, n))
    params = {"conv1": {"kernel": kernel}, "layer1_0": {"conv1": {"kernel": kernel[..., :8]}}}
    stats = {"bn1": {"mean": rng.normal(size=64), "var": rng.uniform(size=64)}}
    path = str(tmp_path / "enc.npz")
    jti.save_encoder_artifact(path, params, stats)
    ours, theirs = tti.load_encoder_artifact(path), jti.load_encoder_artifact(path)
    for a, b in zip(ours, theirs):
        fa, fb = tti._flatten_tree(a), jti._flatten_tree(b)
        assert fa.keys() == fb.keys() and len(fa) > 0
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    assert tti._unflatten_tree(tti._flatten_tree(params)).keys() == params.keys()


def test_trainer_and_clis_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    import json

    from packnet_sfm_tpu_torch.cli import eval as eval_cli
    from packnet_sfm_tpu_torch.cli import evaluate_depth_maps as edm_cli
    from packnet_sfm_tpu_torch.cli import infer as infer_cli
    from packnet_sfm_tpu_torch.cli import train as train_cli
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.train(path)
    # the depth-map CLI asks for the device before it reads a file
    with pytest.raises(RuntimeError, match="device='cpu'"):
        edm_cli.evaluate_folders(str(tmp_path / "none"), str(tmp_path / "none"))
    assert eval_cli.parse_args(["--checkpoint", path]).device == "cuda"
    assert infer_cli.parse_args(["--checkpoint", path, "--input", "a",
                                 "--output", "b"]).device == "cuda"
    assert train_cli.parse_args([path]).device == "cuda"
    assert edm_cli.parse_args(["--pred_folder", "a", "--gt_folder", "b"]).device == "cuda"
