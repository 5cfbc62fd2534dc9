"""Rules of the port package (packnet_sfm_tpu_torch):

- importing any of its modules leaves ``jax`` and ``packnet_sfm_tpu`` out of
  ``sys.modules``, and no source of it (nor chip_smoke.py) imports them;
- entry points run on CUDA by default and raise without it, unless the
  caller asks for the CPU; the kernel wrappers raise on a non-CUDA tensor;
- its own copies of host modules agree with the JAX package's: the OMNICAM
  and KITTI dicts with configs/train_omnicam.yaml and configs/train_kitti.yaml,
  the synthetic dataset sample for sample;
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
