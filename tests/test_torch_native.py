"""The port's native image decode (``packnet_sfm_tpu_torch/native``, built
from its own copy of ``image_pipeline.cpp`` into ``build/native/``) against
the JAX package's (``packnet_sfm_tpu/native``, built from ``native/``) and
against Pillow, on the files of tests/test_native.py: noise PNGs and JPEGs
(quality 95) and a grayscale PNG, plus a smooth photograph-like JPEG.

Tolerances: the two native decoders are one source compiled twice, so they
agree bit for bit; against Pillow, tests/test_native.py's: 0 levels for PNG,
6 for JPEG (libjpeg builds may differ in their IDCT and upsampling).
"""

import numpy as np
import pytest
from PIL import Image

from packnet_sfm_tpu import native as jax_native
from packnet_sfm_tpu_torch import native
from packnet_sfm_tpu_torch.datasets.kitti import load_image, load_image_u8
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def built():
    if not native.native_available():
        pytest.skip(f"native toolchain unavailable: {native.build_error()}")
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library is unavailable")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    files = []
    for i, ext in enumerate(["png", "jpg", "png", "jpg"]):
        arr = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
        p = str(d / f"img{i}.{ext}")
        Image.fromarray(arr).save(p, quality=95)
        files.append(p)
    gray = (rng.uniform(size=(16, 24)) * 255).astype(np.uint8)
    p = str(d / "gray.png")
    Image.fromarray(gray, mode="L").save(p)
    files.append(p)
    ys, xs = np.mgrid[:60, :90]
    smooth = np.stack([np.sin(xs / 9.0 + c) * np.cos(ys / 7.0) for c in range(3)], -1)
    smooth = np.clip(127 + 100 * smooth + rng.normal(0, 3, smooth.shape), 0, 255)
    p = str(d / "smooth.jpg")
    Image.fromarray(smooth.astype(np.uint8)).save(p, quality=90)
    files.append(p)
    return files


def test_the_library_builds_from_the_ports_copy(built):
    root = native.SOURCE.parents[2]
    assert native.SOURCE == root / "packnet_sfm_tpu_torch" / "native" / "image_pipeline.cpp"
    path = native.library_path()
    assert path.parent == root / "build" / "native" and path.exists()
    assert native.decoder() == "native" and native.build_error() is None
    assert native.load_native().pn_thread_count() >= 2


def test_decode_equals_the_jax_packages_native_decode(built, image_files):
    for p in image_files:
        ours, theirs = native.decode_image(p), jax_native.decode_image(p)
        assert ours.dtype == np.uint8 and ours.shape[2] == 3
        np.testing.assert_array_equal(ours, theirs, err_msg=p)


def test_decode_against_pillow(built, image_files):
    for p in image_files:
        got = native.decode_image(p)
        ref = np.asarray(Image.open(p).convert("RGB"))
        assert got.shape == ref.shape
        tol = 0 if p.endswith("png") else 6
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= tol, p
        np.testing.assert_array_equal(load_image_u8(p), got)
        np.testing.assert_array_equal(load_image(p), got.astype(np.float32) / 255.0)


def test_decode_grows_its_buffer_for_a_large_image(built, tmp_path, monkeypatch):
    p = str(tmp_path / "big.png")
    arr = np.random.default_rng(2).integers(0, 256, size=(70, 90, 3), dtype=np.uint8)
    Image.fromarray(arr).save(p)
    monkeypatch.setattr(native, "_decode_tls", type(native._decode_tls)())
    native._decode_tls.buf = np.empty(100, np.uint8)       # smaller than the image
    np.testing.assert_array_equal(native.decode_image(p), arr)
    assert native._decode_tls.buf.size == arr.size


def test_load_image_batch_equals_the_jax_packages(built, image_files):
    for h, w in ((40, 56), (20, 28), (64, 80)):
        ours = native.load_image_batch(image_files, h, w)
        theirs = jax_native.load_image_batch(image_files, h, w)
        assert ours.shape == (len(image_files), h, w, 3) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_missing_files(built, tmp_path):
    with pytest.raises(IOError):
        native.load_image_batch([str(tmp_path / "none.png")], 8, 8)
    assert native.decode_image(str(tmp_path / "none.png")) is None


def test_a_failed_build_falls_back_to_pillow_loudly(tmp_path, monkeypatch, capsys, image_files):
    broken = tmp_path / "image_pipeline.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.decoder() == "pillow"
    assert native.decode_image(image_files[0]) is None
    printed = capsys.readouterr().out
    assert printed.count("native image decode unavailable, decoding with Pillow") == 1
    assert "exited with" in native.build_error()
    for p in image_files:       # the readers decode with Pillow
        np.testing.assert_array_equal(load_image_u8(p), np.asarray(Image.open(p).convert("RGB")))
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.load_image_batch(image_files, 8, 8)
    assert capsys.readouterr().out == ""         # said once


# --- the pose-graph solver (posegraph_solver.cpp) -------------------------------------
#
# Tolerances: the native solver works in float64 with central-difference
# Jacobians, the pose graphs in float32 with forward-mode ones: poses atol
# 5e-3, tests/test_native.py's bound (measured 2.4e-7 against the port,
# 3.5e-7 against JAX). The cost rtol 0.05, tests/test_native.py's bound,
# holds a difference of definition, not of rounding (measured 1.2e-2): the
# native cost sums (w r)^2 over the edges, the pose graphs' sum w r^2, and
# this graph's loop edges weigh 3. The two float32 solves against each
# other as tests/test_torch_egomotion.py holds them (measured 4.8e-7).

def _graph():
    import jax.numpy as jnp

    from packnet_sfm_tpu.egomotion.posegraph import chain_relative_poses
    from tests.test_egomotion import make_edges, make_trajectory

    rng = np.random.default_rng(1)
    gt = make_trajectory(rng, 8)
    edges = {k: np.asarray(v) for k, v in make_edges(gt, rng, noise=0.02, loop=True).items()}
    return np.asarray(chain_relative_poses(jnp.asarray(edges["Z"][:7]))), edges


def test_the_solver_builds_on_its_own_without_the_image_libraries():
    native.load_solver()
    path = native.library_path(native.SOLVER_SOURCE, "packnet_posegraph")
    assert path.parent == native.SOURCE.parents[2] / "build" / "native" and path.exists()
    assert native.SOLVER_SOURCE.read_text().count("#include") == 3      # cmath, cstring, vector


@pytest.mark.parametrize("optimize_scales", [True, False])
def test_native_solver_matches_both_pose_graphs(optimize_scales):
    import jax.numpy as jnp
    import torch

    from packnet_sfm_tpu.egomotion.posegraph import PoseGraphConfig as JaxConfig
    from packnet_sfm_tpu.egomotion.posegraph import optimize_pose_graph as jax_optimize
    from packnet_sfm_tpu_torch.egomotion.posegraph import PoseGraphConfig, optimize_pose_graph

    T_init, edges = _graph()
    T_nat, s_nat, c_nat = native.solve_pose_graph_native(
        T_init, edges, num_iterations=10, optimize_scales=optimize_scales)
    T_jax, _, c_jax = jax_optimize(jnp.asarray(T_init), {k: jnp.asarray(v) for k, v in edges.items()},
                                   JaxConfig(num_iterations=10, optimize_scales=optimize_scales))
    T_port, s_port, c_port = optimize_pose_graph(
        torch.from_numpy(T_init), {k: torch.from_numpy(v) for k, v in edges.items()},
        PoseGraphConfig(num_iterations=10, optimize_scales=optimize_scales))
    for T, c in ((T_port.numpy(), float(c_port)), (np.asarray(T_jax), float(c_jax))):
        np.testing.assert_allclose(T_nat, T, atol=5e-3)
        np.testing.assert_allclose(c_nat, c, rtol=0.05)
    assert s_nat.shape == (8,) and (optimize_scales or not s_nat.any())
    np.testing.assert_allclose(T_port.numpy(), np.asarray(T_jax), atol=1e-5)


def test_a_solver_that_does_not_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    broken = tmp_path / "posegraph_solver.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOLVER_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_solver", None)
    monkeypatch.setattr(native, "_solver_error", None)
    T_init, edges = _graph()
    with pytest.raises(RuntimeError, match="solver unavailable.*exited with"):
        native.solve_pose_graph_native(T_init, edges)
