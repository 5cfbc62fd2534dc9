"""The rest of the JAX package's kinds on the port's (data x space) grid
(``make_train_step(..., mesh=make_mesh_2d(S))``): VelSupModel, SemiSupModel
and GenericSelfSupModel (NRS, through the band form of the soft-argmax),
with the band ops they need (``parallel/spatial.take_rows``, ``share``,
``max_over``; the band resizes of ``ops/image.interpolate_image``; the
band forms of ``ops/softargmax``; the supervised loss on a band), against
the same ops on whole tensors, the port's one-process step and the JAX
package's step on the global batch.

Two launches of tests/torch_spatial_kinds_worker.py, one after the other,
each ``torch.distributed.run --standalone`` on gloo ranks of the CPU under a
hard timeout of 120 s, after which every process of the launch is killed:
two ranks (space 2), then four (space 4, then data 2 x space 2). The
references are computed here meanwhile: the NRS references beside the
first, JAX's VelSup and SemiSup steps beside the second.

Tolerances, and what was measured on a CPU (float32; ``PYTHONPATH=. python
tests/test_torch_spatial_kinds.py`` prints them):
- (a) the band form of the plain soft-argmax at the 64x48 grid of a 128x96
  image, p = 20, T = 0.05 and 1e-4, on 2 bands and on 4 (16 rows a band,
  shallower than a window's reach of 20: the ray slab gathers the whole),
  against the rows of the whole: ex, ey and d direction within 1e-6 of the
  largest (measured 0, the same bits), the bands' d rays summed through the
  halo's backward within 1e-6 of the largest (measured at most 7.6e-8).
  The band two-gather form of the backward kernel's d rays role
  (``transposed_window_bounds`` cut to the band) covers exactly the pixels
  that hold each ray.
- (b) the band resizes (bilinear align_corners down by 2, up by 2 and to
  40x30; nearest down and up) against the rows of the whole: forward and
  input gradient within 1e-6 of the largest (measured 0 and at most 7.4e-8).
- (c) the ten supervised methods (l1, mse, berhu, silog, abs_rel, dense
  and ``sparse-``) over 4 scales on 2 bands, the ground truth whole at
  75x124: the shares summed over the group against the whole loss, rtol
  1e-6 (measured at most 1.0e-7), the predictions' gradients within 1e-6 of
  the largest (2.4e-7).
- (d) DepthResNet-18 + PoseNet at 64x96, batch 8 (data rank 1's rows
  brighter), from JAX's weights, one Adam step on data 2 x space 2: VelSup
  (velocity weight 0.1), SemiSup at w = 0.9 with ``sparse-berhu`` and with
  ``silog``, against JAX's step on the global batch (one device): the mean
  of the data ranks' losses and of each term rtol 1e-5 (measured at most
  4.7e-7; the velocity term equal), the BatchNorm running statistics
  within 1e-5 of their largest (1.4e-6), the update cosine >= 0.9999 (at
  least 0.999992). The supervised sums and BerHu's threshold are the global
  batch's on every rank, as JAX takes them. (JAX's own mesh_2d step misses
  that last bound for BatchNorm networks, ROADMAP.md §3 (u).)
- (e) NRS (configs/train_omnicam.yaml's RaySurfaceResNet-18 + PoseNet,
  128x96, batch 2, progress 0.3, float32) on space 2, one Adam step,
  against the port's one-process step and JAX's step on the global batch.
  The objective is chaotic at T ~ 1e-4 (tests/test_torch_train_step.py):
  the port's own floor, one process from weights perturbed by a relative
  1e-7, is a loss 5.5e-7 apart and an update cosine of 0.9828. The bounds
  sit under it: loss rtol 1e-4, update cosine >= 0.96 (measured 6.9e-7 and
  0.9907 against one process, 1.3e-5 and 0.9872 against JAX).
- (f) the control: (e) with the rows of the ray slab from the other band
  replaced by zeros misses both bounds (measured the loss 5.7e-3 apart,
  the update cosine 0.571).
- (g) SemiSupCompletionModel is refused on a space axis, on every rank,
  with a message that names ROADMAP.md §3 faults (m), (n) and (o).
"""

import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import merge_config as jax_merge_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.train import TrainState, make_train_step as jax_make_train_step
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.parallel.mesh import make_mesh, shard_batch
from packnet_sfm_tpu_torch.core.config import OMNICAM, config_from_dict
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.models.sfm import check_band
from packnet_sfm_tpu_torch.ops.softargmax import (
    ray_slab,
    softargmax_coords_plain,
    transposed_window_bounds,
)
from packnet_sfm_tpu_torch.parallel.spatial import Band
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.test_torch_distributed import _jax_batch, _jax_model, _resnet_batch, _smooth
from tests.torch_spatial_kinds_worker import SUPERVISED_METHODS, train_step
from tests.torch_cleanup import remove_tmp_path, remove_tree  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_spatial_kinds_worker.py")
LAUNCH_TIMEOUT = 120
NRS_H, NRS_W = 128, 96
NRS_PROGRESS = 0.3


def _kind(name, **loss):
    return {"model": {"name": name, "depth_net": {"name": "DepthResNet", "version": "18"},
                      "pose_net": {"name": "PoseNet"}, "loss": {"flip_lr_prob": 0.0, **loss}}}


KINDS = {
    "velsup": _kind("VelSupModel", velocity_loss_weight=0.1),
    "semisup_berhu": _kind("SemiSupModel", supervised_loss_weight=0.9,
                           supervised_method="sparse-berhu"),
    "semisup_silog": _kind("SemiSupModel", supervised_loss_weight=0.9,
                           supervised_method="silog"),
}
SAN = {"model": {"name": "SemiSupCompletionModel",
                 "depth_net": {"name": "PackNetSAN01", "version": "1A"},
                 "pose_net": {"name": "PoseNet"}}}
TERMS = {"velsup": ("photometric_loss", "smoothness_loss", "velocity_loss"),
         "semisup_berhu": ("photometric_loss", "smoothness_loss", "supervised_loss"),
         "semisup_silog": ("photometric_loss", "smoothness_loss", "supervised_loss")}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _flat(state, keys):
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


def _update_cos(state0, a, b):
    keys = sorted(k for k in state0 if "running_" not in k)
    p0 = _flat(state0, keys)
    u, v = _flat(a, keys) - p0, _flat(b, keys) - p0
    return float(u @ v / np.linalg.norm(u) / np.linalg.norm(v))


def _stats_err(a, b):
    keys = sorted(k for k in a if "running_" in k)
    sa, sb = _flat(a, keys), _flat(b, keys)
    return float(np.abs(sa - sb).max() / np.abs(sb).max())


def _kinds_batch():
    """The 8 rows of tests/test_torch_distributed.py (rank 1's brighter)
    with a sparse ground truth (0 below 20 m) and OXTS-like context poses
    whose translations differ by row."""
    batch = _resnet_batch()
    rng = np.random.default_rng(4)
    depth = (rng.uniform(size=(8, 64, 96, 1)) * 60).astype(np.float32)
    depth[depth < 20] = 0.0
    poses = []
    for scale in (1.0, -0.6):
        T = np.broadcast_to(np.eye(4, dtype=np.float32), (8, 4, 4)).copy()
        T[:, :3, 3] = scale * rng.uniform(0.2, 1.5, size=(8, 3)).astype(np.float32)
        poses.append(T)
    return dict(batch, depth=depth, pose_context=poses)


def _nrs_batch():
    rng = np.random.default_rng(6)
    return {"rgb": _smooth(rng, 2, NRS_H, NRS_W),
            "rgb_context": [_smooth(rng, 2, NRS_H, NRS_W) for _ in range(2)]}


def _save_batch(path, batch):
    np.savez(path, **{k: v for k, v in batch.items() if k not in ("rgb_context",
                                                                  "pose_context")},
             **{f"ctx{i}": c for i, c in enumerate(batch.get("rgb_context", []))},
             **{f"pose{i}": p for i, p in enumerate(batch.get("pose_context", []))})


def _jax_global_step(cfg_dict, variables, batch, progress=0.0):
    """JAX's Adam step from ``variables`` on the whole batch, on a 1-device
    mesh: (loss, {term: value}, state after under the port's names)."""
    jcfg = jax_merge_config(jax_default_config(), cfg_dict)
    jmodel = jax_factory.setup_model(jcfg.model)
    tx = jax_factory.make_optimizer(jcfg.model.optimizer, jcfg.model.scheduler, 1000)
    mesh1 = make_mesh(num_devices=1)
    variables = jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), variables)
    state, acc = jax_make_train_step(jmodel, tx, mesh1)(      # donates the state's buffers
        TrainState.create(variables, tx), jax_zero_metrics(),
        shard_batch(_jax_batch(batch), mesh1), progress=progress)
    terms = {k: float(v[0]) for k, v in acc.items() if float(v[1]) > 0}
    return float(acc["loss"][0]), terms, from_jax(_np_tree(state.params),
                                                  _np_tree(state.batch_stats))


def _perturbed(state0, seed=0):
    """``state0`` with every parameter moved by a relative 1e-7."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v if "running_" in k or not v.is_floating_point()
            else v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
            for k, v in state0.items()}


def _torchrun(n, data):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), WORKER, str(data)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        out, _ = proc.communicate()
        pytest.fail(f"a launch did not finish in {LAUNCH_TIMEOUT} s (deadlock?):\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]


def _run_all(data):
    """Both launches and every reference; ``data`` is an empty directory."""
    batch8, nrs2 = _kinds_batch(), _nrs_batch()
    _save_batch(data / "batch8.npz", batch8)
    _save_batch(data / "nrs2.npz", nrs2)
    torch.save(dict(KINDS, san=SAN, nrs=OMNICAM, nrs_progress=NRS_PROGRESS),
               data / "configs.pt")
    # JAX's initial weights: one draw serves the three kinds (the same networks)
    _, _, variables = _jax_model(KINDS["velsup"], batch8)
    resnet_state0 = from_jax(_np_tree(variables["params"]), _np_tree(variables["batch_stats"]))
    _, _, nrs_variables = _jax_model(OMNICAM, nrs2)
    nrs_state0 = from_jax(_np_tree(nrs_variables["params"]),
                          _np_tree(nrs_variables["batch_stats"]))
    torch.save(resnet_state0, data / "resnet_state0.pt")
    torch.save(nrs_state0, data / "nrs_state0.pt")
    # one launch at a time, each beside its references
    proc = _torchrun(2, data)
    nrs_jax = _jax_global_step(OMNICAM, nrs_variables, nrs2, NRS_PROGRESS)
    nrs_one = train_step(OMNICAM, nrs_state0, nrs2, progress=NRS_PROGRESS)
    nrs_floor = train_step(OMNICAM, _perturbed(nrs_state0), nrs2, progress=NRS_PROGRESS)
    _finish(proc)
    proc = _torchrun(4, data)
    jax_kinds = {kind: _jax_global_step(cfg, variables, batch8) for kind, cfg in KINDS.items()}
    _finish(proc)
    load = lambda r, n: torch.load(data / f"rank{r}_world{n}.pt", weights_only=False)  # noqa
    return dict(two=[load(r, 2) for r in range(2)], four=[load(r, 4) for r in range(4)],
                nrs_jax=nrs_jax, nrs_one=nrs_one, nrs_floor=nrs_floor, jax_kinds=jax_kinds,
                resnet_state0=resnet_state0, nrs_state0=nrs_state0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_kinds")
    yield _run_all(root)
    remove_tree(root)


# --- one process ----------------------------------------------------------------------

@pytest.mark.parametrize("n,patch,bands", [(64, 20, 2), (64, 20, 4), (192, 20, 2),
                                           (61, 20, 1), (12, 2, 3)])
def test_band_transposed_window_bounds_cover_the_band_pixels_that_hold_a_ray(n, patch,
                                                                           bands):
    """Cut to a band, the intervals of the d rays role are exactly the band's
    pixels whose windows hold each ray of the band's slab, and the slab is
    the least that holds every window of the band."""
    k = 2 * patch + 1
    start = (torch.arange(n) - patch).clamp(0, n - k)                # window start of pixel y
    for i in range(bands):
        row0, rows = i * (n // bands), n // bands if i < bands - 1 else n - i * (n // bands)
        first, stop = ray_slab(row0, rows, n, patch)
        ys = torch.arange(row0, row0 + rows)
        assert first == int(start[ys].min()) and stop == int(start[ys].max()) + k
        lo, hi = transposed_window_bounds(n, patch, row0, rows, first, stop - first)
        r = torch.arange(first, stop)[:, None]
        holds = (start[ys][None, :] <= r) & (r < start[ys][None, :] + k)     # [ray, pixel]
        y = torch.arange(rows)[None, :]
        assert torch.equal(holds, (lo[:, None] <= y) & (y <= hi[:, None]))
        assert bool((hi >= lo).all())                # every ray of the slab is held


def test_the_plain_band_form_refuses_a_slab_that_misses_a_window():
    d = torch.randn(1, 3, 8, 48)
    d = d / d.norm(dim=1, keepdim=True)
    first, stop = ray_slab(16, 8, 64, 20)
    rays = torch.randn(1, 3, stop - first, 48)
    softargmax_coords_plain(d, rays, 0.05, 20, row0=16, height=64, ray_row0=first)
    with pytest.raises(ValueError, match="needs the ray rows"):
        softargmax_coords_plain(d, rays[:, :, 1:], 0.05, 20, row0=16, height=64,
                                ray_row0=first + 1)


def test_check_band_refuses_completion_naming_its_faults():
    model = setup_model(config_from_dict(SAN).model, device="cpu")
    with pytest.raises(ValueError, match=r"SemiSupCompletionModel.*\(m\).*\(n\).*\(o\)"):
        check_band(model, 64, Band(None, 0, 2))
    for kind in ("SfmModel", "GenericSfmModel"):
        model.kind = kind
        with pytest.raises(ValueError, match="does not run on a space axis"):
            check_band(model, 64, Band(None, 0, 2))


# --- (a)-(c): the ops on 2 and 4 bands --------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("temperature", ["0.05", "0.0001"])
def test_a_band_softargmax_matches_the_rows_of_the_whole(runs, world, temperature):
    for r in runs["two" if world == 2 else "four"]:
        got = r["ops"][f"softargmax_T{temperature}"]
        assert got["forward"] <= 1e-6 and got["d_direction"] <= 1e-6, got
        assert got["d_rays"] <= 1e-6, got


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["bilinear_down", "bilinear_up", "bilinear_odd",
                                  "nearest_down", "nearest_up"])
def test_b_band_resize_matches_the_rows_of_the_whole(runs, world, case):
    for r in runs["two" if world == 2 else "four"]:
        got = r["ops"][f"resize_{case}"]
        assert got["forward"] <= 1e-6 and got["input_grad"] <= 1e-6, got


@pytest.mark.parametrize("method", SUPERVISED_METHODS)
def test_c_supervised_shares_sum_to_the_whole_loss(runs, method):
    for r in runs["two"]:
        got = r["ops"][f"supervised_{method}"]
        assert got["loss"] <= 1e-6 and got["grads"] <= 1e-6, got


# --- (d): VelSup and SemiSup on data 2 x space 2 against JAX's global batch ----------------

def _grid_mean(runs, kind, key=None):
    four = runs["four"]
    pick = (lambda r: r[kind]["loss"]) if key is None else (lambda r: r[kind]["metrics"][key])
    return float(np.mean([pick(four[0]), pick(four[2])]))


@pytest.mark.parametrize("kind", list(KINDS))
def test_d_kind_on_data_2_space_2_matches_jax_global_batch(runs, kind):
    four = runs["four"]
    assert [r["grid"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four[1:]:                          # the ranks stay one model
        for key, v in four[0][kind]["state"].items():
            assert torch.equal(v, r[kind]["state"][key]), key
    assert four[0][kind]["loss"] == four[1][kind]["loss"]
    j_loss, j_terms, j_after = runs["jax_kinds"][kind]
    np.testing.assert_allclose(_grid_mean(runs, kind), j_loss, rtol=1e-5)
    for term in TERMS[kind]:
        np.testing.assert_allclose(_grid_mean(runs, kind, term), j_terms[term], rtol=1e-5,
                                   err_msg=term)
    got = four[0][kind]["state"]
    assert _stats_err(got, j_after) <= 1e-5
    assert _update_cos(runs["resnet_state0"], got, j_after) >= 0.9999


# --- (e), (f): NRS on space 2 -------------------------------------------------------------

def _nrs_figures(runs):
    state0, two = runs["nrs_state0"], runs["two"]
    out = {}
    for name, (loss, after) in (
            ("floor", (runs["nrs_floor"]["loss"], runs["nrs_floor"]["state"])),
            ("one", (two[0]["nrs"]["loss"], two[0]["nrs"]["state"])),
            ("jax", (two[0]["nrs"]["loss"], two[0]["nrs"]["state"])),
            ("zero_halo", (two[0]["nrs_zero_halo"]["loss"], two[0]["nrs_zero_halo"]["state"]))):
        ref_loss, ref_after = ((runs["nrs_jax"][0], runs["nrs_jax"][2]) if name == "jax"
                               else (runs["nrs_one"]["loss"], runs["nrs_one"]["state"]))
        out[name] = (abs(loss - ref_loss) / abs(ref_loss), _update_cos(state0, after, ref_after))
    return out


def test_e_nrs_step_on_space_2_matches_one_process_and_jax(runs):
    a, b = (r["nrs"] for r in runs["two"])
    for key, v in a["state"].items():
        assert torch.equal(v, b["state"][key]), key
    assert a["loss"] == b["loss"]
    figures = _nrs_figures(runs)
    for name in ("one", "jax"):
        loss_rel, cos = figures[name]
        assert loss_rel <= 1e-4 and cos >= 0.96, (name, figures)
    # the bounds sit under the port's own floor
    assert figures["floor"][0] <= 1e-4 and figures["floor"][1] >= 0.96, figures


def test_f_control_a_zeroed_ray_halo_misses(runs):
    loss_rel, cos = _nrs_figures(runs)["zero_halo"]
    assert loss_rel > 1e-4 or cos < 0.96, (loss_rel, cos)


# --- (g) ----------------------------------------------------------------------------------

def test_g_completion_is_refused_on_every_rank(runs):
    for r in runs["four"]:
        assert r["refused"] is not None and "(m)" in r["refused"], r["refused"]


if __name__ == "__main__":
    import pathlib
    import tempfile

    import tests.conftest  # noqa: F401 (JAX on the CPU, with the 8 devices of the tests)

    with tempfile.TemporaryDirectory() as tmp:
        res = _run_all(pathlib.Path(tmp))
    for world in ("two", "four"):
        for case in res[world][0]["ops"]:
            print(world, case, [r["ops"][case] for r in res[world]])
    for kind in KINDS:
        j_loss, j_terms, j_after = res["jax_kinds"][kind]
        got = res["four"][0][kind]["state"]
        print(f"(d) {kind}: loss rel {abs(_grid_mean(res, kind) - j_loss) / j_loss:.3e}",
              {t: abs(_grid_mean(res, kind, t) - j_terms[t]) / abs(j_terms[t])
               for t in TERMS[kind]},
              f"stats {_stats_err(got, j_after):.3e}",
              f"update cos {_update_cos(res['resnet_state0'], got, j_after):.7f}")
    print("(e), (f) (loss rel, update cos):", _nrs_figures(res))
    print("(g)", res["four"][0]["refused"])
