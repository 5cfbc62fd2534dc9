"""The port's depth metrics (packnet_sfm_tpu_torch/engine/metrics.py) against
the JAX package's, on the same seeded ground truth and predictions, float32
on the CPU.

Tolerances, and what was measured on a CPU:
- ``compute_depth_metrics_per_sample`` and ``compute_depth_metrics``: rtol
  1e-5, atol 1e-6 (measured: at most 4.9e-7 relative; the sums over pixels
  run in another order);
- ``_masked_lower_median``: the same value, exactly (both sort the same
  float32 values and pick the same element);
- ``garg_crop_mask``: equal;
- ``post_process_inv_depth``: atol 1e-6 on inverse depths in [0.05, 2]
  (measured 0: the same float32 formulas, and the ramp's x is i / (w - 1)
  as ``jnp.linspace`` computes it).
"""

import numpy as np
import pytest
import torch

from packnet_sfm_tpu.engine import metrics as jm
from packnet_sfm_tpu_torch.engine import metrics as tm

torch.set_num_threads(1)


def _gt_pred(seed, b, gh, gw, ph, pw, density=0.3):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 90.0, size=(b, gh, gw, 1)).astype(np.float32)
    gt = (depth * (rng.uniform(size=depth.shape) < density)).astype(np.float32)
    pred = rng.uniform(0.5, 60.0, size=(b, ph, pw, 1)).astype(np.float32)
    return gt, pred


# (gt H, W), (pred H, W): same size, pred at half the ground truth's size,
# and KITTI's 192x640 against 375x1242 scaled down by 5
SHAPES = {"same": ((24, 40), (24, 40)), "half": ((24, 40), (12, 20)),
          "kitti-by-5": ((75, 248), (38, 128))}


@pytest.mark.parametrize("use_gt_scale", [True, False], ids=["gt-scale", "no-scale"])
@pytest.mark.parametrize("crop", ["garg", ""], ids=["garg", "no-crop"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("scale_output", ["resize", "top-center"])
def test_per_sample_metrics_match_jax(scale_output, shape, crop, use_gt_scale):
    (gh, gw), (ph, pw) = SHAPES[shape]
    gt, pred = _gt_pred(0, 3, gh, gw, ph, pw)
    gt[1] = 0.0                                   # a sample with no valid pixel
    cfg = dict(crop=crop, min_depth=0.0, max_depth=80.0, scale_output=scale_output)
    want = np.asarray(jm.compute_depth_metrics_per_sample(
        gt, pred, jm.DepthMetricsConfig(**cfg), use_gt_scale=use_gt_scale))
    got = tm.compute_depth_metrics_per_sample(
        torch.from_numpy(gt), torch.from_numpy(pred), tm.DepthMetricsConfig(**cfg),
        use_gt_scale=use_gt_scale).numpy()
    assert got.shape == (3, 7)
    # top-center pads a smaller prediction with zeros: where those meet valid
    # ground truth, rmse_log is +inf in both packages
    if scale_output == "resize" or shape == "same":
        assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1], np.zeros(7, np.float32))
    assert np.all(got[[0, 2]] != 0)


@pytest.mark.parametrize("use_gt_scale", [True, False])
def test_depth_range_masking_and_batch_mean_match_jax(use_gt_scale):
    gt, pred = _gt_pred(1, 4, 30, 44, 15, 22, density=0.5)
    cfg = dict(crop="", min_depth=2.0, max_depth=20.0, scale_output="resize")
    want = np.asarray(jm.compute_depth_metrics(
        gt, pred, jm.DepthMetricsConfig(**cfg), use_gt_scale=use_gt_scale))
    got = tm.compute_depth_metrics(
        torch.from_numpy(gt), torch.from_numpy(pred), tm.DepthMetricsConfig(**cfg),
        use_gt_scale=use_gt_scale).numpy()
    assert got.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the range matters: the default range gives other numbers
    wide = tm.compute_depth_metrics(torch.from_numpy(gt), torch.from_numpy(pred),
                                    tm.DepthMetricsConfig(crop=""),
                                    use_gt_scale=use_gt_scale).numpy()
    assert np.abs(wide - got).max() > 1e-3


MEDIAN_CASES = {
    "odd": (np.array([5.0, 1.0, 4.0, 2.0, 3.0, 9.0, 7.0]), np.array([1, 1, 1, 1, 1, 0, 0])),
    "even": (np.array([5.0, 1.0, 4.0, 2.0, 3.0, 9.0, 7.0]), np.array([1, 1, 1, 1, 0, 0, 0])),
    "ties": (np.array([2.0, 2.0, 1.0, 2.0, 3.0, 3.0, 1.0]), np.array([1, 1, 1, 1, 1, 1, 0])),
    "one": (np.array([8.0, 1.0, 4.0, 2.0, 3.0, 9.0, 7.0]), np.array([0, 0, 0, 0, 0, 0, 1])),
    "none": (np.array([5.0, 1.0, 4.0, 2.0, 3.0, 9.0, 7.0]), np.zeros(7)),
}


def test_masked_lower_median_is_the_same_element():
    values = np.stack([v for v, _ in MEDIAN_CASES.values()]).astype(np.float32)
    masks = np.stack([m for _, m in MEDIAN_CASES.values()]).astype(np.float32)
    rng = np.random.default_rng(2)
    big = rng.uniform(0, 80, size=(3, 4001)).astype(np.float32)
    big_mask = (rng.uniform(size=big.shape) < 0.4).astype(np.float32)
    for v, m in ((values, masks), (big, big_mask)):
        got = tm._masked_lower_median(torch.from_numpy(v), torch.from_numpy(m)).numpy()
        want = np.array([np.asarray(jm._masked_lower_median(vi, mi)) for vi, mi in zip(v, m)])
        np.testing.assert_array_equal(got, want)
    got = tm._masked_lower_median(torch.from_numpy(values), torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got[:4], [3.0, 2.0, 2.0, 7.0])
    assert got[4] == np.inf                       # no valid entry: selected away by the caller


@pytest.mark.parametrize("hw", [(24, 40), (192, 640), (375, 1242), (5, 7)])
def test_garg_crop_mask_matches_jax(hw):
    got = tm.garg_crop_mask(*hw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.garg_crop_mask(*hw)))
    assert got.dtype == np.float32


@pytest.mark.parametrize("method", ["mean", "max", "min"])
def test_post_process_inv_depth_matches_jax(method):
    rng = np.random.default_rng(3)
    inv = rng.uniform(0.05, 2.0, size=(2, 12, 41, 1)).astype(np.float32)
    inv_flipped = rng.uniform(0.05, 2.0, size=(2, 12, 41, 1)).astype(np.float32)
    want = np.asarray(jm.post_process_inv_depth(inv, inv_flipped, method=method))
    got = tm.post_process_inv_depth(torch.from_numpy(inv), torch.from_numpy(inv_flipped),
                                    method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown post-process"):
        tm.fuse_inv_depth(torch.from_numpy(inv), torch.from_numpy(inv), method="median")
