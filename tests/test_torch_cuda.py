"""CUDA kernels K6f/K6b (csrc/softargmax.cu) and warp_fwd/warp_bwd
(csrc/warp.cu) against their plain PyTorch versions, on the card. Skipped
where there is no CUDA device; run there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Shapes cover a width and a height that are not multiples of the kernels'
32 x 3 tile, an image exactly one window tall and wide (every window
clamped on all four borders), widths and a height between k and 3p + 1
(where the backward's interval of pixels that hold a ray is cut short by
the image on both sides), a window narrower than four positions, a window
so large that what a block stages goes in pieces, several batches and both
temperatures.
Tolerances (coordinates in pixels; gradients relative to their largest
magnitude): T = 0.05, 2e-3 px and 3e-4; T = 1e-4, 0.1 px and 5e-3 — at
T = 1e-4 near-tied window positions turn the f32 rounding of the logits
(which the kernel and the plain version sum in different orders) into
weight changes of ~1e-3 between positions up to 40 px apart, where the
gradients are largest (p(1-p)/T). Measured on an H100 over these cases:
T = 0.05, 3.1e-5 px and 2.8e-5 at p <= 20; T = 1e-4, 0.015 px and 5.8e-4.
The p = 90 case sums 32761 window positions a pixel and is given 1e-3
(measured 3.8e-4 px and 3.7e-4). The backward sums d direction and d rays
in one fixed order each (two gathers, no atomics): every case is run twice
and both gradients must come back bit for bit the same.

The warp cases cover both padding modes, one and several channels, an output
grid of another size than the image, coordinates that leave the image on
every side, exact integer positions and the corners -1/+1. Tolerances:
values 1e-5 (images in [0, 1); only fused multiply-adds round differently);
gradients 1e-4 of their largest magnitude (d coords sums the channels in
another order; d image is summed with atomics).

The eval step (PackNetSlim01-1A, random weights) on the card against the
CPU, same weights and batch, at 64x96 with the ground truth at 75x124 and
at 32x64 with it at the input's size: continuous metrics rtol 1e-3, a1-a3
within 2 / n_valid, as chip_smoke.py holds the full-width PackNet01; the
eval path launches none of the port's kernels.
"""

import pytest
import torch

from packnet_sfm_tpu_torch.ops import softargmax as sa
from packnet_sfm_tpu_torch.ops import warp

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

CASES = [((2, 24, 48), 4, 0.05), ((1, 45, 70), 20, 0.05), ((1, 41, 41), 20, 0.05),
         ((2, 64, 96), 20, 1e-4),
         ((3, 43, 77), 20, 0.05), ((3, 50, 45), 20, 1e-4), ((1, 41, 41), 20, 1e-4),
         ((2, 7, 35), 1, 0.05), ((1, 3, 3), 0, 0.05), ((1, 190, 260), 90, 0.05),
         ((1, 192, 192), 20, 1e-4),
         # k <= w < 3p + 1, k <= h < 3p + 1, both, and a width just past 3p + 1
         ((1, 64, 50), 20, 1e-4), ((2, 55, 96), 20, 0.05), ((1, 44, 60), 20, 1e-4),
         ((1, 70, 62), 20, 0.05), ((2, 9, 8), 3, 0.05)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _unit(gen, shape, device):
    v = torch.randn(shape, generator=gen)
    return (v / v.norm(dim=1, keepdim=True)).to(device)


@pytest.mark.parametrize("bhw,patch,temperature", CASES)
def test_kernels_match_plain(device, bhw, patch, temperature):
    b, h, w = bhw
    gen = torch.Generator().manual_seed(0)
    d, r = _unit(gen, (b, 3, h, w), device), _unit(gen, (b, 3, h, w), device)
    gx, gy = (torch.randn((b, h, w), generator=gen).to(device) for _ in range(2))
    px_tol, grad_tol = (2e-3, 3e-4) if temperature >= 1e-2 else (0.1, 5e-3)
    if patch > 20:
        grad_tol = 1e-3         # 181 x 181 positions a sum: measured 3.7e-4

    before = dict(sa.launch_counts)
    dk, rk = d.clone().requires_grad_(), r.clone().requires_grad_()
    ex, ey = sa.softargmax_coords(dk, rk, temperature, patch)
    ((ex * gx).sum() + (ey * gy).sum()).backward()
    torch.cuda.synchronize()
    assert sa.launch_counts["softargmax_fwd"] == before["softargmax_fwd"] + 1
    assert sa.launch_counts["softargmax_bwd"] == before["softargmax_bwd"] + 1

    dp, rp = d.clone().requires_grad_(), r.clone().requires_grad_()
    ex_p, ey_p = sa.softargmax_coords_plain(dp, rp, temperature, patch)
    ((ex_p * gx).sum() + (ey_p * gy).sum()).backward()
    assert (ex - ex_p).abs().max().item() <= px_tol
    assert (ey - ey_p).abs().max().item() <= px_tol
    for got, want in ((dk.grad, dp.grad), (rk.grad, rp.grad)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= grad_tol * want.abs().max().item()


@pytest.mark.parametrize("bhw,patch,temperature", CASES)
def test_backward_is_deterministic(device, bhw, patch, temperature):
    b, h, w = bhw
    gen = torch.Generator().manual_seed(0)
    d, r = _unit(gen, (b, 3, h, w), device), _unit(gen, (b, 3, h, w), device)
    gx, gy = (torch.randn((b, h, w), generator=gen).to(device) for _ in range(2))
    ex, ey, m, s = sa.softargmax_fwd_cuda(d, r, temperature, patch)
    first = sa.softargmax_bwd_cuda(d, r, temperature, patch, ex, ey, m, s, gx, gy)
    first = [t.clone() for t in first]
    # NaNs in what the allocator hands out next: the kernel must write it all
    junk = [torch.full_like(d, float("nan")) for _ in range(4)]
    del junk
    second = sa.softargmax_bwd_cuda(d, r, temperature, patch, ex, ey, m, s, gx, gy)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.isfinite(c).all()
        assert torch.equal(a, c)


def test_wrapper_checks(device):
    d = torch.randn(1, 3, 30, 30, device=device)
    with pytest.raises(ValueError):
        sa.softargmax_fwd_cuda(d, d, 0.05, 20)          # window 41 > 30
    with pytest.raises(ValueError):
        sa.softargmax_fwd_cuda(d.double(), d.double(), 0.05, 4)
    with pytest.raises(ValueError):
        sa.softargmax_fwd_cuda(d.transpose(2, 3), d, 0.05, 4)


WARP_CASES = [((1, 12, 20, 3), (10, 16)), ((8, 48, 160, 3), (48, 160)),
              ((2, 33, 70, 1), (37, 75)), ((3, 5, 7, 4), (64, 96)),
              # pixel counts that are no multiple of the 256-thread block, odd ones
              # too, for C = 1, 3 (the compiled channel counts) and 4, 2 (the loop)
              ((3, 33, 71, 3), (37, 75)), ((2, 9, 11, 1), (31, 33)), ((2, 20, 12, 4), (17, 19)),
              ((1, 6, 1, 3), (5, 300)), ((2, 16, 24, 2), (16, 24)), ((8, 96, 320, 3), (96, 320))]


def _warp_inputs(shape, out_hw, device):
    b, h, w, c = shape
    ho, wo = out_hw
    gen = torch.Generator().manual_seed(0)
    image = torch.rand(shape, generator=gen)
    coords = (torch.rand((b, ho, wo, 2), generator=gen) * 2 - 1) * 1.4
    coords[0, 0, :9] = torch.tensor([[-1., -1.], [1., 1.], [-1., 1.], [1., -1.], [0., 0.],
                                     [2. * 3 / max(w - 1, 1) - 1, 2. * 2 / (h - 1) - 1],
                                     [5., 5.], [-5., 0.], [0.5, -7.]])
    grad = torch.randn((b, ho, wo, c), generator=gen)
    return image.to(device), coords.to(device), grad.to(device)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape,out_hw", WARP_CASES)
def test_warp_kernels_match_plain(device, shape, out_hw, padding_mode):
    image, coords, grad = _warp_inputs(shape, out_hw, device)
    before = dict(warp.launch_counts)
    ik, ck = image.clone().requires_grad_(), coords.clone().requires_grad_()
    out = warp.grid_sample(ik, ck, padding_mode)
    (out * grad).sum().backward()
    torch.cuda.synchronize()
    assert warp.launch_counts["warp_fwd"] == before["warp_fwd"] + 1
    assert warp.launch_counts["warp_bwd"] == before["warp_bwd"] + 1

    ip, cp = image.clone().requires_grad_(), coords.clone().requires_grad_()
    out_p = warp.grid_sample_plain(ip, cp, padding_mode)
    (out_p * grad).sum().backward()
    assert (out - out_p).abs().max().item() <= 1e-5
    for got, want in ((ck.grad, cp.grad), (ik.grad, ip.grad)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()

    # the image as data: the same d coords, and no d image
    cd = coords.clone().requires_grad_()
    (warp.grid_sample_data(ik, cd, padding_mode) * grad).sum().backward()
    assert torch.equal(cd.grad, ck.grad)


def test_warp_wrapper_checks(device):
    image = torch.rand(2, 6, 8, 3, device=device)
    coords = torch.rand(2, 6, 8, 2, device=device)
    with pytest.raises(ValueError):
        warp.warp_fwd_cuda(image.double(), coords.double())
    with pytest.raises(ValueError):
        warp.warp_fwd_cuda(image.transpose(1, 2), coords)
    with pytest.raises(ValueError):
        warp.warp_fwd_cuda(image, coords.cpu())
    with pytest.raises(ValueError):
        warp.warp_bwd_cuda(image, coords, torch.rand(2, 6, 8, 1, device=device))
    # the entry point casts and lays out what the kernels need, and returns
    # the dtype the inputs promote to, as the plain version does on the CPU
    out = warp.grid_sample(image.double().transpose(1, 2), coords.double().transpose(1, 2))
    assert out.shape == (2, 8, 6, 3) and out.dtype == torch.float64
    for im_t, co_t in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)):
        got = warp.grid_sample(image.to(im_t), coords.to(co_t))
        want = warp.grid_sample_plain(image.cpu().to(im_t), coords.cpu().to(co_t))
        assert got.dtype == want.dtype == torch.promote_types(im_t, co_t)


def test_forward_statistics_feed_the_backward(device):
    """m is the largest dot of the window (the largest logit times T) and s
    the sum of exp(logit - largest logit), as the backward kernel reads
    them."""
    gen = torch.Generator().manual_seed(4)
    d, r = _unit(gen, (2, 3, 30, 40), device), _unit(gen, (2, 3, 30, 40), device)
    for temperature in (0.05, 1e-4):
        _, _, m, s = sa.softargmax_fwd_cuda(d, r, temperature, 4)
        k = 9
        sy = (torch.arange(30, device=device) - 4).clamp(0, 30 - k)
        sx = (torch.arange(40, device=device) - 4).clamp(0, 40 - k)
        kk = torch.arange(k, device=device)
        win = r.permute(0, 2, 3, 1)[:, (sy[:, None] + kk)[:, None, :, None],
                                    (sx[:, None] + kk)[None, :, None, :]]
        logits = torch.einsum("bchw,bhwyxc->bhwyx", d, win).double() / temperature
        m_ref = logits.amax(dim=(3, 4))
        s_ref = torch.exp(logits - m_ref[..., None, None]).sum(dim=(3, 4))
        # float32 dots of magnitude 1 carry a rounding of 6e-8: 6e-8 / T of a logit
        assert (m.double() / temperature - m_ref).abs().max().item() <= 4e-7 / temperature
        assert ((s.double() - s_ref).abs() / s_ref).max().item() <= (1e-4 if temperature > 1e-3 else 5e-2)
        assert (s >= 1.0).all()


@pytest.mark.parametrize("b,hw,gt_hw", [(1, (64, 96), (75, 124)), (2, (32, 64), (32, 64))])
def test_eval_step_on_the_card_matches_the_cpu(device, b, hw, gt_hw):
    import numpy as np

    from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import setup_metrics_config, setup_model
    from packnet_sfm_tpu_torch.engine.metrics import garg_crop_mask
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, make_eval_step

    cfg = config_from_dict(KITTI)
    cfg.model.depth_net.name = "PackNetSlim01"
    rgb_ds = SyntheticSfmDataset(length=b, height=hw[0], width=hw[1], seed=1)
    gt_ds = SyntheticSfmDataset(length=b, height=gt_hw[0], width=gt_hw[1], seed=2,
                                back_context=0, forward_context=0)
    batch = {"rgb": np.stack([rgb_ds[i]["rgb"] for i in range(b)]),
             "depth": np.stack([gt_ds[i]["depth"] for i in range(b)])}
    model = setup_model(cfg.model, device=device)
    cpu_model = setup_model(cfg.model, device="cpu", seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    metrics_cfg = setup_metrics_config(cfg)
    sa.reset_launch_counts()
    warp.reset_launch_counts()
    card = make_eval_step(model, metrics_cfg)(batch)
    torch.cuda.synchronize()
    assert sa.launch_counts == {"softargmax_fwd": 0, "softargmax_bwd": 0}
    assert warp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0}
    cpu = make_eval_step(cpu_model, metrics_cfg)(batch)
    valid = ((batch["depth"][..., 0] > 0) & (batch["depth"][..., 0] < 80)
             & (garg_crop_mask(*gt_hw).numpy() > 0))     # the KITTI config's crop
    n_valid = int(valid.reshape(b, -1).sum(axis=1).min())
    for mode in EVAL_MODES:
        got, want = card[mode].cpu().numpy(), cpu[mode].numpy()
        assert got.shape == (b, 7) and np.all(np.isfinite(got))
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0, atol=2.0 / n_valid)
