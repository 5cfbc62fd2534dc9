"""CUDA kernels K6f/K6b (csrc/softargmax.cu) and warp_fwd/warp_bwd/warp_jvp/
warp_bwd_image (csrc/warp.cu) against their plain PyTorch versions, on the card. Skipped
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
another order; warp_bwd_image sums each pixel's taps in key order, one
order on every call, which a second call must repeat bit for bit, also
where a tile's bin of target pixels is full and where it overflows).
warp_jvp, the coordinate tangent, on the same cases against the plain warp
under forward AD: 1e-4 of the tangent's largest magnitude, alone and with
an image tangent beside it (warp_fwd of the tangent).

The eval step (PackNetSlim01-1A, random weights) on the card against the
CPU, same weights and batch, at 64x96 with the ground truth at 75x124 and
at 32x64 with it at the input's size: continuous metrics rtol 1e-3, a1-a3
within 2 / n_valid, as chip_smoke.py holds the full-width PackNet01; the
eval path launches none of the port's kernels.

Group norm at adversarial means (1e3-3e4, std 1 and 0.1) on the card, for a
contiguous and a channels-last input, against a float64 two-pass oracle:
within 4 float32 spacings of the mean over the std (the input's own
quantization), as the CPU's kernel is on a contiguous input
(tests/test_torch_networks.py); the CPU's channels-last kernel is not
(ROADMAP.md §3 (c)).

The bfloat16-image warp variants against the plain version on the widened
image (the same function: a bfloat16 tap widens to float32 exactly), on
the float32 cases above, both paddings: the same tolerances; the image's
gradient is the float32 kernel's rounded once to bfloat16. FastGroupNorm in bfloat16 compute on the card
against the CPU on the same bfloat16 input bits: within one bfloat16
spacing of the output (both compute float32 statistics and round once).

Two trainer steps (``Trainer.train_epoch`` over a 2-step epoch of the
PackNetSlim overfit recipe at batch 2, device jitter and the training flip
on) on the card against the CPU from the same seed: the epoch's mean loss
within 1e-3 relative, as chip_smoke.py holds the card's first two steps, and
the weights' update over the two steps at a cosine of 0.99 or more; the
warp kernels launch 4 times a step each.

PackNet-SAN's sparse branch on the card against the CPU, same inputs: the
masked max pool exactly (values, mask and the gradient, which goes to the
window's largest entry on both), MaskedBatchNorm's training forward, its
running statistics and the gradient of its input within 1e-5 of their
largest (cuDNN and the CPU sum the active sites in other orders); no kernel
of the port launches on this path.

channel_conv3d's weight and bias gradient (csrc/fold_conv.cu) against its
plain version at PackNet-SAN's and PackNet01's largest shapes, on tiles cut
by every edge and under the band's padding: float32 within 1e-5 of the
largest of the float64 sum, bfloat16 within one bfloat16 spacing of the
float32 sum rounded once; the same bits on a second call and one launch
count a call; and the autograd function around it against F.conv3d's
autograd on the card (the forward the same bits; the input's gradient,
cuDNN's in both, within 1e-6, as cuDNN's does not repeat its own bits at
every shape).

An NRS step (configs/train_omnicam.yaml at 96x96, bfloat16 as the recipe
says, batch 2) on the card: its record counts 2 launches of K6f and 2 of
K6b (a forward and a backward a context) and the batch's copies alone (the
canonical rays stay on the card).
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
              ((1, 6, 1, 3), (5, 300)), ((2, 16, 24, 2), (16, 24)), ((8, 96, 320, 3), (96, 320)),
              # warp_bwd_image's bins: an 8 x 32 image is one tile of targets;
              # 64 x 128 outputs put 256 warps' records in its bin (a full bin),
              # 64 x 130 put 260 (an overfull bin: the walk)
              ((1, 8, 32, 3), (64, 128)), ((1, 8, 32, 3), (64, 130))]


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
    assert warp.launch_counts["warp_bwd_image"] == before["warp_bwd_image"] + 1

    ip, cp = image.clone().requires_grad_(), coords.clone().requires_grad_()
    out_p = warp.grid_sample_plain(ip, cp, padding_mode)
    (out_p * grad).sum().backward()
    assert (out - out_p).abs().max().item() <= 1e-5
    for got, want in ((ck.grad, cp.grad), (ik.grad, ip.grad)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    # d image has one summation order: the same bits on every call
    again = warp.warp_bwd_image_cuda(coords, grad, shape[1:3], torch.float32, padding_mode)
    assert torch.equal(again, ik.grad)

    # the image as data: the same d coords, and no d image
    cd = coords.clone().requires_grad_()
    (warp.grid_sample_data(ik, cd, padding_mode) * grad).sum().backward()
    assert torch.equal(cd.grad, ck.grad)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape,out_hw", WARP_CASES)
def test_warp_jvp_matches_plain_forward_mode(device, shape, out_hw, padding_mode):
    """warp_jvp through torch.func.jvp of grid_sample (the direct
    alignment's path) against the plain warp under forward AD: one launch of
    each kernel; an image tangent is warp_fwd of the tangent, and with a
    coordinate tangent beside it the two add."""
    image, coords, _ = _warp_inputs(shape, out_hw, device)
    tangent = torch.randn(coords.shape, generator=torch.Generator().manual_seed(1)).to(device)
    before = dict(warp.launch_counts)
    out, out_t = torch.func.jvp(lambda c: warp.grid_sample(image, c, padding_mode),
                                (coords,), (tangent,))
    torch.cuda.synchronize()
    assert warp.launch_counts["warp_fwd"] == before["warp_fwd"] + 1
    assert warp.launch_counts["warp_jvp"] == before["warp_jvp"] + 1
    want, want_t = torch.func.jvp(lambda c: warp.grid_sample_plain(image, c, padding_mode),
                                  (coords,), (tangent,))
    assert (out - want).abs().max().item() <= 1e-5
    assert torch.isfinite(out_t).all()
    assert (out_t - want_t).abs().max().item() <= 1e-4 * want_t.abs().max().item()
    image_t = torch.randn(image.shape, generator=torch.Generator().manual_seed(2)).to(device)
    before = dict(warp.launch_counts)
    _, got = torch.func.jvp(lambda im, c: warp.grid_sample(im, c, padding_mode),
                            (image, coords), (image_t, tangent))
    torch.cuda.synchronize()
    assert warp.launch_counts["warp_fwd"] == before["warp_fwd"] + 2
    assert warp.launch_counts["warp_jvp"] == before["warp_jvp"] + 1
    _, want = torch.func.jvp(lambda im, c: warp.grid_sample_plain(im, c, padding_mode),
                             (image, coords), (image_t, tangent))
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape,out_hw", WARP_CASES)
def test_bf16_warp_kernels_match_plain(device, shape, out_hw, padding_mode):
    image, coords, grad = _warp_inputs(shape, out_hw, device)
    image = image.bfloat16()
    warp.reset_launch_counts()
    ck = coords.clone().requires_grad_()
    out = warp.grid_sample(image, ck, padding_mode)
    (out * grad).sum().backward()
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and ck.grad.dtype == torch.float32
    assert warp.bf16_launch_counts == {"warp_fwd_bf16": 1, "warp_bwd_bf16": 1,
                                       "warp_bwd_image_bf16": 0}
    assert warp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0, "warp_jvp": 0,
                                 "warp_bwd_image": 0}
    cp = coords.clone().requires_grad_()
    out_p = warp.grid_sample_plain(image.float(), cp, padding_mode)
    (out_p * grad).sum().backward()
    assert (out - out_p).abs().max().item() <= 1e-5
    assert torch.isfinite(ck.grad).all()
    assert (ck.grad - cp.grad).abs().max().item() <= 1e-4 * cp.grad.abs().max().item()
    # the same function of the widened image as the float32 kernel
    assert (out - warp.warp_fwd_cuda(image.float(), coords, padding_mode)).abs().max() <= 1e-6


def test_bf16_warp_refuses_an_image_gradient(device):
    """Refused once; now a bfloat16 image's gradient on the card is the
    float32 one of the widened image rounded once to bfloat16, as the CPU
    gives it, and the coordinate tangent on a bfloat16 image is the float32
    image's."""
    gen = torch.Generator().manual_seed(3)
    image = torch.rand((2, 6, 8, 3), generator=gen).to(device).bfloat16()
    coords = ((torch.rand((2, 6, 8, 2), generator=gen) * 2 - 1) * 1.3).to(device)
    grad = torch.randn((2, 6, 8, 3), generator=gen).to(device)
    ik = image.clone().requires_grad_()
    (warp.grid_sample(ik, coords) * grad).sum().backward()
    assert ik.grad.dtype == torch.bfloat16
    ic = image.cpu().requires_grad_()
    (warp.grid_sample(ic, coords.cpu()) * grad.cpu()).sum().backward()
    d32 = warp.warp_bwd_image_cuda(coords, grad, (6, 8))
    assert torch.equal(ik.grad, d32.bfloat16())
    assert (ik.grad.float().cpu() - ic.grad.float()).abs().max() <= \
        2 ** -7 * ic.grad.float().abs().max()
    tangent = torch.randn(coords.shape, generator=gen).to(device)
    _, got = torch.func.jvp(lambda c: warp.grid_sample(image, c), (coords,), (tangent,))
    _, want = torch.func.jvp(lambda c: warp.grid_sample(image.float(), c), (coords,), (tangent,))
    assert torch.equal(got, want)
    _, d_coords = warp.warp_bwd_cuda(image, coords, grad)
    assert torch.isfinite(d_coords).all()
    with pytest.raises(ValueError):
        warp.warp_fwd_cuda(image.half(), coords)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_bf16_group_norm_on_the_card_matches_the_cpu(device, layout):
    from packnet_sfm_tpu_torch.nn.layers import FastGroupNorm

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((2, 64, 24, 40), generator=gen) * 3 + 1).bfloat16()
    if layout == "channels_last":
        x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    norm = FastGroupNorm(64, dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(64, generator=gen) + 0.5)
        norm.bias.copy_(torch.randn(64, generator=gen))
        want = norm(x).float()
        got = norm.to(device)(x.to(device)).float().cpu()
    assert got.dtype == want.dtype
    spacing = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=2 ** -120))) - 7)
    assert ((got - want).abs() <= spacing).all()


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
    assert warp.launch_counts == {"warp_fwd": 0, "warp_bwd": 0, "warp_jvp": 0,
                                 "warp_bwd_image": 0}
    cpu = make_eval_step(cpu_model, metrics_cfg)(batch)
    valid = ((batch["depth"][..., 0] > 0) & (batch["depth"][..., 0] < 80)
             & (garg_crop_mask(*gt_hw).numpy() > 0))     # the KITTI config's crop
    n_valid = int(valid.reshape(b, -1).sum(axis=1).min())
    for mode in EVAL_MODES:
        got, want = card[mode].cpu().numpy(), cpu[mode].numpy()
        assert got.shape == (b, 7) and np.all(np.isfinite(got))
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0, atol=2.0 / n_valid)


def test_trainer_steps_on_the_card_match_the_cpu(device):
    import copy

    import numpy as np

    from packnet_sfm_tpu_torch.cli.train import build_trainer
    from packnet_sfm_tpu_torch.core.config import OVERFIT_PACKNET_SYNTHETIC

    cfg = copy.deepcopy(OVERFIT_PACKNET_SYNTHETIC)
    for mode in ("train", "validation", "test"):
        cfg["datasets"][mode].update(batch_size=2, synthetic_length=4, num_workers=2)
    cfg["datasets"]["train"]["repeat"] = [1]
    card, cpu = build_trainer(cfg, device=device), build_trainer(cfg, device="cpu")
    start = {k: v.detach().cpu().clone() for k, v in card.model.state_dict().items()}
    for k, v in cpu.model.state_dict().items():
        assert torch.equal(v, start[k]), k
    warp.reset_launch_counts()
    got = card.train_epoch(0)
    torch.cuda.synchronize()
    assert card.step == 2 and got["peak_mib"] > 0
    assert warp.launch_counts == {"warp_fwd": 8, "warp_bwd": 8, "warp_jvp": 0, "warp_bwd_image": 0}
    want = cpu.train_epoch(0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    keys = sorted(start)
    flat = lambda state: torch.cat([state[k].detach().cpu().double().ravel() for k in keys])
    d_card = flat(card.model.state_dict()) - flat(start)
    d_cpu = flat(cpu.model.state_dict()) - flat(start)
    assert (d_card @ d_cpu / d_card.norm() / d_cpu.norm()).item() >= 0.99


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("mean,std", [(1e3, 1.0), (1e4, 1.0), (1e4, 0.1), (3e4, 0.1)])
def test_group_norm_at_large_means_on_the_card(device, mean, std, layout):
    import numpy as np

    from packnet_sfm_tpu_torch.nn.layers import FastGroupNorm

    x = np.random.default_rng(0).normal(mean, std, size=(2, 8, 12, 64)).astype(np.float32)
    xg = x.reshape(2, 8, 12, 16, 4).astype(np.float64)
    centred = xg - xg.mean(axis=(1, 2, 4), keepdims=True)
    want = (centred / np.sqrt((centred ** 2).mean(axis=(1, 2, 4), keepdims=True) + 1e-5)
            ).reshape(x.shape)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)         # strided as a channels-last tensor
    if layout == "contiguous":
        nchw = nchw.contiguous()
    with torch.no_grad():
        got = FastGroupNorm(64).to(device)(nchw.to(device)).permute(0, 2, 3, 1).cpu().double()
    assert np.abs(got.numpy() - want).max() <= 4 * mean * 2.0 ** -24 / std


@pytest.mark.parametrize("hw", [(13, 18), (88, 304)])
def test_masked_pool_and_batch_norm_on_the_card_match_the_cpu(device, hw):
    from packnet_sfm_tpu_torch.nn import sparse

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8) + hw, generator=gen) * 2.0 + 1.0
    mask = (torch.rand((2, 1) + hw, generator=gen) < 0.1).float()
    out = {}
    for dev in ("cpu", device):
        xd = x.detach().to(dev).requires_grad_()
        pooled, new_mask = sparse.masked_max_pool(xd, mask.to(dev))
        bn = sparse.MaskedBatchNorm(8).to(dev).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 2.0, 8))
            bn.bias.copy_(torch.linspace(-1.0, 1.0, 8))
        y = bn(pooled, new_mask)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(dev)).sum().backward()
        out[str(dev)] = [t.detach().cpu() for t in (pooled, new_mask, y, bn.running_mean,
                                                    bn.running_var, xd.grad)]
    cpu, card = out["cpu"], out[str(device)]
    for got, want in zip(card[:2], cpu[:2]):
        assert torch.equal(got, want)
    for got, want in zip(card[2:], cpu[2:]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


# (B, Cp, Hin, W, d, padding, dtype): PackNet-SAN's largest unpack and its
# two-step pack5, PackNet01's largest unpack at B 16 in bfloat16; then tiles
# cut by every edge (Cp not a multiple of 16, H of 4, W of 32), an odd d,
# and the band's padding with its halo rows attached
CONV3D_WGRAD_CASES = [(1, 32, 176, 608, 4, 1, "float32"), (1, 2048, 11, 38, 4, 1, "float32"),
                      (16, 32, 96, 320, 8, 1, "bfloat16"), (2, 19, 13, 45, 4, 1, "float32"),
                      (1, 5, 6, 31, 3, 1, "float32"), (1, 8, 12, 40, 4, (1, 0, 1), "float32"),
                      (2, 20, 7, 70, 8, (1, 0, 1), "bfloat16")]


@pytest.mark.parametrize("b,cp,hin,w,d,padding,dtype", CONV3D_WGRAD_CASES)
def test_conv3d_weight_gradient_kernel_matches_plain(device, b, cp, hin, w, d, padding, dtype):
    """channel_conv3d_wgrad against the plain version: float32 within 1e-5
    of the largest dW and db of the float64 sum (float32 sums of up to
    3.4 M products); bfloat16 within one bfloat16 spacing of the float32
    sum rounded once (the kernel rounds its own float32 sum, taken in
    another order, once). The same bits on a second call, one count a call."""
    from packnet_sfm_tpu_torch.ops import fold_conv

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    h = hin if padding == 1 else hin - 2
    x = torch.randn((b, 1, cp, hin, w), generator=gen).to(device, dt)
    grad = torch.randn((b, d, cp, h, w), generator=gen).to(device, dt)
    before = fold_conv.launch_counts["channel_conv3d_wgrad"]
    got = fold_conv.channel_conv3d_wgrad_cuda(x, grad, padding)
    again = fold_conv.channel_conv3d_wgrad_cuda(x, grad, padding)
    torch.cuda.synchronize()
    assert fold_conv.launch_counts["channel_conv3d_wgrad"] == before + 2
    if dt == torch.float32:
        want = fold_conv.channel_conv3d_wgrad_plain(x.double(), grad.double(), padding)
    else:
        want = fold_conv.channel_conv3d_wgrad_plain(x, grad, padding)
    for a, c, ref in zip(got, again, want):
        assert a.dtype == dt and a.shape == ref.shape
        assert torch.equal(a, c)
        if dt == torch.float32:
            assert (a.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
        else:
            spacing = torch.ldexp(torch.ones_like(ref.float()), torch.frexp(ref.float())[1] - 8)
            assert ((a.float() - ref.float()).abs() <= spacing).all()


def test_channel_conv3d_on_the_card_matches_conv3d_autograd(device):
    """The autograd function on the card: its forward is F.conv3d's, the
    same bits; its input's gradient cuDNN's, within 1e-6 of the largest
    (cuDNN's own input gradient at this shape differs between two calls of
    F.conv3d's autograd by 1.7e-7 of the largest on an H100); its weight and
    bias gradients the kernel's, within 1e-5 of the largest."""
    import torch.nn.functional as F

    from packnet_sfm_tpu_torch.ops import fold_conv

    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 1, 24, 40, 70), generator=gen).to(device)
    weight = torch.randn((4, 1, 3, 3, 3), generator=gen).to(device)
    bias = torch.randn((4,), generator=gen).to(device)
    grad = torch.randn((2, 4, 24, 40, 70), generator=gen).to(device)
    outs = []
    for fn in (lambda *a: F.conv3d(*a, padding=1),
               lambda *a: fold_conv._ChannelConv3d.apply(*a, 1)):
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
        y = fn(*leaves)
        y.backward(grad)
        outs.append([y.detach()] + [t.grad for t in leaves])
    want, got = outs
    assert torch.equal(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= 1e-6 * want[1].abs().max().item()
    for a, c in zip(got[2:], want[2:]):
        assert (a - c).abs().max().item() <= 1e-5 * c.abs().max().item()


def test_an_nrs_step_launches_each_soft_argmax_kernel_twice(device):
    import copy

    import numpy as np

    from packnet_sfm_tpu_torch.core.config import OMNICAM, config_from_dict
    from packnet_sfm_tpu_torch.engine import spans
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

    raw = copy.deepcopy(OMNICAM)
    raw["datasets"]["augmentation"]["image_shape"] = "(96, 96)"
    cfg = config_from_dict(raw)
    model = setup_model(cfg.model, device=device, seed=0, dtype=torch.bfloat16)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 100)
    step = make_train_step(model, optimizer, scheduler, compute_dtype=torch.bfloat16)
    acc = zero_metrics(device)
    rng = np.random.default_rng(0)
    img = lambda: rng.integers(0, 256, size=(2, 96, 96, 3), dtype=np.uint8)  # noqa: E731
    batch = {"rgb": img(), "rgb_context": [img(), img()],
             "jitter": rng.uniform(0.9, 1.1, size=(2, 4)).astype(np.float32)}
    step(acc, batch, 0.5)
    torch.cuda.synchronize()
    with spans.recording() as records:
        step(acc, batch, 0.5)
    torch.cuda.synchronize()
    (r,) = records
    assert r.counters["softargmax_fwd"] == 2 and r.counters["softargmax_bwd"] == 2
    assert r.counters["softargmax_fwd_band"] == r.counters["softargmax_bwd_band"] == 0
    assert r.counters["pageable_copies"] == 4
    assert torch.isfinite(acc["loss"]).all()
