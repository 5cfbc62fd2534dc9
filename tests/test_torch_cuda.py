"""CUDA kernels K6f/K6b (csrc/softargmax.cu) and warp_fwd/warp_bwd
(csrc/warp.cu) against their plain PyTorch versions, on the card. Skipped
where there is no CUDA device; run there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Shapes cover a width that is not a multiple of the 32-pixel block, an image
exactly one window tall, several batches and both temperatures.
Tolerances (coordinates in pixels; gradients relative to their largest
magnitude): T = 0.05, 2e-3 px and 1e-3; T = 1e-4, 0.1 px and 5e-2 — at
T = 1e-4 near-tied window positions turn the f32 rounding of the logits
(which the kernel and the plain version sum in different orders) into
weight changes of ~1e-3 between positions up to 40 px apart, where the
gradients are largest (p(1-p)/T). d rays is summed with atomics, in an
order that changes from run to run.

The warp cases cover both padding modes, one and several channels, an output
grid of another size than the image, coordinates that leave the image on
every side, exact integer positions and the corners -1/+1. Tolerances:
values 1e-5 (images in [0, 1); only fused multiply-adds round differently);
gradients 1e-4 of their largest magnitude (d coords sums the channels in
another order; d image is summed with atomics).
"""

import pytest
import torch

from packnet_sfm_tpu_torch.ops import softargmax as sa
from packnet_sfm_tpu_torch.ops import warp

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

CASES = [((2, 24, 48), 4, 0.05), ((1, 45, 70), 20, 0.05), ((1, 41, 41), 20, 0.05),
         ((2, 64, 96), 20, 1e-4)]


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
    px_tol, grad_tol = (2e-3, 1e-3) if temperature >= 1e-2 else (0.1, 5e-2)

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


def test_wrapper_checks(device):
    d = torch.randn(1, 3, 30, 30, device=device)
    with pytest.raises(ValueError):
        sa.softargmax_fwd_cuda(d, d, 0.05, 20)          # window 41 > 30
    with pytest.raises(ValueError):
        sa.softargmax_fwd_cuda(d.double(), d.double(), 0.05, 4)
    with pytest.raises(ValueError):
        sa.softargmax_fwd_cuda(d.transpose(2, 3), d, 0.05, 4)


WARP_CASES = [((1, 12, 20, 3), (10, 16)), ((8, 48, 160, 3), (48, 160)),
              ((2, 33, 70, 1), (37, 75)), ((3, 5, 7, 4), (64, 96))]


def _warp_inputs(shape, out_hw, device):
    b, h, w, c = shape
    ho, wo = out_hw
    gen = torch.Generator().manual_seed(0)
    image = torch.rand(shape, generator=gen)
    coords = (torch.rand((b, ho, wo, 2), generator=gen) * 2 - 1) * 1.4
    coords[0, 0, :9] = torch.tensor([[-1., -1.], [1., 1.], [-1., 1.], [1., -1.], [0., 0.],
                                     [2. * 3 / (w - 1) - 1, 2. * 2 / (h - 1) - 1],
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
    # the entry point casts and lays out what the kernels need
    out = warp.grid_sample(image.double().transpose(1, 2), coords.double().transpose(1, 2))
    assert out.shape == (2, 8, 6, 3) and out.dtype == torch.float32
