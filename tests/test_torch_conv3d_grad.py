"""The weight and bias gradient of ``ops/fold_conv.channel_conv3d`` on the CPU.

``channel_conv3d_wgrad_plain`` (the 27-tap sum written out, the CPU's path
and the card kernel's reference) against ``F.conv3d``'s autograd in float64,
on small shapes: Cp 1, 3 and 8, odd H and W, d 4 and 8, B 1 and 2, both
paddings that ``channel_conv3d`` passes (1 for the whole image, (1, 0, 1) for
a band with its halo rows attached); ``gradcheck`` of the autograd function
that carries it; ``channel_conv3d``'s output and gradients against
``F.conv3d`` under autograd; and its launch counter, 0 after a CPU step and
a key of the spans' step record. The kernel itself is tested on the card
(``tests/test_torch_cuda.py``).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.ops import fold_conv

torch.set_num_threads(1)

# (B, Cp, Hin, W, d, padding): Hin is the input's rows, the band's halo rows
# included under (1, 0, 1)
SHAPES = [(1, 1, 5, 7, 4, 1), (2, 3, 7, 9, 8, 1), (1, 8, 9, 5, 4, 1), (2, 8, 3, 11, 8, 1),
          (1, 1, 5, 7, 8, (1, 0, 1)), (2, 3, 9, 5, 4, (1, 0, 1)), (1, 8, 7, 13, 8, (1, 0, 1)),
          (2, 8, 4, 3, 4, (1, 0, 1))]


def _gap(got, want):
    """The largest difference over the largest magnitude. Float32 sums of
    ~1600 products, summed in another order than F.conv3d's: measured
    1.0e-6, held to 1e-5."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _inputs(b, cp, hin, w, d, padding, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 1, cp, hin, w), generator=gen, dtype=dtype)
    weight = torch.randn((d, 1, 3, 3, 3), generator=gen, dtype=dtype)
    bias = torch.randn((d,), generator=gen, dtype=dtype)
    h = hin if padding == 1 else hin - 2
    grad = torch.randn((b, d, cp, h, w), generator=gen, dtype=dtype)
    return x, weight, bias, grad


@pytest.mark.parametrize("b,cp,hin,w,d,padding", SHAPES)
def test_plain_weight_gradient_matches_conv3d_autograd(b, cp, hin, w, d, padding):
    x, weight, bias, grad = _inputs(b, cp, hin, w, d, padding)
    weight.requires_grad_()
    bias.requires_grad_()
    F.conv3d(x, weight, bias, padding=padding).backward(grad)
    d_w, d_b = fold_conv.channel_conv3d_wgrad_plain(x, grad, padding)
    assert d_w.dtype == d_b.dtype == torch.float64
    torch.testing.assert_close(d_w, weight.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(d_b, bias.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("padding", [1, (1, 0, 1)])
def test_function_passes_gradcheck(padding):
    x, weight, bias, _ = _inputs(2, 3, 5, 6, 4, padding)
    args = [t.requires_grad_() for t in (x, weight, bias)]
    assert torch.autograd.gradcheck(
        lambda *a: fold_conv._ChannelConv3d.apply(*a, padding), args)


@pytest.mark.parametrize("padding", [1, (1, 0, 1)])
def test_function_matches_conv3d_forward_and_gradients(padding):
    x, weight, bias, grad = _inputs(2, 8, 9, 11, 4, padding, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    want = F.conv3d(*leaves, padding=padding)
    want.backward(grad)
    got_leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    got = fold_conv._ChannelConv3d.apply(*got_leaves, padding)
    got.backward(grad)
    assert torch.equal(got, want)                   # the forward is F.conv3d
    assert torch.equal(got_leaves[0].grad, leaves[0].grad)   # the input's, the same call
    for a, b in zip(got_leaves[1:], leaves[1:]):    # summed in another order
        assert _gap(a.grad, b.grad) <= 1e-5


def test_channel_conv3d_matches_conv3d_under_autograd():
    """The folded layout around the function, with the kernel and bias cast
    to the compute dtype inside the graph, against F.conv3d's autograd."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 7, 9, 5), generator=gen, requires_grad=True)        # [B, H, W, Cp]
    kernel = torch.randn((4, 1, 3, 3, 3), generator=gen, requires_grad=True)
    bias = torch.randn((4,), generator=gen, requires_grad=True)
    cot = torch.randn((2, 7, 9, 20), generator=gen)
    got = fold_conv.channel_conv3d(x, kernel, bias)
    got_grads = torch.autograd.grad((got * cot).sum(), (x, kernel, bias))
    y = F.conv3d(x.permute(0, 3, 1, 2).unsqueeze(1), kernel, bias, padding=1)
    want = y.reshape(2, 20, 7, 9).permute(0, 2, 3, 1)
    want_grads = torch.autograd.grad((want * cot).sum(), (x, kernel, bias))
    assert torch.equal(got, want)
    for a, b in zip(got_grads, want_grads):
        assert _gap(a, b) <= 1e-5


def test_bfloat16_gradient_is_the_float32_sum_rounded_once():
    x, _, _, grad = _inputs(1, 3, 6, 7, 4, 1, torch.float32, seed=3)
    x16, grad16 = x.bfloat16(), grad.bfloat16()
    d_w, d_b = fold_conv.channel_conv3d_wgrad_plain(x16, grad16)
    w32, b32 = fold_conv.channel_conv3d_wgrad_plain(x16.float(), grad16.float())
    assert d_w.dtype == d_b.dtype == torch.bfloat16
    assert torch.equal(d_w, w32.bfloat16()) and torch.equal(d_b, b32.bfloat16())


def test_padding_and_plan_checks():
    with pytest.raises(ValueError):
        fold_conv.channel_conv3d_wgrad_plain(torch.zeros(1, 1, 2, 3, 3), torch.zeros(1, 4, 2, 3, 3),
                                             (1, 2, 1))
    plan = fold_conv.wgrad_plan(1, 32, 176, 608, 4)
    assert plan["jb"] == 2 and plan["blocks"] * 2 <= fold_conv.WGRAD_RESIDENT_BLOCKS
    assert fold_conv.wgrad_plan(1, 1, 3, 5, 3)["jb"] == 1


def test_counter_is_zero_after_a_cpu_step_and_in_the_step_record():
    from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict
    from packnet_sfm_tpu_torch.engine import spans
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

    raw = copy.deepcopy(KITTI)
    raw["model"]["depth_net"] = {"name": "PackNetSlim01", "version": "1A"}
    raw["datasets"]["augmentation"]["image_shape"] = "(32, 64)"
    cfg = config_from_dict(raw)
    model = setup_model(cfg.model, device="cpu", seed=0)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 100)
    step = make_train_step(model, optimizer, scheduler, generator=torch.Generator().manual_seed(0),
                           compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    img = lambda: rng.integers(0, 256, size=(1, 32, 64, 3), dtype=np.uint8)  # noqa: E731
    k = np.array([[38.4, 0, 32], [0, 38.4, 16], [0, 0, 1]], np.float32)[None]
    batch = {"rgb": img(), "rgb_context": [img(), img()], "intrinsics": k,
             "jitter": rng.uniform(0.9, 1.1, size=(1, 4)).astype(np.float32)}
    before = dict(fold_conv.launch_counts)
    with spans.recording() as records:
        step(zero_metrics("cpu"), batch)
    (record,) = records
    assert record.counters["channel_conv3d_wgrad"] == 0
    assert fold_conv.launch_counts == before
    assert all(p.grad is None or torch.isfinite(p.grad).all()
               for p in model.depth_net.parameters())
