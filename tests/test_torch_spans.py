"""The span recorder (``engine/spans.py``) at the boundaries of the train and
eval steps (``engine/train.py``), on the CPU: off, a step makes no record
and its spans are profiler ranges nested under ``train_step`` on the
operators' timeline; on, one record a step with the expected nesting, each
child inside its parent, self times not below 0, the copied bytes of the
host batch and the change of the kernels' launch counters (0 on the CPU).
An NRS step (configs/train_omnicam.yaml) opens ``ray_decoder`` under
``depth_net`` and ``generic_project`` under ``photometric_loss``, once a
context; its canonical rays are the template's bits, copied to the device
once (``models/sfm.SfmModelDef.canonical_rays``), so that a later step's
record counts the batch's copies alone. The ``cuda``-marked case
checks one step's warp launches on the card against the ops' own counters:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest -q
"""

import copy

import numpy as np
import pytest
import torch

from packnet_sfm_tpu_torch.core.config import KITTI, OMNICAM, config_from_dict
from packnet_sfm_tpu_torch.engine import spans
from packnet_sfm_tpu_torch.engine.factory import (
    make_optimizer,
    setup_metrics_config,
    setup_model,
)
from packnet_sfm_tpu_torch.engine.train import make_eval_step, make_train_step, zero_metrics
from packnet_sfm_tpu_torch.geometry.camera_generic import canonical_pinhole_rays
from packnet_sfm_tpu_torch.ops import softargmax, warp

torch.set_num_threads(1)

H, W, B = 32, 64, 2
TRAIN_CHILDREN = ("batch_copy", "forward", "backward", "optimizer_step")


def _cfg(depth_net="DepthResNet", version="18", shape=(H, W)):
    raw = copy.deepcopy(KITTI)
    raw["model"]["depth_net"] = {"name": depth_net, "version": version}
    raw["datasets"]["augmentation"]["image_shape"] = str(tuple(shape))
    return config_from_dict(raw)


def _train_batch(h=H, w=W, b=B, seed=0):
    rng = np.random.default_rng(seed)
    img = lambda: rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)  # noqa: E731
    k = np.array([[w * 0.6, 0, w / 2], [0, h * 1.2, h / 2], [0, 0, 1]], np.float32)
    return {"rgb": img(), "rgb_context": [img(), img()],
            "intrinsics": np.repeat(k[None], b, axis=0),
            "jitter": rng.uniform(0.9, 1.1, size=(b, 4)).astype(np.float32)}


def _train_step(device="cpu", dtype=None, **cfg_kwargs):
    cfg = _cfg(**cfg_kwargs)
    model = setup_model(cfg.model, device=device, seed=0, dtype=dtype)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 100)
    step = make_train_step(model, optimizer, scheduler, generator=torch.Generator().manual_seed(0),
                           compute_dtype=dtype or torch.float32)
    return step, zero_metrics(device)


def _nrs_step(shape, device="cpu", dtype=None):
    raw = copy.deepcopy(OMNICAM)
    raw["datasets"]["augmentation"]["image_shape"] = str(tuple(shape))
    cfg = config_from_dict(raw)
    model = setup_model(cfg.model, device=device, seed=0, dtype=dtype)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 100)
    step = make_train_step(model, optimizer, scheduler, compute_dtype=dtype or torch.float32)
    return step, zero_metrics(device)


def _nrs_batch(shape, b=1, seed=0):
    rng = np.random.default_rng(seed)
    img = lambda: rng.integers(0, 256, size=(b, *shape, 3), dtype=np.uint8)  # noqa: E731
    return {"rgb": img(), "rgb_context": [img(), img()],
            "jitter": rng.uniform(0.9, 1.1, size=(b, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def recorded():
    step, acc = _train_step()
    batches = [_train_batch(seed=i) for i in range(3)]
    step(acc, batches[0])           # the first call, outside the recorder
    before = {**warp.launch_counts, **warp.bf16_launch_counts, **softargmax.launch_counts,
              **softargmax.band_launch_counts}
    with spans.recording() as records:
        for b in batches[1:]:
            step(acc, b)
    after = {**warp.launch_counts, **warp.bf16_launch_counts, **softargmax.launch_counts,
             **softargmax.band_launch_counts}
    return records, batches, before, after


def _by_name(record):
    return {s.name: s for s in record.spans}


def test_off_makes_no_record_and_the_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    step, acc = _train_step()
    assert spans._recorder is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(acc, _train_batch())
    assert spans._recorder is None
    with spans.recording() as records:
        pass
    assert records == []
    events = prof.events()
    (root,) = [e for e in events if e.name == "train_step"]
    for name in TRAIN_CHILDREN + ("depth_net", "pose_net", "photometric_loss"):
        found = [e for e in events if e.name == name]
        assert found, name
        for e in found:
            assert root.time_range.start <= e.time_range.start <= e.time_range.end \
                <= root.time_range.end, name
    (forward,) = [e for e in events if e.name == "forward"]
    convs = [e for e in events if e.name == "aten::conv2d"
             and forward.time_range.start <= e.time_range.start < forward.time_range.end]
    assert convs          # the operators on the same timeline, inside the forward


def test_one_record_a_step(recorded):
    records, *_ = recorded
    assert [r.step for r in records] == [0, 1]
    for r in records:
        assert r.spans[0].name == "train_step" and r.spans[0].parent == -1
        # the images' copies before the jitter, the intrinsics' after it
        assert [s.name for s in r.spans if s.parent == 0] == ["batch_copy", *TRAIN_CHILDREN]


@pytest.mark.parametrize("child,parent", [(c, "train_step") for c in TRAIN_CHILDREN]
                         + [("depth_net", "forward"), ("pose_net", "forward"),
                            ("photometric_loss", "forward")])
def test_each_child_lies_within_its_parent(recorded, child, parent):
    records, *_ = recorded
    for r in records:
        spans_ = _by_name(r)
        c = spans_[child]
        assert r.spans[c.parent].name == parent
        p = spans_[parent]
        assert p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns


def test_self_times_are_not_negative(recorded):
    records, *_ = recorded
    out = spans.summary(records)
    assert out["steps"] == 2
    for name, row in out["spans"].items():
        assert row["self_ms"] >= 0 and row["ms"] >= row["self_ms"], name
    parts = sum(out["spans"][c]["ms"] for c in TRAIN_CHILDREN)
    root = out["spans"]["train_step"]
    assert root["ms"] == pytest.approx(parts + root["self_ms"])


def test_counters_hold_the_copies_and_the_launches(recorded):
    records, batches, before, after = recorded
    for r, b in zip(records, batches[1:]):
        host = [b["rgb"], *b["rgb_context"], b["jitter"], b["intrinsics"]]
        assert r.counters["copy_bytes"] == sum(a.nbytes for a in host)
        assert r.counters["copies"] == r.counters["pageable_copies"] == len(host)
    for k in before:
        assert sum(r.counters[k] for r in records) == after[k] - before[k] == 0, k


def test_summary_of_known_records():
    root = spans.Span("train_step", -1, 0, 10_000_000)
    rec = [spans.StepRecord(0, [root, spans.Span("forward", 0, 1_000_000, 5_000_000),
                                spans.Span("depth_net", 1, 2_000_000, 4_000_000)],
                            {"copies": 2}),
           spans.StepRecord(1, [spans.Span("train_step", -1, 0, 20_000_000),
                                spans.Span("forward", 0, 0, 6_000_000)], {"copies": 4})]
    out = spans.summary(rec)
    assert out["spans"]["train_step"] == {"ms": 15.0, "self_ms": 10.0, "calls": 1.0}
    assert out["spans"]["forward"] == {"ms": 5.0, "self_ms": 4.0, "calls": 1.0}
    assert out["spans"]["depth_net"] == {"ms": 1.0, "self_ms": 1.0, "calls": 0.5}
    assert out["counters"] == {"copies": 3.0}


def test_an_nrs_step_opens_its_spans():
    step, acc = _nrs_step((96, 96))
    with spans.recording() as records:
        step(acc, _nrs_batch((96, 96)), 0.5)
    (r,) = records
    parents = [(s.name, r.spans[s.parent].name) for s in r.spans if s.parent >= 0]
    assert parents.count(("ray_decoder", "depth_net")) == 1
    assert parents.count(("generic_project", "photometric_loss")) == 2
    for s in r.spans:
        if s.name in ("ray_decoder", "generic_project"):
            p = r.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize("h,w", [(96, 96), (48, 80)])
def test_the_kept_canonical_rays_are_the_template_bit_for_bit(h, w):
    model = setup_model(config_from_dict(OMNICAM).model, device="cpu", seed=0)
    got = model.canonical_rays(h, w, "cpu")
    assert torch.equal(got, canonical_pinhole_rays(h, w, device="cpu"))
    assert model.canonical_rays(h, w, torch.device("cpu")) is got


def test_an_nrs_step_copies_its_rays_once():
    shape = (96, 128)
    step, acc = _nrs_step(shape)
    batches = [_nrs_batch(shape, seed=i) for i in range(2)]
    with spans.recording() as records:
        for b in batches:
            step(acc, b, 0.5)
    rays = canonical_pinhole_rays(*shape, device="cpu")
    for r, b, extra in zip(records, batches, (1, 0)):
        host = [b["rgb"], *b["rgb_context"], b["jitter"]]
        assert r.counters["copies"] == r.counters["pageable_copies"] == len(host) + extra
        assert r.counters["copy_bytes"] == sum(a.nbytes for a in host) + extra * rays.nbytes


def test_recording_cannot_nest():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans._recorder is None


def test_an_eval_step_makes_an_eval_step_record():
    cfg = _cfg()
    model = setup_model(cfg.model, device="cpu", seed=0)
    step = make_eval_step(model, setup_metrics_config(cfg))
    rng = np.random.default_rng(3)
    batch = {"rgb": rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8),
             "depth": rng.uniform(0, 50, size=(B, 40, 80, 1)).astype(np.float32)}
    with spans.recording() as records:
        step(batch)
    (r,) = records
    assert r.spans[0].name == "eval_step"
    assert [s.name for s in r.spans if s.parent == 0] == ["batch_copy", "depth_net",
                                                          "depth_metrics"]
    assert r.counters["copy_bytes"] == batch["rgb"].nbytes + batch["depth"].nbytes


@pytest.mark.cuda
def test_one_step_warp_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the flagship recipe's kind and dtype on the slim network: the contexts
    # are stacked on the batch, one warp a scale through the bfloat16 variants
    step, acc = _train_step("cuda", torch.bfloat16, depth_net="PackNetSlim01", version="1A",
                            shape=(64, 96))
    batch = _train_batch(64, 96)
    step(acc, batch)
    torch.cuda.synchronize()
    before = {**warp.launch_counts, **warp.bf16_launch_counts, **softargmax.launch_counts,
              **softargmax.band_launch_counts}
    with spans.recording() as records:
        step(acc, batch)
    torch.cuda.synchronize()
    after = {**warp.launch_counts, **warp.bf16_launch_counts, **softargmax.launch_counts,
             **softargmax.band_launch_counts}
    (r,) = records
    assert {k: r.counters[k] for k in before} == {k: after[k] - before[k] for k in before}
    want = dict.fromkeys(before, 0)
    want.update(warp_fwd_bf16=4, warp_bwd_bf16=4)
    assert {k: r.counters[k] for k in before} == want
    assert r.counters["copies"] == r.counters["pageable_copies"] == 5
