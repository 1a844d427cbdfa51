"""The spans inside the port (``utils/profiling.py``): the host spans'
``record_function`` while a profiler records, and the train step's parts
(``StepSpans``), eager on the CPU and, on a card (``cuda`` marker, skipped
without one), in a captured step against the eager step.

This module imports no JAX: its card test runs on the GPU machine with
``python -m pytest tests/test_torch_spans.py --noconftest``.
"""

import json
import os

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
from dino_tracker_tpu_torch.models import tracker
from dino_tracker_tpu_torch.structures import BBData
from dino_tracker_tpu_torch.training import sampler, train
from dino_tracker_tpu_torch.utils import profiling
from test_torch_threads import one_thread  # noqa: F401

PARTS = ("sampler", "refiner", "view", "flow_term", "head", "cycle", "contrastive_ref",
         "contrastive_dino", "regularisers", "backward_terms", "refiner_bwd", "optimizer")
NESTED = {"head"}  # inside the flow and cycle terms
STEP = "train/step"


def sizes(card: bool) -> dict:
    """A tiny step on the CPU; on a card one whose parts take long enough
    that the few kernels between them (the loss's sum, the metrics) stay
    small beside them."""
    if card:
        return dict(t=16, h=238, w=427, channels=(3, 16, 32, 64, 256), batch=256,
                    cyc=64, cl=128, trajectories=4000, bb_cap=128)
    return dict(t=6, h=70, w=98, channels=(3, 4, 4, 4, 16), batch=32, cyc=16, cl=16,
                trajectories=150, bb_cap=24)


def step_setup(device, card=False, seed=0):
    """(model, optimizer, schedule, generator, cfg, tcfg, data) of a
    seeded step on ``device``, its data drawn with numpy."""
    z = sizes(card)
    t, h, w, c = z["t"], z["h"], z["w"], z["channels"][-1]
    tcfg = TrackerConfig(video_h=h, video_w=w, delta_channels=z["channels"])
    cfg = TrainConfig(video_resh=h, video_resw=w, train_batch_size=z["batch"],
                      batch_n_frames=4, cyc_n_frames=2, cyc_batch_size_per_frame=z["cyc"],
                      cl_n_frames=3, cl_points_per_pair=z["cl"], cl_fg_points_ratio=0.5,
                      compute_dtype="float32")
    hp, wp = tcfg.feat_hw
    rng = np.random.default_rng(seed)
    video = rng.random((t, 3, h, w), dtype=np.float32)
    dino = (rng.standard_normal((1, c, hp, wp)) * 2
            + rng.standard_normal((t, c, hp, wp))).astype(np.float16)
    masks = (rng.random((t, h, w)) < 0.4).astype(np.float32) * 255
    banks = []
    for _ in range(2):
        tr = (rng.random((z["trajectories"], t, 2)) * [w - 1, h - 1]).astype(np.float32)
        tr[rng.random(tr.shape[:2]) > 0.8] = np.nan
        banks.append(sampler.build_bank(tr, device=device))
    cap = z["bb_cap"]
    bb = BBData(*(torch.from_numpy(a).to(device) for a in (
        (rng.random((t, t, cap, 2)) * [w - 1, h - 1]).astype(np.float32),
        (rng.random((t, t, cap, 2)) * [w - 1, h - 1]).astype(np.float32),
        (0.2 + 0.8 * rng.random((t, t, cap))).astype(np.float32),
        rng.random((t, t, cap)).astype(np.float32),
        np.arange(cap)[None, None] < rng.integers(5, cap, (t, t))[..., None])))
    data = train.VideoData(torch.from_numpy(video).to(device), torch.from_numpy(dino).to(device),
                           torch.from_numpy(masks).to(device), bb, *banks)
    model = tracker.Tracker(tcfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return model, opt, sched, gen, cfg, tcfg, data


def runner_on(device, card=False):
    model, opt, sched, gen, cfg, tcfg, data = step_setup(device, card)
    return train.StepRunner(model, opt, sched, gen, cfg, tcfg), data


def step_entries() -> dict:
    return {k: v for k, v in profiling.stage_report().items()
            if k == STEP or k.startswith(STEP + "/")}


@pytest.fixture
def clean_registry():
    profiling.reset_stage_timers()
    yield
    profiling.reset_stage_timers()


def annotations(trace_dir) -> list:
    with open(os.path.join(trace_dir, "trace.json")) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation" and "dur" in e]


@pytest.mark.parametrize("gates", [(True, True), (False, False)], ids=["on", "off"])
def test_an_eager_step_under_a_profiler_records_every_part(gates, clean_registry, tmp_path):
    """One eager step on the CPU under ``device_trace``: every part of the
    step (those of its gates) is read once, on the host clock, and lies in
    the trace inside ``train/step``; the top-level parts sum to no more
    than the step."""
    runner, data = runner_on(torch.device("cpu"))
    with profiling.device_trace(str(tmp_path)):
        runner.run(data, *gates, 1)
    parts = [p for p in PARTS if gates[0] or p not in ("cycle", "contrastive_ref")]
    got = step_entries()
    assert set(got) == {STEP} | {f"{STEP}/{p}" for p in parts}
    assert all(v["calls"] == 1 and v["clock"] == "host" for v in got.values())
    assert all(v["total_s"] > 0 for v in got.values())
    top = sum(got[f"{STEP}/{p}"]["total_s"] for p in parts if p not in NESTED)
    assert top <= got[STEP]["total_s"]
    assert got[f"{STEP}/head"]["total_s"] <= (got[f"{STEP}/flow_term"]["total_s"]
                                              + got.get(f"{STEP}/cycle", {}).get("total_s", 0))

    events = annotations(tmp_path)
    (step,) = [e for e in events if e["name"] == STEP]
    for p in parts:
        mine = [e for e in events if e["name"] == f"{STEP}/{p}"]
        assert mine, p
        assert all(step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]
                   for e in mine), p


def test_each_read_adds_a_step_only_once(clean_registry):
    """A read adds the newest completed step once: a second read (the
    Trainer's log, after the runner's) adds nothing; the next step's read
    adds one more sample."""
    runner, data = runner_on(torch.device("cpu"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        runner.run(data, False, False, 2)  # two steps: only the newest is read
        first = step_entries()
        runner.spans.read()
        assert step_entries() == first
        runner.run(data, False, False, 1)
        second = step_entries()
    assert {v["calls"] for v in first.values()} == {1}
    assert {v["calls"] for v in second.values()} == {2}
    assert set(second) == set(first)


def test_a_captured_step_is_read_after_its_replays(clean_registry):
    """The bookkeeping of a captured step on the CPU's clock: a step taken
    while capturing is recorded whatever the profiler, read only once it
    was replayed and while a profiler records, and once a replay."""
    spans = profiling.StepSpans(torch.device("cpu"))
    with spans.taking(capturing=True):
        with profiling.step_span(STEP):
            with profiling.step_span(f"{STEP}/sampler"):
                pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.read()  # captured, not replayed: nothing completed
        assert step_entries() == {}
        spans.replayed()
        spans.read()
        spans.read()
    spans.replayed()
    spans.read()  # no profiler: nothing read
    assert {k: v["calls"] for k, v in step_entries().items()} == {STEP: 1,
                                                                  f"{STEP}/sampler": 1}


def test_with_no_profiler_nothing_is_read(clean_registry):
    """Steps and reads with no profiler leave the report as the stage timers
    alone make it, in the JAX package's format."""
    runner, data = runner_on(torch.device("cpu"))
    with profiling.stage_timer("train/steps_gates_on"):
        runner.run(data, True, True, 2)
    runner.spans.read()
    report = profiling.stage_report()
    assert list(report) == ["train/steps_gates_on"]
    assert report["train/steps_gates_on"].keys() == {"total_s", "calls"}
    assert profiling.step_span(STEP) is profiling.step_span(f"{STEP}/head")  # the no-op
    x = torch.ones(2, requires_grad=True)
    assert profiling.step_boundary(x, ends="a", begins="b") is x


def test_host_spans_are_annotations_only_while_a_profiler_records(clean_registry, tmp_path):
    """A host span opens a ``record_function`` of its name while a profiler
    records (nested names nested in time), and none without one; its
    seconds reach the registry and the span either way."""
    assert not profiling.tracing()
    with profiling.stage_timer("preprocess/untraced") as span:
        pass
    with profiling.device_trace(str(tmp_path)):
        assert profiling.tracing()
        with profiling.stage_timer("preprocess/stage"):
            with profiling.stage_timer("preprocess/stage/part", fence=torch.device("cpu")) as part:
                torch.ones(32, 32) @ torch.ones(32, 32)
    events = {e["name"]: e for e in annotations(tmp_path)}
    assert "preprocess/untraced" not in events
    outer, inner = events["preprocess/stage"], events["preprocess/stage/part"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    report = profiling.stage_report()
    assert {k: v["calls"] for k, v in report.items()} == {
        "preprocess/untraced": 1, "preprocess/stage": 1, "preprocess/stage/part": 1}
    assert span.seconds >= 0 and part.seconds > 0
    assert profiling.stage_seconds("preprocess/stage/part") == pytest.approx(part.seconds)


@pytest.mark.cuda
def test_a_captured_step_has_the_eager_steps_parts():
    """On a card: a step captured into a CUDA graph and replayed reads the
    same parts as the eager step, every replay recording its events again,
    and its top-level parts sum to its ``train/step`` within 3%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    reads = {}
    for mode in ("eager", "captured"):
        runner, data = runner_on(dev, card=True)
        if mode == "eager":
            runner.graphed = False
        runner.run(data, True, True, 4)  # warm-up, capture, replays
        torch.cuda.synchronize()
        profiling.reset_stage_timers()
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                runner.run(data, True, True, 3)
                torch.cuda.synchronize()
            reads[mode] = step_entries()
        finally:
            profiling.reset_stage_timers()
            runner.release()
    assert set(reads["captured"]) == set(reads["eager"]) == {STEP} | {
        f"{STEP}/{p}" for p in PARTS}
    got = reads["captured"]
    assert all(v["calls"] == 1 and v["clock"] == "device" for v in got.values())
    step = got[STEP]["total_s"]
    top = sum(v["total_s"] for k, v in got.items()
              if k != STEP and k.rsplit("/", 1)[1] not in NESTED)
    assert 0.97 * step <= top <= step, (top, step)
