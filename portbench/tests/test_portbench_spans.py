"""The readers of the program's spans (``yardstick/spans.py`` and the
metrics that use it) on synthetic traces and on records like a card run's."""

import os

import pytest
import torch

from conftest import PORTBENCH

import run
from yardstick import spans
from yardstick.trace import TraceSummary

TRAIN = {"step_sampler_ms.train": ["sampler"], "step_refiner_ms.train": ["refiner", "refiner_bwd"],
         "step_head_ms.train": ["head"], "step_flow_term_ms.train": ["flow_term"],
         "step_cycle_ms.train": ["cycle"],
         "step_contrastive_ms.train": ["contrastive_ref", "contrastive_dino"],
         "step_regularisers_ms.train": ["regularisers"],
         "step_backward_terms_ms.train": ["backward_terms"],
         "step_optimizer_ms.train": ["optimizer"]}
PARTS = sorted({p for ps in TRAIN.values() for p in ps})


def reader(metric):
    return run.load_module(os.path.join(PORTBENCH, "metrics", f"{metric}.py"), f"m_{metric}")


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2,
            "args": {"correlation": corr}}


def kernel(ts, dur, corr, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def video_trace():
    """One traced video on the µs clock: stage 1 from 0 to 1000 with an
    encode (0-100), a direct-flows span (200-300) and a harvest (600-1000);
    stage 5 from 1000 to 1500. Kernels: two launched in encode, one in
    direct_flows that runs late (700-760, inside harvest's interval), one
    copy launched in harvest, one launched in stage 5."""
    host = [span("preprocess/trajectories", 0, 1000),
            span("preprocess/trajectories/encode", 0, 100),
            span("preprocess/trajectories/direct_flows", 200, 100),
            span("preprocess/trajectories/harvest", 600, 400),
            span("preprocess/best_buddies", 1000, 500),
            launch(10, 1), launch(50, 2), launch(250, 3), launch(610, 4, "cudaMemcpyAsync"),
            launch(1100, 5)]
    device = [kernel(20, 100, 1), kernel(120, 30, 2), kernel(700, 60, 3),
              kernel(620, 5, 4, cat="gpu_memcpy"), kernel(1200, 100, 5)]
    return host, device


def test_device_time_goes_to_the_span_that_launched_it():
    host, device = video_trace()
    decode = ["preprocess/trajectories/encode", "preprocess/trajectories/direct_flows"]
    assert spans.launched_in_s(host, device, decode) == pytest.approx(190e-6)  # 100 + 30 + 60
    assert spans.launched_in_s(host, device, ["preprocess/trajectories/harvest"]) == \
        pytest.approx(5e-6)
    assert spans.launched_in_s(host, device, ["preprocess/missing"]) is None
    assert spans.launched_in_s(host, [], decode) == 0.0


def test_idle_time_inside_a_span():
    """Stage 1 (0-1000) is busy 20-150, 620-625 and 700-760: idle 0-20,
    150-620, 625-700, 760-1000."""
    host, device = video_trace()
    assert spans.idle_in_s(host, device, ["preprocess/trajectories"]) == pytest.approx(805e-6)
    assert spans.idle_in_s(host, device, ["preprocess/best_buddies"]) == pytest.approx(400e-6)
    assert spans.idle_in_s(host, device, ["preprocess/missing"]) is None
    assert spans.span_s(host, ["preprocess/best_buddies"]) == pytest.approx(500e-6)


def test_idle_gaps_go_to_the_innermost_span():
    """The gaps between device operations (150-620, 625-700, 760-1200) by the
    deepest span open: stage 1 alone over 150-200 and 300-600, direct_flows
    200-300, harvest 600-620, 625-700 and 760-1000, stage 5 1000-1200."""
    host, device = video_trace()
    got = spans.idle_by_span(host, device, "preprocess/")
    assert got == pytest.approx({"preprocess/trajectories": 350e-6,
                                 "preprocess/trajectories/direct_flows": 100e-6,
                                 "preprocess/trajectories/harvest": 335e-6,
                                 "preprocess/best_buddies": 200e-6})
    assert spans.idle_by_span(host, device, "train/") == {"": pytest.approx(985e-6)}


def record_of(events_by_video, card=True):
    trace = TraceSummary()
    for host, device in events_by_video:
        trace.add(host + device, 1e-3)
    return {"card": card, "trace": trace}


def test_the_preprocessing_readers_on_a_card_runs_record():
    """Each reader per traced video (two videos, the second the first
    shifted); None without a card, or in a trace of a program without the
    spans."""
    host, device = video_trace()

    def later(events):  # the same video 5 ms on, its correlation ids 100 on
        out = [dict(e, ts=e["ts"] + 5000) for e in events]
        for e in out:
            if "args" in e:
                e["args"] = {"correlation": e["args"]["correlation"] + 100}
        return out

    record = record_of([(host, device), (later(host), later(device))])
    assert reader("stage1_decode_s.preprocess").read(record) == pytest.approx(190e-6)
    assert reader("stage1_host_s.preprocess").read(record) == pytest.approx(805e-6)
    assert reader("bb_s.preprocess").read(record) == pytest.approx(500e-6)
    bare = record_of([([e for e in host if e["cat"] != "user_annotation"], device)])
    for name in ("stage1_decode_s.preprocess", "stage1_host_s.preprocess", "bb_s.preprocess"):
        assert reader(name).read(record_of([(host, device)], card=False)) is None
        assert reader(name).read(bare) is None
        assert reader(name).read({"card": True}) is None


class _Event:
    """Stands in for a completed timing CUDA event at ``ms``."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture
def card_registry():
    """The program's registry after three traced stretches' reads on a card
    (stand-in events; every part 1 ms longer each stretch, the head run
    twice a step)."""
    from dino_tracker_tpu_torch.utils import profiling
    profiling.reset_stage_timers()
    steps = profiling.StepSpans(torch.device("cpu"))
    steps.cuda = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in range(3):
            taken = [("train/step", _Event(0), _Event(160 + k))]
            for i, part in enumerate(PARTS):
                taken.append((f"train/step/{part}", _Event(0), _Event(i + 1 + k)))
            taken.append(("train/step/head", _Event(0), _Event(1)))
            steps._newest, steps._unread = taken, True
            steps.read()
    yield profiling
    profiling.reset_stage_timers()


@pytest.mark.parametrize("metric", sorted(TRAIN))
def test_each_train_reader_on_a_card_runs_record(metric, card_registry):
    mean = lambda part: PARTS.index(part) + 2 + (part == "head")  # ms, over k = 0, 1, 2
    record = {"card": True, "traced_steps": 15}
    assert reader(metric).read(record) == pytest.approx(sum(mean(p) for p in TRAIN[metric]))
    assert reader(metric).read({"card": False, "traced_steps": 15}) is None
    assert reader(metric).read({"card": True}) is None
    card_registry.reset_stage_timers()  # a program that read no spans
    assert reader(metric).read(record) is None


def test_the_contrastive_reader_without_the_refined_term(card_registry):
    """With the refined term's gate off the step has no
    ``contrastive_ref``: the reader reads the other term alone."""
    import dino_tracker_tpu_torch.utils.profiling as profiling
    with profiling._LOCK:
        profiling._STAGE_TIMES.pop("train/step/contrastive_ref")
    dino = PARTS.index("contrastive_dino") + 2
    assert reader("step_contrastive_ms.train").read(
        {"card": True, "traced_steps": 15}) == pytest.approx(dino)
