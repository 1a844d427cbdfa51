"""The port's stage timers (``utils/profiling.py``) against the JAX
package's: the same sequence of timers gives a report with the same keys,
call counts and format; the port's fence and trace run on the CPU."""

import json
import os

import pytest

from dino_tracker_tpu.utils import profiling as jprofiling
from dino_tracker_tpu_torch.utils import profiling

SEQUENCE = ("preprocess/trajectories", "train/steps_gates_off", "preprocess/trajectories",
            "inference/query_frame_0", "train/steps_gates_off", "preprocess/trajectories")


@pytest.fixture
def clean_registries():
    for mod in (profiling, jprofiling):
        mod.reset_stage_timers()
    yield
    for mod in (profiling, jprofiling):
        mod.reset_stage_timers()


def test_stage_report_matches_jax(clean_registries):
    for name in SEQUENCE:
        with profiling.stage_timer(name, fence="cpu"):
            pass
        with jprofiling.stage_timer(name):
            pass
    got, want = profiling.stage_report(), jprofiling.stage_report()
    assert {k: v["calls"] for k, v in got.items()} == {k: v["calls"] for k, v in want.items()}
    assert got["preprocess/trajectories"]["calls"] == 3
    assert all(v.keys() == {"total_s", "calls"} for v in got.values())
    assert json.loads(profiling.dump_stage_report()) == got
    assert json.loads(jprofiling.dump_stage_report()) == want
    profiling.reset_stage_timers()
    assert profiling.stage_report() == {}


def test_timer_records_a_failing_stage(clean_registries):
    with pytest.raises(RuntimeError):
        with profiling.stage_timer("eval/0"):
            raise RuntimeError("boom")
    assert profiling.stage_report()["eval/0"]["calls"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch
    profiling.device_fence(None)
    profiling.device_fence(torch.device("cpu"))
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        assert "traceEvents" in json.load(f)
