"""A run's result line on the CPU at a tiny size: its keys, its checks, and
the program held to the plain reference."""

import json
import math

import pytest

import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(trace):
    result, where = tiny.run_tiny(trace=trace)
    json.dumps(result)  # one JSON object
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(tiny.LIMITS)
    for name, row in result["checks"].items():
        assert set(row) == {"value", "limit"} and math.isfinite(row["value"])
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert result["metrics"].keys() <= {"train_step_mfu.train", "device_idle.train",
                                            "k1_fwd_roofline.train", "k1_bwd_roofline.train"}
    else:
        assert set(result["metrics"]) == {"train_ms_per_iter", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert where["left_out"] == ["tracker_head.conv2.bias"]  # its gradient is rounding alone
