"""The preprocessing generator on the CPU at a tiny size: a sound run is held
to the plain reference and is correct; a run whose flows are altered where
they are produced is not, and neither is the control (the reference with
float8 ViT operands put in the program's place)."""

import calibrate
import faults
import tiny


def test_a_sound_preprocessing_run_is_correct():
    result, where = tiny.run_tiny_pre(seed=6)
    assert result["correct"] is True, (result, where)
    assert set(result["metrics"]) == {"preprocess_s_per_video", "setup_s"}
    assert result["attempted"] >= 1 and where["trajectories"][0] > 0


def test_an_altered_flow_is_caught():
    mend = faults.altered_flow()
    try:
        result, _ = tiny.run_tiny_pre(seed=6)
    finally:
        mend()
    assert result["correct"] is False
    assert result["checks"]["traj_px"]["value"] > result["checks"]["traj_px"]["limit"]


def test_the_preprocessing_control_is_not_correct():
    r = calibrate.readings(tiny.bench_pre(), tiny.CELL_PRE, 7, "cpu")
    assert all(r["program"][k] <= v for k, v in tiny.LIMITS_PRE.items()), r["program"]
    assert not all(r["control"][k] <= v for k, v in tiny.LIMITS_PRE.items()), r["control"]
