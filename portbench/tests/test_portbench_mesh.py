"""The training generator on a 4-rank mesh (gloo ranks on the CPU, as the
four-card cell runs NCCL ranks): every rank takes the same steps, the
slowest rank's window decides, and rank 0's checked steps are held to the
one-device reference; a mesh whose ranks leave out the gradients' exchange,
or the half of the batch, is not correct; and a mesh one of whose ranks has
loaded JAX gives no result."""

import pytest

import faults
import run
import tiny


def test_a_mesh_run_is_held_to_the_one_device_reference():
    result, where = tiny.run_tiny_dp4(seed=6)
    assert result["correct"] is True, (result, where)
    assert result["device"]["count"] == 4 and result["attempted"] > 0
    assert set(result["metrics"]) == {"train_ms_per_iter", "setup_s"}


def test_a_traced_mesh_run_has_the_contract_keys():
    result, _ = tiny.run_tiny_dp4(seed=5, trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_the_exchange_left_out_is_caught():
    result, _ = tiny.run_tiny_dp4(seed=6, plant=faults.no_exchange)
    assert result["correct"] is False
    assert result["checks"]["grad"]["value"] > result["checks"]["grad"]["limit"]


def test_half_the_batch_left_out_on_a_mesh_is_caught():
    result, _ = tiny.run_tiny_dp4(seed=6, plant=faults.half_batch)
    assert result["correct"] is False
    assert result["checks"]["loss"]["value"] > result["checks"]["loss"]["limit"]


def test_a_rank_that_loads_jax_gives_no_result():
    with pytest.raises(run.RunError, match=r"rank 2.*jax"):
        tiny.run_tiny_dp4(seed=5, plant=tiny.jax_on_rank_2)
