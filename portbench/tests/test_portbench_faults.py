"""The check that decides ``correct`` fails what it must: the whole run of
the tiny cell with the timed path broken underneath (a step that leaves its
state unchanged; half of the batch left out, the mean taken over the rest)
comes out not correct, and so does the control (the plain reference in
float8 operands put in the program's place), while a sound run is correct.
On the card, the control fails the cell's own limits at its own size."""

import math
import os

import pytest
import torch

import calibrate
import faults
import run
import tiny
from conftest import ROOT


def test_a_sound_run_is_correct():
    assert tiny.run_tiny(seed=6)[0]["correct"] is True


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_a_broken_step_is_caught(fault):
    mend = faults.PROGRAM_FAULTS[fault]()
    try:
        result, _ = tiny.run_tiny(seed=6)
    finally:
        mend()
    assert result["correct"] is False
    if fault == "frozen_state":  # the leaves' change reads 1
        assert result["checks"]["change_median"]["value"] > 0.5


def test_the_control_is_not_correct():
    rows = [calibrate.readings(tiny.bench(), tiny.CELL, seed, "cpu") for seed in (5, 6, 7)]
    for r in rows:
        program_ok = all(r["program"][k] <= v for k, v in tiny.LIMITS.items())
        control_ok = all(r["control"][k] <= v for k, v in tiny.LIMITS.items())
        fault_ok = all(r["half_batch"][k] <= v for k, v in tiny.LIMITS.items())
        assert program_ok and not control_ok and not fault_ok, r


@pytest.mark.cuda
def test_the_control_fails_the_cells_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the card")
    cell = "dt-l14-davis.train-on"
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    limits = run.load_json(run.resolve(bench, cell)["limits_path"])
    for seed in (101, 102, 103):
        r = calibrate.readings(bench, cell, seed, "cuda:0")
        assert all(math.isfinite(r["program"][k]) and r["program"][k] <= v
                   for k, v in limits.items()), r
        assert not all(r["control"][k] <= v for k, v in limits.items()), r
        assert not all(r["half_batch"][k] <= v for k, v in limits.items()), r


@pytest.mark.cuda
def test_the_mesh_cells_control_and_faults_fail_its_limits_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: the mesh cell's own size runs on four cards")
    cell = "dt-l14-davis-dp4.train-on"
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    limits = run.load_json(run.resolve(bench, cell)["limits_path"])
    for seed in (101, 102, 103):
        r = calibrate.readings(bench, cell, seed, "cuda:0", program_faults=["no_exchange"])
        assert all(math.isfinite(r["program"][k]) and r["program"][k] <= v
                   for k, v in limits.items()), r
        for kind in ("control", "half_batch", "program_no_exchange"):
            assert not all(r[kind][k] <= v for k, v in limits.items()), (kind, r)
