"""A measuring run with no card fails and prints no result: it does not fall
back to the CPU. So does a run from a directory holding only BENCHMARK.json
and the harness, where the program is missing."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import PORTBENCH, ROOT



def _run(cwd, env_extra=None):
    env = {**os.environ, "PYTHONPATH": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "dt-l14-davis.train-on", "--seed", "4294967311", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def _no_result(out):
    for line in out.stdout.strip().splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_a_run_without_a_card_fails_with_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    _no_result(out)
    assert "CUDA device" in out.stderr


def test_a_run_without_the_program_fails_with_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
    # past the card's look as well: the program cannot be imported
    code = ("import sys, time; sys.path.insert(0, 'portbench'); import run; "
            "run.run_cell(run.load_json('BENCHMARK.json'), 'dt-l14-davis.train-on', 1, 1.0, "
            "False, 'cpu', t_start=time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and "No module named 'dino_tracker_tpu_torch'" in out.stderr
