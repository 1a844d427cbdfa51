"""Every cell, configuration and metric of BENCHMARK.json resolves to its own
files by name, BENCHMARK.json keeps to the benchmark's contract, and a cell,
a traffic mix or a metric added as new files is found with no file edited."""

import copy
import hashlib
import json
import os
import re
import shutil

import pytest

from conftest import PORTBENCH, ROOT

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load_bench():
    return run.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_benchmark_json_keeps_to_the_contract():
    b = load_bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"} and 0 < m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", []):  # each cell reports the metric it moves
            moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for w in b["workloads"]:  # setup_s, another end-to-end metric, a per-layer metric
        mine = lambda ms: [m for m in ms if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine(b["end_to_end"])) >= 2 and mine(b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in load_bench()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    files = run.resolve(load_bench(), cell)
    for key in ("config_path", "generator_path", "limits_path"):
        assert os.path.isfile(files[key]), files[key]
    limits = run.load_json(files["limits_path"])
    assert limits and all(v > 0 for v in limits.values())
    assert hasattr(run.load_module(files["generator_path"], "d"), "run")


@pytest.mark.parametrize("metric", [m["name"] for m in load_bench()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    path = os.path.join(PORTBENCH, "metrics", f"{metric}.py")
    reader = run.load_module(path, f"m_{metric}")
    assert reader.read({}) is None  # nothing to read: nothing returned


def _digests(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_found_from_new_files_alone(tmp_path):
    copy_root = tmp_path / "checkout"
    shutil.copytree(PORTBENCH, copy_root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = str(copy_root / "portbench")
    before = _digests(base)
    b = copy.deepcopy(load_bench())
    # the new traffic mix, its cell's limits and a new per-layer metric: new files only
    traffic = run.load_json(os.path.join(base, "traffic", "train-on.json"))
    traffic.update(gates={"cycle": False, "refined_bb": False}, start_iteration=0)
    (copy_root / "portbench" / "traffic" / "train-off.json").write_text(json.dumps(traffic))
    (copy_root / "portbench" / "limits" / "dt-l14-davis.train-off.json").write_text(
        json.dumps({"loss": 1e-3}))
    (copy_root / "portbench" / "metrics" / "steps_traced.train.py").write_text(
        "def read(record):\n    return record.get('traced_steps')\n")
    b["workloads"].append({"name": "dt-l14-davis.train-off", "config": "dt-l14-davis",
                           "traffic": "train-off", "chips": 1, "why": "gates off"})
    b["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "train_ms_per_iter"})
    files = run.resolve(b, "dt-l14-davis.train-off", base)
    assert files["traffic"]["gates"] == {"cycle": False, "refined_bb": False}
    assert run.load_json(files["limits_path"]) == {"loss": 1e-3}
    assert files["generator_path"] == os.path.join(base, "generators", "train_loop.py")
    assert "steps_traced.train" in [m["name"] for m in files["per_layer"]]
    reader = run.load_module(files["readers"]["steps_traced.train"], "m_new")
    assert reader.read({"traced_steps": 15}) == 15
    after = _digests(base)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    assert set(after) - set(before) == {"traffic/train-off.json",
                                        "limits/dt-l14-davis.train-off.json",
                                        "metrics/steps_traced.train.py"}
