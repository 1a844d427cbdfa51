"""No module a run loads has the top-level name of JAX or of the JAX package
(compared whole: the port's name begins with the JAX package's), and the
plain reference and the yardstick import none of those nor the program."""

import ast
import os
import subprocess
import sys
import types

import pytest

from conftest import PORTBENCH, ROOT

import run

PROGRAM = "dino_tracker_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("folder", ["reference", "yardstick"])
def test_reference_and_yardstick_import_no_jax_and_no_program(folder):
    for f in os.listdir(os.path.join(PORTBENCH, folder)):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(PORTBENCH, folder, f)))
            assert not names & set(run.FORBIDDEN + (PROGRAM,)), (f, names)


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for d, _, fs in os.walk(PORTBENCH):
        for f in fs:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(d, f)))
                assert not names & set(run.FORBIDDEN), (f, names)
                assert not names & {"chip_smoke", "bench", "scripts"}, (f, names)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dino_tracker_tpu_torchlike", types.ModuleType("x"))
    assert "dino_tracker_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dino_tracker_tpu.models", types.ModuleType("x"))
    assert run.forbidden_modules() == ["dino_tracker_tpu"]


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = [{r!r}, {p!r}, {t!r}]\n"
            "import torch; torch.set_num_threads(1)\n"
            "import tiny, run\n"
            "result, _ = tiny.run_tiny()\n"
            "assert result['correct']\n"
            "print(sorted({{n.split('.')[0] for n in sys.modules}}))\n").format(
        r=ROOT, p=PORTBENCH, t=os.path.join(PORTBENCH, "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded and not loaded & set(run.FORBIDDEN)


def test_the_reference_alone_loads_no_program():
    code = ("import sys; sys.path[:0] = [{p!r}]\n"
            "from reference import train_step\n"
            "from yardstick import compare, counts, peaks, rooflines, trace, train_data\n"
            "print(sorted({{n.split('.')[0] for n in sys.modules}}))\n").format(p=PORTBENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=PORTBENCH, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(run.FORBIDDEN + (PROGRAM,))
