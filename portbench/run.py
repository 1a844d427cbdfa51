"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in the checkout's ``BENCHMARK.json``.
Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

* ``configs/<config>.json`` (the entry's ``file``): the sizes as run;
* ``traffic/<traffic>.json``: the traffic's parameters, and in ``generator``
  the name of the general generator that reads them,
  ``generators/<generator>.py`` (``run(ctx) -> dict``);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell;
* ``metrics/<metric>.py`` (``read(record) -> float | None``): one reader a
  per-layer metric; a reader that finds nothing to read returns None and
  the metric is left out.

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (read from the same run, whose device
trace is taken after the measured window). The last line of standard output
is one JSON object; the numbers compared and their limits close both it
(``checks``) and standard error. A run exits non-zero, and prints no result,
when the card is missing, the program cannot be imported, or a module of
JAX or of the JAX package is loaded once the window has closed: in this
process, or in any process that ran the cell's work (a generator that
spawns ranks returns each one's loaded top-level names under ``modules``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dino_tracker_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise RunError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def context(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, base: str = HERE, plant=None):
    """(the cell's files, the generator's context). The program is imported
    from the checkout's root; a cell of several chips runs one rank a chip
    (``ctx.ranks``)."""
    import torch
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    files = resolve(bench, cell, base)
    ctx = SimpleNamespace(cell=cell, config=load_json(files["config_path"]),
                          ranks=int(files["workload"]["chips"]),
                          traffic=files["traffic"], seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=torch.device(device), t_start=t_start,
                          t_start_wall=time.time() - (time.perf_counter() - t_start),
                          tmpdir=tempfile.gettempdir(), plant=plant)
    return files, ctx


def resolve(bench: dict, cell: str, base: str = HERE) -> dict:
    """The files of one cell, found by the names in ``bench``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell not in by_name:
        raise RunError(f"no cell {cell!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[cell]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    return {"workload": w,
            "config_path": os.path.join(os.path.dirname(base), config["file"]),
            "traffic": traffic,
            "generator_path": os.path.join(base, "generators", f"{traffic['generator']}.py"),
            "limits_path": os.path.join(base, "limits", f"{cell}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])],
            "per_layer": [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])],
            "readers": {m["name"]: os.path.join(base, "metrics", f"{m['name']}.py")
                        for m in bench["per_layer"]}}


def traffic_generator(files: dict):
    """The traffic's generator, imported by its module name (``generators.<name>``)
    so that ranks spawned from it find it too."""
    return importlib.import_module(f"generators.{files['traffic']['generator']}")


def top_level_modules() -> list:
    """The top-level names of the modules this process has loaded."""
    return sorted({n.split(".")[0] for n in list(sys.modules)})


def forbidden_modules(names=None) -> list:
    """Of the loaded modules (``names``, default this process's), those whose
    top-level name is JAX's or the JAX package's, compared whole (the port's
    name begins with the JAX package's)."""
    names = top_level_modules() if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def check_modules(processes: dict) -> None:
    """Raise when this process, or one of ``processes`` (a name -> its loaded
    top-level names), has loaded a module of JAX or of the JAX package."""
    found = {name: forbidden_modules(names)
             for name, names in {"this process": None, **processes}.items()}
    found = {name: mods for name, mods in found.items() if mods}
    if found:
        raise RunError(f"modules of JAX or of the JAX package are loaded: {found}")


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             base: str = HERE, t_start: float = T_START, limits: dict = None, plant=None):
    """Drive one cell once on ``device``; returns its result object
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    optionally ``breakdown``, then ``checks``) and where each compared
    number was worst."""
    import torch
    files, ctx = context(bench, cell, seed, seconds, trace, device, t_start, base, plant)
    if limits is None:
        limits = load_json(files["limits_path"])
    out = traffic_generator(files).run(ctx)
    check_modules(out.get("modules", {}))
    from yardstick import compare
    ok, checks = compare.judge(out["readings"], limits)
    dev = ctx.device
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not trace:
        values = {**out["metrics"], "setup_s": out["setup_s"]}
        for m in files["end_to_end"]:
            if m["name"] not in values:
                raise RunError(f"the generator gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in files["per_layer"]:
            reader = load_module(files["readers"][m["name"]], f"portbench_metric_{m['name']}")
            value = reader.read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": int(files["workload"]["chips"]),
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(ok and out["failed"] == 0), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if trace and out.get("trace") is not None:
        device_info["busy_s"] = out["trace"].busy_s
        device_info["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result, {**out["readings"].get("where", {}), "setup_s": out["setup_s"]}


def card_state() -> str:
    """The card's name, power limit, clock, power draw, temperature and
    active clock-throttle reasons, as ``nvidia-smi`` reads them (or why
    not)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)  # caches stay in the checkout
    try:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        chips = int(resolve(bench, args.workload)["workload"]["chips"])
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} CUDA device(s); "
                           f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                           f"device_count() {torch.cuda.device_count()}")
        result, where = run_cell(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0")
    except Exception as e:  # no result line: the run failed
        print(f"portbench: {args.workload} failed: {type(e).__name__}: {e}", file=sys.stderr)
        if not isinstance(e, RunError):
            import traceback
            traceback.print_exc()
        return 1
    print(f"portbench: {args.workload} seed {args.seed}: worst at {json.dumps(where)}; "
          f"card {card_state()}", file=sys.stderr)
    for name, row in result["checks"].items():
        mark = "ok" if math.isfinite(row["value"]) and row["value"] <= row["limit"] else "FAIL"
        print(f"check {name}: {row['value']!r} limit {row['limit']!r} {mark}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
