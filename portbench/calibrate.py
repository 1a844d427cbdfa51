"""The readings a training cell's limits are set from, on the card at the
cell's own size, seed by seed in one process:

* ``program``: the program's checked steps (the cell's set-up, as a run
  makes it) against the plain reference: the lower reading;
* ``control``: the reference in the precision below the configuration's
  (float8 e4m3 operands for bf16), put in the program's place: the upper
  reading;
* ``half_batch``: the reference with half of the batch left out and the flow
  term's mean taken over the rest, put in the program's place (a planted
  fault); ``program_<fault>``: a fault of ``faults.py`` planted in the
  program (``--program-faults``, after the sound readings, then mended). A step that
  leaves its state unchanged reads 1 by the leaf measures and needs no run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--device cuda:0]
        [--program-faults no_exchange]

Prints one JSON line a seed and a last line with each number's largest
program reading and smallest control and fault readings. Training's
readings need no measured window, so none is run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import run  # noqa: E402

def readings(bench: dict, cell: str, seed: int, device, faults=None,
             program_faults=()) -> dict:
    """One seed's readings of the program, the control, each fault planted in
    the reference put in the program's place (``faults``) and each fault
    planted in the program (``program_faults``, names in
    ``faults.PROGRAM_FAULTS``) against the reference. A cell of several
    ranks runs them on a mesh, rank 0 reading; as in a run, no process may
    have loaded a module of JAX or of the JAX package."""
    files, ctx = run.context(bench, cell, seed, 0.0, False, device, time.perf_counter())
    if ctx.ranks == 1:
        out = run.traffic_generator(files).calibrate(ctx, None, faults, program_faults)
        run.check_modules({})
        return out
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    outs = mesh_lib.spawn(_rank_readings, ctx.ranks, ctx.device.type,
                          args=(ctx, files, faults, program_faults))
    run.check_modules({f"rank {r}": modules for r, (_, modules) in enumerate(outs)})
    return outs[0][0]


def _rank_readings(mesh, ctx, files, faults, program_faults):
    ctx.device = mesh.device
    return (run.traffic_generator(files).calibrate(ctx, mesh, faults, program_faults),
            run.top_level_modules())


def summary(rows) -> dict:
    """Each number's largest program reading and smallest reading of the
    control and of each fault."""
    kinds = [k for k in rows[0] if k not in ("seed", "program", "seconds")]
    numbers = [n for n in rows[0]["program"] if n != "where"]
    return {n: {"program_max": max(r["program"][n] for r in rows),
                **{f"{k}_min": min(r[k][n] for r in rows if k in r) for k in kinds}}
            for n in numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--program-faults", default="", help="comma-separated names of "
                    "faults.PROGRAM_FAULTS to plant in the program after the sound readings")
    args = ap.parse_args(argv)
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows.append(readings(bench, args.workload, seed, args.device,
                             program_faults=[f for f in args.program_faults.split(",") if f]))
        rows[-1]["seconds"] = time.perf_counter() - t0
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"summary": summary(rows), "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
