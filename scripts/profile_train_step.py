#!/usr/bin/env python3
"""Where the eager train step's time goes on the card: the device's busy
share, NCCL's share of the device time and the host syncs of one step, on
one card or on each rank of an NCCL mesh, for this checkout's port or an
earlier one (the replayed step's busy share is chip_smoke.py's, phases 5
and 12).

    python3 scripts/profile_train_step.py [--root DIR] [--steps 10] [--devices N]

Runs the port under ``--root`` (default: this checkout; an unpacked earlier
commit works too: ``git archive <commit> | tar -x -C build/parent_tree``)
at TrainConfig's full width on chip_smoke.py's phase 5 data (T=50 at
854x476, C=1024, 100k + 100k trajectories, made on the card from a seed),
from the Trainer's init, for each set of phase gates: warm-up steps, then
``--steps`` steps timed on the host clock (synchronised) under
torch.profiler tracing the card (busy share: the traced device time over
that wall time; NCCL share: NCCL's kernels' device time over the traced
device time; busy without NCCL: the device time less NCCL's over the wall
time, since NCCL's kernels spin while they wait for a slower peer), and
one step under torch.cuda.set_sync_debug_mode("warn")
(host syncs). With ``--devices N`` (N > 1) the step is the data-parallel
one on N ranks over NCCL, rank r on cuda:r, every rank with the same data
and seed. Prints one JSON line per rank and set of gates (and, on a mesh,
one for the slowest rank), then the cards' names and power limits. Needs N
CUDA devices (one without ``--devices``).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py, for the data, the trace and the sync
    count, whichever port runs: its helpers import the port when called."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def profile(mesh, root, steps):
    """Each set of gates' profile of the eager step on this rank's card (or
    the one card, ``mesh`` None)."""
    import torch
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.training import train
    smoke = _smoke()
    dev = torch.device("cuda") if mesh is None else mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig()
    tcfg = TrackerConfig(video_h=smoke.H, video_w=smoke.W, delta_channels=smoke.CHANNELS,
                         compute_dtype=cfg.compute_dtype)
    video, dino = smoke.make_inputs(smoke.T, smoke.H, smoke.W, smoke.CHANNELS[-1],
                                    tcfg.feat_hw, dev, 1)
    data = smoke.make_train_data(video, dino, dev, 5)
    trainer = train.Trainer(cfg, tcfg, data, "", seed=2, device=dev, mesh=mesh)
    rows = []
    for gates in (False, True):
        model = trainer.init_model().train()
        opt, sched = train.make_optimizer(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(2)
        step = lambda: train.train_step(model, opt, sched, data, gen, gates, gates, cfg,
                                        tcfg, mesh)
        for _ in range(3):
            step()
        syncs = smoke.count_syncs(step)
        wall, device_ms, _, nccl_ms = smoke.traced(lambda: [step() for _ in range(steps)])
        ms = wall / steps
        rows.append({"root": root, "rank": 0 if mesh is None else mesh.rank,
                     "ranks": 1 if mesh is None else mesh.world_size, "gates": gates,
                     "ms_per_iter": ms, "device_ms_per_iter": device_ms / steps,
                     "busy_share": device_ms / wall, "nccl_share_of_device": nccl_ms / device_ms,
                     "busy_share_without_nccl": (device_ms - nccl_ms) / wall,
                     "host_syncs": len(syncs), "sync_sites": sorted(set(syncs))})
        del model, opt, sched
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--devices", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))  # the port under test
    import torch
    if torch.cuda.device_count() < max(args.devices, 1):
        raise SystemExit(f"needs {max(args.devices, 1)} CUDA devices")
    if args.devices > 1:
        from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
        ranks = mesh_lib.spawn(profile, args.devices, "cuda", args=(args.root, args.steps))
        rows = [row for rank in ranks for row in rank]
        for gates in (False, True):
            mine = [r for r in rows if r["gates"] == gates]
            rows.append({"rank": "slowest", "ranks": args.devices, "gates": gates,
                         **{k: max(r[k] for r in mine) for k in ("ms_per_iter",
                                                                  "host_syncs")},
                         **{k: min(r[k] for r in mine) for k in (
                             "busy_share", "busy_share_without_nccl")}})
    else:
        rows = profile(None, args.root, args.steps)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
