#!/usr/bin/env python3
"""Where the eager train step's time goes on the card: the device's busy
share and the host syncs of one step, for this checkout's port or an earlier
one (the replayed step's busy share is chip_smoke.py phase 5's).

    python3 scripts/profile_train_step.py [--root DIR] [--steps 10]

Runs the port under ``--root`` (default: this checkout; an unpacked earlier
commit works too: ``git archive <commit> | tar -x -C build/parent_tree``)
at TrainConfig's full width on chip_smoke.py's phase 5 data (T=50 at
854x476, C=1024, 100k + 100k trajectories, made on the card from a seed),
from the Trainer's init, for each set of phase gates: warm-up steps, then
``--steps`` steps timed on the host clock (synchronised) under
torch.profiler tracing the card (busy share: the traced device time over
that wall time), and one step under torch.cuda.set_sync_debug_mode("warn")
(host syncs). Prints one JSON line per set of gates, then the card's name
and power limit. Needs one CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))  # the port under test
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    # this checkout's smoke for the data, the trace and the sync count,
    # whichever port
    # runs: its helpers import the port when called
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.training import train
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig()
    tcfg = TrackerConfig(video_h=smoke.H, video_w=smoke.W, delta_channels=smoke.CHANNELS,
                         compute_dtype=cfg.compute_dtype)
    video, dino = smoke.make_inputs(smoke.T, smoke.H, smoke.W, smoke.CHANNELS[-1],
                                    tcfg.feat_hw, dev, 1)
    data = smoke.make_train_data(video, dino, dev, 5)
    trainer = train.Trainer(cfg, tcfg, data, "", seed=2, device=dev)
    for gates in (False, True):
        model = trainer.init_model().train()
        opt, sched = train.make_optimizer(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(2)
        step = lambda: train.train_step(model, opt, sched, data, gen, gates, gates, cfg, tcfg)
        for _ in range(3):
            step()
        syncs = smoke.count_syncs(step)
        wall, device_ms, _ = smoke.traced(lambda: [step() for _ in range(args.steps)])
        ms, device_ms = wall / args.steps, device_ms / args.steps
        print(json.dumps({"root": args.root, "gates": gates, "ms_per_iter": ms,
                          "device_ms_per_iter": device_ms, "busy_share": device_ms / ms,
                          "host_syncs": len(syncs), "sync_sites": sorted(set(syncs))}),
              flush=True)
        del model, opt, sched
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
