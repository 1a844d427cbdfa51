"""Stage timers and device traces of the port (counterpart of
``dino_tracker_tpu/utils/profiling.py``).

A process-wide registry of accumulating wall-clock stage timers with the JAX
package's names and report format, a device fence for timing (CUDA work is
asynchronous, so a host clock without one measures the enqueue), and a
``torch.profiler`` trace written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

_STAGE_TIMES: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)
_STAGE_BYTES: Dict[str, int] = defaultdict(int)


def device_fence(device: Optional[torch.device] = None):
    """Wait until ``device`` has finished its queued work; a no-op for the
    CPU (or None)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timer(name: str, fence: Optional[torch.device] = None, nbytes: int = 0):
    """Accumulating wall-clock timer for pipeline stages; with ``fence`` the
    time runs until that device has finished the stage's work. ``nbytes``
    (a transfer's size) accumulates beside the time."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        device_fence(fence)
        dt = time.perf_counter() - t0
        _STAGE_TIMES[name] += dt
        _STAGE_COUNTS[name] += 1
        if nbytes:
            _STAGE_BYTES[name] += nbytes
        logger.info("[timing] %s: %.2fs (total %.1fs over %d calls)",
                    name, dt, _STAGE_TIMES[name], _STAGE_COUNTS[name])


def stage_report() -> Dict[str, dict]:
    """Each stage's total seconds and calls (and bytes, for transfers)."""
    return {k: {"total_s": round(v, 3), "calls": _STAGE_COUNTS[k],
                **({"bytes": _STAGE_BYTES[k]} if k in _STAGE_BYTES else {})}
            for k, v in sorted(_STAGE_TIMES.items(), key=lambda kv: -kv[1])}


def reset_stage_timers():
    _STAGE_TIMES.clear()
    _STAGE_COUNTS.clear()
    _STAGE_BYTES.clear()


def add_slowest_rank(mesh, prefix: str):
    """Beside each of this rank's stage timers whose name starts with
    ``prefix``, the largest total any rank of ``mesh`` holds for it, as
    ``<name>/slowest_rank`` (one all_gather; every rank must hold the same
    names, as ranks running the same loop do)."""
    import torch.distributed as dist
    names = sorted(n for n in _STAGE_TIMES
                   if n.startswith(prefix) and not n.endswith("/slowest_rank"))
    mine = torch.tensor([_STAGE_TIMES[n] for n in names], dtype=torch.float64,
                        device=mesh.device)
    every = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(every, mine, group=mesh.group)
    for n, slowest in zip(names, torch.stack(every).max(dim=0).values.tolist()):
        _STAGE_TIMES[f"{n}/slowest_rank"] = slowest
        _STAGE_COUNTS[f"{n}/slowest_rank"] = _STAGE_COUNTS[n]


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launch count in this process (the
    wrappers' counters, which callers reset)."""
    from ..ops import blurpool, flash_attention, window_gather
    return {"blurpool_down_nhwc": blurpool.blurpool_cuda.launches,
            "blurpool_up_nhwc": blurpool.blurpool_cuda_bwd.launches,
            "flash_attention": flash_attention.flash_attention_cuda.launches,
            "corr_lookup": window_gather.corr_lookup_cuda.launches}


def graph_counts() -> Dict[str, int]:
    """The train-step captures made and the steps replayed from them in this
    process (``training/step_graph.StepGraph``'s counters, which callers
    reset)."""
    from ..training.step_graph import StepGraph
    return {"captures": StepGraph.captures, "replays": StepGraph.replays}


def rank_report(device: Optional[torch.device] = None) -> dict:
    """What one process ran: its stage report, its kernel launches, its
    train-step captures and replays and, on a card, the peak device memory
    (what a multi-rank CLI returns per rank)."""
    report = {"stages": stage_report(), "launches": kernel_launches(),
              "graphs": graph_counts()}
    if device is not None and torch.device(device).type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return report


def dump_stage_report() -> str:
    """The stage report as indented JSON."""
    return json.dumps(stage_report(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record the enclosed work with ``torch.profiler`` (host, and the card
    where there is one) and write it to ``logdir/trace.json`` as a Chrome
    trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
