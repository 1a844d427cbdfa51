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


def device_fence(device: Optional[torch.device] = None):
    """Wait until ``device`` has finished its queued work; a no-op for the
    CPU (or None)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timer(name: str, fence: Optional[torch.device] = None):
    """Accumulating wall-clock timer for pipeline stages; with ``fence`` the
    time runs until that device has finished the stage's work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        device_fence(fence)
        dt = time.perf_counter() - t0
        _STAGE_TIMES[name] += dt
        _STAGE_COUNTS[name] += 1
        logger.info("[timing] %s: %.2fs (total %.1fs over %d calls)",
                    name, dt, _STAGE_TIMES[name], _STAGE_COUNTS[name])


def stage_report() -> Dict[str, dict]:
    return {k: {"total_s": round(v, 3), "calls": _STAGE_COUNTS[k]}
            for k, v in sorted(_STAGE_TIMES.items(), key=lambda kv: -kv[1])}


def reset_stage_timers():
    _STAGE_TIMES.clear()
    _STAGE_COUNTS.clear()


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
