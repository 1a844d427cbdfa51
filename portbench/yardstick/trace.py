"""Device traces: run a stretch of work under ``torch.profiler`` (host and
card) and reduce its Chrome trace to what the per-layer metrics read.

A stretch is short (a CUDA graph's replays lost kernels in a 25-step trace),
so a traced run profiles several and adds them up (``TraceSummary.add``).
Busy time is the union of the intervals in which any device operation ran
(kernels, copies, sets), so work that overlaps on two streams counts once;
``busy_s_without`` leaves out operations whose name holds a given word (NCCL's
kernels spin while they wait for a peer, so they are busy without work).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def _union_s(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(seconds covered, merged intervals) of [start, end) intervals in µs."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, [(a, b) for a, b in merged]


class TraceSummary:
    """What the traces of one run hold: the traced wall seconds, the device
    operations (name -> [count, seconds]), the busy seconds, and the idle
    gaps between device operations with what the host was doing as each
    began."""

    def __init__(self):
        self.window_s = 0.0
        self.ops: Dict[str, List[float]] = {}
        self.busy_s = 0.0
        self._busy_without: Dict[str, float] = {}
        self.gaps: List[Tuple[float, float, int]] = []  # (seconds, start µs, stretch)
        self.stretches = 0
        self._device_events: List[List[dict]] = []
        self._host_events: List[List[dict]] = []

    def add(self, events: List[dict], wall_s: float):
        device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
        for e in device:
            op = self.ops.setdefault(e["name"], [0, 0.0])
            op[0] += 1
            op[1] += e["dur"] / 1e6
        busy, merged = _union_s([(e["ts"], e["ts"] + e["dur"]) for e in device])
        self.busy_s += busy
        self._device_events.append(device)
        self._host_events.append(host)
        self.window_s += wall_s
        self.gaps.extend(((start - end) / 1e6, end, self.stretches)
                         for (_, end), (start, _) in zip(merged, merged[1:]))
        self.stretches += 1

    def busy_s_without(self, word: str) -> float:
        """Busy seconds with the operations whose name holds ``word`` (any
        case) left out."""
        if word not in self._busy_without:
            total = 0.0
            for device in self._device_events:
                total += _union_s([(e["ts"], e["ts"] + e["dur"]) for e in device
                                   if word.lower() not in e["name"].lower()])[0]
            self._busy_without[word] = total
        return self._busy_without[word]

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(launches, seconds) of the device operations whose name holds
        ``fragment``."""
        hits = [v for k, v in self.ops.items() if fragment in k]
        return int(sum(v[0] for v in hits)), float(sum(v[1] for v in hits))

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, by what the host was doing (at most TOP of each)."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps, reverse=True)[:TOP]
        return {"device_ops": [[_short(k), v[1]] for k, v in ops],
                "idle_gaps": [[_short(_host_at(self._host_events[i], t)), s]
                              for s, t, i in gaps]}


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n]


def _host_at(host: List[dict], t: float) -> str:
    """The innermost host event running at ``t`` µs, or "host idle"."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
            best = e
    return best["name"] if best is not None else "host idle"


def profile(fn: Callable[[], None], tmpdir: str, summary: TraceSummary):
    """Run ``fn`` (which ends with its device work queued) under
    ``torch.profiler``, fenced on the card before and after, and add its
    trace to ``summary``. The Chrome trace goes to ``tmpdir`` and is removed
    once read."""
    import torch
    from torch.profiler import ProfilerActivity
    card = torch.cuda.is_available()
    fence = torch.cuda.synchronize if card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    fence()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        fence()
        wall = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"portbench-trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    summary.add(events, wall)
