"""Spans and device traces of the port (counterpart of
``dino_tracker_tpu/utils/profiling.py``).

One process-wide registry of accumulating spans, reported with the JAX
package's names and format (``stage_report``), holds two kinds of span:

* **Host spans** (``stage_timer``): the wall-clock seconds of a named piece
  of work, with an optional device fence (CUDA work is asynchronous, so a
  host clock without one measures the enqueue). While a ``torch.profiler``
  session records (``tracing``: ``device_trace`` or any other session), a
  span also opens a ``record_function`` of its name, so it lies on the device
  trace's clock as a ``user_annotation`` event, its fenced end inside it, and
  the kernels it launched are found from the trace by their correlation
  ids. Names nest with ``/`` (``preprocess/trajectories/harvest`` is a part
  of ``preprocess/trajectories``). With no profiler recording a span costs
  one flag check beyond its timer.
* **Step spans** (``StepSpans``): the parts of one train step,
  ``train/step/<part>`` inside ``train/step``, timed on the device's clock by
  a pair of timing CUDA events recorded on the current stream (on the CPU,
  the host clock), so they time the parts of a step captured into a CUDA
  graph too: capture turns each event into an event-record node that every
  replay records again. They are read into the registry, as device seconds
  and samples, only where the card is waited on anyway and only while a
  profiler records (``StepSpans.read``).

``device_trace`` writes a ``torch.profiler`` trace as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from ..ops import _guard

logger = logging.getLogger(__name__)

_STAGE_TIMES: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)
_STAGE_BYTES: Dict[str, int] = defaultdict(int)
# the clock of each step span's seconds ("device" on a card, "host" on the CPU)
_STAGE_CLOCKS: Dict[str, str] = {}
# spans close on writer threads too
_LOCK = threading.Lock()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session records in this process (the
    profiler's own flag, set while any session records)."""
    return torch.autograd.profiler._is_profiler_enabled


def device_fence(device: Optional[torch.device] = None):
    """Wait until ``device`` has finished its queued work; a no-op for the
    CPU (or None)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Span:
    """A host span's seconds, set when it closes."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


@contextlib.contextmanager
def stage_timer(name: str, fence: Optional[torch.device] = None, nbytes: int = 0,
                log: bool = True):
    """A host span: accumulating wall-clock timer for pipeline stages and
    their parts; with ``fence`` the time runs until that device has finished
    the span's work. ``nbytes`` (a transfer's size) accumulates beside the
    time. Yields a ``Span`` whose ``seconds`` are set when it closes. While
    a profiler records, the span is also a ``record_function`` of ``name``
    that closes after the fence. ``log``: a line at INFO as it closes."""
    annotation = None
    if tracing():
        annotation = torch.autograd.profiler.record_function(name)
        annotation.__enter__()
    span = Span()
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        try:
            device_fence(fence)
        finally:
            span.seconds = dt = time.perf_counter() - t0
            if annotation is not None:
                annotation.__exit__(None, None, None)
        with _LOCK:
            _STAGE_TIMES[name] += dt
            _STAGE_COUNTS[name] += 1
            if nbytes:
                _STAGE_BYTES[name] += nbytes
            total, calls = _STAGE_TIMES[name], _STAGE_COUNTS[name]
        if log:
            logger.info("[timing] %s: %.2fs (total %.1fs over %d calls)",
                        name, dt, total, calls)


def stage_seconds(*names: str) -> float:
    """The registry's total seconds of the spans ``names`` so far (a caller
    takes the difference over a run for its own view)."""
    with _LOCK:
        return sum(_STAGE_TIMES.get(n, 0.0) for n in names)


def stage_report() -> Dict[str, dict]:
    """Each span's total seconds and calls (and bytes, for transfers); a
    step span's entry holds its seconds to the µs, its samples as calls, and
    its ``clock``."""
    with _LOCK:
        items = sorted(_STAGE_TIMES.items(), key=lambda kv: -kv[1])
        report = {}
        for k, v in items:
            if k in _STAGE_CLOCKS:
                report[k] = {"total_s": round(v, 6), "calls": _STAGE_COUNTS[k],
                             "clock": _STAGE_CLOCKS[k]}
            else:
                report[k] = {"total_s": round(v, 3), "calls": _STAGE_COUNTS[k],
                             **({"bytes": _STAGE_BYTES[k]} if k in _STAGE_BYTES else {})}
        return report


def reset_stage_timers():
    with _LOCK:
        _STAGE_TIMES.clear()
        _STAGE_COUNTS.clear()
        _STAGE_BYTES.clear()
        _STAGE_CLOCKS.clear()


# ---------------------------------------------------------------------------
# step spans
# ---------------------------------------------------------------------------

# the recorder of the train step being taken in this process, while its
# parts are recorded
_step: Optional["StepSpans"] = None


class StepSpans:
    """The parts of one train step on ``device``'s clock: ``part(name)``
    brackets a part with two timing CUDA events on the current stream
    (``external``, so a capture records them as event-record nodes and
    every replay records them again), or with the host clock on the CPU.
    A backward part begins or ends where the backward pass reaches a
    tensor's gradient (``step_boundary``).

    A step records its parts (``taking``) when it is being captured, so the
    graph always holds the events, or, eagerly, while a profiler records;
    otherwise each part costs a flag check. ``read`` adds the newest
    completed step's parts, once, to the registry: per part, the seconds of
    every time it ran in that step, and one sample."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._open: Dict[str, tuple] = {}   # part -> (start, annotation)
        self._taken: List[tuple] = []       # (part, start, end) of the step being taken
        self._newest: List[tuple] = []      # of the newest step completed
        self._captured: List[tuple] = []    # of the captured step (replays record them)
        self._unread = False

    @contextlib.contextmanager
    def taking(self, capturing: bool = False):
        """Around one step; ``capturing``: the step is being captured into a
        CUDA graph (it runs nothing: its parts complete in each replay)."""
        global _step
        on = capturing or tracing()
        outer, _step = _step, (self if on else None)
        self._open, self._taken = {}, []
        try:
            yield
        finally:
            _step = outer
        if not on:
            return
        if capturing:
            self._captured = self._taken
        else:
            self._newest, self._unread = self._taken, True

    def replayed(self):
        """The captured step was replayed: its parts are the newest."""
        if self._captured:
            self._newest, self._unread = self._captured, True

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def begin(self, name: str):
        annotation = None
        if tracing():
            annotation = torch.autograd.profiler.record_function(name)
            annotation.__enter__()
        self._open[name] = (self._mark(), annotation)

    def end(self, name: str):
        if name not in self._open:  # its begin was never reached (no gradient)
            return
        start, annotation = self._open.pop(name)
        self._taken.append((name, start, self._mark()))
        if annotation is not None:
            annotation.__exit__(None, None, None)

    @contextlib.contextmanager
    def part(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def read(self):
        """While a profiler records: the newest completed step's parts into
        the registry, unless they were read already (on a card this waits
        for that step's last event; the callers wait for the card anyway)."""
        if not (self._unread and tracing()):
            return
        self._unread = False
        seconds: Dict[str, float] = defaultdict(float)
        for name, start, end in self._newest:
            if self.cuda:
                end.synchronize()
                seconds[name] += start.elapsed_time(end) / 1e3
            else:
                seconds[name] += end - start
        clock = "device" if self.cuda else "host"
        with _LOCK:
            for name, s in seconds.items():
                _STAGE_TIMES[name] += s
                _STAGE_COUNTS[name] += 1
                _STAGE_CLOCKS[name] = clock


def step_span(name: str):
    """The train step's part ``name`` (``train/step`` or
    ``train/step/<part>``): recorded while a step records its parts, else a
    no-op."""
    return _NO_SPAN if _step is None else _step.part(name)


_NO_SPAN = contextlib.nullcontext()


class _Boundary(torch.autograd.Function):
    """The identity; its backward ends one step part and begins another."""

    @staticmethod
    def forward(ctx, x, spans, ends, begins):
        ctx.spans, ctx.ends, ctx.begins = spans, ends, begins
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.ends is not None:
            ctx.spans.end(ctx.ends)
        if ctx.begins is not None:
            ctx.spans.begin(ctx.begins)
        return grad, None, None, None


def step_boundary(x: torch.Tensor, ends: Optional[str] = None,
                  begins: Optional[str] = None) -> torch.Tensor:
    """``x``; while a step records its parts, the backward pass ends the
    part ``ends`` and begins the part ``begins`` once it has x's whole
    gradient (on the stream of x's forward)."""
    if _step is None:
        return x
    return _Boundary.apply(x, _step, ends, begins)


def step_span_end(name: str):
    """End the step part ``name`` (one a ``step_boundary`` began)."""
    if _step is not None:
        _step.end(name)


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

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
    """Each hand-written kernel's launch count in this process
    (``ops/_guard.py``'s counts, which callers reset)."""
    return _guard.launch_counts()


def graph_counts() -> Dict[str, int]:
    """The train-step captures made and the steps replayed from them in this
    process (``training/step_graph.StepGraph``'s counters, which callers
    reset)."""
    from ..training.step_graph import StepGraph
    return {"captures": StepGraph.captures, "replays": StepGraph.replays}


def rank_report(device: Optional[torch.device] = None) -> dict:
    """What one process ran: its stage report (its step spans too, where a
    profiler read them), its kernel launches, its train-step captures and
    replays and, on a card, the peak device memory (what a multi-rank CLI
    returns per rank)."""
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
    trace; the spans opened inside it are ``user_annotation`` events there,
    and the step spans read while it records join the stage report."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
