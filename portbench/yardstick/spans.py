"""The program's own spans (``dino_tracker_tpu_torch/utils/profiling.py``), as
the per-layer metrics read them.

* **A train step's parts** (``train/step/<part>``): while a profiler records,
  the program reads each traced stretch's newest step into its process-wide
  registry, on the device's clock: per part its seconds in that step and
  one sample. ``step_ms`` averages the samples of the registry's report,
  which the metric hands it (this module imports nothing of the program).
* **Preprocessing's host spans** (``preprocess/<stage>/<part>``): while a
  profiler records each is a ``user_annotation`` event of the trace, on the
  kernels' clock. A device operation belongs to the span whose interval
  holds the host call that launched it (the trace's ``correlation`` ids tie
  the two); a span's idle seconds are those of its interval in which no
  device operation ran.

A program without these spans (an earlier one) leaves nothing to read, and
every reader then returns None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

STEP = "train/step"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def step_ms(record, report: Optional[dict], parts: Iterable[str],
            optional: Iterable[str] = ()) -> Optional[float]:
    """The traced steps' mean device ms in ``parts`` (and in those of
    ``optional`` the step ran), from ``report`` (the program's
    ``stage_report()``); None without a card, without traced steps or a
    report, or where a part was not read."""
    if not record.get("card") or not record.get("traced_steps") or report is None:
        return None
    rows = [report.get(f"{STEP}/{p}") for p in parts]
    rows += [r for r in (report.get(f"{STEP}/{p}") for p in optional) if r is not None]
    if any(r is None or r.get("clock") != "device" or not r["calls"] for r in rows):
        return None
    return sum(1e3 * r["total_s"] / r["calls"] for r in rows)


def stretches(record) -> Optional[List[Tuple[List[dict], List[dict]]]]:
    """(host events, device events) of each traced stretch of a card run
    (``yardstick.trace.TraceSummary``), or None."""
    trace = record.get("trace") if record.get("card") else None
    if trace is None or not getattr(trace, "stretches", 0):
        return None
    return list(zip(trace._host_events, trace._device_events))


def spans(host: List[dict], names: Iterable[str]) -> List[Tuple[float, float]]:
    """The [start, end) µs of every span named in ``names``."""
    names = set(names)
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                  if e.get("cat") == "user_annotation" and e["name"] in names)


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _inside(t: float, merged: List[Tuple[float, float]]) -> bool:
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def launched_in_s(host: List[dict], device: List[dict], names: Iterable[str]) -> Optional[float]:
    """Device seconds of the operations launched inside a span named in
    ``names``; None where no such span is in the trace."""
    within = _merge(spans(host, names))
    if not within:
        return None
    ids = {e["args"]["correlation"] for e in host
           if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
           and _inside(e["ts"], within)}
    return sum(e["dur"] for e in device
               if e.get("args", {}).get("correlation") in ids) / 1e6


def _uncovered(a: float, b: float, busy: List[Tuple[float, float]]) -> float:
    """µs of [a, b) that no interval of ``busy`` (merged) covers."""
    covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy if x < b and y > a)
    return (b - a) - covered


def idle_in_s(host: List[dict], device: List[dict], names: Iterable[str]) -> Optional[float]:
    """Seconds of the spans named in ``names`` in which no device operation
    ran; None where no such span is in the trace."""
    within = _merge(spans(host, names))
    if not within:
        return None
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in device)
    return sum(_uncovered(a, b, busy) for a, b in within) / 1e6


def span_s(host: List[dict], names: Iterable[str]) -> Optional[float]:
    """Seconds of the spans named in ``names``; None where there is none."""
    within = _merge(spans(host, names))
    return sum(b - a for a, b in within) / 1e6 if within else None


def per_video(record, read) -> Optional[float]:
    """``read(host, device)`` summed over a traced run's stretches (one
    video each) over their number; None where a stretch gives None."""
    runs = stretches(record)
    if not runs:
        return None
    values = [read(h, d) for h, d in runs]
    return None if any(v is None for v in values) else sum(values) / len(values)


def idle_by_span(host: List[dict], device: List[dict], prefix: str = "") -> Dict[str, float]:
    """Seconds of the idle gaps between device operations by the innermost
    program span (its name starting with ``prefix``) open at each moment:
    the deepest name, then the shortest span; "" where none is open."""
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    named = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                    if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)))
    out: Dict[str, float] = {}
    for a, b in gaps:
        open_ = [s for s in named if s[0] < b and s[1] > a]
        cuts = sorted({a, b, *(t for s in open_ for t in s[:2] if a < t < b)})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            at = [s for s in open_ if s[0] <= mid < s[1]]
            name = max(at, key=lambda s: (s[2].count("/"), s[0] - s[1]))[2] if at else ""
            out[name] = out.get(name, 0.0) + (y - x) / 1e6
    return out
