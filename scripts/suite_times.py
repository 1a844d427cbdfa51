"""Where the test suite's seconds go: each file's summed test seconds from a
JUnit file, the slowest tests, and (with samples) the share of each in JAX
and in torch.

Per file and per test, from the JUnit file pytest wrote (``--junitxml``):

    python scripts/suite_times.py /tmp/_t1.xml [--top 10]

Shares: run pytest with this module as a plugin. It samples each test's
main thread every 5 ms from its setup to its teardown, module-scoped
fixtures included, and puts a sample to JAX (jax, jaxlib, flax, optax, the
``dino_tracker_tpu`` package) or to torch (torch, the
``dino_tracker_tpu_torch`` package) by the innermost frame of either on
the stack, else to neither (the test's own code, numpy, waiting on a
thread). Each process appends one JSON line a test to ``PREFIX.<pid>``:

    SUITE_TIMES_SAMPLES=/tmp/st PYTHONPATH=scripts python -m pytest tests/ \\
        -p suite_times ... --junitxml=/tmp/_t1.xml
    python scripts/suite_times.py /tmp/_t1.xml --samples /tmp/st

The sampler holds the interpreter lock for a moment every 5 ms, so a
sampled run is a little slower; read its shares, and take seconds from a
run without it. Imports neither JAX nor torch.
"""

import argparse
import collections
import glob
import json
import os
import sys
import threading
import time
import xml.etree.ElementTree as ET

import pytest

JAX = ("/dino_tracker_tpu/", "/jax/", "/jaxlib/", "/flax/", "/optax/")
TORCH = ("/dino_tracker_tpu_torch/", "/torch/")
SIDES = ("jax", "torch", "neither")
PERIOD_S = 0.005


def side(frame) -> str:
    while frame is not None:
        name = frame.f_code.co_filename
        if any(k in name for k in TORCH):
            return "torch"
        if any(k in name for k in JAX):
            return "jax"
        frame = frame.f_back
    return "neither"


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    prefix = os.environ.get("SUITE_TIMES_SAMPLES")
    if not prefix:
        yield
        return
    main, stop, counts = threading.get_ident(), threading.Event(), collections.Counter()

    def sample():
        while not stop.wait(PERIOD_S):
            counts[side(sys._current_frames().get(main))] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    start = time.monotonic()
    sampler.start()
    try:
        yield
    finally:
        stop.set()
        sampler.join()
        with open(f"{prefix}.{os.getpid()}", "a") as f:
            f.write(json.dumps({"id": item.nodeid, "seconds": time.monotonic() - start,
                                **counts}) + "\n")


def junit_tests(path: str) -> list:
    """(seconds, file, test id) of every test case of a JUnit file."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    out = []
    for case in suite.iter("testcase"):
        file = case.get("classname").replace(".", "/") + ".py"
        out.append((float(case.get("time")), file, f"{file}::{case.get('name')}"))
    return out


def shares(prefix: str) -> dict:
    """{test id or file: Counter of samples by side}."""
    out = collections.defaultdict(collections.Counter)
    for path in glob.glob(f"{prefix}.*"):
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                for key in (row["id"], row["id"].split("::")[0]):
                    out[key].update({s: row.get(s, 0) for s in SIDES})
    return out


def share_text(counts) -> str:
    n = sum(counts[s] for s in SIDES)
    return " ".join(f"{s} {counts[s] / n:.2f}" for s in SIDES) if n else "no samples"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("junit")
    parser.add_argument("--samples", help="the prefix the plugin wrote to")
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args(argv)
    tests = junit_tests(args.junit)
    by_side = shares(args.samples) if args.samples else None
    per_file, count = collections.Counter(), collections.Counter()
    for seconds, file, _ in tests:
        per_file[file] += seconds
        count[file] += 1
    total = sum(per_file.values())
    port = sum(v for k, v in per_file.items() if "/test_torch_" in k)
    print(f"{len(tests)} tests, {total:.1f} test-seconds, {port:.1f} in tests/test_torch_*.py")
    if by_side:
        port_counts = sum((c for k, c in by_side.items()
                           if "::" not in k and "/test_torch_" in k), collections.Counter())
        print(f"samples of tests/test_torch_*.py: {share_text(port_counts)}")
    for file, seconds in per_file.most_common(args.top):
        extra = f"  {share_text(by_side[file])}" if by_side else ""
        print(f"{seconds:9.1f} s {count[file]:4d} tests  {file}{extra}")
    print("slowest tests:")
    for seconds, _, test in sorted(tests, reverse=True)[:args.top]:
        extra = f"  {share_text(by_side[test])}" if by_side else ""
        print(f"{seconds:9.1f} s  {test}{extra}")


if __name__ == "__main__":
    main()
