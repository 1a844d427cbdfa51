#!/usr/bin/env python3
"""Which CUDA graph capture error mode holds NCCL collectives: a probe.

    python3 scripts/probe_nccl_capture.py [--ranks N] [--trials 10]

Starts N ranks over NCCL, one card each (N = 1 runs a one-rank NCCL group on
one card; NCCL refuses two ranks on one card). Each rank, for each capture
error mode (``torch.cuda.graph(..., capture_error_mode=...)``), ``--trials``
times: an eager step (an all_reduce, an all_gather and the backward of an
autograd Function whose backward all-reduces, as the port's collectives
do), then straight away the same step captured under
``torch.cuda.set_sync_debug_mode("error")`` while ProcessGroupNCCL's watchdog
still holds the eager step's work, then a replay held against the eager
step. It also records, inside the backward, whether the autograd thread
that runs it is another thread than the one that captures, and whether the
stream it runs on is capturing. Prints one JSON line per rank and mode:
captures that succeeded, the errors of those that failed, replays equal to
the eager step, and what the backward saw. Needs N CUDA devices.
"""

import argparse
import json
import os
import tempfile
import threading

import torch
import torch.distributed as dist

MODES = ("global", "thread_local", "relaxed")


class _SumBack(torch.autograd.Function):
    """Identity forward; the backward all-reduces the cotangent and records
    where it ran."""
    seen = []

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _SumBack.seen.append((threading.get_ident(),
                              torch.cuda.is_current_stream_capturing()))
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def step(w, x, out):
    """Writes the step's results into ``out`` (tensors that outlive it)."""
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    loss = (_SumBack.apply(w) * torch.cat(parts)[: w.numel()].view_as(w)).sum()
    (g,) = torch.autograd.grad(loss, w)
    out[0].copy_(torch.cat(parts)[:8])
    out[1].copy_(g[:8])


def rank_main(rank, n, workdir, trials):
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(workdir, "store"), n),
                            rank=rank, world_size=n)
    x = torch.arange(1 << 20, dtype=torch.float32, device=dev) * (rank + 1)
    w = torch.ones(1 << 20, device=dev, requires_grad=True)
    want = [torch.empty(8, device=dev), torch.empty(8, device=dev)]
    side = torch.cuda.Stream(dev)
    for mode in MODES:
        ok, errors, equal, backward = 0, [], 0, []
        for _ in range(trials):
            out = [torch.empty(8, device=dev), torch.empty(8, device=dev)]
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step(w, x, want)  # eager, its work still in the watchdog's list
            graph = torch.cuda.CUDAGraph()
            _SumBack.seen.clear()
            prev = torch.cuda.get_sync_debug_mode()
            try:
                with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        step(w, x, out)
                    finally:
                        torch.cuda.set_sync_debug_mode(prev)
                ok += 1
                backward.append([(t != threading.get_ident(), c) for t, c in _SumBack.seen])
                torch.cuda.current_stream(dev).wait_stream(side)
                graph.replay()
                torch.cuda.synchronize(dev)
                equal += all(torch.equal(a, b) for a, b in zip(out, want))
            except RuntimeError as e:
                errors.append(str(e).splitlines()[0][:200])
                torch.cuda.synchronize(dev)
            del graph
        print(json.dumps({"rank": rank, "ranks": n, "mode": mode, "trials": trials,
                          "captured": ok, "replays_equal": equal,
                          "backward_other_thread_and_capturing": sorted(
                              {str(b) for b in backward}),
                          "errors": sorted(set(errors)), "torch": torch.__version__,
                          "nccl": ".".join(map(str, torch.cuda.nccl.version()))}),
              flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--trials", type=int, default=10)
    args = ap.parse_args()
    if torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"needs {args.ranks} CUDA devices")
    with tempfile.TemporaryDirectory() as workdir:
        torch.multiprocessing.start_processes(rank_main, nprocs=args.ranks,
                                              args=(args.ranks, workdir, args.trials),
                                              start_method="spawn")


if __name__ == "__main__":
    main()
