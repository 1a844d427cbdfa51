#!/usr/bin/env python3
"""Time K1-bwd and K3 of the PyTorch port against an earlier version of their
sources, in one process on one GPU.

    git archive <commit> dino_tracker_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/compare_kernels.py --parent build/parent/dino_tracker_tpu_torch/csrc

Builds ``csrc/blurpool.cu`` and ``csrc/corr_lookup.cu`` of the repository
("repo") and of ``--parent`` ("parent") with the port's nvcc flags into
``build/compare/``, one nvcc per source, all together, and prints what ptxas
reports for their kernels. Each build is checked against the plain version
as chip_smoke.py checks it (K1-bwd within one bf16 ulp of the plain backward
at the three training shapes, K3 within 1e-5·max|out| of
corr_lookup_reference on chip_smoke's lookup inputs); one that disagrees
fails the run. Both are then timed with chip_smoke.py's ``cuda_ms`` and its
settings (CUDA events over 10 calls after 2), in turns: repo, parent,
parent, repo, three times over; each side's mean and range are printed.

K3 is timed on two inputs: chip_smoke's, and the same with every coordinate
past the maps' far edge, where each window cell is zero-filled and nothing
of the pyramid is read, so that time is the output writes' alone. Its
kernel time without the host's part comes from torch.profiler. The numbers
go to build/compare/compare_kernels.json.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from dino_tracker_tpu_torch.ops import _build, _guard  # noqa: E402
from dino_tracker_tpu_torch.ops import blurpool as bp  # noqa: E402
from dino_tracker_tpu_torch.ops import window_gather as wg  # noqa: E402

OUT = os.path.join(REPO, "build", "compare")
ROUNDS = 3


def build(csrc, mod, tag):
    """nvcc csrc/<mod.LIBRARY>.cu; returns (the library bound to the module's
    signatures, ptxas rows)."""
    name = mod.LIBRARY
    lib = os.path.join(OUT, f"lib{name}_{tag}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(csrc, f"{name}.cu")], capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed for {tag} {name}.cu:\n{proc.stderr}")
    return _build.bind(ctypes.CDLL(lib), mod.SIGNATURES), _build.parse_ptxas(proc.stderr)


def entry_call(lib, entry, device):
    """``lib.<entry>`` launched by the port's own launch path (uncounted)."""
    return lambda *args: _guard.launch(lib, entry, device, *args)


def up_call(fn):
    def call(g, h, w):
        n, _, _, c = g.shape
        gx = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
        fn(g.data_ptr(), gx.data_ptr(), n, h, w, c, bp._DTYPE_CODE[g.dtype])
        return gx
    return call


def lookup_call(fn):
    def call(pyramid, coords):
        b, _, h, w = coords.shape
        out = torch.empty((b, 324, h, w), dtype=torch.float32, device=coords.device)
        fn(*[v.data_ptr() for v in pyramid], *[s for v in pyramid for s in v.shape[1:]],
           coords.data_ptr(), out.data_ptr(), b, h, w)
        return out
    return call


def in_turns(fns):
    """Mean, min and max ms of each of two fns, timed in the order A B B A."""
    times = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k in list(fns) + list(reversed(fns)):
            times[k].append(cs.cuda_ms(fns[k]))
    return {k: {"mean": sum(v) / len(v), "min": min(v), "max": max(v)} for k, v in times.items()}


def device_ms(fn):
    """Mean duration of the corr_lookup kernel over 20 calls, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if "corr_lookup" in evt.key and evt.count:
            us = getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0))
            return us / 1e3 / evt.count
    return None


def report(what, bound_ms, ms, result):
    result[what] = {"bound_ms": bound_ms, **ms}
    print(f"{what}: bound {bound_ms:.4f} ms; " + "; ".join(
        f"{k} {t['mean']:.4f} ms ({t['min']:.4f}-{t['max']:.4f}, {bound_ms / t['mean']:.3f} "
        f"of the bound)" for k, t in ms.items()) + f"; repo/parent "
        f"{ms['repo']['mean'] / ms['parent']['mean']:.3f}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the earlier version's csrc directory")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    jobs = [(csrc, mod, tag) for tag, csrc in (("repo", _build.CSRC), ("parent", args.parent))
            for mod in (bp, wg)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip([(j[1].LIBRARY, j[2]) for j in jobs],
                         pool.map(lambda j: build(*j), jobs)))
    for (name, tag), (_, rows) in built.items():
        for kernel, usage in rows:
            if "up_kernel" in kernel or "corr_lookup" in kernel:
                print(f"ptxas {tag} {name}.cu {kernel}: {usage}", flush=True)
    tags = ("repo", "parent")
    up = {t: up_call(entry_call(built[bp.LIBRARY, t][0], "blurpool_up_nhwc", dev)) for t in tags}
    look = {t: lookup_call(entry_call(built[wg.LIBRARY, t][0], "corr_lookup_fwd", dev))
            for t in tags}

    result = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape in cs.TRAIN_SHAPES:
        n, h, w, c = shape
        x = torch.zeros(shape, device=dev, dtype=torch.bfloat16).requires_grad_(True)
        gy = torch.randn((n, (h + 1) // 2, (w + 1) // 2, c), generator=gen,
                         device=dev).bfloat16()
        ref = torch.autograd.grad(bp.blurpool_reference(x), x, gy)[0].float()
        for t, fn in up.items():
            err = (fn(gy, h, w).float() - ref).abs().max().item()
            cs.check(err <= cs.bf16_ulp(ref), f"K1-bwd {t} {shape}: max abs err {err}")
        del ref, x
        report(f"K1-bwd {shape} bf16", cs.blurpool_bound([shape])["bound_ms"],
               in_turns({t: (lambda f=fn: f(gy, h, w)) for t, fn in up.items()}), result)
        del gy

    pyramid, coords = cs.lookup_inputs(dev, *cs.LOOKUP_SHAPE, seed=12)
    ref = wg.corr_lookup_reference(pyramid, coords)
    for t, fn in look.items():
        err = (fn(pyramid, coords) - ref).abs().max().item()
        cs.check(err <= cs.LOOKUP_TOL * ref.abs().max().item(), f"K3 {t}: max abs err {err}")
    del ref
    outside = torch.full_like(coords, 1e4)  # past every level's far edge: no cell read
    for what, xy in (("K3", coords), ("K3 writes only (no window inside a map)", outside)):
        numbers, _, sector_bytes = cs.corr_lookup_bound(pyramid, xy)
        report(f"{what} {cs.LOOKUP_SHAPE}", numbers["bound_ms"],
               in_turns({t: (lambda f=fn: f(pyramid, xy)) for t, fn in look.items()}), result)
        device = {t: device_ms(lambda f=fn: f(pyramid, xy)) for t, fn in look.items()}
        result[f"{what} {cs.LOOKUP_SHAPE}"].update(
            sector_floor_ms=sector_bytes / cs.HBM_BYTES * 1e3, device_ms=device)
        print(f"{what} kernel time by torch.profiler: " + ", ".join(
            f"{t} {v:.4f} ms" if v else f"{t} not measured" for t, v in device.items()),
            flush=True)
    with open(os.path.join(OUT, "compare_kernels.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
