#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dino_tracker_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --raft-frames 50   # phases 1, 2 (K3) and 8 only, at T=50

Phases, one line or more each (any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles kernels K1 (csrc/blurpool.cu: K1-fwd blurpool_down_nhwc
     and K1-bwd blurpool_up_nhwc), K2 (csrc/flash_attention.cu) and K3
     (csrc/corr_lookup.cu) with nvcc into build/kernels/, one nvcc per
     source, all started together; prints each kernel's registers, shared
     memory and spills as ptxas reports them.
  3. kernel check: K1-fwd against its plain PyTorch version at the three
     DeltaDINO blurpool shapes of a 16-frame refine chunk, and K1-bwd against
     autograd of the plain version at the three shapes of an 8-frame training
     step, bf16 and f32, each shape's time beside its own bound; K2 against
     attention_reference at the ViT stage's shape [4 frames, 16 heads,
     S=8108, 64] in bf16 on contiguous inputs and on the ViT's layout
     (permuted views of one qkv buffer, which it reads without copies), at
     one frame in f32 and at ragged S = 100 and 1000 in both, timed on both
     bf16 layouts, with TFLOP/s and the fraction of its bound; K3 against
     corr_lookup_reference on a pyramid of random 256-channel f32 fmaps for a decode batch of 8
     pairs at 60×107 with coordinates inside, at the edge and far outside
     the maps, timed beside its byte bound and the floor that 32-byte sectors
     put under it; with the error bounds and kernel vs plain (and, for K2,
     F.scaled_dot_product_attention, for K3 four F.grid_sample calls) times
     from CUDA events, and the share of the bound each kernel reaches.
  4. the inference slice at full width: T=50 frames of 854×476, a
     dinov2_vitl14-width (C=1024) feature stack on the 67×121 grid, bf16
     compute, seeded random weights in the JAX package's layout carried over
     by convert.state_from_jax. runtime.make_model_inference refines every
     frame (DeltaDINO through K1-fwd), then ModelInference.infer serves three
     requests of 256 query points on frames 0, 24 and 49.
  5. the training slice at full width: the same video and feature stack,
     synthetic fg masks, 100k fg + 100k bg trajectories and padded best
     buddies, all made on the card from a seed; TrainConfig's defaults
     (batch 512 × 4 frames, bf16, cycle 4×256, contrastive 4×256); the port's
     own initialization. train.train_step runs warm-up steps, then 20 timed
     steps with both phase gates off and 10 with both on (all six losses);
     every step launches K1-fwd and K1-bwd 3 times each. Then train.Trainer
     trains 4 iterations across a phase boundary, writing state_<step>.pt,
     and runtime.load_model + make_model_inference serve one 256-point
     request from that checkpoint.
  6. the ViT feature stage at full width: seeded random dinov2_vitl14 weights
     (D=1024, 24 blocks, 16 heads) in the DINOv2 layout, made on the card,
     and a synthetic T=50 video at 854×476. PreprocessingPipeline.
     extract_dino_features sweeps layers 15 and 23 once (stride 7, a 67×121
     grid, S=8108 tokens, 4 frames a batch, bf16, every attention through
     K2) and writes the f16 artifacts under build/chip_smoke/vit/; then
     create_fg_masks on the layer-23 features (mask jpgs written) and
     split_trajectories on synthetic trajectories (masks read back, fg/bg
     banks written); then the per-token cosine of bf16 against f32 features
     on one frame (gate: median >= 0.995).
  7. reference: the inference entry points on a small f32 input, one f32
     training step (losses and gradients) on a small input from the same
     init and the same injected batch, a small f32 ViT through
     extract_feature_video and compute_fg_masks, and pipeline stage 1 on 6
     f32 frames of 224×128 plus a RAFT forward with degenerate pyramid
     levels (48×64), each on the GPU and on the CPU (the CPU path is held
     against the JAX package by the tests).
  8. pipeline stage 1 at full width: seeded random RAFT-large weights in the
     princeton-vl layout (the flow head's last conv scaled by 0.1, so flows
     stay sub-pixel and trajectories survive), made on the card and loaded
     by load_raft_state_dict; a synthetic textured T=12 video at 854×476 that
     moves by (1.5, 0.5) px a frame. PreprocessingPipeline.
     extract_trajectories_both (encoders once per frame, adjacent flows,
     both chaining passes over every start frame with its direct flows:
     24 GRU iterations, f32, 8 pairs a decode batch, every lookup through
     K3), with its phase times, the trajectory counts, peak memory and one
     decode batch's time.
Each main path (phases 4, 5, 6, 8) runs with every kernel's launch count set
to 0 just before it and read just after. Then one JSON line with the
kernels, and last {"ok": true, "device": ...}.

The feature stack is a static scene plus per-frame noise, so a query's own
cell is the correlation peak in every frame and tracks stay near the query.
Imports no JAX, none of the JAX package's modules, and none of PyYAML,
imageio or msgpack; Pillow only through the pipeline's mask jpgs.
"""

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

T, H, W = 50, 476, 854
CHANNELS = (3, 64, 128, 256, 1024)
QUERY_FRAMES = (0, 24, 49)
N_QUERIES = 256
# the head's argmax radius (35 px) plus one feature cell (7 px) rounded up
SELF_TRACK_PX = 50.0
REAL_SHAPES = [(16, 476, 854, 64), (16, 238, 427, 128), (16, 119, 214, 256)]
# the three DeltaDINO blurpool inputs of a training step (8-frame set)
TRAIN_SHAPES = [(8, 476, 854, 64), (8, 238, 427, 128), (8, 119, 214, 256)]
# TrainConfig defaults for the occlusion rule
ANCHOR_COS, COS = 0.7, 0.6
N_FG_TRAJ = N_BG_TRAJ = 100_000
BB_CAP = 512
WARMUP_STEPS, OFF_STEPS, ON_STEPS = 3, 20, 10
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
# K2 on the ViT feature stage's main path: 4 frames a batch × 16 heads,
# 67·121 tokens + cls, head dim 64, bf16
ATTN_SHAPE = (4, 16, 8108, 64)
ATTN_SCALE = 1.0 / math.sqrt(ATTN_SHAPE[-1])
# K2's bf16 bound, in units of the reference output's largest magnitude
BF16_ATTN_TOL = 2.0 ** -6
N_SPLIT_TRAJ = 100_000
# published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12
# K3 on stage 1's main path: a decode batch of 8 pairs on the 60×107 grid of
# 854×476 frames padded to 856×480; bound of K3 against its plain version,
# in units of the plain output's largest magnitude
RAFT_T = 12
LOOKUP_SHAPE = (8, 60, 107)
LOOKUP_TOL = 1e-5
# RAFT flows, GPU against CPU, in units of max|flow|; trajectories chained
# from the same flows on both, in px
FLOW_TOL, TRAJ_TOL = 1e-4, 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound(flops, nbytes, peak_flops):
    """(least ms for the work, "operations" or "bytes", whichever bounds)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def reset_counts():
    """Set every kernel's launch count to 0."""
    from dino_tracker_tpu_torch.ops import blurpool as bp
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    from dino_tracker_tpu_torch.ops import window_gather as wg
    bp.blurpool_cuda.launches = bp.blurpool_cuda_bwd.launches = 0
    fa.flash_attention_cuda.launches = 0
    wg.corr_lookup_cuda.launches = 0


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(y: torch.Tensor) -> float:
    return float(2.0 ** (np.floor(np.log2(y.abs().max().item())) - 7))


def jax_layout_weights(rng, channels, head_shift=0.0):
    """Random (params, batch_stats) in the JAX package's pytree layout (HWIO
    convs, torch-default kaiming-uniform bounds), non-zero everywhere."""
    def conv(k, cin, cout):
        bound = 1.0 / np.sqrt(cin * k * k)  # kaiming_uniform(a=√5)
        return {"w": rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    layers, stats = [], []
    for i in range(len(channels) - 1):
        cout = channels[i + 1]
        scale = 0.05 if i == len(channels) - 2 else 1.0
        layers.append({"conv": conv(5, channels[i], cout),
                       "bn": {"scale": np.full(cout, scale, np.float32),
                              "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}})
        stats.append({"mean": (rng.standard_normal(cout) * 0.1).astype(np.float32),
                      "var": (rng.random(cout) + 0.5).astype(np.float32)})
    head = {"conv1": conv(3, 1, 16), "conv2": conv(3, 16, 1)}
    for c in head.values():
        c["w"] += np.float32(head_shift)
    return ({"delta_dino": {"layers": layers}, "tracker_head": head},
            {"delta_dino": {"layers": stats}})


def make_inputs(t, h, w, c, feat_hw, device, seed):
    """Video T×3×H×W in [0,1] and an f16 T×C×h'×w' feature stack: a static
    per-position pattern plus per-frame noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    video = torch.rand((t, 3, h, w), generator=g, device=device)
    pos = torch.randn((1, c, *feat_hw), generator=g, device=device) * 3
    noise = torch.randn((t, c, *feat_hw), generator=g, device=device) * 0.6
    return video, (pos + noise).half()


def queries(rng, n, frame, h, w):
    return np.stack([rng.random(n) * (w - 1), rng.random(n) * (h - 1),
                     np.full(n, frame)], -1).astype(np.float32)


def build_model(params, stats, tcfg, device):
    from dino_tracker_tpu_torch import convert
    from dino_tracker_tpu_torch.models.tracker import Tracker
    model = Tracker(tcfg)
    model.load_state_dict(convert.state_from_jax(params, stats))
    return model.to(device)


def blurpool_bound(shapes, itemsize=2):
    """Summed bound of one blurpool (either direction) per N×H×W×C input
    shape: the full-size and the half-size tensor each moved once; 16 f32
    FMAs per half-size value."""
    flops = nbytes = 0.0
    for n, h, w, c in shapes:
        small = n * ((h + 1) // 2) * ((w + 1) // 2) * c
        flops += 32.0 * small
        nbytes += (n * h * w * c + small) * itemsize
    ms, by = bound(flops, nbytes, F32_FLOPS)
    return {"bound_ms": ms, "bound_by": by, "library_ms": None}


def phase_kernel_check(bp, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for shape in REAL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            y = bp.blurpool_cuda(x)
            ref = bp.blurpool_reference(x)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            bound = bf16_ulp(ref.float()) if dtype == torch.bfloat16 else 1e-5
            check(y.shape == ref.shape and err <= bound,
                  f"K1 {shape} {dtype}: max abs err {err} > bound {bound}")
            k = cuda_ms(lambda: bp.blurpool_cuda(x))
            p = cuda_ms(lambda: bp.blurpool_reference(x))
            print(f"kernel check: K1 {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3g} (bound {bound:.3g}), kernel {k:.3f} ms, "
                  f"plain {p:.3f} ms", flush=True)
            if dtype == torch.bfloat16:  # the main path's dtype
                worst = max(worst, err)
                ms += k
                plain_ms += p
            del x, y, ref
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **blurpool_bound(REAL_SHAPES)}


def phase_kernel_bwd_check(bp, dev):
    """K1-bwd against the plain backward (autograd of blurpool_reference) on
    the same cotangent; plain ms times that backward alone."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for shape in TRAIN_SHAPES:
        n, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device=dev).to(dtype).requires_grad_(True)
            y = bp.blurpool_reference(x)
            gy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
            ref = torch.autograd.grad(y, x, gy, retain_graph=True)[0]
            gx = bp.blurpool_cuda_bwd(gy, h, w)
            torch.cuda.synchronize()
            err = (gx.float() - ref.float()).abs().max().item()
            bound = bf16_ulp(ref.float()) if dtype == torch.bfloat16 else 1e-5
            check(gx.shape == ref.shape and err <= bound,
                  f"K1-bwd {shape} {dtype}: max abs err {err} > bound {bound}")
            k = cuda_ms(lambda: bp.blurpool_cuda_bwd(gy, h, w))
            p = cuda_ms(lambda: torch.autograd.grad(y, x, gy, retain_graph=True))
            least = blurpool_bound([shape], gy.element_size())["bound_ms"]
            print(f"kernel check: K1-bwd {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3g} (bound {bound:.3g}), kernel {k:.4f} ms, its bound "
                  f"{least:.4f} ms (bytes; {least / k:.3f} of it), plain {p:.3f} ms",
                  flush=True)
            if dtype == torch.bfloat16:  # the training step's dtype
                worst = max(worst, err)
                ms += k
                plain_ms += p
            del x, y, gy, ref, gx
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **blurpool_bound(TRAIN_SHAPES)}


def qkv_views(shape, g, dev):
    """q, k, v [B, H, S, 64] as the ViT makes them: permuted views of one bf16
    [B, S, 3·H·64] qkv buffer (models/vit.py)."""
    b, h, s, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=dev).bfloat16()
    return qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)


def phase_attention_check(dev):
    """K2 against attention_reference: at the main path's shape in bf16 (the
    plain version frame by frame: one frame's f32 scores take 4.2 GB), both
    on contiguous q, k, v and on the main path's layout (the permuted views
    of one [4, 8108, 3·1024] qkv buffer, through multi_head_attention), at
    one frame in f32, and at ragged S in both dtypes and both bf16 layouts.
    Bounds: bf16 2^-6·max|out|, two to four bf16 ulps at the top of the
    output's range (the kernel rounds the unnormalised probabilities to bf16,
    the plain version the normalised ones; both round the output), f32 2e-5.
    Times at the main path's shape: K2 on the qkv views (the main path) and
    on contiguous inputs, the plain version and F.scaled_dot_product_attention
    (timed only: the port never calls it)."""
    from dino_tracker_tpu_torch.ops import attention as attn
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(3)

    def plain(q, k, v):
        return torch.cat([attn.attention_reference(q[i:i + 1], k[i:i + 1],
                                                   v[i:i + 1], ATTN_SCALE)
                          for i in range(q.shape[0])])

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(ATTN_SHAPE, bf16, "qkv views"), (ATTN_SHAPE, bf16, "contiguous"),
             ((1,) + ATTN_SHAPE[1:], f32, "contiguous")] + [
        ((2, 3, s, 64), dt, lay) for s in (100, 1000)
        for dt, lay in ((bf16, "qkv views"), (bf16, "contiguous"), (f32, "contiguous"))]
    inputs = {}
    for shape, dtype, layout in cases:
        if layout == "qkv views":
            q, k, v = qkv_views(shape, g, dev)
        else:
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for _ in range(3))
        out = attn.multi_head_attention(q, k, v, ATTN_SCALE)
        ref = plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_ATTN_TOL * ref.float().abs().max().item() if dtype == bf16 else 2e-5
        check(out.shape == ref.shape and out.dtype == dtype and err <= tol,
              f"K2 {shape} {dtype} {layout}: max abs err {err} > bound {tol}")
        if dtype == bf16:  # a [B, S, H, 64] buffer, so the ViT's transpose is a view
            b, h, s, d = shape
            check(out.stride() == (s * h * d, d, h * d, 1),
                  f"K2 {shape} bf16 output strides {out.stride()}")
        print(f"kernel check: K2 {shape} {str(dtype)[6:]} {layout}: max_abs_err "
              f"{err:.3g} (bound {tol:.3g})", flush=True)
        if shape == ATTN_SHAPE and dtype == bf16:
            inputs[layout] = (q, k, v, err)
        del out, ref
    q, k, v, err = inputs["qkv views"]
    qc, kc, vc, err_c = inputs["contiguous"]
    # the main path copies nothing: the call allocates its output and no more
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = attn.multi_head_attention(q, k, v, ATTN_SCALE)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    check(extra <= out.numel() * out.element_size(),
          f"K2 on the qkv views allocated {extra} bytes beyond its inputs")
    print(f"kernel check: K2 {ATTN_SHAPE} bf16 qkv views: {extra / 2**20:.1f} MiB "
          f"allocated by the call (its output), no copies", flush=True)
    del out
    b, h, s, d = ATTN_SHAPE
    flops = 4.0 * b * h * s * s * d
    bound_ms, bound_by = bound(flops, 4.0 * b * h * s * d * 2, BF16_FLOPS)
    contiguous_ms = cuda_ms(lambda: fa.flash_attention_cuda(qc, kc, vc, ATTN_SCALE))
    ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v, ATTN_SCALE))  # the main path
    plain_ms = cuda_ms(lambda: plain(q, k, v), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, scale=ATTN_SCALE))
    print(f"kernel check: K2 {ATTN_SHAPE} bf16 contiguous: {contiguous_ms:.3f} ms "
          f"({flops / contiguous_ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / contiguous_ms:.3f} of the bound)", flush=True)
    print(f"kernel check: K2 {ATTN_SHAPE} bf16 through multi_head_attention on the "
          f"qkv views: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the bound {bound_ms:.3f} ms ({bound_by})), "
          f"scaled_dot_product_attention {library_ms:.3f} ms "
          f"({flops / library_ms / 1e9:.1f} TFLOP/s, contiguous), plain "
          f"{plain_ms:.3f} ms (frame by frame)", flush=True)
    return {"max_abs_err": max(err, err_c), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_slice(bp, dev):
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrackerConfig
    tcfg = TrackerConfig(video_h=H, video_w=W, delta_channels=CHANNELS,
                         compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    params, stats = jax_layout_weights(rng, CHANNELS)
    model = build_model(params, stats, tcfg, dev)
    video, dino = make_inputs(T, H, W, CHANNELS[-1], tcfg.feat_hw, dev, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    mi = runtime.make_model_inference(model, video, dino, tcfg, ANCHOR_COS, COS)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    request_s, self_px, track_px, occluded = [], [], [], []
    for frame in QUERY_FRAMES:
        qp = queries(rng, N_QUERIES, frame, H, W)
        t0 = time.perf_counter()
        trajs, occ = mi.infer(qp)
        request_s.append(time.perf_counter() - t0)
        check(trajs.shape == (N_QUERIES, T, 2) and occ.shape == (N_QUERIES, T)
              and occ.dtype == bool, f"shapes {trajs.shape} {occ.shape} {occ.dtype}")
        check(np.isfinite(trajs).all(), "non-finite trajectory coordinates")
        check((trajs >= 0).all() and (trajs[..., 0] <= W - 1).all()
              and (trajs[..., 1] <= H - 1).all(), "a coordinate left the frame")
        d = np.linalg.norm(trajs - qp[:, None, :2], axis=-1)
        self_px.append(d[:, frame].max())
        track_px.append(np.median(d))
        occluded.append(occ.mean())
        check(self_px[-1] <= SELF_TRACK_PX,
              f"frame {frame}: a query came back {self_px[-1]:.1f} px from "
              f"itself on its own frame (> {SELF_TRACK_PX})")
    launches = bp.blurpool_cuda.launches
    expected = 3 * -(-T // 16)  # 3 blurpools per 16-frame refine chunk
    check(launches == expected and bp.blurpool_cuda_bwd.launches == 0,
          f"K1 launched {launches} times (K1-bwd "
          f"{bp.blurpool_cuda_bwd.launches}) in the inference path, expected "
          f"{expected} (and 0)")
    print(f"slice: T={T} {W}x{H} C={CHANNELS[-1]} grid {tcfg.feat_hw} bf16: "
          f"refine {refine_s:.3f} s, requests "
          f"{', '.join(f'{s:.3f}' for s in request_s)} s for {N_QUERIES} "
          f"points each, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, own-frame error max {max(self_px):.2f} px, median track "
          f"distance {np.median(track_px):.2f} px, occluded share "
          f"{np.mean(occluded):.3f}, K1 launches {launches}", flush=True)
    return launches, video, dino


def make_train_data(video, dino, dev, seed, bb_cap=BB_CAP,
                    n_traj=(N_FG_TRAJ, N_BG_TRAJ)):
    """Training data on the card from a seed: an fg ellipse drifting across
    the frames (0/255 masks, as the artifact), fg/bg trajectory banks whose
    rows are visible in ~80% of the frames (at least 2, as build_bank
    guarantees), and padded best buddies for every ordered frame pair."""
    from dino_tracker_tpu_torch.structures import BBData
    from dino_tracker_tpu_torch.training.sampler import TrajectoryBank
    from dino_tracker_tpu_torch.training.train import VideoData
    g = torch.Generator(device=dev).manual_seed(seed)
    t, _, h, w = video.shape
    scale = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    cx = w * (0.3 + 0.4 * torch.arange(t, device=dev) / max(t - 1, 1))[:, None, None]
    masks = ((((xs - cx) / (0.15 * w)) ** 2 + ((ys - h / 2) / (0.25 * h)) ** 2)
             < 1).float() * 255

    def bank(n):
        valid = torch.rand((n, t), generator=g, device=dev) < 0.8
        valid[:, :2] = True
        coords = torch.rand((n, t, 2), generator=g, device=dev) * scale
        return TrajectoryBank(coords * valid[..., None], valid, n)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    nvalid = torch.randint(bb_cap // 5, bb_cap, (t, t), generator=g, device=dev)
    bb = BBData(rand(t, t, bb_cap, 2) * scale, rand(t, t, bb_cap, 2) * scale,
                0.2 + 0.8 * rand(t, t, bb_cap), rand(t, t, bb_cap),
                torch.arange(bb_cap, device=dev) < nvalid[..., None])
    return VideoData(video, dino, masks, bb, bank(n_traj[0]), bank(n_traj[1]))


def phase_train(bp, dev, video, dino):
    """The training slice at full width; returns the K1 launch counts of its
    main path (the timed train_step loop)."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.training import checkpoint, train
    cfg = TrainConfig()  # the reference's config/train.yaml defaults
    tcfg = TrackerConfig(video_h=H, video_w=W, delta_channels=CHANNELS,
                         compute_dtype=cfg.compute_dtype)
    data = make_train_data(video, dino, dev, 5)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt_folder = os.path.join(WORK_DIR, "models", "dino_tracker")
    trainer = train.Trainer(cfg, tcfg, data, ckpt_folder, seed=2, device=dev)
    model = trainer.init_model().train()
    init = [p.detach().clone() for p in model.parameters()]
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []

    def run(n, gates):
        t0 = time.perf_counter()
        for _ in range(n):
            history.append(train.train_step(model, opt, sched, data, gen, gates,
                                            gates, cfg, tcfg))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    reset_counts()
    first_ms = run(1, False)
    run(WARMUP_STEPS - 1, False)
    off_ms = run(OFF_STEPS, False)
    m_off = history[-1]
    run(WARMUP_STEPS - 1, True)
    on_ms = run(ON_STEPS, True)
    m_on = history[-1]
    launches = (bp.blurpool_cuda.launches, bp.blurpool_cuda_bwd.launches)
    steps = len(history)
    check(launches == (3 * steps, 3 * steps),
          f"K1-fwd / K1-bwd launched {launches} times in {steps} train steps, "
          f"expected {3 * steps} each")
    peak = torch.cuda.max_memory_allocated() / 2**30
    values = torch.stack([torch.stack(list(m.values())) for m in history])
    check(bool(values.isfinite().all()), "a non-finite loss term")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    check(len(grads) > 0 and all(bool(gr.isfinite().all()) for gr in grads),
          "a non-finite gradient")
    moved = sum(not torch.equal(a, p) for a, p in zip(init, model.parameters()))
    check(moved == len(grads), f"{moved} parameter tensors moved, "
          f"{len(grads)} have gradients")
    fmt = lambda m: ", ".join(f"{k} {float(v):.6g}" for k, v in m.items())
    print(f"train: T={T} {W}x{H} C={CHANNELS[-1]} bf16, batch "
          f"{cfg.train_batch_size}x{cfg.batch_n_frames} frames, "
          f"{N_FG_TRAJ}+{N_BG_TRAJ} trajectories: first step {first_ms:.1f} ms, "
          f"gates off {off_ms:.2f} ms/iter ({OFF_STEPS} steps), gates on "
          f"{on_ms:.2f} ms/iter ({ON_STEPS} steps), peak memory {peak:.2f} GiB, "
          f"{steps} steps, K1-fwd/K1-bwd launches {launches}", flush=True)
    print(f"train: losses, gates off: {fmt(m_off)}", flush=True)
    print(f"train: losses, gates on: {fmt(m_on)}", flush=True)

    # the Trainer loop across a phase boundary, then serve its checkpoint
    short = dataclasses.replace(cfg, total_iterations=4, checkpoint_interval=2,
                                apply_cyc_after=2, apply_cl_ref_after=2)
    t0 = time.perf_counter()
    train.Trainer(short, tcfg, data, ckpt_folder, seed=2, device=dev).train(
        log_interval=2)
    steps_saved = checkpoint.checkpoint_steps(ckpt_folder)
    check(steps_saved == [4, 2], f"Trainer wrote checkpoints {steps_saved}")
    served = runtime.load_model(ckpt_folder, tcfg, dev)
    mi = runtime.make_model_inference(served, video, dino, tcfg, ANCHOR_COS, COS)
    qp = queries(np.random.default_rng(7), N_QUERIES, T // 5, H, W)
    trajs, occ = mi.infer(qp)
    check(trajs.shape == (N_QUERIES, T, 2) and occ.shape == (N_QUERIES, T)
          and np.isfinite(trajs).all(), "serving the trained checkpoint failed")
    print(f"train: Trainer 4 iterations + checkpoints {steps_saved} + serve "
          f"{N_QUERIES} points from state_4.pt: {time.perf_counter() - t0:.2f} s, "
          f"tracks finite, occluded share {occ.mean():.3f}", flush=True)
    return launches


def phase_train_reference(dev):
    """One f32 training step on a small input, GPU against CPU: the same
    init (drawn on the CPU), the same injected batch, cycle data and
    contrastive pairs, all six losses. Losses within 1e-4 relative plus
    1e-6 absolute: the two regularisers average |‖r‖/‖d‖ − 1| and
    |cos − 1| over ratios and cosines within ~1e-3 of 1, which f32 resolves
    only to ~1e-7 absolute. Gradients within 1e-3 of each tensor's largest
    magnitude: the row gathers' backward accumulates with atomics on the
    card, so sums land in another order than on the CPU (and from run to
    run)."""
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.models import nn as pnn
    from dino_tracker_tpu_torch.models.tracker import Tracker
    from dino_tracker_tpu_torch.training import cycle, sampler, train
    t, h, w, channels = 6, 70, 98, (3, 8, 8, 8, 32)
    tcfg = TrackerConfig(video_h=h, video_w=w, delta_channels=channels)
    n_feat = tcfg.feat_hw[0] * tcfg.feat_hw[1]
    cfg = TrainConfig(video_resh=h, video_resw=w, train_batch_size=32,
                      batch_n_frames=3, cyc_n_frames=2, cyc_batch_size_per_frame=16,
                      cl_n_frames=2, cl_points_per_pair=2 * n_feat,
                      cl_fg_points_ratio=0.5, compute_dtype="float32")
    cpu = torch.device("cpu")
    video, dino = make_inputs(t, h, w, channels[-1], tcfg.feat_hw, cpu, 4)
    data = make_train_data(video, dino, cpu, 4, bb_cap=24, n_traj=(200, 200))
    gen = torch.Generator().manual_seed(4)
    sample = sampler.sample_batch(gen, data.fg_bank, data.bg_bank, 32, 3, 0.5,
                                  t, w, h)
    p, k = cfg.cyc_n_frames, cfg.cyc_batch_size_per_frame
    sel = torch.randint(0, len(sample.frames_set_t), (2, p), generator=gen)
    pts = [torch.cat([torch.rand((p, k, 2), generator=gen) * torch.tensor([w - 1, h - 1]),
                      sample.frames_set_t[s].float()[:, None, None].expand(p, k, 1)],
                     2).reshape(-1, 3) for s in sel]
    cyc = cycle.CycleData(pts[0], pts[1], sel[0].repeat_interleave(k),
                          sel[1].repeat_interleave(k), torch.rand(p * k, generator=gen) * 4,
                          torch.rand(p * k, generator=gen) < 0.7)
    pairs = (np.array([0, 2]), np.array([1, 0]))
    model = Tracker(tcfg)
    model.reset_parameters(gen)
    pnn.init_conv_(model.delta_dino.layers[-1].conv, gen)  # every layer gets gradient
    with torch.no_grad():  # keep the head's normalized convs well conditioned
        for conv in (model.tracker_head.conv1, model.tracker_head.conv2):
            conv.weight += 0.3
    out = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        md = Tracker(tcfg)
        md.load_state_dict(model.state_dict())
        md = md.to(d).train()
        move = lambda x: x.to(d) if isinstance(x, torch.Tensor) else x
        dd = type(data)(*(type(v)(*map(move, v)) if isinstance(v, tuple) else move(v)
                          for v in data))
        total, metrics = train.step_losses(
            md, dd, type(sample)(*map(move, sample)), None, cfg, tcfg, True,
            True, cyc_data=type(cyc)(*map(move, cyc)), dino_pair_sel=pairs,
            ref_pair_sel=pairs)
        total.backward()
        out[name] = ({k2: float(v) for k2, v in metrics.items()},
                       {n: q.grad.cpu() for n, q in md.named_parameters()
                        if q.grad is not None})
    loss_err, worst = max((abs(out["card"][0][k2] - v) / (1e-4 * abs(v) + 1e-6), k2)
                          for k2, v in out["cpu"][0].items())
    grad_err = max(float((out["card"][1][n] - gr).abs().max() / gr.abs().max())
                   for n, gr in out["cpu"][1].items()
                   if n != "tracker_head.conv2.bias")  # float noise (trap)
    print(f"reference: one f32 train step, T={t} {w}x{h}, all six losses: GPU "
          f"vs CPU losses {json.dumps(out['card'][0])} vs "
          f"{json.dumps(out['cpu'][0])}: worst {worst} at {loss_err:.3g} of its "
          f"bound (1e-4 relative + 1e-6), gradients max diff {grad_err:.3g} of "
          f"each tensor's max (bound 1e-3)", flush=True)
    check(out["card"][1].keys() == out["cpu"][1].keys() and loss_err <= 1.0
          and grad_err <= 1e-3, "GPU and CPU training steps disagree")


def phase_reference(dev):
    """The same entry points on a small f32 input, GPU against CPU."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrackerConfig
    t, h, w, channels = 6, 70, 98, (3, 8, 8, 8, 32)
    tcfg = TrackerConfig(video_h=h, video_w=w, delta_channels=channels)
    rng = np.random.default_rng(2)
    # shift the head taps so each 3×3 kernel's sum (the normalized conv's
    # divisor) stays far from 0: a near-zero sum amplifies the two devices'
    # f32 summation-order differences without bound
    params, stats = jax_layout_weights(rng, channels, head_shift=0.3)
    video, dino = make_inputs(t, h, w, channels[-1], tcfg.feat_hw, dev, 3)
    qp = np.concatenate([queries(rng, 8, f, h, w) for f in (0, 3, 5)])
    out = {}
    for d in (dev, torch.device("cpu")):
        mi = runtime.make_model_inference(
            build_model(params, stats, tcfg, d), video.to(d), dino.to(d),
            tcfg, ANCHOR_COS, COS)
        out[d.type] = mi.infer(qp)
    err = np.abs(out["cuda"][0] - out["cpu"][0]).max()
    same_occ = (out["cuda"][1] == out["cpu"][1]).mean()
    print(f"reference: {len(qp)} queries, T={t} {w}x{h}, f32: GPU vs CPU "
          f"trajectories max diff {err:.3g} px (bound 1e-2), occlusion "
          f"agreement {same_occ:.3f} (bound 1.0)", flush=True)
    check(err <= 1e-2 and same_occ == 1.0, "GPU and CPU paths disagree")


def vit_state(cfg, dev, seed):
    """Random ViT weights under the DINOv2 state-dict keys, made on ``dev``:
    linears ~U(±1/√din), non-zero pos-embed (so the bicubic resize does
    work) and layerscale ~U(±0.2)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, scale):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale

    d, hid, p = cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim, cfg.patch_size
    sd = {"patch_embed.proj.weight": u((d, 3, p, p), 1 / math.sqrt(3 * p * p)),
          "patch_embed.proj.bias": u((d,), 0.1), "cls_token": u((1, 1, d), 1.0),
          "pos_embed": u((1, 1 + cfg.pretrain_grid ** 2, d), 1.0)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                                  "mlp.fc1": (hid, d), "mlp.fc2": (d, hid)}.items():
            sd[f"{b}{name}.weight"] = u((dout, din), 1 / math.sqrt(din))
            sd[f"{b}{name}.bias"] = u((dout,), 0.1)
        for name in ("norm1", "norm2"):
            sd[f"{b}{name}.weight"] = 1 + u((d,), 0.2)
            sd[f"{b}{name}.bias"] = u((d,), 0.1)
        if cfg.layerscale:
            sd[f"{b}ls1.gamma"] = u((d,), 0.2)
            sd[f"{b}ls2.gamma"] = u((d,), 0.2)
    return sd


def scene_video(t, h, w, dev, seed):
    """T×3×H×W in [0, 1]: a smooth static background and a bright disk that
    crosses it, plus noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ys = torch.linspace(0, 1, h, device=dev)[:, None]
    xs = torch.linspace(0, 1, w, device=dev)[None, :]
    bg = torch.stack([0.4 + 0.2 * torch.sin(6 * xs + 2 * ys),
                      0.4 + 0.2 * torch.cos(5 * ys - 3 * xs),
                      0.3 + 0.1 * xs + 0.1 * ys])  # 3×H×W
    cx = 0.25 + 0.5 * torch.arange(t, device=dev)[:, None, None] / max(t - 1, 1)
    disk = (((xs - cx) * w / h) ** 2 + (ys - 0.5) ** 2) < 0.2 ** 2  # T×H×W
    fg = torch.tensor([0.9, 0.8, 0.2], device=dev)[None, :, None, None]
    video = torch.where(disk[:, None], fg, bg[None])
    noise = torch.randn(video.shape, generator=g, device=dev) * 0.03
    return (video + noise).clamp(0, 1)


def token_cosines(a, b):
    """Per-token cosine of two T×D×h×w feature videos, flattened."""
    return F.cosine_similarity(a.flatten(2), b.flatten(2), dim=1).flatten()


def phase_vit(dev):
    """The ViT feature stage at full width through the port's entry points;
    returns K2's launch count in it and the features' seconds."""
    from dino_tracker_tpu_torch.config import PreprocessConfig, feature_grid_size
    from dino_tracker_tpu_torch.models import vit, vit_convert
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    from dino_tracker_tpu_torch.preprocessing import fg_mask, split_fg_bg
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    from dino_tracker_tpu_torch.utils import video_io
    cfg = PreprocessConfig()  # dinov2_vitl14, layers 15 and 23, stride 7, bf16
    vcfg = vit.ViTConfig.for_model(cfg.dino_model_name)
    model = vit_convert.build_vit(vit_state(vcfg, dev, 6), vcfg, dev)
    h, w = cfg.video_resh, cfg.video_resw
    grid = feature_grid_size(h, w, vcfg.patch_size, cfg.dino_stride)
    video = scene_video(T, h, w, dev, 7)
    root = os.path.join(WORK_DIR, "vit")
    shutil.rmtree(root, ignore_errors=True)
    pipe = PreprocessingPipeline(root, cfg, vit=model, device=dev, frames=video)
    paths = [pipe.paths["dino_embed_video_path"],
             pipe.paths["mask_dino_embed_video_path"]]
    layers = [cfg.dino_layer, cfg.mask_dino_layer]
    rng = np.random.default_rng(8)
    trajs = np.stack([rng.uniform(0, w - 1, (N_SPLIT_TRAJ, T)),
                      rng.uniform(0, h - 1, (N_SPLIT_TRAJ, T))], -1).astype(np.float32)
    trajs[rng.random((N_SPLIT_TRAJ, T)) < 0.3] = np.nan  # late starts and gaps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    feats, mask_feats = pipe.extract_dino_features(layers, paths)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    masks_np = pipe.create_fg_masks(mask_feats)  # and the mask jpgs
    t2 = time.perf_counter()
    fg, bg = pipe.split_trajectories(trajs)  # masks read back, two .npz banks
    t3 = time.perf_counter()
    launches = fa.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    pipe.join_saves()
    t4 = time.perf_counter()
    # stages 3-4 again, with the first call's library loads done and the
    # feature artifacts landed: the computation alone, then each entry point
    again = fg_mask.compute_fg_masks(mask_feats, (h, w), cfg.fg_mask_threshold)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    masks_again = pipe.create_fg_masks(mask_feats)
    t6 = time.perf_counter()
    fg_again, _ = pipe.split_trajectories(trajs)
    t7 = time.perf_counter()
    check(np.array_equal(again.cpu().numpy(), masks_np)
          and np.array_equal(masks_again, masks_np)
          and np.array_equal(fg_again, fg, equal_nan=True),
          "stages 3-4 are not deterministic")
    # the mask jpgs read back are the masks in memory (at the midpoint: the
    # jpg rings a few levels around an edge, and the split, as in the
    # reference, takes any value > 0 as fg); the banks written are the split
    # of what was read back
    on_disk = video_io.load_masks(pipe.paths["masks_path"], h, w)
    check(np.array_equal((on_disk > 127).astype(np.float32), masks_np),
          "the mask jpgs do not read back as the masks")
    ref_fg, ref_bg = split_fg_bg.split_fg_bg(trajs, on_disk)
    for name, got, ref in (("fg_trajectories_file", fg, ref_fg),
                           ("bg_trajectories_file", bg, ref_bg)):
        check(np.array_equal(got, ref, equal_nan=True) and np.array_equal(
            video_io.load_npz(pipe.paths[name])["trajectories"], ref, equal_nan=True),
              f"{name} is not the split of the masks on disk")

    depth = max(layers) + 1  # the sweep stops after the deepest layer
    expected = depth * -(-T // cfg.extract_frames_per_batch)
    check(launches == expected, f"K2 launched {launches} times in the ViT "
          f"stage, expected {expected}")
    for f in (feats, mask_feats):
        check(f.shape == (T, vcfg.embed_dim, *grid) and f.dtype == torch.float32
              and bool(f.isfinite().all()), f"features {f.shape} {f.dtype}")
    for path, f in zip(paths, (feats, mask_feats)):
        art = video_io.load_npz(path)["features"]
        check(art.dtype == np.float16 and art.shape == tuple(f.shape)
              and np.array_equal(art[[0, -1]], f[[0, -1]].half().cpu().numpy()),
              f"artifact {path}: {art.dtype} {art.shape}")
    check(masks_np.shape == (T, h, w) and set(np.unique(masks_np)) <= {0.0, 1.0},
          "masks are not T×H×W {0, 1}")
    check(len(fg) + len(bg) == N_SPLIT_TRAJ, "the split lost trajectories")
    fg_share = float(masks_np.mean())
    print(f"vit: {cfg.dino_model_name} T={T} {w}x{h} stride {cfg.dino_stride} "
          f"grid {grid} S={grid[0] * grid[1] + 1} bf16, {cfg.extract_frames_per_batch} "
          f"frames a batch, layers {layers} in one sweep: features {t1 - t0:.3f} s "
          f"({T / (t1 - t0):.2f} frames/s), fg masks with their jpgs "
          f"{t2 - t1:.3f} s, split of {N_SPLIT_TRAJ} trajectories with the "
          f"masks read back and both banks written {t3 - t2:.3f} s ({len(fg)} "
          f"fg / {len(bg)} bg), f16 artifacts joined {t4 - t3:.3f} s later; "
          f"peak memory {peak:.2f} GiB, fg share {fg_share:.4f}, K2 launches "
          f"{launches}", flush=True)
    print(f"vit: again, after the artifacts landed: compute_fg_masks "
          f"{t5 - t4:.3f} s, create_fg_masks {t6 - t5:.3f} s, "
          f"split_trajectories {t7 - t6:.3f} s", flush=True)

    ref = vit.extract_feature_video(model, video[:1], stride=cfg.dino_stride,
                                    layer=layers, compute_dtype=torch.float32)
    cos = torch.cat([token_cosines(f[:1], r) for f, r in zip((feats, mask_feats), ref)])
    cmin, cmed = cos.min().item(), cos.median().item()
    print(f"vit: bf16 vs f32 features on frame 0, layers {layers}: per-token "
          f"cosine min {cmin:.6f}, median {cmed:.6f} (gate: median >= 0.995)",
          flush=True)
    check(cmed >= 0.995, f"bf16 features drift from f32: median cosine {cmed}")
    return launches, t1 - t0


def phase_vit_reference(dev):
    """A small f32 ViT (head dim 64, the dim K2 takes) through
    extract_feature_video and compute_fg_masks, GPU against CPU: features
    within 1e-4 of their max, masks equal."""
    from dino_tracker_tpu_torch.models import vit, vit_convert
    from dino_tracker_tpu_torch.preprocessing import fg_mask
    cpu = torch.device("cpu")
    cfg = vit.ViTConfig(embed_dim=128, depth=3, num_heads=2, mlp_ratio=2,
                        patch_size=14, pretrain_grid=5)
    state = vit_state(cfg, cpu, 9)
    t, h, w = 3, 70, 98
    video = scene_video(t, h, w, cpu, 10)
    out = []  # (features, masks) on the GPU, then on the CPU
    for d in (dev, cpu):
        model = vit_convert.build_vit(state, cfg, d)
        f = vit.extract_feature_video(model, video.to(d), stride=7, layer=[1, 2])
        out.append(([x.cpu() for x in f],
                    fg_mask.compute_fg_masks(f[1], (h, w)).cpu()))
    (gpu_f, gpu_m), (cpu_f, cpu_m) = out
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(gpu_f, cpu_f))
    same = bool(torch.equal(gpu_m, cpu_m))
    print(f"reference: f32 ViT (D=128, 3 blocks, 2 heads) T={t} {w}x{h}: GPU vs "
          f"CPU features max diff {err:.3g} of their max (bound 1e-4), fg masks "
          f"equal {same} (fg share {cpu_m.mean().item():.3f})", flush=True)
    check(err <= 1e-4 and same, "GPU and CPU ViT feature stages disagree")


def corr_lookup_bound(pyramid, coords, radius=4):
    """K3's least time on these inputs: the in-map cells of each pixel's
    10×10 window at every level read once (4 B each), its coordinates (8 B)
    read and its 324 outputs (4 B each) written once; 7 f32 FLOP an output.
    Returns (bound numbers, the all-inside bytes, the sector floor's bytes:
    the same with each in-map window row read as the whole 32-byte sectors
    it spans, which is what device memory moves)."""
    b, _, h, w = coords.shape
    n = b * h * w
    side = 2 * radius + 2
    cells = sectors = 0.0
    pixel = torch.arange(n, device=coords.device, dtype=torch.int64)[:, None]
    for lvl, vol in enumerate(pyramid):
        spans = []  # [lo, hi) of the in-map window, x then y
        for c, size in ((coords[:, 0], vol.shape[2]), (coords[:, 1], vol.shape[1])):
            c = c.reshape(-1)
            if size == 1:  # every tap reads the one cell
                spans.append((torch.zeros_like(c), torch.ones_like(c)))
                continue
            c = torch.clamp(c / 2 ** lvl, -(radius + 1.0), size + radius)
            lo = torch.floor(c) - radius
            spans.append((torch.clamp(lo, min=0),
                          torch.clamp(torch.clamp(lo + side, max=float(size)), min=0)))
        (x0, x1), (y0, y1) = [(a.long(), torch.maximum(a, z).long()) for a, z in spans]
        cells += float(((x1 - x0) * (y1 - y0)).sum())
        hl, wl = vol.shape[1:]
        rows = y0[:, None] + torch.arange(side, device=coords.device)
        live = (rows < y1[:, None]) & (x1 > x0)[:, None]
        start = ((pixel * hl + rows) * wl + x0[:, None]) * 4
        end = ((pixel * hl + rows) * wl + x1[:, None]) * 4
        sectors += float(torch.where(live, (end - 1) // 32 - start // 32 + 1, 0).sum())
    n_out = len(pyramid) * (2 * radius + 1) ** 2
    other = 8 * n + 4 * n_out * n
    ms, by = bound(7.0 * n_out * n, 4 * cells + other, F32_FLOPS)
    return ({"bound_ms": ms, "bound_by": by},
            n * (4 * len(pyramid) * side * side + 8 + 4 * n_out), 32 * sectors + other)


def corr_lookup_grid_sample(pyramid, coords, radius=4):
    """The lookup as four F.grid_sample calls, one per level, each sampling
    its maps at the 9×9 tap grid (torchvision RAFT's CorrBlock form), then a
    cat: timed as K3's library yardstick only; the port never calls it."""
    b, _, h, w = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (dx, dy)
    centre = coords.permute(0, 2, 3, 1).reshape(-1, 1, 1, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        hl, wl = vol.shape[1:]
        pts = centre / 2 ** lvl + delta
        grid = torch.stack([2 * pts[..., 0] / max(wl - 1, 1) - 1,
                            2 * pts[..., 1] / max(hl - 1, 1) - 1], dim=-1)
        out.append(F.grid_sample(vol[:, None], grid, align_corners=True).reshape(b, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def lookup_inputs(dev, b, h, w, seed):
    """A real pyramid (random 256-channel f32 fmaps) and coordinates: the grid
    moved by N(0, 2) px, a tenth of the pixels within 6 px of an edge of the
    map, and one in fifty 50-300 px outside it."""
    from dino_tracker_tpu_torch.models import raft
    g = torch.Generator(device=dev).manual_seed(seed)
    f1, f2 = (torch.randn((b, 256, h, w), generator=g, device=dev) for _ in range(2))
    pyramid = raft.build_corr_pyramid(f1, f2)
    del f1, f2
    coords = raft.coords_grid(b, h, w, dev)
    coords += torch.randn(coords.shape, generator=g, device=dev) * 2

    def rand(scale, shift=0.0):
        return torch.rand((b, h, w), generator=g, device=dev) * scale + shift

    for axis, size in ((0, w), (1, h)):
        edge = rand(1.0) < 0.1
        side = torch.where(rand(1.0) < 0.5, 0.0, size - 1.0)
        coords[:, axis] = torch.where(edge, side + rand(12.0, -6.0), coords[:, axis])
        far = rand(1.0) < 0.02
        sign = torch.where(rand(1.0) < 0.5, -1.0, 1.0)
        coords[:, axis] = torch.where(far, side + sign * rand(250.0, 50.0), coords[:, axis])
    return pyramid, coords.contiguous()


def phase_corr_lookup_check(dev):
    """K3 against corr_lookup_reference at the main path's shape, with the
    bound, kernel, plain and 4× F.grid_sample times from CUDA events."""
    from dino_tracker_tpu_torch.ops import window_gather as wg
    pyramid, coords = lookup_inputs(dev, *LOOKUP_SHAPE, seed=12)
    out = wg.corr_lookup_cuda(pyramid, coords)
    ref = wg.corr_lookup_reference(pyramid, coords)
    lib_out = corr_lookup_grid_sample(pyramid, coords)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    lib_err = (lib_out - ref).abs().max().item()
    check(out.shape == ref.shape == (LOOKUP_SHAPE[0], 324) + LOOKUP_SHAPE[1:]
          and err <= LOOKUP_TOL * scale,
          f"K3 {LOOKUP_SHAPE}: max abs err {err} > bound {LOOKUP_TOL * scale}")
    zero_share = float((ref == 0).float().mean())
    del ref, lib_out
    ms = cuda_ms(lambda: wg.corr_lookup_cuda(pyramid, coords))
    plain_ms = cuda_ms(lambda: wg.corr_lookup_reference(pyramid, coords), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: corr_lookup_grid_sample(pyramid, coords))
    numbers, inside_bytes, sector_bytes = corr_lookup_bound(pyramid, coords)
    least = numbers["bound_ms"]
    floor_ms = sector_bytes / HBM_BYTES * 1e3
    print(f"kernel check: K3 {LOOKUP_SHAPE[0]} pairs x {LOOKUP_SHAPE[1]}x"
          f"{LOOKUP_SHAPE[2]}, levels {[tuple(v.shape[1:]) for v in pyramid]} f32: "
          f"max_abs_err {err:.3g} (bound {LOOKUP_TOL * scale:.3g}; zero outputs "
          f"{zero_share:.3f}), 4x grid_sample max diff {lib_err:.3g}; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms, 4x grid_sample {library_ms:.3f} ms, bound "
          f"{least:.4f} ms ({numbers['bound_by']}; {least / ms:.3f} of it; all "
          f"windows inside: {inside_bytes / HBM_BYTES * 1e3:.4f} ms), sector floor "
          f"{floor_ms:.4f} ms ({floor_ms / ms:.3f} of the kernel's time)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **numbers,
            "library_ms": library_ms}


def raft_state(dev, seed):
    """Random RAFT-large weights under the princeton-vl keys (``module.``
    prefixed), made on ``dev``: convs ~U(±1/√fan_in) (torch's default
    bounds), BN affine and statistics near identity. The flow head's last
    conv is scaled by 0.1: unscaled, the random flows run to a few px with
    forward and backward flows unrelated, so the cycle check kills every
    trajectory; scaled, they stay near 0.3 px, most pixels survive, and the
    harvest works at the load of a real video."""
    from torch import nn
    from dino_tracker_tpu_torch.models import raft
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, scale, shift=0.0):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale + shift

    sd = {}
    for name, m in raft.RAFT().named_modules():
        if isinstance(m, nn.Conv2d):
            bound_ = 1 / math.sqrt(m.weight[0].numel())
            sd[f"{name}.weight"] = u(m.weight.shape, bound_)
            sd[f"{name}.bias"] = u(m.bias.shape, bound_)
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            sd.update({f"{name}.weight": u((c,), 0.2, 1.0), f"{name}.bias": u((c,), 0.1),
                       f"{name}.running_mean": u((c,), 0.1),
                       f"{name}.running_var": u((c,), 0.5, 1.0)})
    for k in ("weight", "bias"):
        sd[f"update_block.flow_head.conv2.{k}"] *= 0.1
    return {f"module.{k}": v for k, v in sd.items()}


def textured_video(t, h, w, dev, shift=(1.5, 0.5)):
    """T×3×H×W in [0, 1]: a smooth colour texture moving by ``shift`` (x, y)
    px a frame."""
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    frames = []
    for i in range(t):
        x, y = xs - shift[0] * i, ys - shift[1] * i
        frames.append(torch.stack([
            0.5 + 0.25 * torch.sin(0.11 * x + 0.05 * y) * torch.cos(0.07 * y),
            0.5 + 0.25 * torch.sin(0.05 * x - 0.13 * y + 1.0),
            0.5 + 0.2 * torch.cos(0.03 * x + 0.02 * y) * torch.sin(0.09 * x)]))
    return torch.stack(frames).clamp(0, 1)


def decode_batches(t, pair_batch=8, min_len=2):
    """Decode batches of stage 1 at T frames: adjacent flows both ways, then
    each start frame's direct flows both ways."""
    per = lambda n: -(-n // pair_batch)
    return 2 * per(t - 1) + 2 * sum(per(t - 1 - s) for s in range(t - (min_len - 1)))


def check_trajectories(trajs, t, h, w, what):
    finite = ~np.isnan(trajs).any(-1)
    check(trajs.ndim == 3 and trajs.shape[1:] == (t, 2) and trajs.dtype == np.float32,
          f"{what}: {trajs.shape} {trajs.dtype}")
    pts = trajs[finite]
    check(np.isfinite(pts).all() and (pts >= 0).all() and (pts[:, 0] <= w - 1).all()
          and (pts[:, 1] <= h - 1).all(), f"{what}: a point outside the frame")
    check((finite.sum(1) >= 2).all(), f"{what}: a trajectory shorter than 2 frames")


def phase_raft(dev, t=RAFT_T):
    """Pipeline stage 1 at full width; returns K3's launch count in it."""
    from dino_tracker_tpu_torch.config import PreprocessConfig
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.ops import window_gather as wg
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    from dino_tracker_tpu_torch.utils import video_io
    cfg = PreprocessConfig()  # RAFT 24 iterations f32, thresholds 1.5 / 2.5
    h, w = cfg.video_resh, cfg.video_resw
    model = raft.load_raft_state_dict(raft_state(dev, 11), dev)
    root = os.path.join(WORK_DIR, "raft")
    shutil.rmtree(root, ignore_errors=True)
    pipe = PreprocessingPipeline(root, cfg, device=dev, frames=textured_video(t, h, w, dev),
                                 raft=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    trajs, unfiltered = pipe.extract_trajectories_both()
    total = time.perf_counter() - t0
    launches = wg.corr_lookup_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    batches = decode_batches(t)
    check(launches == cfg.raft_iters * batches,
          f"K3 launched {launches} times in stage 1, expected {cfg.raft_iters} x "
          f"{batches} decode batches")
    for arr, what in ((trajs, "filtered"), (unfiltered, "unfiltered")):
        check_trajectories(arr, t, h, w, what)
    check(np.array_equal(video_io.load_npz(pipe.paths["trajectories_file"])["trajectories"],
                         trajs, equal_nan=True), "trajectories.npz is not the result")
    fwd, bwd = pipe.flow_engine.adjacent_flows()
    check(fwd.shape == bwd.shape == (t - 1, 2, h, w) and bool(fwd.isfinite().all())
          and bool(bwd.isfinite().all()), "adjacent flows: shape or non-finite")

    # one full decode batch (8 pairs) and its correlation pyramid, warm
    eng = pipe.flow_engine
    ia, ib = np.zeros(8, np.int64), np.arange(1, 9) % t
    decode_ms = cuda_ms(lambda: eng.decode(ia, ib), iters=3, warmup=1)
    fmaps = eng.encodings()[0]
    pyramid_ms = cuda_ms(lambda: raft.build_corr_pyramid(fmaps[ia], fmaps[ib]), iters=3)
    tm = pipe.timings
    direct = batches - 2 * -(-(t - 1) // 8)
    print(f"raft: stage 1, T={t} {w}x{h}, RAFT-large {cfg.raft_iters} iterations "
          f"{cfg.raft_compute_dtype}, 8 pairs a decode batch: encode {tm['encode']:.3f} s, "
          f"adjacent flows {tm['adjacent_flows']:.3f} s, direct sweep and chaining "
          f"{tm['direct_sweep_and_chaining']:.3f} s, harvest {tm['harvest']:.3f} s, "
          f"total {total:.3f} s; {len(trajs)} filtered / {len(unfiltered)} unfiltered "
          f"trajectories; peak memory {peak:.2f} GiB; one decode batch (8 pairs) "
          f"{decode_ms:.2f} ms, its pyramid {pyramid_ms:.2f} ms; {batches} decode "
          f"batches ({direct} direct), K3 launches {launches}", flush=True)
    return launches, decode_ms, pyramid_ms, eng


def profile_decode(eng, ia, ib):
    """Device time of one decode batch by kernel (torch.profiler, CUDA
    activity only): the top kernels and the sums by kind. Kinds by kernel
    name: K3; cuDNN convolutions (implicit GEMM and FFT kernels); GEMMs (the
    pyramid); everything else (elementwise, concatenation, copies)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decode(ia, ib)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, evt.count, evt.key))
    kinds = {"K3 corr_lookup": 0.0, "convolutions": 0.0, "GEMM": 0.0, "other": 0.0}
    for ms, _, name in rows:
        low = name.lower()
        if "corr_lookup" in low:
            kinds["K3 corr_lookup"] += ms
        elif any(k in low for k in ("conv", "fprop", "cudnn", "winograd", "xmma", "fft",
                                    "complex", "region_transform")):
            kinds["convolutions"] += ms
        elif "gemm" in low:
            kinds["GEMM"] += ms
        else:
            kinds["other"] += ms
    total = sum(kinds.values())
    if total == 0:
        print("raft: profile of one decode batch: no device time recorded", flush=True)
        return
    print(f"raft: profile of one decode batch (8 pairs, device time {total:.1f} ms): "
          + ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})" for k, v in kinds.items()),
          flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"raft:   {ms:9.2f} ms {count:5d}x {name[:110]}", flush=True)


def conv_table(model, dev, n=8, hw=(60, 107)):
    """Each conv of the update block alone at a decode batch's shape (n pairs
    on the 60×107 grid, f32, TF32 off), NCHW and channels-last input: ms
    from CUDA events and the achieved f32 TFLOP/s."""
    from torch import nn
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.models.nn import _exact_f32_convs
    g = torch.Generator(device=dev).manual_seed(0)
    for name, m in model.update_block.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        x = torch.randn((n, m.in_channels, *hw), generator=g, device=dev)
        flops = 2.0 * m.weight.numel() * n * hw[0] * hw[1]
        times = []
        for layout in (torch.contiguous_format, torch.channels_last):
            xl = x.contiguous(memory_format=layout)
            with torch.no_grad(), _exact_f32_convs(xl):
                times.append(cuda_ms(lambda: m(xl), iters=5, warmup=2))
        print(f"raft: conv {name} {m.in_channels}->{m.out_channels} "
              f"{tuple(m.kernel_size)} x{n}: NCHW {times[0]:.2f} ms "
              f"({flops / times[0] / 1e9:.1f} TFLOP/s), channels-last {times[1]:.2f} ms "
              f"({flops / times[1] / 1e9:.1f} TFLOP/s)", flush=True)
        if name == "encoder.conv":  # as the motion encoder runs it
            with torch.no_grad(), _exact_f32_convs(x):
                ms = cuda_ms(lambda: raft._conv_out_padded(m, x, 128), iters=5, warmup=2)
            print(f"raft: conv {name} with 128 outputs, cut to {m.out_channels}: "
                  f"{ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)


def phase_raft_reference(dev):
    """Stage 1 on 6 f32 frames of 224×128 (12 iterations), and one RAFT
    forward at 48×64 (degenerate levels), GPU against CPU from the same
    weights. Flows within FLOW_TOL of max|flow|. Trajectories: the CPU
    chains the GPU's flows (adjacent and direct) and must give the GPU's
    trajectories, counts equal and positions within TRAJ_TOL px; the CPU
    pipeline's own trajectories, from its own flows, are printed beside
    them (a point within float noise of a threshold may flip)."""
    from dino_tracker_tpu_torch.config import PreprocessConfig
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.preprocessing import trajectories as traj
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    cpu = torch.device("cpu")
    state = raft_state(cpu, 13)
    t, h, w = 6, 128, 224
    cfg = PreprocessConfig(video_resh=h, video_resw=w, raft_iters=12)
    video = textured_video(t, h, w, cpu)
    out = []  # (trajectories, flows, engine) on the GPU, then on the CPU
    for i, d in enumerate((dev, cpu)):
        root = os.path.join(WORK_DIR, f"raft_ref_{i}")
        shutil.rmtree(root, ignore_errors=True)
        pipe = PreprocessingPipeline(root, cfg, device=d, frames=video.clone(),
                                     raft=raft.load_raft_state_dict(state, d))
        res = pipe.extract_trajectories_both()
        eng = pipe.flow_engine
        out.append((res, [f.cpu() for f in eng.adjacent_flows()]
                    + [eng.direct_flows(0, cfg.threshold)[0].cpu()], eng))
    (gpu_res, gpu_flows, gpu_eng), (cpu_res, cpu_flows, _) = out
    flow_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(gpu_flows, cpu_flows))
    chained = traj.extract_trajectories_dual(
        gpu_flows[0], gpu_flows[1],
        direct_flow_fn=lambda s: [x.cpu() for x in gpu_eng.direct_flows(s, cfg.threshold)],
        threshold=cfg.threshold, min_trajectory_length=cfg.min_trajectory_length,
        direct_flow_threshold=cfg.direct_flow_threshold)
    same = all(a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
               for a, b in zip(gpu_res, chained))
    traj_err = max((float(np.nanmax(np.abs(a - b))) if len(a) else 0.0)
                   for a, b in zip(gpu_res, chained)) if same else float("inf")

    rng = np.random.default_rng(14)
    img1, img2 = (torch.from_numpy(rng.random((2, 3, 48, 64), dtype=np.float32))
                  for _ in range(2))
    small = [raft.raft_forward(raft.load_raft_state_dict(state, d), img1.to(d),
                               img2.to(d), 12).cpu() for d in (dev, cpu)]
    small_err = float((small[0] - small[1]).abs().max() / small[1].abs().max())
    print(f"reference: stage 1 T={t} {w}x{h} f32 ({cfg.raft_iters} iterations): GPU vs "
          f"CPU flows max diff {flow_err:.3g} of max|flow| (bound {FLOW_TOL}); "
          f"trajectories {[len(a) for a in gpu_res]} on the GPU, "
          f"{[len(a) for a in chained]} chained on the CPU from the GPU's flows "
          f"(max diff {traj_err:.3g} px, bound {TRAJ_TOL}), "
          f"{[len(a) for a in cpu_res]} from the CPU's own flows; RAFT forward 48x64 "
          f"(degenerate levels) GPU vs CPU {small_err:.3g} of max|flow|", flush=True)
    check(flow_err <= FLOW_TOL and small_err <= FLOW_TOL,
          "GPU and CPU RAFT flows disagree")
    check(same and traj_err <= TRAJ_TOL and len(gpu_res[1]) > 0,
          "GPU and CPU chaining disagree")


def build_kernels(sources):
    """nvcc for each (name, module) at once; prints each source's seconds and
    what ptxas reports for its kernels."""
    from dino_tracker_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        jobs = {name: pool.submit(mod.load_library) for name, mod in sources}
        nvcc_s = {name: job.result()[1] for name, job in jobs.items()}
    print("build: " + ", ".join(f"csrc/{name} nvcc {s:.2f} s" for name, s in nvcc_s.items())
          + f", all loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in nvcc_s:
        for kernel, usage in _build.ptxas_report(name.removesuffix(".cu")):
            print(f"build: ptxas csrc/{name} {kernel}: {usage}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--raft-frames", type=int, default=0,
                    help="run only the K3 build and stage 1 at this many frames")
    args = ap.parse_args()
    check(torch.cuda.is_available(), "CUDA is not available: this smoke "
          "runs the port on an NVIDIA GPU and has no CPU fallback")
    from dino_tracker_tpu_torch.ops import blurpool as bp
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    from dino_tracker_tpu_torch.ops import window_gather as wg
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    if args.raft_frames:  # stage 1 alone, then where one decode batch's time goes
        from dino_tracker_tpu_torch.models import raft
        build_kernels([("corr_lookup.cu", wg)])
        eng = phase_raft(dev, args.raft_frames)[3]
        ia, ib = np.zeros(8, np.int64), np.arange(1, 9) % args.raft_frames
        profile_decode(eng, ia, ib)
        conv_table(eng.model, dev)
        conv_table(eng.model, dev, n=1)
        # raft_decode itself on n pairs, as the engine ran short batches
        # before it padded them to 8
        fmaps, nets, inps = eng.encodings()
        by_n = [cuda_ms(lambda: raft.raft_decode(eng.model, fmaps[ia[:n]], fmaps[ib[:n]],
                                                 nets[ia[:n]], inps[ia[:n]]),
                        iters=2, warmup=1) for n in range(1, 9)]
        print("raft: raft_decode by pairs in the batch, unpadded: " + ", ".join(
            f"{n} {ms:.1f} ms" for n, ms in enumerate(by_n, 1)), flush=True)
        torch.backends.cudnn.benchmark = True  # cuDNN times its algorithms
        ms = cuda_ms(lambda: eng.decode(ia, ib), iters=3, warmup=1)
        torch.backends.cudnn.benchmark = False
        print(f"raft: one decode batch with torch.backends.cudnn.benchmark on: "
              f"{ms:.2f} ms", flush=True)
        return
    build_kernels([("blurpool.cu", bp), ("flash_attention.cu", fa),
                   ("corr_lookup.cu", wg)])

    k1 = phase_kernel_check(bp, dev)
    k1_bwd = phase_kernel_bwd_check(bp, dev)
    k2 = phase_attention_check(dev)
    k3 = phase_corr_lookup_check(dev)
    infer_launches, video, dino = phase_slice(bp, dev)
    train_launches = phase_train(bp, dev, video, dino)
    del video, dino
    vit_launches, vit_s = phase_vit(dev)
    print(f"vit: K2 {vit_launches} launches x {k2['ms']:.3f} ms (phase 3) = "
          f"{vit_launches * k2['ms'] / 1e3:.3f} s, {vit_launches * k2['ms'] / 1e3 / vit_s:.3f} "
          f"of the features' {vit_s:.3f} s", flush=True)
    raft_launches = phase_raft(dev)[0]
    phase_train_reference(dev)
    phase_reference(dev)
    phase_vit_reference(dev)
    phase_raft_reference(dev)

    # launches: the sum of the main-path runs, each counted from 0; K1 ms /
    # plain_ms / bound_ms: the sum over its three bf16 shapes; K2's at the
    # ViT stage's shape; K3's at one decode batch's
    def entry(name, source, replaces, launches, numbers):
        return {"name": name, "route": "cuda",
                "source": f"dino_tracker_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **numbers}

    print(json.dumps({"kernels": [
        entry("blurpool_down_nhwc", "blurpool.cu",
              "dino_tracker_tpu/ops/blurpool.py:59",
              infer_launches + train_launches[0], k1),
        entry("blurpool_up_nhwc", "blurpool.cu",
              "dino_tracker_tpu/ops/blurpool.py:67", train_launches[1], k1_bwd),
        entry("flash_attention", "flash_attention.cu",
              "dino_tracker_tpu/ops/flash_attention.py:27", vit_launches, k2),
        entry("corr_lookup", "corr_lookup.cu",
              "dino_tracker_tpu/ops/window_gather.py:37", raft_launches, k3)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
