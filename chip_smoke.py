#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dino_tracker_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each (any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles kernel K1 (csrc/blurpool.cu: K1-fwd blurpool_down_nhwc
     and K1-bwd blurpool_up_nhwc) with nvcc into build/kernels/.
  3. kernel check: K1-fwd against its plain PyTorch version at the three
     DeltaDINO blurpool shapes of a 16-frame refine chunk, and K1-bwd against
     autograd of the plain version at the three shapes of an 8-frame training
     step, bf16 and f32, with the error bound and kernel vs plain times from
     CUDA events.
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
  6. reference: the inference entry points on a small f32 input, and one f32
     training step (losses and gradients) on a small input from the same
     init and the same injected batch, each on the GPU and on the CPU (the
     CPU path is held against the JAX package by the tests).
Then one JSON line with the kernels, and last {"ok": true, "device": ...}.

The feature stack is a static scene plus per-frame noise, so a query's own
cell is the correlation peak in every frame and tracks stay near the query.
Imports no JAX, none of the JAX package's modules, and none of PyYAML,
Pillow or msgpack.
"""

import json
import os
import shutil
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

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
# dino_tracker_tpu.config.TrainConfig's defaults (the reference's
# config/train.yaml) for the fields training reads; that module imports
# PyYAML, which this script must not need
TRAIN_CFG = SimpleNamespace(
    checkpoint_interval=2500, video_resw=W, video_resh=H, fg_traj_ratio=0.5,
    train_batch_size=512, batch_n_frames=4, sampler_batch_iterations=100_000,
    total_iterations=10_000, lr_delta_dino=0.01, lr_cnn_refiner=0.01,
    apply_scheduler_every=40, scheduler_gamma=0.999, lambda_cyc=0.5,
    apply_cyc_after=5000, cyc_n_frames=4, cyc_batch_size_per_frame=256,
    cyc_fg_points_ratio=0.7, cyc_thresh=4.0, cyc_gamma=0.8,
    lambda_emb_norm=0.0001, lambda_angle=0.0001, lambda_cl_dino_bb=0.00025,
    lambda_cl_ref_bb=0.00005, cl_n_frames=4, cl_points_per_pair=256,
    cl_fg_points_ratio=0.7, cl_temp=0.1, cl_div_dino_bb=700.0,
    cl_div_ref_bb=900.0, apply_cl_ref_after=5000, bb_amb_sig_a=27.0,
    bb_amb_sig_b=-5.7, compute_dtype="bfloat16")
N_FG_TRAJ = N_BG_TRAJ = 100_000
BB_CAP = 512
WARMUP_STEPS, OFF_STEPS, ON_STEPS = 3, 20, 10
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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
    return worst, ms, plain_ms


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
            print(f"kernel check: K1-bwd {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3g} (bound {bound:.3g}), kernel {k:.3f} ms, "
                  f"plain {p:.3f} ms", flush=True)
            if dtype == torch.bfloat16:  # the training step's dtype
                worst = max(worst, err)
                ms += k
                plain_ms += p
            del x, y, gy, ref, gx
    return worst, ms, plain_ms


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

    bp.blurpool_cuda.launches = bp.blurpool_cuda_bwd.launches = 0
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
    from dino_tracker_tpu_torch.config import TrackerConfig
    from dino_tracker_tpu_torch.training import checkpoint, train
    tcfg = TrackerConfig(video_h=H, video_w=W, delta_channels=CHANNELS,
                         compute_dtype=TRAIN_CFG.compute_dtype)
    data = make_train_data(video, dino, dev, 5)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt_folder = os.path.join(WORK_DIR, "models", "dino_tracker")
    trainer = train.Trainer(TRAIN_CFG, tcfg, data, ckpt_folder, seed=2, device=dev)
    model = trainer.init_model().train()
    init = [p.detach().clone() for p in model.parameters()]
    opt, sched = train.make_optimizer(model, TRAIN_CFG)
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []

    def run(n, gates):
        t0 = time.perf_counter()
        for _ in range(n):
            history.append(train.train_step(model, opt, sched, data, gen, gates,
                                            gates, TRAIN_CFG, tcfg))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    bp.blurpool_cuda.launches = bp.blurpool_cuda_bwd.launches = 0
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
          f"{TRAIN_CFG.train_batch_size}x{TRAIN_CFG.batch_n_frames} frames, "
          f"{N_FG_TRAJ}+{N_BG_TRAJ} trajectories: first step {first_ms:.1f} ms, "
          f"gates off {off_ms:.2f} ms/iter ({OFF_STEPS} steps), gates on "
          f"{on_ms:.2f} ms/iter ({ON_STEPS} steps), peak memory {peak:.2f} GiB, "
          f"{steps} steps, K1-fwd/K1-bwd launches {launches}", flush=True)
    print(f"train: losses, gates off: {fmt(m_off)}", flush=True)
    print(f"train: losses, gates on: {fmt(m_on)}", flush=True)

    # the Trainer loop across a phase boundary, then serve its checkpoint
    cfg = SimpleNamespace(**{**vars(TRAIN_CFG), "total_iterations": 4,
                             "checkpoint_interval": 2, "apply_cyc_after": 2,
                             "apply_cl_ref_after": 2})
    t0 = time.perf_counter()
    train.Trainer(cfg, tcfg, data, ckpt_folder, seed=2, device=dev).train(
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
    from dino_tracker_tpu_torch.config import TrackerConfig
    from dino_tracker_tpu_torch.models import nn as pnn
    from dino_tracker_tpu_torch.models.tracker import Tracker
    from dino_tracker_tpu_torch.training import cycle, sampler, train
    t, h, w, channels = 6, 70, 98, (3, 8, 8, 8, 32)
    tcfg = TrackerConfig(video_h=h, video_w=w, delta_channels=channels)
    n_feat = tcfg.feat_hw[0] * tcfg.feat_hw[1]
    cfg = SimpleNamespace(**{**vars(TRAIN_CFG), "video_resh": h, "video_resw": w,
                             "train_batch_size": 32, "batch_n_frames": 3,
                             "cyc_n_frames": 2, "cyc_batch_size_per_frame": 16,
                             "cl_n_frames": 2, "cl_points_per_pair": 2 * n_feat,
                             "cl_fg_points_ratio": 0.5, "compute_dtype": "float32"})
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


def main():
    check(torch.cuda.is_available(), "CUDA is not available: this smoke "
          "runs the port on an NVIDIA GPU and has no CPU fallback")
    from dino_tracker_tpu_torch.ops import blurpool as bp
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _, nvcc_s = bp.load_library()
    print(f"build: K1-fwd and K1-bwd csrc/blurpool.cu nvcc {nvcc_s:.2f} s, "
          f"loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    err, ms, plain_ms = phase_kernel_check(bp, dev)
    err_b, ms_b, plain_ms_b = phase_kernel_bwd_check(bp, dev)
    infer_launches, video, dino = phase_slice(bp, dev)
    train_launches = phase_train(bp, dev, video, dino)
    del video, dino
    phase_train_reference(dev)
    phase_reference(dev)

    # launches: the sum of the main-path runs (inference, then training),
    # each counted from 0; ms / plain_ms: the sum over the three bf16 shapes
    print(json.dumps({"kernels": [{
        "name": "blurpool_down_nhwc", "route": "cuda",
        "source": "dino_tracker_tpu_torch/csrc/blurpool.cu",
        "replaces": "dino_tracker_tpu/ops/blurpool.py:59",
        "launches": infer_launches + train_launches[0], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}, {
        "name": "blurpool_up_nhwc", "route": "cuda",
        "source": "dino_tracker_tpu_torch/csrc/blurpool.cu",
        "replaces": "dino_tracker_tpu/ops/blurpool.py:67",
        "launches": train_launches[1], "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_ms_b}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
