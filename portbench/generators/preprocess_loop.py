"""Traffic generator for preprocessing: a closed loop of videos, one after
another, through the program's own pipeline
(``preprocessing.pipeline.PreprocessingPipeline(...).run()``) with the seeded
ViT and RAFT handed in.

Set-up makes the weights from the seed, builds the program's ViT and RAFT on
the card and runs one warm-up video through every stage (building the
kernels, choosing cuDNN's algorithms). The window starts videos while the
clock is under ``--seconds``; the last one started runs to its end. Each
video is written into a fresh data path under ``TMPDIR``; once the window
has closed one of them, drawn from the seed, is read back, every data path
is removed, and the plain reference preprocesses that video again from
weights and frames made anew from the seed.

The traffic file holds: ``frames`` (T of a video).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from reference import preprocess as reference  # noqa: E402
from yardstick import compare, preprocess_data, trace as trace_lib, train_data  # noqa: E402

STAGE1 = "preprocess/trajectories"


def _pipeline(ctx, s, video, path):
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    return PreprocessingPipeline(path, s.cfg, vit=s.vit, device=ctx.device, frames=video,
                                 raft=s.raft)


def setup(ctx):
    from types import SimpleNamespace
    from dino_tracker_tpu_torch.config import PreprocessConfig
    from dino_tracker_tpu_torch.models import vit_convert
    from dino_tracker_tpu_torch.models.raft import load_raft_state_dict
    from dino_tracker_tpu_torch.models.vit import ViTConfig
    cfg, dev = ctx.config, ctx.device
    s = SimpleNamespace(cfg=PreprocessConfig(**cfg["preprocess"]), t=ctx.traffic["frames"])
    s.vit = vit_convert.build_vit(preprocess_data.vit_state(cfg["vit"], ctx.seed, dev),
                                  ViTConfig.for_model(cfg["vit"]["model"]), dev)
    s.raft = load_raft_state_dict(preprocess_data.raft_state(ctx.seed, dev), dev)
    s.root = tempfile.mkdtemp(prefix="portbench-preprocess-", dir=ctx.tmpdir)
    warm = os.path.join(s.root, "warm-up")
    _pipeline(ctx, s, preprocess_data.video(ctx.seed, -1, s.t, cfg["height"], cfg["width"], dev),
              warm).run()
    shutil.rmtree(warm)
    return s


def run(ctx) -> dict:
    import torch
    s = setup(ctx)
    cfg, dev = ctx.config, ctx.device
    setup_s = time.time() - ctx.t_start_wall
    try:
        stage1, paths = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            k = len(paths)
            paths.append(os.path.join(s.root, f"video-{k}"))
            pipe = _pipeline(ctx, s, preprocess_data.video(ctx.seed, k, s.t, cfg["height"],
                                                           cfg["width"], dev), paths[-1])
            pipe.run()
            stage1.append(pipe.timings[STAGE1])
        seconds = time.perf_counter() - t0
        record = {"card": dev.type == "cuda", "video_s": seconds / len(paths),
                  "stage1_s": sum(stage1) / len(stage1)}
        summary = None
        if ctx.trace:
            t_trace = time.perf_counter()
            summary = trace_lib.TraceSummary()
            path = os.path.join(s.root, "traced")
            trace_lib.profile(lambda: _pipeline(ctx, s, preprocess_data.video(
                ctx.seed, len(paths), s.t, cfg["height"], cfg["width"], dev), path).run(),
                ctx.tmpdir, summary)
            shutil.rmtree(path)
            record["trace_s"] = time.perf_counter() - t_trace
            record.update(trace=summary, attention=_attention_shape(cfg, s.t),
                          k3=dict(_k3_cells(cfg), launches=cfg["preprocess"]["raft_iters"]
                                  * decode_batches(s.t, cfg["raft"]["pairs_per_decode_batch"],
                                                   cfg["preprocess"]["min_trajectory_length"])))
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        k = int(np.random.default_rng(train_data.derived_seed(ctx.seed, 14)).integers(len(paths)))
        program = compare.read_preprocess_artifacts(paths[k])
    finally:
        shutil.rmtree(s.root, ignore_errors=True)
    del s
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare.preprocess_readings(program, reference_run(ctx, k))
    readings["where"].update(video=k, reference_s=time.perf_counter() - t_ref,
                             trace_s=record.get("trace_s"))
    return {"metrics": {"preprocess_s_per_video": seconds / len(paths)}, "setup_s": setup_s,
            "attempted": len(paths), "failed": 0, "readings": readings,
            "memory_peak_bytes": peak, "record": record, "trace": summary}


def reference_run(ctx, k, precision=None) -> dict:
    """The plain reference of video ``k`` from weights and frames made anew
    from the seed (``precision``: the control's)."""
    cfg, dev = ctx.config, ctx.device
    video = preprocess_data.video(ctx.seed, k, ctx.traffic["frames"], cfg["height"],
                                  cfg["width"], dev)
    return reference.preprocess(video, preprocess_data.raft_state(ctx.seed, dev),
                                preprocess_data.vit_state(cfg["vit"], ctx.seed, dev), cfg,
                                precision or reference.Precision())


def decode_batches(t, pair_batch=8, min_len=2):
    """RAFT decode batches of one video: the adjacent flows both ways, then
    each start frame's direct flows both ways."""
    per = lambda n: -(-n // pair_batch)
    return 2 * per(t - 1) + 2 * sum(per(t - 1 - s) for s in range(t - (min_len - 1)))


def _attention_shape(cfg, t):
    """(launches, b, h, s, d) of the ViT's attention at this video size."""
    v = cfg["vit"]
    fh = 1 + (cfg["height"] - v["patch"]) // v["stride"]
    fw = 1 + (cfg["width"] - v["patch"]) // v["stride"]
    b = cfg["preprocess"]["extract_frames_per_batch"]
    batches = [min(b, t - s) for s in range(0, t, b)]
    return {"batches": batches, "heads": v["heads"], "tokens": 1 + fh * fw,
            "head_dim": v["embed_dim"] // v["heads"], "depth": max(v["layers"]) + 1}


def _k3_cells(cfg):
    """In-map window cells of one K3 launch: a decode batch of
    ``pairs_per_decode_batch`` pairs at 1/8 of the padded frame, counted at
    the zero-flow position (this cell's flows stay under a pixel)."""
    import torch
    h8, w8 = -(-cfg["height"] // 8), -(-cfg["width"] // 8)
    levels = [(h8, w8)]
    for _ in range(3):
        hh, ww = levels[-1]
        levels.append((hh // 2, ww // 2) if hh >= 2 and ww >= 2 else (hh, ww))
    ys, xs = torch.meshgrid(torch.arange(h8, dtype=torch.float32),
                            torch.arange(w8, dtype=torch.float32), indexing="ij")
    b = cfg["raft"]["pairs_per_decode_batch"]
    coords = torch.stack([xs, ys])[None].repeat(b, 1, 1, 1)
    from yardstick import counts
    return {"cells": counts.k3_in_map_cells(levels, coords), "pixels": b * h8 * w8}


def calibrate(ctx, mesh=None, faults=None, program_faults=()) -> dict:
    """One seed's readings of video 0 against the reference: the program's
    artifacts, the control (the ViT in float8 operands, RAFT in TF32), and
    each of ``faults.PROGRAM_FAULTS`` named in ``program_faults``, planted in
    the program (and mended) after the sound readings."""
    import faults as faults_lib
    s = setup(ctx)
    cfg, dev = ctx.config, ctx.device

    def artifacts(name):
        path = os.path.join(s.root, name)
        _pipeline(ctx, s, preprocess_data.video(ctx.seed, 0, s.t, cfg["height"], cfg["width"],
                                                dev), path).run()
        out = compare.read_preprocess_artifacts(path)
        shutil.rmtree(path)
        return out

    try:
        program = artifacts("video-0")
        broken = {}
        for fault in program_faults:
            mend = faults_lib.PROGRAM_FAULTS[fault]()
            try:
                broken[fault] = artifacts(f"video-0-{fault}")
            finally:
                mend()
    finally:
        shutil.rmtree(s.root, ignore_errors=True)
    del s
    gc.collect()
    ref = reference_run(ctx, 0)
    out = {"seed": ctx.seed, "program": compare.preprocess_readings(program, ref),
           "control": compare.preprocess_readings(
               _as_program(reference_run(ctx, 0, reference.Precision("float8_e4m3", "tf32"))), ref)}
    for fault, arts in broken.items():
        out[f"program_{fault}"] = compare.preprocess_readings(arts, ref)
    return out


def _as_program(ref: dict) -> dict:
    """A reference's outputs in the artifacts' layout (the control, put in
    the program's place)."""
    import numpy as np
    t = ref["masks"].shape[0]
    gw = ref["features"].shape[-1]
    n = max([len(d["src"]) for d in ref["bb"].values()] + [1])
    bb = {"source_coords": np.zeros((t, t, n, 2), np.float32),
          "target_coords": np.zeros((t, t, n, 2), np.float32),
          "cos_sims": np.zeros((t, t, n), np.float32), "r": np.ones((t, t, n), np.float32),
          "valid": np.zeros((t, t, n), bool)}
    for (s, u), d in ref["bb"].items():
        k = len(d["src"])
        for key, tok in (("source_coords", d["src"]), ("target_coords", d["tgt"])):
            tok = tok.numpy()
            bb[key][s, u, :k] = np.stack([7 + 7 * (tok % gw), 7 + 7 * (tok // gw)], -1)
        bb["cos_sims"][s, u, :k], bb["r"][s, u, :k] = d["cos"].numpy(), d["r"].numpy()
        bb["valid"][s, u, :k] = True
    return {**ref, "features": ref["features"].numpy(), "mask_features": ref["mask_features"].numpy(),
            "bb": bb}
