"""Regenerate tests/fixtures/full_width/*.npz: the JAX package's outputs at
the published width, the reference that ``chip_smoke.py`` phase 14 holds the
port to on the card.

    python scripts/gen_full_width_golden.py [--seed 0] [--stages vit raft ...]

Runs the JAX package on JAX's CPU backend (pinned before any JAX call), on
the inputs of ``full_width_inputs.py``, stage by stage, one process:

  a. ``vit``: ``models/vit.py extract_feature_video`` on 2 frames at 476×854,
     stride 7, layers 15 and 23, f32 and bf16 (at this grid the JAX "bf16"
     computes in f32: ROADMAP, defects in the reference), the weights read
     by ``vit_convert.load_dinov2_checkpoint`` from an ``.npz`` under
     ``build/``; attention through the plain XLA path, one frame a batch;
  b. ``raft``: ``raft_forward`` on 2 pairs at 854×476 padded as
     ``InputPadder`` pads, 24 iterations, f32, the weights through
     ``convert_raft_state_dict``;
  c. ``train``: the loss terms and gradients of ``training/train.py
     make_train_step`` (its body recomposed with the random parts injected,
     ``jax_step``) at TrainConfig's width on 8 frames, both phase gates, f32
     and bf16;
  d. ``refine``: ``cache_refined_embeddings`` (chunks of 16 frames) on
     T = 20 and one 256-point request through ``ModelInference.infer``
     (anchor re-tracking, chunks cut by ``corr_budget_bytes``), f32 and bf16;
  e. ``bb``: ``extract_best_buddies`` with the fused flow filter,
     ``closest_trajectory_grids`` and ``compute_bb_ambiguity`` on T = 4,
     C = 1024 at the 67×121 grid, 12,000 trajectories (two closest-grid
     chunks) and more than 8,192 valid rows a target frame (two slabs);
  f. ``traj``: stage 1's chaining, ``preprocessing/trajectories.py
     extract_trajectories_dual`` with ``direct_flow_fn`` (both passes, the
     per-pass look-behind occupancy) on T = 8 synthetic flows at 854×476,
     and each start frame's keep masks of ``_chain_dual`` and
     ``_keep_mask``.

Each file keeps what ``full_width_inputs.record_*`` keep of the outputs,
and ``meta`` (JSON): the seed, the widths, every input's sha256, each
record's shape and dtype, the tolerances, the JAX and numpy versions and
the stage's wall seconds on this machine's CPU. Never builds the JAX
``PreprocessingPipeline`` (its constructor turns on the persistent compile
cache). The stage functions take the widths, so the CPU tests run them at
toy sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import full_width_inputs as fw  # noqa: E402
from dino_tracker_tpu.config import TrainConfig  # noqa: E402
from dino_tracker_tpu.inference.infer import ModelInference  # noqa: E402
from dino_tracker_tpu.models import raft as jraft  # noqa: E402
from dino_tracker_tpu.models import tracker as jtracker  # noqa: E402
from dino_tracker_tpu.models import vit as jvit  # noqa: E402
from dino_tracker_tpu.models import vit_convert  # noqa: E402
from dino_tracker_tpu.preprocessing import best_buddies as jbb  # noqa: E402
from dino_tracker_tpu.preprocessing import trajectories as jtraj  # noqa: E402
from dino_tracker_tpu.training import contrastive as jcl  # noqa: E402
from dino_tracker_tpu.training import cycle as jcycle  # noqa: E402
from dino_tracker_tpu.training import losses as jlosses  # noqa: E402
from dino_tracker_tpu.training import train as jtrain  # noqa: E402
from dino_tracker_tpu.utils import coords as jcoords  # noqa: E402

OUT_DIR = os.path.join(REPO, "tests", "fixtures", "full_width")
DTYPES = ("float32", "bfloat16")
VIT_TOKENS = 24  # tokens a frame whose whole feature vector a golden keeps
ANCHOR_COS, COS = 0.7, 0.6  # TrainConfig's occlusion thresholds


def vit_config(wd: fw.Widths) -> jvit.ViTConfig:
    d, depth, heads, mlp, grid = wd.vit
    return jvit.ViTConfig(embed_dim=d, depth=depth, num_heads=heads, mlp_ratio=mlp,
                          patch_size=14, pretrain_grid=grid)


def tracker_config(wd: fw.Widths, dtype: str) -> jtracker.TrackerConfig:
    return jtracker.TrackerConfig(video_h=wd.h, video_w=wd.w, delta_channels=wd.channels,
                                  compute_dtype=dtype)


def train_config(wd: fw.Widths, dtype: str) -> TrainConfig:
    """TrainConfig at these widths. The contrastive terms take every
    candidate (2·n points a pair, half of them foreground), so that their
    point selections, drawn from each package's own generator, are the whole
    candidate set in both."""
    return TrainConfig(video_resh=wd.h, video_resw=wd.w, train_batch_size=wd.batch,
                       batch_n_frames=wd.batch_n_frames, cyc_n_frames=wd.cyc[0],
                       cyc_batch_size_per_frame=wd.cyc[1], cl_n_frames=wd.cl_pairs,
                       cl_points_per_pair=2 * wd.n_feat, cl_fg_points_ratio=0.5,
                       compute_dtype=dtype)


# ---------------------------------------------------------------------------
# a. ViT
# ---------------------------------------------------------------------------

def stage_vit(inp, wd: fw.Widths, seed: int, work_dir: str = None):
    """Features of layers ``wd.vit_layers`` in f32 and bf16 -> records
    ``{dtype}/layer{l}/...``. At the published width the weights go through
    ``load_dinov2_checkpoint`` from an ``.npz`` in ``work_dir``."""
    cfg = vit_config(wd)
    if work_dir is not None and cfg == jvit.ViTConfig.for_model("dinov2_vitl14"):
        path = os.path.join(work_dir, "dinov2_vitl14.npz")
        np.savez(path, **inp["weights"])
        params, cfg = vit_convert.load_dinov2_checkpoint(path, "dinov2_vitl14")
        os.remove(path)
    else:
        params = vit_convert.convert_dinov2_state_dict(inp["weights"], cfg)
    tokens = fw.sample_positions(seed, "vit", wd.n_feat, VIT_TOKENS)
    rec = {}
    for dtype in DTYPES:
        feats = jvit.extract_feature_video(
            params, jnp.asarray(inp["frames"]), cfg, stride=7, layer=list(wd.vit_layers),
            frames_per_batch=1, attn_impl="xla", compute_dtype=jnp.dtype(dtype))
        for layer, f in zip(wd.vit_layers, feats):
            for k, v in fw.record_features(np.asarray(f), tokens).items():
                rec[f"{dtype}/layer{layer}/{k}"] = v
    return rec


# ---------------------------------------------------------------------------
# b. RAFT
# ---------------------------------------------------------------------------

def stage_raft(inp, wd: fw.Widths, seed: int):
    """Flows source → target of every pair, f32 -> records."""
    params = jraft.convert_raft_state_dict(inp["weights"])
    frames = jnp.asarray(inp["frames"])
    padder = jraft.InputPadder(frames.shape)
    flow = jraft.raft_forward(params, padder.pad(frames[inp["source"]]),
                              padder.pad(frames[inp["target"]]), num_iters=wd.raft_iters)
    return fw.record_flow(np.asarray(padder.unpad(flow)))


# ---------------------------------------------------------------------------
# c. one train step
# ---------------------------------------------------------------------------

def jax_step(params, stats, data, sample, cyc, dino_pairs, ref_pairs, cfg, jcfg):
    """The JAX loss_fn of make_train_step (train.py:113-181) with the random
    parts injected, for both phases: {gates: (metrics, grads, new batch
    stats)}. ``data``: video, dino (f16 stack), masks and bb (dict of BBData
    fields), numpy; ``sample`` the fields of a sampled batch, ``cyc`` those of
    CycleData, the pairs (sources, targets), all numpy. Every term is
    computed once; the phase with the gates off drops the cycle and
    refined-buddy terms from the total (the other terms do not depend on
    them), so one compiled program serves both phases."""
    jbbd = jtrain.BBData(**{k: jnp.asarray(v) for k, v in data["bb"].items()})
    dino_cl = jnp.transpose(jnp.asarray(data["dino"]), (0, 2, 3, 1))  # to_channels_last
    frames_set_t = jnp.asarray(sample["frames_set_t"])
    inp = jtracker.TrackerInput(jnp.asarray(sample["t1_points"]),
                                jnp.asarray(sample["source_frame_indices"]),
                                jnp.asarray(sample["target_frame_indices"]),
                                frames_set_t)
    labels = jnp.asarray(sample["t2_points_normalized"][:, :2])
    cyc_data = jcycle.CycleData(*(jnp.asarray(cyc[f]) for f in jcycle.CycleData._fields))
    masks = jnp.asarray(data["masks"])
    key = jax.random.PRNGKey(0)

    def terms(p):
        refined, _, raw, new_stats = jtracker.get_refined_embeddings(
            p, stats, jnp.asarray(data["video"]), dino_cl, frames_set_t, jcfg,
            train=True, channels_last=True)
        view = jtracker.make_frame_view(refined, jnp.dtype(jcfg.compute_dtype),
                                        channels_last=True)
        coords = jtracker.get_point_predictions(p, inp, refined, jcfg,
                                                view=view, channels_last=True)
        cl = dict(n_pairs=cfg.cl_n_frames, points_per_pair=cfg.cl_points_per_pair,
                  fg_points_ratio=cfg.cl_fg_points_ratio, temp=cfg.cl_temp,
                  view=view, channels_last=True)
        m = {"loss_of": jnp.mean(jlosses.huber(coords, labels)),
             "loss_cyc": jcycle.cycle_consistency_loss(
                 p, refined, frames_set_t, cyc_data, jcfg, cfg.cyc_gamma,
                 view=view, group_size=cfg.cyc_batch_size_per_frame,
                 channels_last=True),
             "loss_cl_refiner": jcl.refined_bb_contrastive_loss(
                 key, refined, frames_set_t, masks, jcfg,
                 cl_div=cfg.cl_div_ref_bb, pair_sel=ref_pairs, **cl),
             "loss_cl_dino_bb": jcl.dino_bb_contrastive_loss(
                 key, refined, frames_set_t, jbbd, masks, jcfg,
                 cl_div=cfg.cl_div_dino_bb, sig_a=cfg.bb_amb_sig_a,
                 sig_b=cfg.bb_amb_sig_b, pair_sel=dino_pairs, **cl),
             "loss_emb_norm_reg": jlosses.emb_norm_regularization(
                 refined, raw, channels_last=True),
             "loss_angle_reg": jlosses.emb_angle_regularization(
                 refined, raw, channels_last=True)}
        return m, new_stats

    def total(m, gates):
        t = (m["loss_of"] + cfg.lambda_cl_dino_bb * m["loss_cl_dino_bb"]
             + cfg.lambda_emb_norm * m["loss_emb_norm_reg"]
             + cfg.lambda_angle * m["loss_angle_reg"])
        if gates:
            t = (t + cfg.lambda_cyc * m["loss_cyc"]
                 + cfg.lambda_cl_ref_bb * m["loss_cl_refiner"])
        return t

    @jax.jit
    def both(p):
        m, vjp, new_stats = jax.vjp(terms, p, has_aux=True)
        out = {}
        for gates in (False, True):
            ct = jax.grad(lambda mm: total(mm, gates))(m)
            mg = dict(m, loss_total=total(m, gates))
            if not gates:
                mg.update(loss_cyc=jnp.asarray(0.0), loss_cl_refiner=jnp.asarray(0.0))
            out[gates] = (mg, vjp(ct)[0], new_stats)
        return out

    return both(params)


def record_step(metrics, grads, new_stats, seed, samples):
    """One phase's losses, new BN statistics and every gradient's record,
    keyed by the JAX pytree paths."""
    rec = {f"loss/{k}": np.float64(v) for k, v in metrics.items()}
    for path, v in fw.flatten(jax.tree.map(np.asarray, new_stats)).items():
        rec[f"stats/{path}"] = v.astype(np.float32)
    for path, g in fw.flatten(jax.tree.map(np.asarray, grads)).items():
        idx = fw.sample_positions(seed, path, g.size, samples)
        for k, v in fw.record_tensor(g, idx).items():
            rec[f"grad/{path}/{k}"] = v
    return rec


def stage_train(inp, wd: fw.Widths, seed: int):
    """Both phases of one step in f32 and bf16 -> records
    ``{dtype}/gates_{off,on}/...``."""
    rec = {}
    for dtype in DTYPES:
        out = jax_step(inp["params"], inp["stats"], inp, inp["sample"], inp["cyc"],
                       (inp["dino_pairs"]["source"], inp["dino_pairs"]["target"]),
                       (inp["ref_pairs"]["source"], inp["ref_pairs"]["target"]),
                       train_config(wd, dtype), tracker_config(wd, dtype))
        for gates, (m, g, s) in out.items():
            for k, v in record_step(m, g, s, seed, wd.samples).items():
                rec[f"{dtype}/gates_{'on' if gates else 'off'}/{k}"] = v
    return rec


# ---------------------------------------------------------------------------
# d. the refine and a request
# ---------------------------------------------------------------------------

def stage_refine(inp, wd: fw.Widths, seed: int):
    """The refined stack (T×h×w×C) and one request's tracks and occlusion
    flags in f32 and bf16 -> records ``{dtype}/...``."""
    rec = {}
    t, c = wd.refine_t, wd.channels[-1]
    idx = fw.sample_positions(seed, "refined", t * wd.n_feat * c, wd.samples * 8)
    for dtype in DTYPES:
        jcfg = tracker_config(wd, dtype)
        refined = jtracker.cache_refined_embeddings(
            inp["params"], inp["stats"], jnp.asarray(inp["video"]),
            jnp.asarray(inp["dino"]), jcfg)
        mi = ModelInference(params=inp["params"], refined_features=refined, cfg=jcfg,
                            anchor_cosine_similarity_threshold=ANCHOR_COS,
                            cosine_similarity_threshold=COS, chunk=wd.infer_chunk)
        trajs, occ = mi.infer(inp["queries"])
        for k, v in fw.record_refined(np.transpose(np.asarray(refined), (0, 2, 3, 1)),
                                      idx).items():
            rec[f"{dtype}/refined/{k}"] = v
        rec[f"{dtype}/tracks"] = np.asarray(trajs, np.float32)
        rec[f"{dtype}/occluded"] = np.asarray(occ, bool)
        rec[f"{dtype}/chunk"] = np.int64(mi.chunk)
    return rec


# ---------------------------------------------------------------------------
# e. stage 5
# ---------------------------------------------------------------------------

def stage_bb(inp, wd: fw.Widths, seed: int):
    """The sweep with the fused flow filter, the closest grids and the
    ambiguity -> records."""
    feats, trajs = jnp.asarray(inp["features"]), inp["trajectories"]
    tel = {}
    bb = jbb.extract_best_buddies(feats, wd.h, wd.w, 7, unfiltered_trajectories=trajs,
                                  telemetry=tel)
    grid = jcoords.bb_meshgrid(wd.h, wd.w, 7)
    closest = jbb.closest_trajectory_grids(trajs, grid, chunk=wd.bb_chunk)
    amb_tel = {}
    bb = jbb.compute_bb_ambiguity(bb, feats, wd.h, wd.w, 7, rows_per_slab=wd.bb_slab,
                                  telemetry=amb_tel)
    rec = fw.record_bb(*(np.asarray(x) for x in bb), wd.h, wd.w)
    rec["capacity"] = np.int64(bb.valid.shape[-1])
    rec["closest"] = np.asarray(closest).astype(np.int32)
    rec["rows_per_target"] = np.asarray(
        [int(np.asarray(bb.valid)[:, u].sum())
         for u in range(wd.bb_t)], np.int64)
    return rec


# ---------------------------------------------------------------------------
# f. stage 1's chaining
# ---------------------------------------------------------------------------

def traj_keep_masks(inp, wd: fw.Widths):
    """Each start frame's keep masks of both passes, before eligibility and
    occupancy: ``_chain_dual`` and ``_keep_mask`` on the start's direct flows
    padded to T-1 rows -> {"f": S×H×W, "u": S×H×W} bool."""
    args = fw.TRAJ_ARGS
    t, h, w = wd.traj_t, wd.h, wd.w
    fwd, bwd = jnp.asarray(inp["fwd"]), jnp.asarray(inp["bwd"])
    keep = {"f": [], "u": []}
    for start in range(t - (args["min_trajectory_length"] - 1)):
        n = t - 1 - start
        dflows = jnp.zeros((t - 1, h, w, 2), jnp.float32).at[:n].set(inp["direct"][start])
        dmasks = jnp.zeros((t - 1, h, w), jnp.float32).at[:n].set(inp["direct_masks"][start])
        tls = jtraj._chain_dual(fwd, bwd, jnp.asarray(start, jnp.int32), dflows, dmasks,
                                args["threshold"], args["direct_flow_threshold"])
        for key, tl in zip("fu", tls):
            keep[key].append(np.asarray(jtraj._keep_mask(tl, args["min_trajectory_length"])))
    return {k: np.stack(v) for k, v in keep.items()}


def stage_traj(inp, wd: fw.Widths, seed: int):
    """Both passes of the chaining with the direct flows through
    ``direct_flow_fn`` and the keep masks of every start -> records
    ``{pass}/...`` (``full_width_inputs.record_traj``; pass f with the
    direct-flow filter, u without)."""
    args = fw.TRAJ_ARGS
    trajs = jtraj.extract_trajectories_dual(
        inp["fwd"], inp["bwd"], direct_flow_fn=lambda s: (inp["direct"][s],
                                                          inp["direct_masks"][s]), **args)
    keep = traj_keep_masks(inp, wd)
    rec = {}
    for key, tr in zip("fu", trajs):
        idx = fw.sample_positions(seed, f"traj/{key}", len(tr), wd.samples)
        for k, v in fw.record_traj(tr, keep[key], wd.h, wd.w, idx).items():
            rec[f"{key}/{k}"] = v
    return rec


STAGE_FNS = {"vit": stage_vit, "raft": stage_raft, "train": stage_train,
             "refine": stage_refine, "bb": stage_bb, "traj": stage_traj}


def golden_meta(stage, wd, seed, inp, rec, seconds):
    return {"stage": stage, "seed": seed, "widths": dataclasses.asdict(wd),
            "input_digests": fw.digests(inp),
            "records": {k: [list(np.shape(v)), np.asarray(v).dtype.str]
                        for k, v in rec.items()},
            "tolerances": fw.TOLERANCES[stage], "jax": jax.__version__,
            "numpy": np.__version__, "seconds_on_this_cpu": round(seconds, 1),
            "made_by": "python scripts/gen_full_width_golden.py"}


def write_golden(path, meta, rec):
    np.savez_compressed(path, meta=np.asarray(json.dumps(meta, sort_keys=True)),
                        **{f"rec/{k}": np.asarray(v) for k, v in rec.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", nargs="+", default=list(fw.STAGES), choices=fw.STAGES)
    args = ap.parse_args()
    os.makedirs(OUT_DIR, exist_ok=True)
    work_dir = os.path.join(REPO, "build", "full_width")
    os.makedirs(work_dir, exist_ok=True)
    for stage in args.stages:
        t0 = time.perf_counter()
        inp = fw.make(stage, fw.FULL, args.seed)
        kw = {"work_dir": work_dir} if stage == "vit" else {}
        rec = STAGE_FNS[stage](inp, fw.FULL, args.seed, **kw)
        seconds = time.perf_counter() - t0
        path = os.path.join(OUT_DIR, f"{stage}.npz")
        write_golden(path, golden_meta(stage, fw.FULL, args.seed, inp, rec, seconds), rec)
        print(f"{stage}: wrote {os.path.relpath(path, REPO)} "
              f"({os.path.getsize(path) / 1e6:.2f} MB) in {seconds:.1f} s", flush=True)


if __name__ == "__main__":
    main()
