"""The inputs and weights of the full-width goldens, made with numpy alone.

One seed makes every array of the five stages that ``gen_full_width_golden.py``
runs through the JAX package and ``chip_smoke.py`` phase 14 runs through the
port, so the card rebuilds the goldens' inputs without JAX:

  a. ``vit``: dinov2_vitl14 weights under the official DINOv2 state-dict keys
     (``mask_token`` and the final ``norm`` included; non-zero pos-embed and
     layerscale) and 2 frames of 854×476;
  b. ``raft``: RAFT-large weights under the princeton-vl ``module.`` keys
     (each strided cnet block's ``norm3`` beside ``downsample.1``, as the
     published checkpoints hold them; the flow head's last conv scaled by
     0.1) and 3 frames, 2 pairs;
  c. ``train``: DeltaDINO and tracker-head weights in the JAX layout, 8
     frames, a C = 1024 feature stack on the 67×121 grid, fg masks,
     trajectory banks, padded best buddies and one train step's injected
     batch at TrainConfig's widths (512 points × 4 frames, cycle 4×256);
  d. ``refine``: other such weights, T = 20 frames and a stack, and the 256
     query points of one request;
  e. ``bb``: a T = 4, C = 1024 stack of ±1 features (every cosine a multiple
     of 2^-9, exact in f32 in any summation order) and 12,000 trajectories;
  f. ``traj``: stage 1's chaining on synthetic flows of T = 8 frames: the
     forward and backward flows of a background moving (1.5, 0.5) px a frame
     with a smooth perturbation, an occluder that moves otherwise, blocks of
     backward-flow noise at and beyond the 1.5 px cycle threshold, and the
     direct flows of every start with their masks, blocks of them at and
     beyond the 2.5 px direct threshold (no RAFT: stage ``raft`` holds it).

Frames are a random texture sampled bilinearly at a sub-pixel shift a frame
and rounded to bytes: only +, ×, floor and the generator's own streams, so
every machine makes the same bits. ``digests`` gives each array's sha256;
every golden records them and every comparison checks them first.

``record_*`` reduce a stage's full outputs to what a golden keeps (norms,
means, full values at seeded positions); the generator and phase 14 call the
same functions, the second with the golden's positions.

Imports numpy only: neither JAX nor either package.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import numpy as np

STAGES = ("vit", "raft", "train", "refine", "bb", "traj")

# What phase 14 holds the port to, stage by stage (recorded in each golden).
# vit: f32 features within 1e-4 of the layer's largest |feature|; bf16 a
#   per-token cosine >= 0.995 against the JAX "bf16" (tests/test_torch_vit.py).
# raft: flows within 1e-4 of max|flow| (tests/test_torch_raft.py).
# train: loss terms rtol, BN statistics rtol (atol 1e-5), gradients within a
#   share of each tensor's largest magnitude; bf16 is sign and scale
#   (tests/test_torch_train_step.py). The BN shifts of DeltaDINO's layers
#   that feed another train-mode BN ("grad_cancelling") have gradients that
#   are sums over 0.2-3.3 M positions of cotangents that cancel (the sum of
#   their magnitudes is 100-220 times the result in the median channel, up
#   to 2e4 times: scripts/probe_bn_shift_grads.py on an H100), so f32
#   summation order moves them that much more than the other tensors: at the
#   published width the port and JAX differ there by 1.0e-3 to 2.6e-3 of the
#   largest magnitude (PERF.md section 6, PR 14).
# refine: the refined stack within a share of its largest magnitude, tracks
#   within px, occlusion flags equal (tests/test_torch_inference.py).
# bb: every buddy, cosine, ratio and closest trajectory equal.
# traj: the chaining's keep masks of every start and pass equal but at
#   "threshold pixels", where the port's float64 recomputation of the
#   pixel's chain puts a cycle error, a direct-flow error or a coordinate
#   within eps_px of its threshold or bound (at most max_threshold_pixels of
#   them, in all); the kept pixels of each start equal up to the first start
#   where they differ, each difference there a threshold pixel, a flow-mask
#   pixel (its cycle error within eps_px of the threshold) or a cell that an
#   earlier trajectory's position within eps_half of a half-integer rounds
#   into either way; every start before it: its per-frame NaN counts equal,
#   its per-frame coordinate sums within sum_rel, its sampled trajectories
#   within sample_px and NaN where the golden's are.
TOLERANCES = {
    "vit": {"float32": 1e-4, "bfloat16_cosine": 0.995},
    "raft": {"flow": 1e-4},
    "train": {"float32": {"loss": 1e-4, "stats": 1e-4, "grad": 1e-3,
                          "grad_cancelling": 5e-3},
              "bfloat16": {"loss": 2e-2, "stats": 2e-2, "grad": 0.35,
                           "grad_cancelling": 0.35}},
    "refine": {"float32": {"refined": 1e-4, "track_px": 1e-3},
               "bfloat16": {"refined": 1e-2, "track_px": 1e-3}},
    "bb": {"equal": 0},
    "traj": {"eps_px": 1e-3, "eps_half": 1e-4, "max_threshold_pixels": 2000,
             "sample_px": 1e-3, "sum_rel": 1e-6},
}


@dataclasses.dataclass(frozen=True)
class Widths:
    """Every size of the five stages. ``FULL`` is the published width; the
    CPU tests run ``TOY``, which crosses the same chunk and slab edges at
    toy sizes."""

    name: str
    h: int
    w: int
    # a. ViT: DINOv2 (embed dim, blocks, heads, mlp ratio, pretrain grid)
    vit: Tuple[int, int, int, int, int]
    vit_layers: Tuple[int, ...]
    vit_frames: int
    # b. RAFT: frames, (source, target) pairs, GRU iterations
    raft_frames: int
    raft_pairs: Tuple[Tuple[int, int], ...]
    raft_iters: int
    # c. one train step: DeltaDINO channels (the last is the stack's C),
    # frames, TrainConfig's batch, frames a batch, cycle frames × points,
    # contrastive pairs, bank rows, best-buddy capacity and most valid slots
    channels: Tuple[int, ...]
    train_t: int
    batch: int
    batch_n_frames: int
    cyc: Tuple[int, int]
    cl_pairs: int
    bank_rows: int
    bb_cap: int
    bb_valid: int
    # d. the refine and a request: frames, query points, ModelInference's
    # chunk (the published default, which corr_budget_bytes cuts at T = 20)
    refine_t: int
    n_queries: int
    query_frame: int
    infer_chunk: int
    # e. stage 5: frames, channels, trajectories, closest-grid chunk, slab
    bb_t: int
    bb_c: int
    bb_traj: int
    bb_chunk: int
    bb_slab: int
    # f. stage 1's chaining: frames
    traj_t: int
    # positions whose full values a golden keeps, per record
    samples: int

    @property
    def feat_hw(self) -> Tuple[int, int]:
        """The ViT grid at stride 7 of a 14-pixel patch."""
        return 1 + (self.h - 14) // 7, 1 + (self.w - 14) // 7

    @property
    def n_feat(self) -> int:
        return self.feat_hw[0] * self.feat_hw[1]


FULL = Widths(
    name="full", h=476, w=854,
    vit=(1024, 24, 16, 4, 37), vit_layers=(15, 23), vit_frames=2,
    raft_frames=3, raft_pairs=((0, 1), (1, 2)), raft_iters=24,
    channels=(3, 64, 128, 256, 1024), train_t=8, batch=512, batch_n_frames=4,
    cyc=(4, 256), cl_pairs=4, bank_rows=20_000, bb_cap=512, bb_valid=400,
    refine_t=20, n_queries=256, query_frame=7, infer_chunk=4096,
    bb_t=4, bb_c=1024, bb_traj=12_000, bb_chunk=8192, bb_slab=8192, traj_t=8,
    samples=1024)

TOY = Widths(
    name="toy", h=70, w=98,
    vit=(128, 3, 2, 2, 5), vit_layers=(1, 2), vit_frames=2,
    raft_frames=3, raft_pairs=((0, 1), (1, 2)), raft_iters=3,
    channels=(3, 8, 8, 8, 32), train_t=6, batch=32, batch_n_frames=3,
    cyc=(2, 16), cl_pairs=2, bank_rows=200, bb_cap=24, bb_valid=20,
    refine_t=17, n_queries=12, query_frame=2, infer_chunk=16,
    bb_t=4, bb_c=64, bb_traj=300, bb_chunk=128, bb_slab=100, traj_t=5,
    samples=64)


def stage_rng(seed: int, stage: str) -> np.random.Generator:
    """The generator of one stage: its arrays do not move when another
    stage's change."""
    return np.random.default_rng([seed, STAGES.index(stage)])


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists / tuples of arrays -> {path: array}."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def digests(tree) -> Dict[str, str]:
    """sha256 of each array's dtype, shape and bytes, by path."""
    out = {}
    for path, a in flatten(tree).items():
        h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
        out[path] = h.hexdigest()
    return out


# ---------------------------------------------------------------------------
# frames and feature stacks
# ---------------------------------------------------------------------------

def moving_texture(rng, t: int, h: int, w: int, shift=(1.5, 0.5), cell: int = 8):
    """T×3×H×W f32 in [0, 1]: a random colour texture of ``cell``-pixel
    cells, bilinearly sampled at ``shift`` (x, y) px a frame and rounded to
    bytes, as a decoded video frame is."""
    tex = rng.random((3, h // cell + 4 + t, w // cell + 4 + t))
    ys = np.arange(h, dtype=np.float64)[:, None]
    xs = np.arange(w, dtype=np.float64)[None, :]
    frames = np.empty((t, 3, h, w), np.uint8)
    for i in range(t):
        y = (ys + 2 * cell - shift[1] * i + t * cell) / cell
        x = (xs + 2 * cell - shift[0] * i + t * cell) / cell
        y, x = np.broadcast_to(y, (h, w)), np.broadcast_to(x, (h, w))
        y0, x0 = np.floor(y).astype(np.int64), np.floor(x).astype(np.int64)
        fy, fx = y - y0, x - x0
        y0, x0 = y0 % (tex.shape[1] - 1), x0 % (tex.shape[2] - 1)
        v = (tex[:, y0, x0] * (1 - fy) * (1 - fx) + tex[:, y0, x0 + 1] * (1 - fy) * fx
             + tex[:, y0 + 1, x0] * fy * (1 - fx) + tex[:, y0 + 1, x0 + 1] * fy * fx)
        frames[i] = np.floor(v * 255 + 0.5).astype(np.uint8)
    return frames.astype(np.float32) / np.float32(255)


def feature_stack(rng, t: int, c: int, hw: Tuple[int, int]):
    """T×C×h×w f16 (the artifact dtype): a static per-position pattern plus
    per-frame noise, so a query's own cell is the correlation peak."""
    pos = rng.standard_normal((1, c, *hw), dtype=np.float32) * np.float32(3)
    noise = rng.standard_normal((t, c, *hw), dtype=np.float32) * np.float32(0.6)
    return (pos + noise).astype(np.float16)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _uniform(rng, shape, scale, shift=0.0):
    return (rng.random(shape, dtype=np.float32) * np.float32(2) - np.float32(1)) \
        * np.float32(scale) + np.float32(shift)


def dinov2_state_dict(rng, vit: Tuple[int, int, int, int, int], patch: int = 14):
    """DINOv2 weights under the official keys (``mask_token`` and the final
    ``norm`` included, which the model does not use): linears ~U(±1/√din),
    non-zero pos-embed ~U(±1) (so the bicubic resize does work), layerscale
    ~U(±0.2), LayerNorm scales 1 ± 0.2."""
    d, depth, _, mlp, grid = vit
    hid = mlp * d
    sd = {"cls_token": _uniform(rng, (1, 1, d), 1.0),
          "pos_embed": _uniform(rng, (1, 1 + grid * grid, d), 1.0),
          "mask_token": _uniform(rng, (1, d), 1.0),
          "patch_embed.proj.weight": _uniform(rng, (d, 3, patch, patch),
                                              1 / np.sqrt(3 * patch * patch)),
          "patch_embed.proj.bias": _uniform(rng, (d,), 0.1)}
    for i in range(depth):
        b = f"blocks.{i}."
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                                  "mlp.fc1": (hid, d), "mlp.fc2": (d, hid)}.items():
            sd[f"{b}{name}.weight"] = _uniform(rng, (dout, din), 1 / np.sqrt(din))
            sd[f"{b}{name}.bias"] = _uniform(rng, (dout,), 0.1)
        for name in ("norm1", "norm2"):
            sd[f"{b}{name}.weight"] = _uniform(rng, (d,), 0.2, 1.0)
            sd[f"{b}{name}.bias"] = _uniform(rng, (d,), 0.1)
        sd[f"{b}ls1.gamma"] = _uniform(rng, (d,), 0.2)
        sd[f"{b}ls2.gamma"] = _uniform(rng, (d,), 0.2)
    sd["norm.weight"] = _uniform(rng, (d,), 0.2, 1.0)
    sd["norm.bias"] = _uniform(rng, (d,), 0.1)
    return sd


def raft_shapes() -> Dict[str, Tuple[int, ...]]:
    """RAFT-large's parameters and BN buffers under the princeton-vl keys
    (unprefixed), in the order of its modules. Each strided cnet block holds
    its downsample BN twice, as ``norm3`` and ``downsample.1`` (one module
    registered under both names in princeton-vl's ResidualBlock)."""
    shapes = {}

    def conv(name, cout, cin, kh, kw=None):
        shapes[f"{name}.weight"] = (cout, cin, kh, kh if kw is None else kw)
        shapes[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{k}"] = (c,)

    for enc, norm in (("fnet", "instance"), ("cnet", "batch")):
        conv(f"{enc}.conv1", 64, 3, 7)
        if norm == "batch":
            bn(f"{enc}.norm1", 64)
        for li, (cin, cout, stride) in enumerate(((64, 64, 1), (64, 96, 2),
                                                  (96, 128, 2)), 1):
            for j in range(2):
                ci, s = (cin, stride) if j == 0 else (cout, 1)
                b = f"{enc}.layer{li}.{j}"
                conv(f"{b}.conv1", cout, ci, 3)
                conv(f"{b}.conv2", cout, cout, 3)
                if norm == "batch":
                    bn(f"{b}.norm1", cout)
                    bn(f"{b}.norm2", cout)
                    if s > 1:
                        bn(f"{b}.norm3", cout)
                if s > 1 or ci != cout:
                    conv(f"{b}.downsample.0", cout, ci, 1)
                    if norm == "batch":
                        bn(f"{b}.downsample.1", cout)
        conv(f"{enc}.conv2", 256, 128, 1)
    u = "update_block."
    conv(f"{u}encoder.convc1", 256, 4 * 81, 1)
    conv(f"{u}encoder.convc2", 192, 256, 3)
    conv(f"{u}encoder.convf1", 128, 2, 7)
    conv(f"{u}encoder.convf2", 64, 128, 3)
    conv(f"{u}encoder.conv", 126, 64 + 192, 3)
    for g in "zrq":
        conv(f"{u}gru.conv{g}1", 128, 384, 1, 5)
        conv(f"{u}gru.conv{g}2", 128, 384, 5, 1)
    conv(f"{u}flow_head.conv1", 256, 128, 3)
    conv(f"{u}flow_head.conv2", 2, 256, 3)
    conv(f"{u}mask.0", 256, 128, 3)
    conv(f"{u}mask.2", 64 * 9, 256, 1)
    return shapes


def raft_state_dict(rng):
    """RAFT-large weights, ``module.``-prefixed: convs ~U(±1/√fan_in)
    (torch's default bounds), BN affine and statistics near identity, each
    ``norm3`` equal to its ``downsample.1``. The flow head's last conv is
    scaled by 0.1: unscaled, the random flows run to a few px; scaled, they
    stay near 0.3 px, as a decoded video's small motions do."""
    shapes = raft_shapes()
    bn_draw = {"weight": (0.2, 1.0), "bias": (0.1, 0.0),
               "running_mean": (0.1, 0.0), "running_var": (0.5, 1.0)}
    sd = {}
    for k, shape in shapes.items():
        if ".norm3." in k:
            continue
        module, _, leaf = k.rpartition(".")
        weight = shapes[f"{module}.weight"]
        if len(weight) == 4:  # a conv
            sd[k] = _uniform(rng, shape, 1 / np.sqrt(np.prod(weight[1:])))
        else:  # a BN
            sd[k] = _uniform(rng, shape, *bn_draw[leaf])
    for k in ("weight", "bias"):
        sd[f"update_block.flow_head.conv2.{k}"] *= np.float32(0.1)
    for k in shapes:
        if ".norm3." in k:
            sd[k] = sd[k.replace(".norm3.", ".downsample.1.")]
    return {f"module.{k}": sd[k] for k in shapes}


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


# ---------------------------------------------------------------------------
# the stages' inputs
# ---------------------------------------------------------------------------

def vit_inputs(wd: Widths, seed: int):
    rng = stage_rng(seed, "vit")
    return {"weights": dinov2_state_dict(rng, wd.vit),
            "frames": moving_texture(rng, wd.vit_frames, wd.h, wd.w)}


def raft_inputs(wd: Widths, seed: int):
    rng = stage_rng(seed, "raft")
    pairs = np.asarray(wd.raft_pairs, np.int64)
    return {"weights": raft_state_dict(rng),
            "frames": moving_texture(rng, wd.raft_frames, wd.h, wd.w),
            "source": pairs[:, 0], "target": pairs[:, 1]}


def _fg_masks(rng, t, h, w):
    """T×H×W f32 in {0, 255}: an ellipse that drifts, the fg of a video."""
    ys = np.arange(h, dtype=np.float64)[:, None] / h
    xs = np.arange(w, dtype=np.float64)[None, :] / w
    cx, cy = 0.3 + 0.4 * rng.random(), 0.35 + 0.3 * rng.random()
    out = np.empty((t, h, w), np.float32)
    for i in range(t):
        x = xs - cx - 0.01 * i
        out[i] = np.where((x / 0.22) ** 2 + ((ys - cy) / 0.3) ** 2 < 1, 255, 0)
    return out


def _trajectories(rng, n, t, h, w, nan_share):
    tr = (rng.random((n, t, 2), dtype=np.float32)
          * np.asarray([w - 1, h - 1], np.float32))
    tr[rng.random((n, t)) < nan_share] = np.nan
    return tr


def train_inputs(wd: Widths, seed: int):
    """One train step's data and its injected batch. The batch is what
    ``sampler.sample_batch`` returns (frames set, source and target indices
    into it, t1 in pixels with t normalised, t2 normalised, target frames),
    drawn here from the banks' visible points; the cycle data in per-pair
    blocks of the set's frames and the contrastive frame pairs are those of
    ``tests/test_torch_train_step.py``'s ``injected``."""
    rng = stage_rng(seed, "train")
    t, h, w, c = wd.train_t, wd.h, wd.w, wd.channels[-1]
    params, stats = jax_layout_weights(rng, wd.channels)
    video = moving_texture(rng, t, h, w)
    dino = feature_stack(rng, t, c, wd.feat_hw)
    masks = _fg_masks(rng, t, h, w)
    fg, bg = (_trajectories(rng, wd.bank_rows, t, h, w, 0.2) for _ in range(2))
    cap = wd.bb_cap
    scale = np.asarray([w - 1, h - 1], np.float32)
    # at most bb_valid valid slots a pair, fewer than the contrastive term's
    # quotas, so its point selection is the whole valid set in both packages
    nvalid = rng.integers(wd.bb_valid // 4, wd.bb_valid + 1, (t, t))
    bb = {"source_coords": rng.random((t, t, cap, 2), dtype=np.float32) * scale,
          "target_coords": rng.random((t, t, cap, 2), dtype=np.float32) * scale,
          "cos_sims": (0.2 + 0.8 * rng.random((t, t, cap))).astype(np.float32),
          "r": rng.random((t, t, cap)).astype(np.float32),
          "valid": np.arange(cap)[None, None] < nvalid[..., None]}

    # the batch: 2·batch_n_frames distinct frames, half the points from each
    # bank, each a trajectory visible at its source and target frame
    set_t = np.sort(rng.choice(t, 2 * wd.batch_n_frames, replace=False)).astype(np.int64)
    t1, t2 = [], []
    for bank, n in ((fg, wd.batch // 2), (bg, wd.batch - wd.batch // 2)):
        got = 0
        while got < n:
            row = rng.integers(0, len(bank))
            a, b = rng.choice(set_t, 2, replace=False)
            if np.isnan(bank[row, a]).any() or np.isnan(bank[row, b]).any():
                continue
            t1.append([*bank[row, a], a])
            t2.append([*bank[row, b], b])
            got += 1
    t1, t2 = np.asarray(t1, np.float32), np.asarray(t2, np.float32)
    norm = np.asarray([w - 1, h - 1, t - 1], np.float32)
    t1_norm = np.float32(2) * t1 / norm - np.float32(1)
    t2_norm = np.float32(2) * t2 / norm - np.float32(1)
    sample = {"frames_set_t": set_t,
              "source_frame_indices": np.searchsorted(set_t, t1[:, 2].astype(np.int64)),
              "target_frame_indices": np.searchsorted(set_t, t2[:, 2].astype(np.int64)),
              "t1_points": np.concatenate([t1[:, :2], t1_norm[:, 2:]], 1),
              "t2_points_normalized": t2_norm,
              "target_times": t2[:, 2].copy()}

    p, k = wd.cyc
    set_size = len(set_t)
    src, tgt = rng.integers(0, set_size, p), rng.integers(0, set_size, p)

    def pts(sel):
        xy = rng.random((p, k, 2)) * [w - 1, h - 1]
        return np.concatenate([xy, np.broadcast_to(set_t[sel][:, None, None], (p, k, 1))],
                              2).reshape(-1, 3).astype(np.float32)

    cyc = {"source_points": pts(src), "target_points": pts(tgt),
           "source_frame_indices": np.repeat(src, k),
           "target_frame_indices": np.repeat(tgt, k),
           "dists": (rng.random(p * k) * 4).astype(np.float32),
           "valid": rng.random(p * k) < 0.7}
    n = wd.cl_pairs
    d0 = rng.integers(0, set_size, n)
    dino_pairs = {"source": d0, "target": (d0 + rng.integers(1, set_size, n)) % set_size}
    r0 = rng.integers(0, set_size, n)
    ref_pairs = {"source": r0, "target": (r0 + rng.integers(1, set_size, n)) % set_size}
    return {"params": params, "stats": stats, "video": video, "dino": dino,
            "masks": masks, "fg_trajectories": fg, "bg_trajectories": bg, "bb": bb,
            "sample": sample, "cyc": cyc, "dino_pairs": dino_pairs,
            "ref_pairs": ref_pairs}


def refine_inputs(wd: Widths, seed: int):
    rng = stage_rng(seed, "refine")
    # the head's 3×3 kernels shifted off a near-zero sum (the normalised
    # conv's divisor), as the inference parity tests do
    params, stats = jax_layout_weights(rng, wd.channels, head_shift=0.1)
    video = moving_texture(rng, wd.refine_t, wd.h, wd.w)
    dino = feature_stack(rng, wd.refine_t, wd.channels[-1], wd.feat_hw)
    n = wd.n_queries
    q = np.stack([rng.random(n) * (wd.w - 1), rng.random(n) * (wd.h - 1),
                  np.full(n, wd.query_frame)], -1).astype(np.float32)
    return {"params": params, "stats": stats, "video": video, "dino": dino,
            "queries": q}


def bb_inputs(wd: Widths, seed: int):
    """±1 features: a per-position sign code with a random 20% of each
    frame's signs flipped. Unit rows are ±1/√C (C a power of 4), so every
    cosine is a multiple of 2/C and exact in f32 in any summation order: both
    packages compute the same affinities bit for bit, and their ties are
    exact ones, which the pinned tie rules settle."""
    rng = stage_rng(seed, "bb")
    gh, gw = wd.feat_hw
    code = np.where(rng.random((1, wd.bb_c, gh, gw)) < 0.5, -1.0, 1.0)
    flip = np.where(rng.random((wd.bb_t, wd.bb_c, gh, gw)) < 0.2, -1.0, 1.0)
    return {"features": (code * flip).astype(np.float32),
            "trajectories": _trajectories(rng, wd.bb_traj, wd.bb_t, wd.h, wd.w, 0.9)}


# stage f: the background's motion a frame, the occluder's, the width of the
# bands along the bottom and right edges where the background moves by
# exactly BG_SHIFT (positions land on half-integers and on the frame's last
# row and column exactly), the ramp beside them, the noise blocks' side
BG_SHIFT, OCCLUDER_SHIFT = (1.5, 0.5), (-2.25, 1.25)
TRAJ_BAND, TRAJ_RAMP, TRAJ_BLOCK = 12, 8, 16


def _cell_field(rng, h: int, w: int, cell: int, y_off: float = 0.0,
                x_off: float = 0.0) -> np.ndarray:
    """H×W f64 in [-1, 1]: uniform values on a grid of ``cell``-pixel cells,
    bilinear between them, read at the pixels shifted by (x_off, y_off)."""
    g = rng.random((h // cell + 3, w // cell + 3)) * 2 - 1
    y = (np.arange(h, dtype=np.float64)[:, None] + y_off + cell) / cell
    x = (np.arange(w, dtype=np.float64)[None, :] + x_off + cell) / cell
    y0, x0 = np.floor(y), np.floor(x)
    wy, wx = y - y0, x - x0
    yi, xi = y0.astype(np.int64), x0.astype(np.int64)
    return ((g[yi, xi] * (1 - wx) + g[yi, xi + 1] * wx) * (1 - wy)
            + (g[yi + 1, xi] * (1 - wx) + g[yi + 1, xi + 1] * wx) * wy)


def _blocks(rng, h: int, w: int, shares, block: int = TRAJ_BLOCK):
    """H×W×2 f64: a vector constant on each ``block``-pixel block, of a
    random direction, its length drawn uniformly from the (low, high) of
    ``shares`` [(share, low, high), ...] in those shares of the blocks, 0
    elsewhere."""
    gh, gw = -(-h // block), -(-w // block)
    u = rng.random((gh, gw))
    length = np.zeros((gh, gw))
    edge = 0.0
    for share, low, high in shares:
        pick = (u >= edge) & (u < edge + share)
        length[pick] = low + (high - low) * rng.random(int(pick.sum()))
        edge += share
    d = rng.standard_normal((gh, gw, 2))
    d /= np.sqrt((d * d).sum(-1, keepdims=True))
    v = d * length[..., None]
    return np.repeat(np.repeat(v, block, 0), block, 1)[:h, :w]


def traj_inputs(wd: Widths, seed: int):
    """Stage 1's chaining inputs at T = ``wd.traj_t``: ``fwd`` and ``bwd``
    ((T-1)×2×H×W f32, i→i+1 and i+1→i) and, for every start s, ``direct``
    ((T-1-s)×H×W×2, the flow s→s+1+k in row k) and ``direct_masks``
    ((T-1-s)×H×W). The background moves BG_SHIFT a frame plus a smooth
    perturbation of up to 0.3 px (none in the bands along the bottom and
    right edges, which it crosses); a rectangle moves OCCLUDER_SHIFT, so the
    cycle check fails along its edges. Backward noise: 12% of the 16-pixel
    blocks 1.4-1.6 px (cycle errors at the 1.5 px threshold), 8% 2-4 px.
    Direct flows: the composed motion plus noise, 10% of the blocks 2.3-2.7
    px (at the 2.5 px threshold), 5% 3-5 px; masks uniform in [0, 1] a
    block, so the 0.2 gate is off in a fifth of them."""
    rng = stage_rng(seed, "traj")
    t, h, w = wd.traj_t, wd.h, wd.w
    ys = np.arange(h, dtype=np.float64)[:, None]
    xs = np.arange(w, dtype=np.float64)[None, :]
    # 0 in the bands, 1 beyond the ramps beside them
    window = (np.clip((w - TRAJ_BAND - xs) / TRAJ_RAMP, 0, 1)
              * np.clip((h - TRAJ_BAND - ys) / TRAJ_RAMP, 0, 1))
    bg = np.asarray(BG_SHIFT, np.float64)
    occ = np.asarray(OCCLUDER_SHIFT, np.float64)
    rect = (0.35 * w, 0.3 * h, 0.2 * w, 0.25 * h)  # x, y, width, height at frame 0

    def occluder(i):
        x0, y0 = rect[0] + occ[0] * i, rect[1] + occ[1] * i
        return (xs >= x0) & (xs < x0 + rect[2]) & (ys >= y0) & (ys < y0 + rect[3])

    fwd = np.empty((t - 1, 2, h, w), np.float32)
    bwd = np.empty((t - 1, 2, h, w), np.float32)
    motion = []  # the background's motion i→i+1 at each pixel of frame i, H×W×2
    for i in range(t - 1):
        state = rng.bit_generator.state
        pert = [0.3 * window * _cell_field(rng, h, w, 32) for _ in range(2)]
        rng.bit_generator.state = state  # the same field, read at the preimages
        back = [0.3 * window * _cell_field(rng, h, w, 32, -bg[1], -bg[0]) for _ in range(2)]
        m = np.stack([bg[0] + pert[0], bg[1] + pert[1]], -1)
        f = np.where(occluder(i)[..., None], occ, m)
        noise = window[..., None] * _blocks(rng, h, w, ((0.12, 1.4, 1.6), (0.08, 2.0, 4.0)))
        b = np.stack([-bg[0] - back[0], -bg[1] - back[1]], -1) + noise
        b = np.where(occluder(i + 1)[..., None], -occ, b)
        fwd[i] = f.transpose(2, 0, 1)
        bwd[i] = b.transpose(2, 0, 1)
        motion.append(np.where(occluder(i)[..., None], occ, m))
    direct, direct_masks = [], []
    for s in range(t - 1):
        rows = t - 1 - s
        flows = np.empty((rows, h, w, 2), np.float32)
        total = np.zeros((h, w, 2))
        for k in range(rows):
            total = total + motion[s + k]
            noise = window[..., None] * _blocks(rng, h, w, ((0.10, 2.3, 2.7), (0.05, 3.0, 5.0)))
            flows[k] = total + noise
        blocks = _blocks(rng, h, w, ((1.0, 0.0, 1.0),))
        direct.append(flows)
        direct_masks.append(np.broadcast_to(
            np.sqrt((blocks * blocks).sum(-1)), (rows, h, w)).astype(np.float32))
    return {"fwd": fwd, "bwd": bwd, "direct": direct, "direct_masks": direct_masks}


MAKERS = {"vit": vit_inputs, "raft": raft_inputs, "train": train_inputs,
          "refine": refine_inputs, "bb": bb_inputs, "traj": traj_inputs}


def make(stage: str, wd: Widths, seed: int):
    return MAKERS[stage](wd, seed)


# ---------------------------------------------------------------------------
# what a golden keeps of an output
# ---------------------------------------------------------------------------

def sample_positions(seed: int, what: str, size: int, k: int) -> np.ndarray:
    """``k`` distinct flat indices of ``size``, from the seed and a name."""
    rng = np.random.default_rng([seed, int.from_bytes(what.encode()[:8], "little")])
    return np.sort(rng.choice(size, min(k, size), replace=False))


def record_features(x: np.ndarray, tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """T×D×h×w f32 -> its largest magnitude, per-token L2 norms (T×h·w),
    per-channel means (T×D) and the full D-vectors of the flat ``tokens`` of
    every frame (T×k×D)."""
    t, d = x.shape[:2]
    flat = x.reshape(t, d, -1).astype(np.float64)
    return {"absmax": np.float64(np.abs(flat).max()),
            "token_norm": np.sqrt((flat ** 2).sum(1)).astype(np.float32),
            "chan_mean": flat.mean(2).astype(np.float32),
            "tokens": tokens,
            "token_vals": np.ascontiguousarray(
                flat[:, :, tokens].transpose(0, 2, 1)).astype(np.float32)}


def record_flow(flow: np.ndarray) -> Dict[str, np.ndarray]:
    """N×2×H×W -> max|flow|, the flow at a stride of 4 and the per-row means
    (N×2×H)."""
    return {"absmax": np.float64(np.abs(flow).max()),
            "flow_s4": np.ascontiguousarray(flow[..., ::4, ::4]).astype(np.float32),
            "row_mean": flow.astype(np.float64).mean(-1).astype(np.float32)}


def record_tensor(x: np.ndarray, idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Any array -> its L2 norm, sum, sum of magnitudes, largest magnitude and
    the flat ``idx`` elements."""
    f = x.astype(np.float64).ravel()
    return {"norm": np.float64(np.sqrt((f ** 2).sum())), "sum": np.float64(f.sum()),
            "l1": np.float64(np.abs(f).sum()),
            "absmax": np.float64(np.abs(f).max()) if f.size else np.float64(0),
            "idx": idx, "vals": x.ravel()[idx].astype(np.float32)}


def record_refined(x: np.ndarray, idx: np.ndarray) -> Dict[str, np.ndarray]:
    """The T×h×w×C refined stack -> its largest magnitude, per-frame channel
    means (T×C) and the flat ``idx`` elements."""
    t, c = x.shape[0], x.shape[-1]
    return {"absmax": np.float64(np.abs(x).max()),
            "chan_mean": x.reshape(t, -1, c).astype(np.float64).mean(1).astype(np.float32),
            "idx": idx, "vals": x.ravel()[idx].astype(np.float32)}


def record_bb(source_coords, target_coords, cos_sims, r, valid, h, w,
              stride=7, patch=14) -> Dict[str, np.ndarray]:
    """A BBData -> per-pair valid counts (T×T), and over the valid slots of
    the pairs s < u in slot order: the source and target tokens (int16),
    the cosines in units of 2^-10 (int16; exact for ±1 features) and the
    ambiguity ratios r."""
    gw = 1 + (w - patch) // stride
    tok = lambda xy: (np.rint((xy[..., 1] - patch // 2) / stride) * gw
                      + np.rint((xy[..., 0] - patch // 2) / stride)).astype(np.int16)
    t = valid.shape[0]
    upper = np.triu(np.ones((t, t), bool), 1)[..., None] & valid
    return {"counts": valid.sum(-1).astype(np.int32),
            "source_tok": tok(source_coords[upper]), "target_tok": tok(target_coords[upper]),
            "cos_1024": np.rint(cos_sims[upper] * 1024).astype(np.int16),
            "r": r[upper].astype(np.float32)}


# ---------------------------------------------------------------------------
# stage f: what a golden keeps of the chaining
# ---------------------------------------------------------------------------

# the chaining's settings: PreprocessConfig's defaults
TRAJ_ARGS = {"threshold": 1.5, "direct_flow_threshold": 2.5, "min_trajectory_length": 2}


def traj_row_starts(trajs: np.ndarray) -> np.ndarray:
    """N×T×2 trajectories (start-major, NaN before the start) -> each row's
    start frame (its first finite one)."""
    return np.isfinite(trajs[..., 0]).argmax(1)


def traj_ideal_rows(trajs: np.ndarray, starts: np.ndarray, h: int, w: int) -> np.ndarray:
    """The rows that start in the bands along the bottom and right edges
    (TRAJ_BAND, where every flow is exactly BG_SHIFT) and lie at start +
    BG_SHIFT·k exactly at every frame they live. Where two implementations
    both keep a row ideal, they decide its death (only by leaving the frame)
    and round its half-integer positions alike, bit for bit."""
    n, t, _ = trajs.shape
    rows = np.arange(n)
    p0 = trajs[rows, starts].astype(np.float64)
    band = (p0[:, 0] >= w - TRAJ_BAND) | (p0[:, 1] >= h - TRAJ_BAND)
    k = np.arange(t)[None, :] - starts[:, None]
    ideal = p0[:, None, :] + k[..., None] * np.asarray(BG_SHIFT)
    alive = np.isfinite(trajs[..., 0]) & (k >= 0)
    return band & (~alive | (trajs.astype(np.float64) == ideal).all(-1)).all(1)


def record_traj(trajs: np.ndarray, keep: np.ndarray, h: int, w: int, idx: np.ndarray,
                exact: np.ndarray = None) -> Dict[str, np.ndarray]:
    """One pass of the chaining -> what a golden keeps: per start frame s
    (``keep``: S×H×W, the chaining's keep masks before eligibility and
    occupancy) the keep mask, the kept pixels (its rows' start pixels) and
    those of ``traj_ideal_rows``, bit-packed, the kept count, and per frame
    the rows' NaN count and the float64 sums of their finite coordinates;
    the same counts over the ``exact`` rows alone (by default the ideal
    ones: rows, NaN per frame, half-integer coordinates per frame); the
    total; the full values of rows ``idx`` (NaN past the last row)."""
    n_starts, t = keep.shape[0], trajs.shape[1]
    starts = traj_row_starts(trajs)
    rows = np.arange(len(trajs))
    p0 = trajs[rows, starts].astype(np.int64)
    kept = np.zeros((n_starts, h * w), bool)
    kept[starts, p0[:, 1] * w + p0[:, 0]] = True
    ideal = traj_ideal_rows(trajs, starts, h, w)
    ideal_px = np.zeros((n_starts, h * w), bool)
    ideal_px[starts[ideal], p0[ideal, 1] * w + p0[ideal, 0]] = True
    nan = ~np.isfinite(trajs[..., 0])
    exact = ideal if exact is None else exact
    half = (np.mod(np.nan_to_num(trajs), 1.0) == 0.5).any(-1) & ~nan
    per = lambda x: np.stack([x[starts == s].sum(0) for s in range(n_starts)])
    return {"keep": np.packbits(keep.reshape(n_starts, -1), axis=1),
            "kept": np.packbits(kept, axis=1), "ideal": np.packbits(ideal_px, axis=1),
            "count": np.bincount(starts, minlength=n_starts).astype(np.int64),
            "nan": per(nan).astype(np.int64),
            "sum": per(np.nan_to_num(trajs.astype(np.float64))),
            "exact_count": np.bincount(starts[exact], minlength=n_starts).astype(np.int64),
            "exact_nan": per(nan & exact[:, None]).astype(np.int64),
            "exact_half": per(half & exact[:, None]).astype(np.int64),
            "total": np.int64(len(trajs)), "idx": idx,
            "vals": np.where((idx < len(trajs))[:, None, None],
                             trajs[np.minimum(idx, len(trajs) - 1)], np.nan).astype(np.float32)}


def unpack_masks(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """``record_traj``'s bit-packed S masks -> S×H×W bool."""
    return np.unpackbits(packed, axis=1, count=h * w).astype(bool).reshape(-1, h, w)

