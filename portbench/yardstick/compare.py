"""The numbers that decide ``correct``, and their judgement against limits
(``judge``). A preprocessing cell compares one video's artifacts with the
plain reference's (``preprocess_readings``). A training cell compares the
program's first steps with the plain reference's, from the same weights,
data and seed (``train_readings``):

* ``loss``: the largest gap of a step's total loss, as a share of the
  reference's;
* ``grad``: the first gradient, leaf by leaf: the gap between the
  program's norm of the leaf (read from Adam's state after one step) and
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf;
* ``change``: the same for each leaf's change over the checked steps;
  ``change_median``: the median leaf's gap of the change (the worst leaf's
  swings with the noise of one small leaf: Adam turns the rounding of a
  near-zero gradient into a step of ±lr).

Leaves whose reference gradient is under NULL_GRAD_SHARE of the median
leaf's are nought to rounding (Adam moves them by round-off alone) and are
left out of both leaf numbers by that rule, not by name. A leaf the
reference never moves (no gradient at all) that the program moved reads 1.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NULL_GRAD_SHARE = 1e-3


def _norm(t) -> float:
    import torch
    return float(torch.linalg.vector_norm(t.detach().double()))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)


def train_readings(program: dict, ref: dict, initial: dict) -> dict:
    """``program`` and ``ref`` each hold ``losses`` (one a step), optionally
    ``terms`` (each step's loss terms, read only to say where a gap lies),
    ``first_grads`` ({leaf: tensor or None}) and ``params`` ({leaf: tensor}
    after the steps); ``initial`` the leaves before them."""
    losses = [_rel(p, r) for p, r in zip(program["losses"], ref["losses"])]
    if len(program["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    ref_g = {k: _norm(g) for k, g in ref["first_grads"].items() if g is not None}
    med_g = statistics.median(ref_g.values())
    kept = [k for k, n in ref_g.items() if n >= NULL_GRAD_SHARE * med_g]
    grads = {}
    for k in kept:
        g = program["first_grads"].get(k)
        grads[k] = abs((_norm(g) if g is not None else 0.0) - ref_g[k]) / max(ref_g[k], med_g)
    ref_c = {k: _norm(ref["params"][k] - initial[k]) for k in kept}
    med_c = statistics.median(ref_c.values())
    changes = {k: abs(_norm(program["params"][k] - initial[k]) - ref_c[k]) / max(ref_c[k], med_c)
               for k in kept}
    for k, g in ref["first_grads"].items():
        if g is None and _norm(program["params"][k] - initial[k]) > 0:
            changes[k] = 1.0
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])
    step = max(range(len(losses)), key=lambda i: losses[i])
    leaf_g, leaf_c = worst(grads), worst(changes)
    where = {"loss": f"step {step + 1}", "grad": leaf_g[0], "change": leaf_c[0],
             "left_out": sorted(set(ref_g) - set(kept)), "step_loss": losses}
    if "terms" in program and "terms" in ref:  # each step's terms' gaps, to find a loss gap's term
        where["step_terms"] = [{k: _rel(p[k], r[k]) for k in r if k in p}
                               for p, r in zip(program["terms"], ref["terms"])]
    return {"loss": losses[step], "grad": leaf_g[1], "change": leaf_c[1],
            "change_median": statistics.median(changes.values()), "where": where}


def judge(readings: dict, limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every reading finite and within its limit, [(name, reading, limit)])."""
    rows = [(k, float(readings[k]), float(v)) for k, v in limits.items()]
    return all(math.isfinite(r) and r <= lim for _, r, lim in rows), rows


# ---- preprocessing: one video's artifacts ----------------------------------

PREPROCESS_FILES = {
    "trajectories": ("of_trajectories/trajectories.npz", "trajectories"),
    "unfiltered": ("of_trajectories/trajectories_wo_direct_filter.npz", "trajectories"),
    "fg": ("of_trajectories/fg_trajectories.npz", "trajectories"),
    "bg": ("of_trajectories/bg_trajectories.npz", "trajectories"),
    "features": ("dino_embeddings/dino_embed_video.npz", "features"),
    "mask_features": ("dino_embeddings/dino_embed_video-layer=23.npz", "features"),
}
BB_FILE = "dino_best_buddies/dino_best_buddies_filtered.npz"
BB_KEYS = ("source_coords", "target_coords", "cos_sims", "r", "valid")


def read_preprocess_artifacts(path: str) -> dict:
    """The artifacts the preprocessing of one video left under ``path`` (the
    per-video layout of DINO-Tracker's data path), as numpy arrays."""
    import os

    import numpy as np
    from PIL import Image
    out = {}
    for name, (rel, key) in PREPROCESS_FILES.items():
        with np.load(os.path.join(path, rel)) as f:
            out[name] = np.asarray(f[key])
    masks = sorted(f for f in os.listdir(os.path.join(path, "masks")) if f.endswith(".jpg"))
    out["masks"] = np.stack([np.asarray(Image.open(os.path.join(path, "masks", f)).convert("L"),
                                        dtype=np.float32) for f in masks])
    with np.load(os.path.join(path, BB_FILE)) as f:
        out["bb"] = {k: np.asarray(f[k]) for k in BB_KEYS}
    return out


def _traj_keys(trajs, h, w):
    """Each trajectory's (first frame, start pixel) as one integer."""
    import numpy as np
    valid = ~np.isnan(trajs).any(-1)
    start = np.argmax(valid, axis=1)
    xy = np.round(trajs[np.arange(len(trajs)), start]).astype(np.int64)
    return (start * h + xy[:, 1]) * w + xy[:, 0], valid


def trajectory_gaps(prog, ref, h, w):
    """(share of the reference's trajectories that the program lacks, adds,
    or keeps alive on other frames; the largest position gap in px at frames
    both keep)."""
    import numpy as np
    kp, vp = _traj_keys(prog, h, w)
    kr, vr = _traj_keys(ref, h, w)
    common, ip, ir = np.intersect1d(kp, kr, assume_unique=True, return_indices=True)
    differ = len(kp) + len(kr) - 2 * len(common) + np.count_nonzero((vp[ip] != vr[ir]).any(1))
    both = vp[ip] & vr[ir]
    gap = float(np.abs(prog[ip] - ref[ir])[both].max()) if both.any() else 0.0
    return differ / max(len(kr), 1), gap


def _token_cos_gap(a, b):
    """1 − the least per-token cosine of two T×D×h×w feature stacks."""
    import torch
    x = torch.as_tensor(a).float().flatten(2)
    y = torch.as_tensor(b).float().flatten(2)
    return float(1.0 - torch.nn.functional.cosine_similarity(x, y, dim=1).min())


def _program_buddies(bb, stride=7, patch=14, grid_w=None):
    """{(s, u, source token, target token): r} of the artifact's valid slots."""
    import numpy as np
    half = patch // 2
    out = {}
    s_idx, u_idx, slot = np.nonzero(bb["valid"])
    src = np.round((bb["source_coords"][s_idx, u_idx, slot] - half) / stride).astype(np.int64)
    tgt = np.round((bb["target_coords"][s_idx, u_idx, slot] - half) / stride).astype(np.int64)
    r = bb["r"][s_idx, u_idx, slot]
    for s, u, a, b, rr in zip(s_idx, u_idx, src[:, 1] * grid_w + src[:, 0],
                              tgt[:, 1] * grid_w + tgt[:, 0], r):
        if s != u:
            out[(int(s), int(u), int(a), int(b))] = float(rr)
    return out


def preprocess_readings(prog: dict, ref: dict, stride: int = 7, patch: int = 14) -> dict:
    """The numbers of one video: ``traj`` and ``traj_px`` (the worse of the
    two passes), ``feat`` (the worse of the two layers), ``mask`` (share of
    mask pixels that differ, as the masks folder serves them), ``split``
    (share of trajectories on the other side of the split, or on one side
    only), ``bb`` (share of best-buddy pairs that differ) and ``bb_r`` (the
    99th percentile of the ambiguity gap over the pairs both hold)."""
    import numpy as np
    t, h, w = ref["masks"].shape
    gaps = [trajectory_gaps(prog[k], ref[k], h, w) for k in ("trajectories", "unfiltered")]
    feat = max(_token_cos_gap(prog[k], ref[k]) for k in ("features", "mask_features"))
    mask = float(np.mean((prog["masks"] > 0) != (ref["masks"] > 0)))
    fg_p, _ = _traj_keys(prog["fg"], h, w)
    fg_r, _ = _traj_keys(ref["fg"], h, w)
    split = len(np.setxor1d(fg_p, fg_r)) / max(len(ref["fg"]) + len(ref["bg"]), 1)
    gw = ref["features"].shape[-1]
    pb = _program_buddies(prog["bb"], stride, patch, gw)
    rb = {}
    for (s, u), d in ref["bb"].items():
        for a, b, rr in zip(d["src"].tolist(), d["tgt"].tolist(), d["r"].tolist()):
            rb[(s, u, a, b)] = rr
    common = pb.keys() & rb.keys()
    # a video with no buddy on either side reads 0: it has nothing to differ in
    bb = (len(pb) + len(rb) - 2 * len(common)) / max(len(rb), 1)
    dr = np.array([abs(pb[k] - rb[k]) for k in common]) if common else np.zeros(1)
    return {"traj": max(g[0] for g in gaps), "traj_px": max(g[1] for g in gaps), "feat": feat,
            "mask": mask, "split": split, "bb": bb, "bb_r": float(np.quantile(dr, 0.99)),
            "where": {"trajectories": [len(prog["trajectories"]), len(ref["trajectories"])],
                      "unfiltered": [len(prog["unfiltered"]), len(ref["unfiltered"])],
                      "fg": [len(prog["fg"]), len(ref["fg"])],
                      "buddies": [len(pb), len(rb)]}}
