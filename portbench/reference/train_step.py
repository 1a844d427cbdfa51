"""Plain PyTorch reference of DINO-Tracker's test-time train step (paper:
Tumanyan et al., ECCV 2024; the reference code's dino_tracker.py:136-448).

It imports nothing of the measured program and no kernel: a frozen copy of
the step's arithmetic written against plain ``torch`` operations, with the
blurpool as reflect pad plus a depthwise conv. It follows the step from the
same weights, data and generator seed as the program: the sampler's,
the cycle filter's and the contrastive terms' random draws are made from the
generator in the same order and with the same shapes, so both sides draw the
same batch. Every place the configuration's compute dtype applies (conv and
GEMM operands; accumulation, batch-norm statistics, the residual and the head
stay f32) goes through ``Precision.round``: bf16 as the configuration states,
or float8 (e4m3) for the control. Adam is written out.

``train_steps`` runs n steps and returns each step's total loss, the first
step's gradients and the parameters after the n steps.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8
MAX_FRAME_TRIES = 32
TAPS = (1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0)
KERNEL_SIZE = 5
DILATIONS = (1, 1, 1, 2)
DOWNSAMPLE = (True, True, True, False)
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
TERMS = ("loss_of", "loss_cyc", "loss_cl_refiner", "loss_cl_dino_bb", "loss_emb_norm_reg",
         "loss_angle_reg")


class Precision:
    """Where the configuration rounds operands: ``round(x)`` gives the bf16
    tensor the convs and GEMMs take. ``"bfloat16"`` rounds to bf16; the
    control ``"float8_e4m3"`` rounds to float8 (e4m3) first."""

    def __init__(self, operand: str = "bfloat16"):
        if operand not in ("bfloat16", "float8_e4m3"):
            raise ValueError(f"operand precision {operand!r}")
        self.operand = operand

    def round(self, x: torch.Tensor) -> torch.Tensor:
        b = x.to(torch.bfloat16)
        if self.operand == "float8_e4m3":  # values on the float8 grid, gradients straight through
            return b + (x.detach().to(torch.float8_e4m3fn).to(torch.bfloat16) - b).detach()
        return b


class Data(NamedTuple):
    video: torch.Tensor       # T×3×H×W f32
    dino: torch.Tensor        # T×C×h'×w' f16
    masks: torch.Tensor       # T×H×W 0/255
    bb_source_coords: torch.Tensor
    bb_target_coords: torch.Tensor
    bb_cos_sims: torch.Tensor
    bb_r: torch.Tensor
    bb_valid: torch.Tensor
    fg_coords: torch.Tensor   # N×T×2
    fg_valid: torch.Tensor    # N×T bool
    bg_coords: torch.Tensor
    bg_valid: torch.Tensor


def data_from(tensors: Dict[str, torch.Tensor]) -> Data:
    return Data(*(tensors[k] for k in Data._fields))


@contextlib.contextmanager
def no_tf32():
    """f32 convs and GEMMs in f32, not TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---- geometry ------------------------------------------------------------

def _axis_matrix(coords_norm, in_size):
    src = (np.asarray(coords_norm, np.float64) + 1.0) * 0.5 * (in_size - 1)
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    wt = src - lo
    mat = np.zeros((len(src), in_size), np.float32)
    np.add.at(mat, (np.arange(len(src)), lo), 1.0 - wt)
    np.add.at(mat, (np.arange(len(src)), hi), wt)
    return mat


def align_matrices(vit_hw, cnn_hw, patch, stride, cnn_stride, device):
    """Bilinear (align_corners, border) resample of the CNN grid at pixel
    i·cnn_stride onto the ViT patch centres, with the reference code's
    -1/c_br half-texel shift (models/utils.py:7-45)."""
    vh, vw = vit_hw
    ch, cw = cnn_hw
    c_br = [(ch - 1) * cnn_stride, (cw - 1) * cnn_stride]
    vx = np.arange(vw, dtype=np.float64) * stride + patch / 2.0
    vy = np.arange(vh, dtype=np.float64) * stride + patch / 2.0
    gx = -1.0 - (1.0 / c_br[1]) + (2.0 * vx / c_br[1])
    gy = -1.0 - (1.0 / c_br[0]) + (2.0 * vy / c_br[0])
    return (torch.from_numpy(_axis_matrix(gy, ch)).to(device),
            torch.from_numpy(_axis_matrix(gx, cw)).to(device))


def grid_affine(h, w, patch=14, stride=7):
    half = patch / 2.0
    last_h = ((h - patch) // stride) * stride + half
    last_w = ((w - patch) // stride) * stride + half
    return ((2.0 / (last_w - half), 2.0 / (last_h - half)),
            (1.0 - last_w * 2.0 / (last_w - half), 1.0 - last_h * 2.0 / (last_h - half)))


def to_grid(points, h, w, patch=14, stride=7):
    """(x, y, t) pixel points -> feature-grid [-1, 1] x, y; t passes."""
    (aw, ah), (bw, bh) = grid_affine(h, w, patch, stride)
    a = torch.tensor((aw, ah, 1.0), dtype=points.dtype, device=points.device)
    b = torch.tensor((bw, bh, 0.0), dtype=points.dtype, device=points.device)
    return points * a + b


def feature_coords(h, w, stride=7, patch=14, device=None):
    half = patch // 2
    x = torch.arange(half, w - half + 1, stride, dtype=torch.float32, device=device)
    y = torch.arange(half, h - half + 1, stride, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def soft_argmax_grid(h, w, patch=14, step=7, device=None):
    start = patch // 2
    h_end = ((h - 2 * start) // step) * step + start + math.ceil(step / 2)
    w_end = ((w - 2 * start) // step) * step + start + math.ceil(step / 2)
    ys = torch.arange(start, h_end, step, dtype=torch.float32, device=device)
    xs = torch.arange(start, w_end, step, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


# ---- sampling ------------------------------------------------------------

def sample_video(feats_thwc, points, normalize_t=True):
    """Trilinear sample (grid_sample, align_corners, border) of a T×H×W×C
    stack at S (x, y in [-1, 1], t a frame index) points -> S×C."""
    t, h, w, c = feats_thwc.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    if normalize_t:
        if t > 1:
            z = z / (t - 1)
        z = z * 2.0 - 1.0
    un = lambda v, n: (v + 1.0) * 0.5 * (n - 1)
    x = torch.clamp(un(x, w), 0.0, w - 1)
    y = torch.clamp(un(y, h), 0.0, h - 1)
    z = torch.clamp(un(z, t), 0.0, t - 1)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = (x - x0)[:, None], (y - y0)[:, None], (z - z0)[:, None]
    flat = feats_thwc.reshape(t * h * w, c)

    def at(zc, yc, xc):
        i = ((torch.clamp(zc, 0, t - 1).long() * h + torch.clamp(yc, 0, h - 1).long()) * w
             + torch.clamp(xc, 0, w - 1).long())
        return flat.index_select(0, i)

    c00 = at(z0, y0, x0) * (1 - wx) + at(z0, y0, x0 + 1) * wx
    c01 = at(z0, y0 + 1, x0) * (1 - wx) + at(z0, y0 + 1, x0 + 1) * wx
    c10 = at(z0 + 1, y0, x0) * (1 - wx) + at(z0 + 1, y0, x0 + 1) * wx
    c11 = at(z0 + 1, y0 + 1, x0) * (1 - wx) + at(z0 + 1, y0 + 1, x0 + 1) * wx
    return (c00 * (1 - wy) + c01 * wy) * (1 - wz) + (c10 * (1 - wy) + c11 * wy) * wz


def sample_masks(masks_phw, coords_pk2, w, h):
    """Bilinear mask values at pixel coords (align_corners=False, zeros,
    normalised by the size), as the reference code's fg filter samples."""
    scale = torch.tensor((w, h), dtype=coords_pk2.dtype, device=coords_pk2.device)
    grid = 2.0 * (coords_pk2 / scale) - 1.0
    out = F.grid_sample(masks_phw[:, None].float(), grid[:, None].float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, 0, 0]


def gumbel(shape, gen, device):
    return -torch.log(torch.empty(shape, device=device).exponential_(generator=gen))


def masked_topk(gen, mask, k):
    """Up to k distinct indices where ``mask`` holds, uniformly (Gumbel
    top-k): ascending, invalid slots 0 and after the valid ones."""
    n = mask.shape[-1]
    scores = gumbel(mask.shape, gen, mask.device).masked_fill(~mask, -torch.inf)
    top = torch.topk(scores, min(k, n), dim=-1).indices
    valid = torch.gather(mask, -1, top)
    idx = torch.sort(torch.where(valid, top, n), dim=-1).values
    valid = idx < n
    idx = torch.where(valid, idx, 0)
    if k > n:
        pad = (*idx.shape[:-1], k - n)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return idx, valid


# ---- the sampler (reference DinoTrackerSampler) --------------------------

def _eligible(valid, count, frame_idx):
    rows = torch.arange(valid.shape[0], device=valid.device) < count
    vis = valid[:, frame_idx].sum(-1) >= 2
    return vis & rows.reshape(-1, *([1] * (vis.dim() - 1)))


def _sample_bank(gen, coords, valid, count, num_frames, batch):
    n, t = valid.shape
    dev = valid.device
    if batch == 0:
        z = torch.zeros((0, 3), device=dev)
        return z, z
    g = gumbel((MAX_FRAME_TRIES, t), gen, dev)
    tries = torch.topk(g, num_frames, dim=1).indices
    eligible_all = _eligible(valid, count, tries)
    counts = eligible_all.sum(0)
    ok = counts >= 2
    pick = torch.where(ok.any(), torch.argmax(ok.int()), MAX_FRAME_TRIES - 1)[None]
    frame_idx = tries.index_select(0, pick)[0]
    eligible = eligible_all.index_select(1, pick)[:, 0]
    g0 = gumbel((t,), gen, dev).masked_fill(~valid[0], -torch.inf)
    fb_idx = torch.topk(g0, num_frames).indices
    use_fb = counts.index_select(0, pick)[0] == 0
    frame_idx = torch.where(use_fb, fb_idx, frame_idx)
    eligible = torch.where(use_fb, _eligible(valid, count, fb_idx), eligible)
    n_eligible = eligible.sum()
    k = min(batch, n)
    scores = gumbel((n,), gen, dev).masked_fill(~eligible, -torch.inf)
    idx = torch.topk(scores, k).indices
    idx = torch.where(torch.arange(k, device=dev) < n_eligible, idx, idx[0])
    if k < batch:
        idx = idx.repeat(-(-batch // k))[:batch]
    vis = valid[idx][:, frame_idx]
    g = gumbel(vis.shape, gen, dev).masked_fill(~vis, -torch.inf)
    top2 = torch.topk(g, 2, dim=1).indices
    t1, t2 = frame_idx[top2[:, 0]], frame_idx[top2[:, 1]]
    return (torch.cat([coords[idx, t1], t1[:, None].float()], 1),
            torch.cat([coords[idx, t2], t2[:, None].float()], 1))


def _unique_padded(values, size, fill):
    s = torch.sort(values).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1
    out = torch.full((size + 1,), fill, dtype=values.dtype, device=values.device)
    out.scatter_(0, torch.where(first & (pos < size), pos, size), s)
    return out[:size]


class Sample(NamedTuple):
    frames: torch.Tensor   # S absolute frames (padded set)
    src: torch.Tensor      # B indices into the set
    tgt: torch.Tensor      # B
    t1: torch.Tensor       # B×3 (x, y pixel, t normalised)
    t2: torch.Tensor       # B×3 normalised


def sample_batch(gen, d: Data, counts, cfg, t, w, h) -> Sample:
    b, nf = cfg["train_batch_size"], cfg["batch_n_frames"]
    fg_count, bg_count = counts
    if fg_count == 0:
        fg_batch = 0
    elif bg_count == 0:
        fg_batch = b
    else:
        fg_batch = int(b * cfg["fg_traj_ratio"])
    fg = _sample_bank(gen, d.fg_coords, d.fg_valid, fg_count, nf, fg_batch)
    bg = _sample_bank(gen, d.bg_coords, d.bg_valid, bg_count, nf, b - fg_batch)
    p1, p2 = torch.cat([fg[0], bg[0]]), torch.cat([fg[1], bg[1]])
    a1, a2 = p1[:, 2].long(), p2[:, 2].long()
    frames = _unique_padded(torch.cat([a1, a2]), 2 * nf, t)
    src, tgt = torch.searchsorted(frames, a1), torch.searchsorted(frames, a2)
    frames = torch.where(frames >= t, frames[0], frames)
    norm = torch.tensor((w - 1, h - 1, t - 1), dtype=torch.float32, device=p1.device)
    n1, n2 = 2.0 * p1 / norm - 1.0, 2.0 * p2 / norm - 1.0
    return Sample(frames, src, tgt, torch.cat([p1[:, :2], n1[:, 2:3]], 1), n2)


# ---- the model -----------------------------------------------------------

def _conv_nhwc(x_nchw, weight, bias, dilation, padding):
    """A stride-1 conv of a logical NCHW tensor in channels-last memory ->
    NHWC (the layout cuDNN runs without a copy)."""
    y = F.conv2d(x_nchw.contiguous(memory_format=torch.channels_last), weight, bias,
                 dilation=dilation, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def blurpool(x_nhwc):
    """Binomial [1,3,3,1]/8, stride 2, reflect pad (1, 2), in f32, cast back."""
    c = x_nhwc.shape[-1]
    a = torch.tensor(TAPS, dtype=torch.float32, device=x_nhwc.device)
    filt = (a[:, None] * a[None, :]).expand(c, 1, 4, 4).contiguous()
    x = F.pad(x_nhwc.permute(0, 3, 1, 2).float(), (1, 2, 1, 2), mode="reflect")
    return F.conv2d(x, filt, stride=2, groups=c).permute(0, 2, 3, 1).contiguous().to(x_nhwc.dtype)


def batchnorm(x, weight, bias, eps=1e-5):
    """Train-mode BN over N, H, W of an NHWC tensor, statistics in f32
    (one-pass variance), cast back."""
    xf = x.float()
    mean = xf.mean(dim=(0, 1, 2))
    var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
    return ((x.float() - mean) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def delta_dino(p, frames_nchw, vit_hw, prec: Precision, n_layers, patch=14, stride=7):
    """DeltaDINO's residual on the ViT grid, channels-last f32."""
    x = frames_nchw.permute(0, 2, 3, 1)
    for i in range(n_layers):
        pre = f"delta_dino.layers.{i}"
        dil = DILATIONS[i]
        pad = (KERNEL_SIZE + (KERNEL_SIZE - 1) * (dil - 1)) // 2
        xin = F.pad(prec.round(x).permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
        y = _conv_nhwc(xin, prec.round(p[f"{pre}.conv.weight"]),
                       prec.round(p[f"{pre}.conv.bias"].detach()), dil, 0)
        x = batchnorm(y, p[f"{pre}.bn.weight"], p[f"{pre}.bn.bias"])
        if i < n_layers - 1:
            x = torch.relu(x)
        if DOWNSAMPLE[i]:
            x = blurpool(x)
    wy, wx = align_matrices(vit_hw, x.shape[1:3], patch, stride, 2 ** sum(DOWNSAMPLE[:n_layers]),
                            x.device)
    out = torch.einsum("oh,nhwc->nowc", wy, x.float())
    return torch.einsum("pw,nowc->nopc", wx, out)


def _norm_conv(x_nhwc, weight, bias):
    """A conv whose weights are divided by their per-(out, in) spatial sum,
    sign-guarded to ±1e-8 (the reference code's conv_norm.py:34-46)."""
    s = weight.sum(dim=(2, 3), keepdim=True)
    s = torch.where(s.abs() < EPS, torch.where(s >= 0, EPS, -EPS), s)
    return _conv_nhwc(x_nhwc.permute(0, 3, 1, 2), weight / s, bias, 1, weight.shape[-1] // 2)


def head(p, maps_b1hw, h, w, patch=14, stride=7, radius=35.0):
    """The tracker head: two sum-normalised 3x3 convs, softmax, soft-argmax
    in a radius around the raw map's first maximum -> B×2 in (-1, 1)."""
    b, _, hp, wp = maps_b1hw.shape
    am = torch.argmax(maps_b1hw.flatten(1), dim=1)
    row, col = am // wp, am % wp
    x = torch.relu(_norm_conv(maps_b1hw.permute(0, 2, 3, 1), p["tracker_head.conv1.weight"],
                              p["tracker_head.conv1.bias"]))
    x = _norm_conv(x, p["tracker_head.conv2.weight"], p["tracker_head.conv2.bias"])
    hm = torch.softmax(x.reshape(b, hp * wp), dim=-1).reshape(b, hp, wp)
    grid = soft_argmax_grid(h, w, patch, stride, device=maps_b1hw.device)
    start = patch // 2
    centre = torch.stack([col * stride + start, row * stride + start], dim=-1).float()
    mask = (((grid[None] - centre[:, None, None]) ** 2).sum(-1) <= radius ** 2).to(hm.dtype)
    hm = hm * mask
    total = hm.sum(dim=(1, 2))
    uniform = mask / torch.clamp(mask.sum(dim=(1, 2)), min=1.0)[:, None, None]
    zero = total < 1e-8
    hm = torch.where(zero[:, None, None], uniform, hm)
    total = torch.where(zero, uniform.sum(dim=(1, 2)), total)
    point = (grid[None] * hm[..., None]).sum(dim=(1, 2)) / total[:, None]
    scale = 2.0 / (torch.tensor((w, h), dtype=torch.float32, device=point.device) - 1.0)
    return point * scale.to(point.dtype) + (-1.0)


# ---- the losses ----------------------------------------------------------

def huber(pred, target, delta=1.0 / 32.0):
    d = pred - target
    a = d.abs()
    return torch.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))


class View(NamedTuple):
    flat: torch.Tensor    # N×hw×C, operand-rounded values held in f32
    norms: torch.Tensor   # N×hw f32


def _source_points(points_b3, frame_idx, h, w):
    pts = to_grid(points_b3, h, w)
    return torch.cat([pts[:, :2], frame_idx[:, None].to(pts.dtype)], dim=1)


def predict_flat(p, emb, view, points, src_idx, tgt_idx, prec, h, w):
    src = sample_video(emb, _source_points(points, src_idx, h, w))
    n, k, c = view.flat.shape
    b = src.shape[0]
    corr_all = (prec.round(src).float() @ view.flat.reshape(n * k, c).T).reshape(-1, n, k)
    tgt = tgt_idx.long()
    corr = corr_all[torch.arange(b, device=tgt.device), tgt]
    corr = corr / torch.clamp(torch.linalg.vector_norm(src, dim=1)[:, None] * view.norms[tgt],
                              min=EPS)
    return head(p, torch.relu(corr.reshape(b, 1, *emb.shape[1:3])), h, w)


def predict_grouped(p, emb, view, points_gp3, src_g, tgt_g, prec, h, w):
    g, q, _ = points_gp3.shape
    _, fh, fw, c = emb.shape
    pts = _source_points(points_gp3.reshape(g * q, 3), src_g.repeat_interleave(q), h, w)
    src = sample_video(emb, pts).reshape(g, q, c)
    tgt = tgt_g.long()
    corr = prec.round(src).float() @ view.flat[tgt].transpose(1, 2)
    corr = corr / torch.clamp(torch.linalg.vector_norm(src, dim=2)[..., None]
                              * view.norms[tgt][:, None, :], min=EPS)
    return head(p, torch.relu(corr).reshape(g * q, 1, fh, fw), h, w).reshape(g, q, 2)


def cycle_loss(gen, p, emb, view, frames, masks, cfg, prec, h, w):
    """Cycle consistency: random fg/bg points tracked there and back under
    no_grad, those back within the threshold re-predicted with gradients."""
    n_pairs, k = cfg["cyc_n_frames"], cfg["cyc_batch_size_per_frame"]
    set_size, dev, mw = frames.shape[0], frames.device, masks.shape[-1]
    n_fg = int(k * cfg["cyc_fg_points_ratio"])
    src_sel = torch.randint(0, set_size, (n_pairs,), generator=gen, device=dev)
    tgt_sel = torch.randint(0, set_size, (n_pairs,), generator=gen, device=dev)
    fg = (masks[frames[src_sel]] > 0).reshape(n_pairs, -1)
    i_fg, v_fg = masked_topk(gen, fg, n_fg)
    i_bg, v_bg = masked_topk(gen, ~fg, k - n_fg)
    idx = torch.cat([i_fg, i_bg], 1)
    coords = torch.stack([(idx % mw).float(), (idx // mw).float()], -1)
    valid = torch.cat([v_fg, v_bg], 1)
    scale = torch.tensor((w - 1, h - 1), dtype=torch.float32, device=dev)
    with_t = lambda xy, sel: torch.cat(
        [xy, frames[sel].float()[:, None, None].expand(n_pairs, k, 1)], 2)
    with torch.no_grad():
        pred = lambda pts, s, t: (predict_grouped(p, emb, view, pts, s, t, prec, h, w)
                                  + 1.0) * 0.5 * scale
        sp = with_t(coords, src_sel)
        tp = with_t(pred(sp, src_sel, tgt_sel), tgt_sel)
        back = pred(tp, tgt_sel, src_sel)
        dists = torch.linalg.vector_norm(coords - back, dim=2).reshape(-1)
        keep = valid.reshape(-1) & (dists <= cfg["cyc_thresh"])
    both = predict_grouped(p, emb, view, torch.cat([sp, tp]), torch.cat([src_sel, tgt_sel]),
                           torch.cat([tgt_sel, src_sel]), prec, h, w).reshape(-1, 2)
    q = n_pairs * k
    st, ts = both[:q], both[q:]
    sp, tp = sp.reshape(-1, 3), tp.reshape(-1, 3)
    weight = (cfg["cyc_gamma"] ** dists) * keep
    count = keep.sum()
    n = torch.clamp(count, min=1)
    l_st = (weight[:, None] * huber(st, 2.0 * tp[:, :2] / scale - 1.0)).sum() / (2 * n)
    l_ts = (weight[:, None] * huber(ts, 2.0 * sp[:, :2] / scale - 1.0)).sum() / (2 * n)
    return torch.where(count > 0, (l_st + l_ts) / 2.0, 0.0)


def _infonce(src_f, tgt_f, src_flat, tgt_flat, src_norms, tgt_norms, temp, prec):
    pos = (src_f * tgt_f).sum(-1)
    st = prec.round(src_f).float() @ tgt_flat.transpose(-1, -2)
    ts = prec.round(tgt_f).float() @ src_flat.transpose(-1, -2)
    sn, tn = torch.linalg.vector_norm(src_f, dim=-1), torch.linalg.vector_norm(tgt_f, dim=-1)
    st = st / torch.clamp(sn[..., :, None] * tgt_norms[..., None, :], min=EPS)
    ts = ts / torch.clamp(tn[..., :, None] * src_norms[..., None, :], min=EPS)
    pos = pos / torch.clamp(sn * tn, min=EPS)
    return (torch.logsumexp(st / temp, dim=-1) - pos / temp,
            torch.logsumexp(ts / temp, dim=-1) - pos / temp)


def _pairs(gen, set_size, n_pairs, dev, distinct):
    src = torch.randint(0, set_size, (n_pairs,), generator=gen, device=dev)
    if distinct:
        off = torch.randint(1, set_size, (n_pairs,), generator=gen, device=dev)
        return src, (src + off) % set_size
    return src, torch.randint(0, set_size, (n_pairs,), generator=gen, device=dev)


def _fg_bg(gen, candidates, fg, n_fg, n_bg):
    i_fg, v_fg = masked_topk(gen, candidates & fg, n_fg)
    i_bg, v_bg = masked_topk(gen, candidates & ~fg, n_bg)
    return torch.cat([i_fg, i_bg], 1), torch.cat([v_fg, v_bg], 1)


def _sample_at(emb, xy, set_idx, h, w):
    pts = torch.cat([xy, set_idx[:, None].to(xy.dtype)], 1)
    return sample_video(emb, to_grid(pts, h, w))


def refined_bb_loss(gen, emb, view, frames, masks, cfg, prec, h, w):
    """InfoNCE over best buddies mined on the refined features (mutual
    nearest neighbours of the cosine affinity), weighted by 2·cos³."""
    s, fh, fw, c = emb.shape
    n = fh * fw
    k = cfg["cl_points_per_pair"]
    n_fg = int(k * cfg["cl_fg_points_ratio"])
    dev = emb.device
    src_sel, tgt_sel = _pairs(gen, frames.shape[0], cfg["cl_n_frames"], dev, False)
    n_pairs = src_sel.shape[0]
    with torch.no_grad():
        norms = view.norms.detach()
        unit = (prec.round(view.flat.detach())
                / prec.round(torch.clamp(norms, min=EPS))[..., None]).float()
        if prec.operand != "bfloat16":
            unit = prec.round(unit).float()
        aff = unit[src_sel] @ unit[tgt_sel].transpose(1, 2)
        src_max = torch.argmax(aff, dim=-1)
        tgt_max = torch.argmax(aff, dim=-2)
        del aff
        is_bb = torch.arange(n, device=dev) == torch.gather(tgt_max, -1, src_max)
        grid = feature_coords(h, w, device=dev)
        fg = sample_masks(masks[frames[src_sel]], grid.expand(n_pairs, -1, -1), w, h) > 0
        sel_src, sel_valid = _fg_bg(gen, is_bb, fg, n_fg, k - n_fg)
        sel_tgt = torch.gather(src_max, 1, sel_src)
    flat = emb.reshape(s * n, c)
    kk = sel_src.shape[1]
    src_f = flat[(src_sel[:, None] * n + sel_src).reshape(-1)].reshape(n_pairs, kk, c)
    tgt_f = flat[(tgt_sel[:, None] * n + sel_tgt).reshape(-1)].reshape(n_pairs, kk, c)
    l1, l2 = _infonce(src_f, tgt_f, view.flat[src_sel], view.flat[tgt_sel],
                      view.norms[src_sel], view.norms[tgt_sel], cfg["cl_temp"], prec)
    with torch.no_grad():
        cos = (src_f * tgt_f).sum(-1) / torch.clamp(
            torch.gather(norms[src_sel], 1, sel_src) * torch.gather(norms[tgt_sel], 1, sel_tgt),
            min=EPS)
        wt = torch.clamp(2.0 * cos ** 3, min=0.0) * sel_valid
    return ((l1 + l2) * wt).sum() / (2.0 * cfg["cl_div_ref_bb"])


def dino_bb_loss(gen, emb, view, frames, d: Data, cfg, prec, h, w):
    """InfoNCE over the precomputed DINO best buddies, weighted by the
    ambiguity sigmoid and 2·cos³."""
    k = cfg["cl_points_per_pair"]
    n_fg = int(k * cfg["cl_fg_points_ratio"])
    src_sel, tgt_sel = _pairs(gen, frames.shape[0], cfg["cl_n_frames"], emb.device, True)
    n_pairs = src_sel.shape[0]
    sf, tf = frames[src_sel], frames[tgt_sel]
    sxy_all, txy_all = d.bb_source_coords[sf, tf], d.bb_target_coords[sf, tf]
    fg = sample_masks(d.masks[sf], sxy_all, w, h) > 0
    sel, sel_valid = _fg_bg(gen, d.bb_valid[sf, tf], fg, n_fg, k - n_fg)
    r = torch.gather(d.bb_r[sf, tf], 1, sel)
    cos = torch.gather(d.bb_cos_sims[sf, tf], 1, sel)
    wt = (torch.sigmoid(cfg["bb_amb_sig_a"] * (1.0 - r) + cfg["bb_amb_sig_b"])
          * torch.clamp(2.0 * cos ** 3, min=0.0) * sel_valid)
    sxy = torch.gather(sxy_all, 1, sel[..., None].expand(-1, -1, 2))
    txy = torch.gather(txy_all, 1, sel[..., None].expand(-1, -1, 2))
    kk = sel.shape[1]
    src_f = _sample_at(emb, sxy.reshape(-1, 2), src_sel.repeat_interleave(kk), h, w)
    tgt_f = _sample_at(emb, txy.reshape(-1, 2), tgt_sel.repeat_interleave(kk), h, w)
    c = src_f.shape[-1]
    l1, l2 = _infonce(src_f.reshape(n_pairs, kk, c), tgt_f.reshape(n_pairs, kk, c),
                      view.flat[src_sel], view.flat[tgt_sel], view.norms[src_sel],
                      view.norms[tgt_sel], cfg["cl_temp"], prec)
    return ((l1 + l2) * wt).sum() / cfg["cl_div_dino_bb"] / 2.0


def step_loss(p, d: Data, gen, counts, cfg, prec, use_cyc, use_cl_ref, half_batch=False,
              terms=None):
    """The step's total loss (the reference code's six terms) on a freshly
    sampled batch. ``half_batch``: a planted fault, the flow term's mean
    taken over every other row of the batch alone. ``terms``, a dict, gets
    each term unweighted, under the program's metric names."""
    t, _, h, w = d.video.shape
    smp = sample_batch(gen, d, counts, cfg, t, w, h)
    if half_batch:
        smp = Sample(smp.frames, *(x[::2] for x in smp[1:]))
    raw = d.dino.index_select(0, smp.frames).float().permute(0, 2, 3, 1)
    n_layers = sum(1 for k in p if k.endswith(".conv.weight") and k.startswith("delta_dino"))
    emb = raw + delta_dino(p, d.video.index_select(0, smp.frames), raw.shape[1:3], prec, n_layers)
    n, fh, fw, c = emb.shape
    flat = emb.reshape(n, fh * fw, c)
    view = View(prec.round(flat).float(), torch.linalg.vector_norm(flat, dim=2))
    coords = predict_flat(p, emb, view, smp.t1, smp.src, smp.tgt, prec, h, w)
    labels = smp.t2[:, :2]
    l_of = huber(coords, labels).sum() / labels.numel()
    l_cyc = l_ref = torch.zeros((), device=l_of.device)
    if use_cyc:
        l_cyc = cycle_loss(gen, p, emb, view, smp.frames, d.masks, cfg, prec, h, w)
    if use_cl_ref:
        l_ref = refined_bb_loss(gen, emb, view, smp.frames, d.masks, cfg, prec, h, w)
    l_dino = dino_bb_loss(gen, emb, view, smp.frames, d, cfg, prec, h, w)
    rn = torch.linalg.vector_norm(emb, dim=-1)
    dn = torch.linalg.vector_norm(raw, dim=-1)
    l_norm = (rn / dn - 1.0).abs().mean()
    l_angle = ((emb * raw).sum(-1) / (rn * dn) - 1.0).abs().mean()
    if terms is not None:
        terms.update({k: float(v.detach()) for k, v in zip(TERMS, (
            l_of, l_cyc, l_ref, l_dino, l_norm, l_angle))})
    total = l_of
    if use_cyc:
        total = total + cfg["lambda_cyc"] * l_cyc
    if use_cl_ref:
        total = total + cfg["lambda_cl_ref_bb"] * l_ref
    return (total + cfg["lambda_cl_dino_bb"] * l_dino + cfg["lambda_emb_norm"] * l_norm
            + cfg["lambda_angle"] * l_angle)


def lr_at(base, gamma, every, count, device):
    """The scheduled rate of the ``count``-th update, in f32 on the device."""
    g = torch.full((), gamma, dtype=torch.float32, device=device)
    return base * torch.pow(g, count // every)


def train_steps(weights: Dict[str, torch.Tensor], tensors: Dict[str, torch.Tensor],
                counts, cfg: dict, seed_generator: torch.Generator, use_cyc: bool,
                use_cl_ref: bool, n_steps: int = 3, start: int = 0,
                precision: str = "bfloat16", half_batch: bool = False) -> dict:
    """``n_steps`` steps with Adam from ``weights`` (a state dict; parameters
    are every entry but BN's running statistics), drawing from
    ``seed_generator``. ``start`` is the schedule's update count at the
    first step. Returns {"losses": [float], "terms": [{term: float}] (each
    step's terms, unweighted), "first_grads": {name: tensor or None},
    "params": {name: tensor}}."""
    prec = Precision(precision)
    d = data_from(tensors)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
         if not k.endswith(("running_mean", "running_var"))}
    names = list(p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    steps = {k: 0 for k in p}
    losses: List[float] = []
    terms: List[Dict[str, float]] = []
    first: Optional[Dict[str, Optional[torch.Tensor]]] = None
    with no_tf32():
        for i in range(n_steps):
            terms.append({})
            total = step_loss(p, d, seed_generator, counts, cfg, prec, use_cyc, use_cl_ref,
                              half_batch, terms[-1])
            grads = torch.autograd.grad(total, [p[k] for k in names], allow_unused=True)
            losses.append(float(total.detach()))
            if first is None:
                first = {k: (None if g is None else g.detach().clone())
                         for k, g in zip(names, grads)}
            lr_dd = lr_at(cfg["lr_delta_dino"], cfg["scheduler_gamma"],
                          cfg["apply_scheduler_every"], start + i, total.device)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    if g is None:
                        continue
                    lr = lr_dd if k.startswith("delta_dino") else cfg["lr_cnn_refiner"]
                    steps[k] += 1
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    bc1 = 1 - BETAS[0] ** steps[k]
                    bc2 = 1 - BETAS[1] ** steps[k]
                    denom = v2[k].sqrt() / math.sqrt(bc2) + ADAM_EPS
                    p[k].sub_(lr * m[k] / denom / bc1)
    return {"losses": losses, "terms": terms, "first_grads": first,
            "params": {k: v.detach() for k, v in p.items()}}
