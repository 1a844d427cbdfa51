"""Plain PyTorch and NumPy reference of DINO-Tracker's preprocessing of one
video (the reference code's preprocessing/ scripts; Tumanyan et al., ECCV
2024): RAFT flows and their chained trajectories in two passes, with and
without the direct-flow filter; DINOv2 ViT features of layers 15 and 23;
foreground masks from the layer-23 PCA, written and read back as JPEG
frames; the fg/bg split; the best buddies with the optical-flow filter and
the NMS ambiguity.

It imports nothing of the measured program and no kernel: RAFT's
correlation lookup is a gather plus the bilinear combine, attention is a
softmax of the full logits (a frame and a few heads at a time), the
look-behind occupancy is NumPy. ``Precision`` states the two precisions of
the configuration: the ViT's operands in bf16 (f32 accumulation, f32
residual, LayerNorm and GELU) and RAFT in f32 with TF32 off; the control
lowers each by one step (float8 e4m3 operands for the ViT, TF32 for RAFT).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

HDIM = CDIM = 128
CORR_LEVELS, CORR_RADIUS = 4, 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Precision(NamedTuple):
    vit: str = "bfloat16"    # or "float8_e4m3" (the control)
    raft: str = "float32"    # or "tf32" (the control)

    def vit_round(self, x: torch.Tensor) -> torch.Tensor:
        """A ViT operand in bf16 (on the float8 grid for the control)."""
        if self.vit == "float8_e4m3":
            return x.to(torch.float8_e4m3fn).to(torch.bfloat16)
        return x.to(torch.bfloat16)


@contextlib.contextmanager
def tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---- RAFT-large (princeton-vl/RAFT, its parameter names) ------------------

def _instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _batch_norm(x, bn, eps=1e-5):
    c = lambda t: t[None, :, None, None]
    return (x - c(bn.running_mean)) * torch.rsqrt(c(bn.running_var) + eps) * c(bn.weight) + c(bn.bias)


def _norm(x, module, kind):
    return _instance_norm(x) if kind == "instance" else _batch_norm(x, module)


class _Residual(nn.Module):
    def __init__(self, cin, cout, norm, stride):
        super().__init__()
        self.kind = norm
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if norm == "batch":
            self.norm1, self.norm2 = nn.BatchNorm2d(cout), nn.BatchNorm2d(cout)
        self.downsample = None
        if stride > 1 or cin != cout:
            layers = [nn.Conv2d(cin, cout, 1, stride=stride)]
            if norm == "batch":
                layers.append(nn.BatchNorm2d(cout))
            self.downsample = nn.Sequential(*layers)

    def forward(self, x):
        y = F.relu(_norm(self.conv1(x), getattr(self, "norm1", None), self.kind))
        y = F.relu(_norm(self.conv2(y), getattr(self, "norm2", None), self.kind))
        if self.downsample is not None:
            ds = self.downsample
            x = _norm(ds[0](x), ds[1] if len(ds) > 1 else None, self.kind)
        return F.relu(x + y)


class _Encoder(nn.Module):
    def __init__(self, norm, out_dim):
        super().__init__()
        self.kind = norm
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        if norm == "batch":
            self.norm1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(_Residual(64, 64, norm, 1), _Residual(64, 64, norm, 1))
        self.layer2 = nn.Sequential(_Residual(64, 96, norm, 2), _Residual(96, 96, norm, 1))
        self.layer3 = nn.Sequential(_Residual(96, 128, norm, 2), _Residual(128, 128, norm, 1))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = F.relu(_norm(self.conv1(x), getattr(self, "norm1", None), self.kind))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class _Motion(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        # the 126-output conv as 128 outputs with two zero filters, cut back
        # (exact): cuDNN's f32 choice at 126 outputs is an FFT many times slower
        w = F.pad(self.conv.weight, (0, 0, 0, 0, 0, 0, 0, 2))
        x = F.conv2d(torch.cat([cor, flo], dim=1), w, F.pad(self.conv.bias, (0, 2)), padding=1)
        return torch.cat([F.relu(x[:, :126]), flow], dim=1)


class _GRU(nn.Module):
    def __init__(self, hidden=HDIM, inp=256):
        super().__init__()
        for n in ("convz1", "convr1", "convq1"):
            setattr(self, n, nn.Conv2d(hidden + inp, hidden, (1, 5), padding=(0, 2)))
        for n in ("convz2", "convr2", "convq2"):
            setattr(self, n, nn.Conv2d(hidden + inp, hidden, (5, 1), padding=(2, 0)))

    def forward(self, h, x):
        for zc, rc, qc in ((self.convz1, self.convr1, self.convq1),
                           (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z, r = torch.sigmoid(zc(hx)), torch.sigmoid(rc(hx))
            h = (1 - z) * h + z * torch.tanh(qc(torch.cat([r * h, x], dim=1)))
        return h


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HDIM, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class _Update(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder, self.gru, self.flow_head = _Motion(), _GRU(), _Head()
        self.mask = nn.Sequential(nn.Conv2d(HDIM, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))


class RAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = _Encoder("instance", 256)
        self.cnet = _Encoder("batch", HDIM + CDIM)
        self.update_block = _Update()


def raft_from_state(state: Dict[str, torch.Tensor], device) -> RAFT:
    """A RAFT-large in eval mode from a princeton-vl state dict."""
    model = RAFT()
    model.load_state_dict({k.removeprefix("module."): v for k, v in state.items()
                           if ".norm3." not in k})
    return model.to(device).eval()


def _pyramid(f1, f2):
    b, c, h, w = f1.shape
    corr = torch.matmul(f1.reshape(b, c, h * w).transpose(1, 2), f2.reshape(b, c, h * w))
    out = [(corr / math.sqrt(c)).reshape(b * h * w, h, w)]
    for _ in range(CORR_LEVELS - 1):
        prev = out[-1]
        hh, ww = prev.shape[-2:]
        if hh < 2 or ww < 2:
            out.append(prev)
            continue
        prev = prev[:, : 2 * (hh // 2), : 2 * (ww // 2)]
        out.append(prev.reshape(-1, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4)))
    return out


def _lookup(pyramid, coords):
    """The 9×9 bilinear window of every level around coords / 2^l, zero
    outside the map -> B×324×h×w (channel l·81 + i·9 + j samples x offset i,
    y offset j)."""
    b, _, h, w = coords.shape
    r = CORR_RADIUS
    xy = coords.permute(0, 2, 3, 1).reshape(-1, 2)
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([di, dj], dim=-1).reshape(-1, 2)   # (dx, dy), dx-major
    out = []
    for lvl, vol in enumerate(pyramid):
        _, hl, wl = vol.shape
        pts = xy[:, None, :] / (2 ** lvl) + delta[None]
        gx = 2 * pts[..., 0] / (wl - 1) - 1 if wl > 1 else torch.zeros_like(pts[..., 0])
        gy = 2 * pts[..., 1] / (hl - 1) - 1 if hl > 1 else torch.zeros_like(pts[..., 1])
        out.append(F.grid_sample(vol[:, None], torch.stack([gx, gy], -1)[:, None],
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=True)[:, 0, 0])
    return torch.cat(out, dim=1).reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _upsample(flow, mask):
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(n, 2, 9, 1, 1, h, w)
    return (mask * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


@torch.no_grad()
def raft_encode(model, images):
    x = images * 2.0 - 1.0
    cnet = model.cnet(x)
    return model.fnet(x), torch.tanh(cnet[:, :HDIM]), F.relu(cnet[:, HDIM:])


@torch.no_grad()
def raft_decode(model, f1, f2, net, inp, iters):
    b, _, h, w = f1.shape
    pyr = _pyramid(f1, f2)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=f1.device),
                            torch.arange(w, dtype=torch.float32, device=f1.device), indexing="ij")
    c0 = torch.stack([xs, ys])[None].repeat(b, 1, 1, 1)
    c1 = c0.clone()
    up = model.update_block
    for _ in range(iters):
        motion = up.encoder(c1 - c0, _lookup(pyr, c1))
        net = up.gru(net, torch.cat([inp, motion], dim=1))
        c1 = c1 + up.flow_head(net)
    return _upsample(c1 - c0, up.mask(net) * 0.25)


class Padder:
    """Edge-replicate H and W to multiples of 8, centred."""

    def __init__(self, h, w):
        ph, pw = (((h // 8) + 1) * 8 - h) % 8, (((w // 8) + 1) * 8 - w) % 8
        self.p = [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]

    def pad(self, x):
        return F.pad(x, self.p, mode="replicate")

    def unpad(self, x):
        l, r, t, b = self.p
        return x[..., t:x.shape[-2] - b, l:x.shape[-1] - r]


class Flows:
    """Adjacent and direct RAFT flows of one video (pairs 8 a decode batch,
    as the reference scripts' batching leaves the numbers alone)."""

    def __init__(self, model, video, iters, pair_batch=8):
        self.model, self.iters, self.bsz = model, iters, pair_batch
        self.t, _, self.h, self.w = video.shape
        self.padder = Padder(self.h, self.w)
        enc = [raft_encode(model, self.padder.pad(video[s:s + 8])) for s in range(0, self.t, 8)]
        self.enc = [torch.cat(x) for x in zip(*enc)]

    def pairs(self, a, b) -> torch.Tensor:
        """Flow a→b of each pair, ``pair_batch`` pairs a decode; a short last
        batch is filled with copies of its last pair (cuDNN's f32 choice at
        4-7 pairs is many times slower)."""
        out = []
        for s in range(0, len(a), self.bsz):
            n = len(a[s:s + self.bsz])
            fill = lambda x: np.concatenate([x[s:s + n], np.repeat(x[s + n - 1:s + n], self.bsz - n)])
            ia = torch.as_tensor(fill(a), device=self.enc[0].device)
            ib = torch.as_tensor(fill(b), device=self.enc[0].device)
            f, net, inp = self.enc
            out.append(self.padder.unpad(raft_decode(self.model, f[ia], f[ib], net[ia], inp[ia],
                                                     self.iters)[:n]))
        return torch.cat(out)

    def adjacent(self):
        i = np.arange(self.t - 1)
        return self.pairs(i, i + 1), self.pairs(i + 1, i)

    def direct(self, start, threshold):
        """(t-1)×h×w×2 flows start→f for f > start and their cycle masks,
        zero rows after."""
        tm1 = self.t - 1
        flows = torch.zeros((tm1, self.h, self.w, 2), device=self.enc[0].device)
        masks = torch.zeros((tm1, self.h, self.w), device=self.enc[0].device)
        tg = np.arange(start + 1, self.t)
        if len(tg):
            fwd, bwd = self.pairs(np.full_like(tg, start), tg), self.pairs(tg, np.full_like(tg, start))
            flows[:len(tg)] = fwd.permute(0, 2, 3, 1)
            g = _grid(self.h, self.w, fwd.device)[None]
            c1 = g + fwd.permute(0, 2, 3, 1)
            c2 = c1 + _sample(bwd, c1).permute(0, 2, 3, 1)
            upper = torch.tensor([self.w - 1.0, self.h - 1.0], device=fwd.device)
            ok = (_len(g - c2) < threshold) & ((c1 >= 0) & (c1 <= upper)).all(-1)
            masks[:len(tg)] = ok.float()
        return flows, masks


# ---- chained trajectories (reference extract_trajectories.py) --------------

def _grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def _len(d):
    return torch.sqrt((d * d).sum(dim=-1))


def _sample(img_nchw, coords_nhw2):
    _, _, h, w = img_nchw.shape
    g = torch.stack([2 * coords_nhw2[..., 0] / (w - 1) - 1, 2 * coords_nhw2[..., 1] / (h - 1) - 1], -1)
    return F.grid_sample(img_nchw, g, mode="bilinear", padding_mode="zeros", align_corners=True)


def flow_masks(fwd, bwd, threshold):
    """(t, h, w) bool: frame f > 0 cycle-checks against f-1 and is hit by a
    forward warp from f-1; frame 0 all False."""
    tm1, _, h, w = fwd.shape
    g = _grid(h, w, fwd.device)[None]
    c1 = g + bwd.permute(0, 2, 3, 1)
    c2 = c1 + _sample(fwd, c1).permute(0, 2, 3, 1)
    tgt = torch.round(g + fwd.permute(0, 2, 3, 1)).to(torch.int64)
    xi, yi = tgt[..., 0], tgt[..., 1]
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    hit = torch.zeros(tm1 * h * w, dtype=torch.bool, device=fwd.device)
    cell = torch.arange(tm1, device=fwd.device)[:, None, None] * (h * w) + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    hit[cell[inb]] = True
    masks = (_len(g - c2) < threshold) & hit.reshape(tm1, h, w)
    return torch.cat([torch.zeros((1, h, w), dtype=torch.bool, device=fwd.device), masks])


def occupy(trajs_tk2, occupied, start):
    t, h, w = occupied.shape
    valid = ~np.isnan(trajs_tk2).any(axis=-1)
    c = np.round(np.nan_to_num(trajs_tk2)).astype(np.int64)
    xi, yi = np.clip(c[..., 0], 0, w - 1), np.clip(c[..., 1], 0, h - 1)
    for f in range(start, t):
        occupied[f, yi[f, valid[f]], xi[f, valid[f]]] = True


def trajectories(flows: Flows, threshold, min_len, direct_threshold):
    """Both passes from every start frame -> (filtered N×t×2, unfiltered
    M×t×2) f32 with NaNs: a pixel spawns where it is not tracked from an
    earlier start (look-behind, per pass) or fails its frame's flow mask;
    it dies on a cycle error at or above ``threshold``, leaving the frame,
    and (filtered pass) disagreeing with the direct flow."""
    fwd, bwd = flows.adjacent()
    tm1, _, h, w = fwd.shape
    t, dev = tm1 + 1, fwd.device
    masks = flow_masks(fwd, bwd, threshold).cpu().numpy()
    occupied = {"f": np.zeros((t, h, w), bool), "u": np.zeros((t, h, w), bool)}
    out = {"f": [], "u": []}
    g = _grid(h, w, dev)
    upper = torch.tensor([w - 1.0, h - 1.0], device=dev)
    for start in range(t - (min_len - 1)):
        dflows, dmasks = flows.direct(start, threshold)
        tl = {k: torch.full((t, h, w, 2), float("nan"), device=dev) for k in "fu"}
        tl["f"][start] = tl["u"][start] = g
        coords = g
        alive = {k: torch.ones((h, w), dtype=torch.bool, device=dev) for k in "fu"}
        for i in range(start, tm1):
            c1 = coords + _sample(fwd[i][None], coords[None])[0].permute(1, 2, 0)
            c2 = c1 + _sample(bwd[i][None], c1[None])[0].permute(1, 2, 0)
            ok = (_len(coords - c2) < threshold) & ((c1 >= 0.0) & (c1 <= upper)).all(-1)
            coords = c1
            alive["u"] = alive["u"] & ok
            direct = _len(c1 - (g + dflows[i - start])) * (dmasks[i - start] > 0.2) < direct_threshold
            alive["f"] = alive["f"] & ok & direct
            for k in "fu":
                tl[k][i + 1] = torch.where(alive[k][..., None], c1, float("nan"))
        for k in "fu":
            keep = ((~torch.isnan(tl[k]).any(-1)).sum(0) >= min_len).cpu().numpy()
            ki = np.flatnonzero(keep & (~masks[start] | ~occupied[k][start]))
            if ki.size:
                cols = tl[k].reshape(t, -1, 2)[:, torch.as_tensor(ki, device=dev)].cpu().numpy()
                out[k].append(np.transpose(cols, (1, 0, 2)))
                occupy(cols, occupied[k], start)
    cat = lambda k: (np.concatenate(out[k]) if out[k] else np.full((0, t, 2), np.nan, np.float32))
    return cat("f"), cat("u")


# ---- DINOv2 ViT at stride 7 (reference models/extractor.py) ----------------

def _ln(x, w, b, eps, prec):
    return F.layer_norm(x.float(), x.shape[-1:], prec.vit_round(w).float(),
                        prec.vit_round(b).float(), eps)


def _lin(x, w, b, prec):
    return F.linear(prec.vit_round(x), prec.vit_round(w), prec.vit_round(b))


def _attention(q, k, v, scale, prec, heads_per_step=4):
    """softmax(q kᵀ · scale) v over the full logits in f32, a frame and a
    few heads at a time; the operands and the probabilities are rounded as
    the precision says."""
    q, k, v = prec.vit_round(q), prec.vit_round(k), prec.vit_round(v)
    out = torch.empty_like(v)
    for b in range(q.shape[0]):
        for h in range(0, q.shape[1], heads_per_step):
            s = torch.matmul(q[b, h:h + heads_per_step].float(),
                             k[b, h:h + heads_per_step].float().transpose(-1, -2)) * scale
            out[b, h:h + heads_per_step] = torch.matmul(prec.vit_round(torch.softmax(s, -1)),
                                                        v[b, h:h + heads_per_step])
    return out


@torch.no_grad()
def vit_features(state, video, layers, cfg, prec: Precision, frames_per_batch=4):
    """T×3×H×W in [0, 1] -> [T×D×h×w f32 tokens of each layer in ``layers``]
    (cls dropped); ``state`` under the DINOv2 keys, ``cfg`` the ViT's
    sizes (embed_dim, depth, heads, patch, stride)."""
    d, heads, patch, stride = cfg["embed_dim"], cfg["heads"], cfg["patch"], cfg["stride"]
    hd, m, eps = d // heads, 37, 1e-6
    dev = video.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    outs = {l: [] for l in layers}
    for s0 in range(0, video.shape[0], frames_per_batch):
        x = prec.vit_round((video[s0:s0 + frames_per_batch] - mean) / std)
        x = F.conv2d(x, prec.vit_round(state["patch_embed.proj.weight"]),
                     prec.vit_round(state["patch_embed.proj.bias"]), stride=stride)
        b, _, h0, w0 = x.shape
        x = prec.vit_round(x)
        cls = prec.vit_round(state["cls_token"]).expand(b, 1, d)
        x = torch.cat([cls, x.flatten(2).transpose(1, 2)], dim=1).float()
        pe = prec.vit_round(state["pos_embed"]).float()
        grid = pe[0, 1:].reshape(m, m, d).permute(2, 0, 1)[None]
        grid = F.interpolate(grid, scale_factor=((h0 + 0.1) / m, (w0 + 0.1) / m), mode="bicubic",
                             align_corners=False, recompute_scale_factor=False)
        x = x + torch.cat([pe[:, :1], grid[0].permute(1, 2, 0).reshape(1, h0 * w0, d)], dim=1)
        for i in range(max(layers) + 1):
            p = lambda n: state[f"blocks.{i}.{n}"]
            qkv = _lin(_ln(x, p("norm1.weight"), p("norm1.bias"), eps, prec),
                       p("attn.qkv.weight"), p("attn.qkv.bias"), prec)
            q, k, v = qkv.view(b, -1, 3, heads, hd).permute(2, 0, 3, 1, 4)
            a = _attention(q, k, v, 1.0 / math.sqrt(hd), prec)
            a = _lin(a.transpose(1, 2).reshape(b, -1, d), p("attn.proj.weight"),
                     p("attn.proj.bias"), prec)
            x = x + a.float() * prec.vit_round(p("ls1.gamma")).float()
            y = _lin(_ln(x, p("norm2.weight"), p("norm2.bias"), eps, prec),
                     p("mlp.fc1.weight"), p("mlp.fc1.bias"), prec)
            y = _lin(F.gelu(y.float()), p("mlp.fc2.weight"), p("mlp.fc2.bias"), prec)
            x = x + y.float() * prec.vit_round(p("ls2.gamma")).float()
            if i in outs:
                outs[i].append(x[:, 1:].transpose(1, 2).reshape(b, d, h0, w0).float())
    return [torch.cat(outs[l]) for l in layers]


# ---- foreground masks and the split ----------------------------------------

def fg_masks(features_tchw, out_hw, threshold):
    """T×H×W {0, 1}: the border-oriented first PCA component of the unit
    features (exact covariance), below ``threshold``, nearest-upsampled."""
    t, c, hp, wp = features_tchw.shape
    f = features_tchw.float().permute(0, 2, 3, 1).reshape(-1, c)
    f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    cen = f - f.mean(dim=0, keepdim=True)
    _, vecs = torch.linalg.eigh(cen.T @ cen)
    colors = f @ vecs.flip(-1)[:, :3]
    lo, hi = colors.min(dim=0).values, colors.max(dim=0).values
    comp = ((colors - lo) / (hi - lo))[:, 0].reshape(t, hp, wp)
    border = torch.cat([comp[:, 0].reshape(-1), comp[:, -1].reshape(-1),
                        comp[:, :, 0].reshape(-1), comp[:, :, -1].reshape(-1)])
    comp = 1.0 - comp if border.mean() < comp.mean() else comp
    fg = (comp < threshold).float()
    h, w = out_hw
    return fg[:, torch.arange(h, device=fg.device) * hp // h][:, :, torch.arange(w, device=fg.device) * wp // w]


def jpeg_round_trip(masks_thw: np.ndarray) -> np.ndarray:
    """0/1 masks written as 0/255 JPEG frames with Pillow's defaults and read
    back as grayscale floats, as the masks folder serves them."""
    import io
    from PIL import Image
    out = []
    for m in (masks_thw * 255).astype(np.uint8):
        buf = io.BytesIO()
        Image.fromarray(m).save(buf, format="JPEG")
        buf.seek(0)
        out.append(np.asarray(Image.open(buf).convert("L"), dtype=np.float32))
    return np.stack(out)


def split(trajs_nt2, masks_thw):
    """(fg, bg): fg where the mask is > 0 at the rounded, clipped first
    valid point."""
    starts = np.argmax(~np.isnan(trajs_nt2).any(-1), axis=1)
    pts = np.round(np.nan_to_num(trajs_nt2[np.arange(len(starts)), starts])).astype(np.int64)
    h, w = masks_thw.shape[1:]
    fg = masks_thw[starts, np.clip(pts[:, 1], 0, h - 1), np.clip(pts[:, 0], 0, w - 1)] > 0
    return trajs_nt2[fg], trajs_nt2[~fg]


# ---- best buddies (reference preprocessing_dino_bb/) -----------------------

def bb_grid(h, w, stride=7, patch=14, device=None):
    half = patch // 2
    x = torch.arange(half, w, stride, dtype=torch.float32, device=device)
    y = torch.arange(half, h, stride, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def closest_trajectories(trajs_nt2, grid_n2, chunk=8192):
    """T×n: the index of the trajectory nearest each grid point at each
    frame (NaN positions infinitely far; ties to the first index)."""
    coords = torch.nan_to_num(trajs_nt2.float(), nan=1e12).transpose(0, 1)
    out = []
    for f in range(coords.shape[0]):
        best_d = torch.full((grid_n2.shape[0],), float("inf"), device=grid_n2.device)
        best_i = torch.zeros(grid_n2.shape[0], dtype=torch.int64, device=grid_n2.device)
        for off in range(0, coords.shape[1], chunk):
            c = coords[f, off:off + chunk]
            dx = grid_n2[:, None, 0] - c[None, :, 0]
            dy = grid_n2[:, None, 1] - c[None, :, 1]
            dd, di = torch.sqrt(dx * dx + dy * dy).min(dim=1)
            best_i = torch.where(dd < best_d, di + off, best_i)
            best_d = torch.minimum(dd, best_d)
        out.append(best_i)
    return torch.stack(out)


def _topk_member(scores, k):
    """The k largest of each row, ties at the k-th value to the lower index."""
    if k >= scores.shape[-1]:
        return torch.ones_like(scores, dtype=torch.bool)
    bits = scores.float().contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    kth = torch.topk(keys, k, dim=-1).values[..., -1:]
    eq = keys == kth
    return (keys > kth) | (eq & (torch.cumsum(eq, -1) <= k - (keys > kth).sum(-1, keepdim=True)))


def ambiguity(sim, grid, topk, box, iou):
    """r = second / first greedy-NMS peak of each row of similarity maps."""
    member = _topk_member(sim, min(topk, sim.shape[1]))
    p1, a1 = sim.max(dim=1)
    d = (grid[None] - grid[a1][:, None]).abs()
    side = 2.0 * box
    inter = (side - d[..., 0]).clamp(min=0.0) * (side - d[..., 1]).clamp(min=0.0)
    ok = member & (inter / (2.0 * side * side - inter) <= iou)
    p2 = torch.where(ok, sim, float("-inf")).amax(dim=1)
    return torch.where(p2.isfinite(), p2, 0.0) / p1


def best_buddies(features_tchw, unfiltered_nt2, h, w, cfg) -> Dict[Tuple[int, int], Dict]:
    """Per ordered frame pair (s, u), s != u: the mutual nearest
    neighbours of the unit features kept where flow supervision is absent
    (the nearest unfiltered trajectory invalid at the other frame, both
    ways) -> {(s, u): {"src": tokens, "tgt": tokens, "cos": cosines, "r":
    ambiguity symmetrised over the two directions}}."""
    t = features_tchw.shape[0]
    dev = features_tchw.device
    grid = bb_grid(h, w, cfg["dino_stride"], device=dev)
    f = features_tchw.float().flatten(2).transpose(1, 2)
    f = f / torch.linalg.vector_norm(f, dim=2, keepdim=True).clamp(min=1e-8)
    trajs = torch.as_tensor(unfiltered_nt2, device=dev)
    closest = closest_trajectories(trajs, grid)
    invalid = trajs.isnan().any(-1)
    box, iou, topk = float(cfg["dino_bb_box_size"]), cfg["dino_bb_iou_threshold"], cfg["dino_bb_nms_topk"]
    out = {}
    for s in range(t):
        for u in range(s + 1, t):
            aff = f[s] @ f[u].T
            src_max, tgt_max = aff.argmax(dim=1), aff.argmax(dim=0)
            n = aff.shape[0]
            mutual = tgt_max[src_max] == torch.arange(n, device=dev)
            keep = invalid[closest[s], u] & invalid[closest[u][src_max], s]
            src = torch.nonzero(mutual & keep)[:, 0]
            tgt = src_max[src]
            cos = aff[src, tgt]
            r_fwd = ambiguity(f[s][src] @ f[u].T, grid, topk, box, iou) if len(src) else cos
            r_bwd = ambiguity(f[u][tgt] @ f[s].T, grid, topk, box, iou) if len(src) else cos
            r = torch.maximum(r_fwd, r_bwd)
            for a, b, x, y in ((s, u, src, tgt), (u, s, tgt, src)):
                out[(a, b)] = {"src": x, "tgt": y, "cos": cos, "r": r}
    return out


# ---- the whole video -------------------------------------------------------

def preprocess(video, raft_state, vit_state, cfg: dict, prec: Precision = Precision()) -> dict:
    """Every stage of one video -> {"trajectories", "unfiltered" (N×t×2),
    "features", "mask_features" (T×D×h×w, as stored: f16), "masks" (T×H×W
    as read back), "fg", "bg", "bb"}. ``cfg`` is the configuration file's
    dict (its ``preprocess``, ``vit`` and ``raft`` groups)."""
    pre, h, w = cfg["preprocess"], cfg["height"], cfg["width"]
    with tf32(prec.raft == "tf32"):
        model = raft_from_state(raft_state, video.device)
        flows = Flows(model, video, pre["raft_iters"], cfg["raft"]["pairs_per_decode_batch"])
        trajs, unfiltered = trajectories(flows, pre["threshold"], pre["min_trajectory_length"],
                                         pre["direct_flow_threshold"])
        del model, flows
    with tf32(False):
        feats, mask_feats = vit_features(vit_state, video, [pre["dino_layer"], pre["mask_dino_layer"]],
                                         cfg["vit"], prec, pre["extract_frames_per_batch"])
        masks = jpeg_round_trip(fg_masks(mask_feats, (h, w), pre["fg_mask_threshold"]).cpu().numpy())
        fg, bg = split(trajs, masks)
        bb = best_buddies(feats, unfiltered, h, w, pre)
    return {"trajectories": trajs, "unfiltered": unfiltered, "features": feats.half().cpu(),
            "mask_features": mask_feats.half().cpu(), "masks": masks, "fg": fg, "bg": bg,
            "bb": {k: {n: x.cpu() for n, x in v.items()} for k, v in bb.items()}}
