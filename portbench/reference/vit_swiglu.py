"""Plain PyTorch reference of the DINOv2 ViT at stride 7 with either FFN:
the GELU MLP of ViT-S/B/L/14, or the SwiGLU of ViT-g/14
(facebookresearch/dinov2: ``vit_giant2``, ``ffn_layer="swiglufused"``,
``dinov2/layers/swiglu_ffn.py``).

A block is x += ls1·attn(norm1(x)), then x += ls2·ffn(norm2(x)), with
ffn(y) = fc2(gelu(fc1(y))) or w3(silu(a)·b), [a | b] = w12(y). The SwiGLU's
hidden width is DINOv2's (int(4·D·2/3) + 7) // 8 · 8: 4,096 at D = 1,536.
It imports nothing of the measured program and no kernel: attention is a
softmax of the full logits, a frame and a few heads at a time
(``reference.preprocess._attention``), so a 40-block ViT-g/14 fits a card at
854×476.

Precision: float32 by default (``FLOAT32``: no operand rounded); with
``reference.preprocess.Precision()`` the operands of the linears and of
attention are rounded to bf16 (f32 accumulation, f32 residual, LayerNorm
and gate), and ``Precision("float8_e4m3")`` puts them on the float8 grid
(the control). TF32 is off for matmuls and cuDNN throughout.

``vit_state_swiglu`` gives seeded random weights under the real DINOv2 keys
(``mlp.w12.*``, ``mlp.w3.*`` for SwiGLU), so nothing is downloaded.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from reference.preprocess import IMAGENET_MEAN, IMAGENET_STD, _attention, _lin, _ln, tf32

PRETRAIN_GRID = 37  # √N of the pretrain pos-embed (518 / 14)
LN_EPS = 1e-6


class Float32(NamedTuple):
    """No operand rounded: the reference's default precision."""
    vit: str = "float32"

    def vit_round(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()


FLOAT32 = Float32()


def swiglu_hidden(embed_dim: int, mlp_ratio: int = 4) -> int:
    """DINOv2's SwiGLU hidden width (``SwiGLUFFNFused``)."""
    return (int(mlp_ratio * embed_dim * 2 / 3) + 7) // 8 * 8


def hidden_dim(vit: dict) -> int:
    """The FFN's hidden width of ``vit`` (its ``hidden``, else the MLP's
    4·D or the SwiGLU's DINOv2 width)."""
    if "hidden" in vit:
        return vit["hidden"]
    d = vit["embed_dim"]
    return swiglu_hidden(d) if vit.get("ffn") == "swiglu" else 4 * d


def state_shapes(vit: dict, pretrain_grid: int = PRETRAIN_GRID) -> Dict[str, tuple]:
    """Every DINOv2 state-dict key the forward reads, and its shape
    (``vit``: embed_dim, depth, patch, ffn "mlp" or "swiglu", optional
    hidden)."""
    d, p, hid = vit["embed_dim"], vit["patch"], hidden_dim(vit)
    ffn = ({"mlp.w12": (2 * hid, d), "mlp.w3": (d, hid)} if vit.get("ffn") == "swiglu"
           else {"mlp.fc1": (hid, d), "mlp.fc2": (d, hid)})
    shapes = {"patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,),
              "cls_token": (1, 1, d), "pos_embed": (1, 1 + pretrain_grid ** 2, d)}
    for i in range(vit["depth"]):
        b = f"blocks.{i}."
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d), **ffn}.items():
            shapes[f"{b}{name}.weight"], shapes[f"{b}{name}.bias"] = (dout, din), (dout,)
        for name in ("norm1", "norm2"):
            shapes[f"{b}{name}.weight"], shapes[f"{b}{name}.bias"] = (d,), (d,)
        shapes[f"{b}ls1.gamma"], shapes[f"{b}ls2.gamma"] = (d,), (d,)
    return shapes


def vit_state_swiglu(vit: dict, seed: int, device, pretrain_grid: int = PRETRAIN_GRID
                     ) -> Dict[str, torch.Tensor]:
    """Random DINOv2 weights under its keys, drawn leaf by leaf on ``device``
    from one generator: linears ~U(±1/√d_in), biases ~U(±0.1), LayerNorm γ
    ~1 + U(±0.2), β ~U(±0.1), cls token and pos-embed ~U(±1) (a non-zero
    pos-embed, so its bicubic resize does work), layerscale ~U(±0.2)."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out = {}
    for k, shape in state_shapes(vit, pretrain_grid).items():
        u = torch.rand(shape, generator=g, device=device) * 2 - 1
        if k.endswith("weight") and len(shape) >= 2:
            a, b = 1 / math.sqrt(math.prod(shape[1:])), 0.0
        elif ".norm" in k and k.endswith("weight"):
            a, b = 0.2, 1.0
        elif k.endswith("gamma"):
            a, b = 0.2, 0.0
        elif k in ("cls_token", "pos_embed"):
            a, b = 1.0, 0.0
        else:  # biases
            a, b = 0.1, 0.0
        out[k] = u * a + b
    return out


def block(x, state, i: int, vit: dict, prec=FLOAT32):
    """One block on the B×S×D f32 residual stream."""
    d, heads = vit["embed_dim"], vit["heads"]
    hd, b = d // heads, x.shape[0]
    p = lambda n: state[f"blocks.{i}.{n}"]
    qkv = _lin(_ln(x, p("norm1.weight"), p("norm1.bias"), LN_EPS, prec),
               p("attn.qkv.weight"), p("attn.qkv.bias"), prec)
    q, k, v = qkv.view(b, -1, 3, heads, hd).permute(2, 0, 3, 1, 4)
    a = _attention(q, k, v, 1.0 / math.sqrt(hd), prec)
    a = _lin(a.transpose(1, 2).reshape(b, -1, d), p("attn.proj.weight"), p("attn.proj.bias"),
             prec)
    x = x + a.float() * prec.vit_round(p("ls1.gamma")).float()
    y = _ln(x, p("norm2.weight"), p("norm2.bias"), LN_EPS, prec)
    if vit.get("ffn") == "swiglu":
        gate, up = _lin(y, p("mlp.w12.weight"), p("mlp.w12.bias"), prec).float().chunk(2, -1)
        y = _lin(F.silu(gate) * up, p("mlp.w3.weight"), p("mlp.w3.bias"), prec)
    else:
        y = _lin(F.gelu(_lin(y, p("mlp.fc1.weight"), p("mlp.fc1.bias"), prec).float()),
                 p("mlp.fc2.weight"), p("mlp.fc2.bias"), prec)
    return x + y.float() * prec.vit_round(p("ls2.gamma")).float()


def embed(state, frames, vit: dict, prec=FLOAT32, pretrain_grid: int = PRETRAIN_GRID):
    """ImageNet-normalised B×3×H×W frames -> (B×S×D f32 stream with the cls
    token and the bicubically resized pos-embed, (h0, w0))."""
    d, m = vit["embed_dim"], pretrain_grid
    x = F.conv2d(prec.vit_round(frames), prec.vit_round(state["patch_embed.proj.weight"]),
                 prec.vit_round(state["patch_embed.proj.bias"]), stride=vit["stride"])
    b, _, h0, w0 = x.shape
    x = prec.vit_round(x)
    cls = prec.vit_round(state["cls_token"]).expand(b, 1, d)
    x = torch.cat([cls, x.flatten(2).transpose(1, 2)], dim=1).float()
    pe = prec.vit_round(state["pos_embed"]).float()
    if (h0, w0) != (m, m):
        grid = pe[0, 1:].reshape(m, m, d).permute(2, 0, 1)[None]
        grid = F.interpolate(grid, scale_factor=((h0 + 0.1) / m, (w0 + 0.1) / m),
                             mode="bicubic", align_corners=False, recompute_scale_factor=False)
        pe = torch.cat([pe[:, :1], grid[0].permute(1, 2, 0).reshape(1, h0 * w0, d)], dim=1)
    return x + pe, (h0, w0)


@torch.no_grad()
def vit_features(state, video, layers: Sequence[int], vit: dict, prec=FLOAT32,
                 frames_per_batch: int = 4, pretrain_grid: int = PRETRAIN_GRID
                 ) -> List[torch.Tensor]:
    """T×3×H×W in [0, 1] -> [T×D×h0×w0 f32 tokens of each layer in
    ``layers``] (cls dropped), one sweep of blocks 0..max(layers) a batch of
    ``frames_per_batch`` frames; ``vit`` holds embed_dim, depth, heads,
    patch, stride, ffn (and hidden)."""
    dev = video.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    outs = {l: [] for l in layers}
    with tf32(False):
        for s0 in range(0, video.shape[0], frames_per_batch):
            frames = (video[s0:s0 + frames_per_batch].float() - mean) / std
            x, (h0, w0) = embed(state, frames, vit, prec, pretrain_grid)
            for i in range(max(layers) + 1):
                x = block(x, state, i, vit, prec)
                if i in outs:
                    outs[i].append(x[:, 1:].transpose(1, 2).reshape(
                        x.shape[0], -1, h0, w0).float())
    return [torch.cat(outs[l]) for l in layers]
