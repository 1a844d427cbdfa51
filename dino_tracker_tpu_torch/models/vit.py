"""DINOv2 ViT with overlapping patches (stride < patch): the feature extractor
of preprocessing, port of ``dino_tracker_tpu/models/vit.py``.

A ViT-L/14 whose patch-embed conv runs at stride 7 (67×121 = 8107 tokens
plus cls at 854×476), with the positional embedding bicubically resized to
that grid (reference models/extractor.py:41-85). Facets: per-block token
outputs and per-block q/k/v slices (extractor.py:137-267).

Parameters are the DINOv2 state-dict keys (``patch_embed.proj.*``,
``cls_token``, ``pos_embed``, ``blocks.i.{norm1,attn.qkv,attn.proj,norm2}.*``,
the FFN's ``blocks.i.mlp.{fc1,fc2}.*`` (GELU MLP) or
``blocks.i.mlp.{w12,w3}.*`` (SwiGLU, ViT-g/14's ``swiglufused``),
``blocks.i.ls{1,2}.gamma``); the module is created empty and filled by
``load_state_dict`` (``models/vit_convert.py``).

Numerics, given a compute dtype ``cd`` (``PreprocessConfig.compute_dtype``):
every parameter is rounded to ``cd`` (JAX ``vit.py:287-291``); the patch
embedding runs in ``cd`` and is rounded to it; the residual stream, the
LayerNorm statistics (eps 1e-6), GELU (exact erf form) or the SwiGLU gate
silu(a)·b, and the layerscale products are f32, the FFN's hidden activation
rounded to ``cd`` before its second linear; the operands of the four linears
and of attention are ``cd`` with f32 accumulation. With ``cd`` = bf16 this is the declared
contract; the JAX package computes its activations in f32 at any grid other
than the pretrain grid, because its f32 pos-embed resize promotes the
residual stream (ROADMAP Queue C). Attention goes through
``ops/attention.py``: K2 on CUDA tensors, the plain version on the CPU.

Each block's attention and FFN are the spans ``vit/attention`` and
``vit/ffn`` (``utils/profiling.py``): no fence and no log line, so outside a
profiler they count calls and enqueue seconds only; a traced run gives each
the kernels it launched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel import mesh as mesh_lib
from ..utils.profiling import stage_timer
from .nn import exact_f32


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    pretrain_grid: int = 37  # √N of the pretrain pos-embed (518/14)
    layerscale: bool = True
    ln_eps: float = 1e-6
    ffn: str = "mlp"  # "mlp": fc1, GELU, fc2; "swiglu": w12, silu(a)·b, w3
    ffn_hidden: Optional[int] = None  # the FFN's hidden width; None: mlp_ratio·D

    @property
    def hidden_dim(self) -> int:
        return self.ffn_hidden or self.mlp_ratio * self.embed_dim

    @classmethod
    def for_model(cls, model_name: str) -> "ViTConfig":
        """dinov2_vit{s,b,l,g}14 (facebookresearch/dinov2) when the name
        contains "v2", else DINO-v1 dino_vit{s,b}{8,16} (patch 8/16,
        pretrained at 224, no layerscale). ViT-g/14 is DINOv2's
        ``vit_giant2``: SwiGLU FFNs of hidden width
        (int(4·1536·2/3) + 7) // 8 · 8 = 4,096. Register variants
        (``..._reg``) are not supported."""
        if "_reg" in model_name:
            raise ValueError(f"{model_name}: DINOv2 models with register tokens "
                             "are not supported")
        presets = {
            "s": dict(embed_dim=384, depth=12, num_heads=6),
            "b": dict(embed_dim=768, depth=12, num_heads=12),
            "l": dict(embed_dim=1024, depth=24, num_heads=16),
            "g": dict(embed_dim=1536, depth=40, num_heads=24, ffn="swiglu",
                      ffn_hidden=4096),
        }
        for key, kw in presets.items():
            if f"vit{key}" not in model_name:
                continue
            if "v2" in model_name:
                return cls(**kw)
            if key not in ("s", "b"):
                break  # the v1 hub only ships ViT-S and ViT-B
            patch = 8 if model_name.rstrip().endswith("8") else 16
            return cls(patch_size=patch, pretrain_grid=224 // patch,
                       layerscale=False, **kw)
        raise ValueError(f"unknown model name {model_name}")


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FACETS = ("tokens", "queries", "keys", "values")


class _Params(nn.Module):
    """Empty parameters under torch's own names, filled by load_state_dict."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))


def _linear(x: torch.Tensor, p: _Params) -> torch.Tensor:
    """x Wᵀ + b with operands in x's dtype (f32 accumulation)."""
    return F.linear(x, p.weight.to(x.dtype), p.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, p: _Params, eps: float, cd: torch.dtype):
    """f32 statistics and affine (the affine rounded to cd first), out in cd."""
    return F.layer_norm(x.float(), x.shape[-1:], p.weight.to(cd).float(),
                        p.bias.to(cd).float(), eps).to(cd)


def _scale(y: torch.Tensor, ls, cd: torch.dtype) -> torch.Tensor:
    y = y.float()
    return y if ls is None else y * ls.gamma.to(cd).float()


class Block(nn.Module):
    """x += ls1·attn(norm1(x)); x += ls2·ffn(norm2(x)), residual in f32. The
    FFN is fc2(gelu(fc1(y))) or, for SwiGLU, w3(silu(a)·b) with
    [a | b] = w12(y)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, hidden = cfg.embed_dim, cfg.hidden_dim
        self.num_heads, self.eps, self.swiglu = cfg.num_heads, cfg.ln_eps, cfg.ffn == "swiglu"
        if cfg.ffn not in ("mlp", "swiglu"):
            raise ValueError(f"unknown ffn {cfg.ffn!r}: 'mlp' or 'swiglu'")
        self.norm1 = _Params(weight=(d,), bias=(d,))
        self.attn = nn.Module()
        self.attn.qkv = _Params(weight=(3 * d, d), bias=(3 * d,))
        self.attn.proj = _Params(weight=(d, d), bias=(d,))
        self.norm2 = _Params(weight=(d,), bias=(d,))
        self.mlp = nn.Module()
        if self.swiglu:
            self.mlp.w12 = _Params(weight=(2 * hidden, d), bias=(2 * hidden,))
            self.mlp.w3 = _Params(weight=(d, hidden), bias=(d,))
        else:
            self.mlp.fc1 = _Params(weight=(hidden, d), bias=(hidden,))
            self.mlp.fc2 = _Params(weight=(d, hidden), bias=(d,))
        self.ls1 = _Params(gamma=(d,)) if cfg.layerscale else None
        self.ls2 = _Params(gamma=(d,)) if cfg.layerscale else None

    def forward(self, x: torch.Tensor, cd: torch.dtype):
        """x: B×S×D f32 -> (x, qkv B×S×3D in cd)."""
        b, s, d = x.shape
        h = self.num_heads
        with stage_timer("vit/attention", log=False):
            qkv = _linear(_layer_norm(x, self.norm1, self.eps, cd), self.attn.qkv)
            # [q | k | v] on the last axis, each (b, s, h, hd) -> (b, h, s, hd)
            q, k, v = qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
            a = multi_head_attention(q, k, v, 1.0 / math.sqrt(d // h))
            a = _linear(a.transpose(1, 2).reshape(b, s, d), self.attn.proj)
            x = x + _scale(a, self.ls1, cd)
        with stage_timer("vit/ffn", log=False):
            y = _layer_norm(x, self.norm2, self.eps, cd)
            if self.swiglu:
                g, u = _linear(y, self.mlp.w12).chunk(2, dim=-1)
                y = _linear((F.silu(g.float()) * u.float()).to(cd), self.mlp.w3)
            else:
                y = _linear(F.gelu(_linear(y, self.mlp.fc1).float(),
                                   approximate="none").to(cd), self.mlp.fc2)
            x = x + _scale(y, self.ls2, cd)
        return x, qkv


class VisionTransformer(nn.Module):
    """DINOv2 DinoVisionTransformer (non-register variants), created empty:
    load a state dict before use."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = _Params(
            weight=(d, 3, cfg.patch_size, cfg.patch_size), bias=(d,))
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.pretrain_grid ** 2, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))

    def interpolate_pos_embed(self, grid_hw: Tuple[int, int],
                              cd: torch.dtype) -> torch.Tensor:
        """(1, 1 + h0·w0, D) f32: the cd-rounded pos-embed, bicubically
        resized in f32 with the reference's +0.1 scale factors and
        ``recompute_scale_factor=False`` (extractor.py:57-85); unchanged on
        the pretrain grid (JAX ``vit.py:144``)."""
        h0, w0 = grid_hw
        m, d = self.cfg.pretrain_grid, self.cfg.embed_dim
        pe = self.pos_embed.to(cd).float()
        if (h0, w0) == (m, m):
            return pe
        patch = pe[0, 1:].reshape(m, m, d).permute(2, 0, 1)[None]
        r = F.interpolate(patch, scale_factor=((h0 + 0.1) / m, (w0 + 0.1) / m),
                          mode="bicubic", align_corners=False,
                          recompute_scale_factor=False)
        assert r.shape[-2:] == (h0, w0), r.shape
        return torch.cat([pe[:, :1], r[0].permute(1, 2, 0).reshape(1, h0 * w0, d)],
                         dim=1)

    def embed(self, x: torch.Tensor, stride: int, cd: torch.dtype):
        """Patch embedding in cd, cls token and the resized pos-embed ->
        (B×S×D f32 residual stream, (h0, w0))."""
        conv = self.patch_embed.proj
        x = F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), stride=stride)
        b, d, h0, w0 = x.shape
        x = torch.cat([self.cls_token.to(cd).expand(b, 1, d),
                       x.flatten(2).transpose(1, 2)], dim=1)
        return x.float() + self.interpolate_pos_embed((h0, w0), cd), (h0, w0)

    def forward_features(self, frames_nchw: torch.Tensor, stride: int,
                         layers: Sequence[int], facet: str = "tokens",
                         compute_dtype: torch.dtype = torch.float32):
        """Run blocks 0..max(layers) on ImageNet-normalized frames; return
        ([the facet at each requested layer], (h0, w0)).

        'tokens': block outputs B×S×D f32 (cls at position 0);
        'queries'/'keys'/'values': that block's slice of qkv, B×S×D in the
        compute dtype."""
        if facet not in FACETS:
            raise ValueError(f"facet {facet!r} is not one of {FACETS}")
        depth = len(self.blocks)
        bad = [l for l in layers if not 0 <= l < depth]
        if bad:
            raise ValueError(
                f"requested ViT layer(s) {bad} out of range for a {depth}-block "
                f"model — the layer-15/23 defaults in config.py are ViT-L/14 "
                f"values; set dino_layer/mask_dino_layer to < {depth} for "
                f"smaller variants")
        cd = compute_dtype
        x = frames_nchw.to(cd)
        with exact_f32(x):
            x, (h0, w0) = self.embed(x, stride, cd)
            b, _, d = x.shape
            sel = {"queries": 0, "keys": 1, "values": 2}.get(facet)
            found = {}
            for i in range(max(layers) + 1):
                x, qkv = self.blocks[i](x, cd)
                if i in layers:
                    found[i] = x if sel is None else qkv.view(
                        b, x.shape[1], 3, d)[:, :, sel]
        return [found[l] for l in layers], (h0, w0)


@torch.no_grad()
def keys_self_similarity(model: VisionTransformer, frames_nchw: torch.Tensor,
                         stride: int, layer: int) -> torch.Tensor:
    """Cosine self-similarity B×S×S of a layer's key facet over all tokens,
    f32 (reference extractor.py:269-274; JAX ``vit.py:331-342``)."""
    keys = model.forward_features(frames_nchw, stride, [layer], facet="keys")[0][0]
    normed = keys / torch.linalg.vector_norm(keys, dim=-1, keepdim=True).clamp(min=1e-8)
    with exact_f32(normed):
        return normed @ normed.transpose(1, 2)


@torch.no_grad()
def attention_maps(model: VisionTransformer, frames_nchw: torch.Tensor, stride: int,
                   layer: int) -> torch.Tensor:
    """Post-softmax attention maps B×H×S×S of one block, f32 (reference
    extractor.py:118-122,160-166; JAX ``vit.py:345-376``): a plain softmax of
    the full S×S logits, so use it at coarse strides only."""
    cd = torch.float32
    x = frames_nchw.to(cd)
    with exact_f32(x):
        x, _ = model.embed(x, stride, cd)
        for blk in model.blocks[:layer]:
            x = blk(x, cd)[0]
        blk = model.blocks[layer]
        b, s, d = x.shape
        qkv = _linear(_layer_norm(x, blk.norm1, blk.eps, cd), blk.attn.qkv)
        q, k, _ = qkv.view(b, s, 3, blk.num_heads, d // blk.num_heads).permute(2, 0, 3, 1, 4)
        logits = q @ k.transpose(-1, -2) / math.sqrt(d // blk.num_heads)
    return torch.softmax(logits, dim=-1)


def extract_feature_video(model: VisionTransformer, video_tchw: torch.Tensor,
                          stride: int = 7, layer: Union[int, Sequence[int], None] = None,
                          facet: str = "tokens", frames_per_batch: int = 4,
                          compute_dtype: torch.dtype = torch.float32,
                          mesh: Optional[mesh_lib.Mesh] = None):
    """video (T×3×H×W in [0, 1], on the model's device) -> feature video
    T×D×h0×w0 f32; a list of them, from one sweep, when ``layer`` is a
    sequence (JAX ``vit.py:256-328``).

    ImageNet-normalized frames go through the model ``frames_per_batch`` at
    a time; the last batch is not padded (the JAX package pads it only to
    keep its compiled shapes). With ``mesh`` each rank runs its share of
    those batches, each whole, and every rank gets the whole feature
    video(s)."""
    single = layer is None or isinstance(layer, int)
    layers = ([model.cfg.depth - 1] if layer is None
              else [layer] if isinstance(layer, int) else list(layer))
    dev = video_tchw.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    t = video_tchw.shape[0]
    starts = range(0, t, frames_per_batch)
    mine, rows = mesh_lib.split_batches([min(frames_per_batch, t - s) for s in starts], mesh)
    outputs: List[List[torch.Tensor]] = []
    with torch.no_grad():
        for s in (starts[i] for i in mine):
            frames = (video_tchw[s:s + frames_per_batch].float() - mean) / std
            outs, (h0, w0) = model.forward_features(frames, stride, layers, facet,
                                                    compute_dtype)
            outputs.append([o[:, 1:].transpose(1, 2).reshape(o.shape[0], o.shape[2], h0, w0)
                            .float() for o in outs])
    results = mesh_lib.gather_batches(outputs, rows, mesh, "vit_features", len(layers))
    return results[0] if single else results
