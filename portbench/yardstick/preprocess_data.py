"""The preprocessing cells' inputs, made on the device from a seed: seeded
DINOv2 ViT and RAFT-large weights under their published state-dict keys, and
one video after another.

Each weight set is one uniform draw, sliced leaf by leaf: the ViT's linears
~U(±1/√d_in), biases ~U(±0.1), LayerNorm γ ~1 + U(±0.2), a non-zero
pos-embed (so its bicubic resize does work) and layerscale ~U(±0.2);
RAFT's convs ~U(±1/√fan_in) (torch's default bounds), BN near identity,
and its flow head scaled by 0.1 so that trajectories survive random weights
(unscaled, random flows run to a few px with forward and backward flows
unrelated, and the cycle check kills every trajectory).

A video is a smooth colour texture moving by a fixed shift a frame: video k
of every run moves by ``SHIFTS[k % 8]`` (at most 2 px a frame; the warm-up
video by the last), and a seed draws only the texture's phases, so every
seed does the same work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .train_data import derived_seed, generator

SHIFTS: List[Tuple[float, float]] = [(1.5, 0.5), (-1.0, 0.75), (0.5, -1.5), (-1.25, -1.0),
                                     (1.75, 0.0), (0.0, 1.25), (-0.5, 1.75), (1.0, 1.0)]


def _draw(shapes: Dict[str, tuple], scale: Dict[str, Tuple[float, float]], seed: int,
          salt: int, device) -> Dict[str, torch.Tensor]:
    """One uniform draw sliced into ``shapes``; leaf k is U(±a) + b for
    ``scale[k] = (a, b)``."""
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator(seed, salt, device), device=device) * 2 - 1
    out, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        a, b = scale[k]
        out[k] = (u[at:at + n] * a + b).reshape(shape)
        at += n
    return out


def vit_state(vit: dict, seed: int, device, pretrain_grid: int = 37) -> Dict[str, torch.Tensor]:
    """Random DINOv2 weights (``vit``: embed_dim, depth, patch) under the
    DINOv2 state-dict keys."""
    d, p, hid = vit["embed_dim"], vit["patch"], 4 * vit["embed_dim"]
    shapes = {"patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,),
              "cls_token": (1, 1, d), "pos_embed": (1, 1 + pretrain_grid ** 2, d)}
    scale = {"patch_embed.proj.weight": (1 / math.sqrt(3 * p * p), 0.0),
             "patch_embed.proj.bias": (0.1, 0.0), "cls_token": (1.0, 0.0),
             "pos_embed": (1.0, 0.0)}
    for i in range(vit["depth"]):
        b = f"blocks.{i}."
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                                  "mlp.fc1": (hid, d), "mlp.fc2": (d, hid)}.items():
            shapes[f"{b}{name}.weight"], scale[f"{b}{name}.weight"] = (dout, din), (1 / math.sqrt(din), 0.0)
            shapes[f"{b}{name}.bias"], scale[f"{b}{name}.bias"] = (dout,), (0.1, 0.0)
        for name in ("norm1", "norm2"):
            shapes[f"{b}{name}.weight"], scale[f"{b}{name}.weight"] = (d,), (0.2, 1.0)
            shapes[f"{b}{name}.bias"], scale[f"{b}{name}.bias"] = (d,), (0.1, 0.0)
        for name in ("ls1", "ls2"):
            shapes[f"{b}{name}.gamma"], scale[f"{b}{name}.gamma"] = (d,), (0.2, 0.0)
    return _draw(shapes, scale, seed, 11, device)


def raft_state(seed: int, device) -> Dict[str, torch.Tensor]:
    """Random RAFT-large weights under the princeton-vl keys (``module.``
    prefixed), the flow head's last conv scaled by 0.1."""
    from torch import nn
    from reference.preprocess import RAFT
    shapes, scale = {}, {}
    for name, m in RAFT().named_modules():
        if isinstance(m, nn.Conv2d):
            bound = 1 / math.sqrt(m.weight[0].numel())
            head = 0.1 if name == "update_block.flow_head.conv2" else 1.0
            for leaf in ("weight", "bias"):
                shapes[f"{name}.{leaf}"] = tuple(getattr(m, leaf).shape)
                scale[f"{name}.{leaf}"] = (bound * head, 0.0)
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            for leaf, s in (("weight", (0.2, 1.0)), ("bias", (0.1, 0.0)),
                            ("running_mean", (0.1, 0.0)), ("running_var", (0.5, 1.0))):
                shapes[f"{name}.{leaf}"], scale[f"{name}.{leaf}"] = (c,), s
    return {f"module.{k}": v for k, v in _draw(shapes, scale, seed, 12, device).items()}


def textured_video(t: int, h: int, w: int, shift, phase, device) -> torch.Tensor:
    """T×3×H×W in [0, 1]: a smooth colour texture moving by ``shift`` (x, y)
    px a frame, its sines offset by ``phase`` (three radians)."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    frames = []
    for i in range(t):
        x, y = xs - shift[0] * i, ys - shift[1] * i
        frames.append(torch.stack([
            0.5 + 0.25 * torch.sin(0.11 * x + 0.05 * y + phase[0]) * torch.cos(0.07 * y),
            0.5 + 0.25 * torch.sin(0.05 * x - 0.13 * y + 1.0 + phase[1]),
            0.5 + 0.2 * torch.cos(0.03 * x + 0.02 * y + phase[2]) * torch.sin(0.09 * x)]))
    return torch.stack(frames).clamp(0, 1)


def video(seed: int, k: int, t: int, h: int, w: int, device) -> torch.Tensor:
    """The k-th video of a run with this seed (k = -1: the warm-up video)."""
    phases = np.random.default_rng(derived_seed(seed, 13)).uniform(0, 2 * math.pi, size=(k + 2, 3))
    return textured_video(t, h, w, SHIFTS[k % len(SHIFTS)], tuple(phases[k + 1]), device)
