"""ViT weights for the port: DINOv2 state dicts from disk, and the JAX
package's ViT pytree carried across (port of
``dino_tracker_tpu/models/vit_convert.py``).

The port's ``VisionTransformer`` uses the DINOv2 state-dict keys, so a
DINOv2 checkpoint loads as it is, minus the keys the feature extractor does
not use (``mask_token``, heads, ...); the FFN's keys follow the preset
(``mlp.fc1``/``mlp.fc2``, or ``mlp.w12``/``mlp.w3`` for ViT-g/14's SwiGLU). The JAX pytree stores linears as
(din, dout) and the patch embedding as HWIO; the port's layout is torch's
(dout, din) and OIHW.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .vit import ViTConfig, VisionTransformer


def vit_state_keys(cfg: ViTConfig) -> list:
    """The state-dict keys of ``VisionTransformer(cfg)`` (those of the DINOv2
    checkpoint it loads, less the unused ones)."""
    with torch.device("meta"):
        return list(VisionTransformer(cfg).state_dict().keys())


def load_dinov2_state_dict(path_or_sd: Union[str, Mapping],
                           model_name: str = "dinov2_vitl14",
                           cfg: Optional[ViTConfig] = None
                           ) -> Tuple[Dict[str, torch.Tensor], ViTConfig]:
    """A DINOv2 state dict (a ``.pth`` torch checkpoint, a raw ``.npz`` dump,
    or a mapping) -> (the f32 CPU tensors the model uses, its ViTConfig:
    ``cfg``, else the preset of ``model_name``). Keys the model does not use
    are dropped; a missing one raises KeyError."""
    cfg = cfg or ViTConfig.for_model(model_name)
    sd = path_or_sd
    if isinstance(path_or_sd, str):
        if path_or_sd.endswith(".npz"):
            with np.load(path_or_sd) as f:
                sd = {k: f[k] for k in f.files}
        else:
            sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "model" in sd:
                sd = sd["model"]
    return {k: torch.as_tensor(np.asarray(sd[k].detach().cpu() if hasattr(
                sd[k], "detach") else sd[k]), dtype=torch.float32)
            for k in vit_state_keys(cfg)}, cfg


def vit_state_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX ViT pytree (``dino_tracker_tpu/models/vit.py`` layout, arrays
    or numpy) -> the port's state dict of f32 CPU tensors. GELU MLPs only
    (``mlp.fc1``/``mlp.fc2``), as the JAX ViT has no other FFN: a SwiGLU
    ViT-g/14 loads from a DINOv2 checkpoint (``load_dinov2_state_dict``)."""
    def t(a, perm=None):
        a = np.array(a, np.float32)  # a writable copy
        return torch.from_numpy(np.ascontiguousarray(
            a if perm is None else a.transpose(perm)))

    d = np.asarray(params["cls_token"]).shape[-1]
    sd = {"patch_embed.proj.weight": t(params["patch_embed"]["w"], (3, 2, 0, 1)),
          "patch_embed.proj.bias": t(params["patch_embed"]["b"]),
          "cls_token": t(params["cls_token"]).reshape(1, 1, d),
          "pos_embed": t(params["pos_embed"])}
    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            sd[p + name + ".weight"] = t(blk[name]["scale"])
            sd[p + name + ".bias"] = t(blk[name]["bias"])
        for group, names in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
            for name in names:
                sd[f"{p}{group}.{name}.weight"] = t(blk[group][name]["w"], (1, 0))
                sd[f"{p}{group}.{name}.bias"] = t(blk[group][name]["b"])
        for name in ("ls1", "ls2"):
            if name in blk:
                sd[f"{p}{name}.gamma"] = t(blk[name])
    return sd


def build_vit(state: Mapping[str, torch.Tensor], cfg: ViTConfig,
              device: Union[str, torch.device] = "cuda") -> VisionTransformer:
    """A ``VisionTransformer`` on ``device`` (the card unless the caller asks
    for the CPU) holding ``state`` (strict keys)."""
    with torch.device("meta"):
        model = VisionTransformer(cfg)
    model.load_state_dict({k: v.to(device) for k, v in state.items()},
                          strict=True, assign=True)
    return model.eval()
