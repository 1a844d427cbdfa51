"""Multi-head attention of the ViT: the plain version and the device dispatch.

``attention_reference`` is the plain PyTorch version of the JAX package's
``xla_attention`` (``dino_tracker_tpu/ops/attention.py:19``): f32 scores,
f32 softmax, probabilities cast to v's dtype, then P·V in v's dtype.
``multi_head_attention`` takes the JAX layout [B, H, S, d]: CPU tensors take
the plain version, CUDA tensors kernel K2 (``ops/flash_attention.py``), with
no fallback between them and no backend sniffing (the reference's
``impl="auto"`` picked XLA on any CPU backend). bf16 views go to the kernel
as they lie (the ViT passes the permuted views of its qkv projection; a
layout the kernel's tensor maps cannot express raises, nothing copies); f32
takes contiguous copies. Any S: the kernel masks by bounds, so the TPU
path's padding to a block multiple is not ported.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Plain version: [..., S, d] -> [..., S, d] in v's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: float) -> torch.Tensor:
    """q/k/v: [B, H, S, d] -> [B, H, S, d]. CPU: the plain version; CUDA:
    K2, on the bf16 views themselves or on contiguous f32 copies; any other
    device raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale)
    if q.device.type == "cuda":
        if q.dtype == torch.bfloat16:
            return flash_attention_cuda(q, k, v, sm_scale)
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), sm_scale)
    raise ValueError(f"multi_head_attention runs on CPU or CUDA tensors, got "
                     f"{q.device}")
