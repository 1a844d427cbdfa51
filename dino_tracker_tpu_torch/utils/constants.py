"""Small constant tensors, made once per (values, dtype, device).

A tensor built from host values on the card (``torch.tensor(..., device=
"cuda")``) is a pageable host-to-device copy: it synchronises the host with
the card, and a CUDA graph cannot capture it (``training/step_graph.py``).
The train step's constant vectors (the scales and normalisers of a video's
size) are therefore made at their first use, which precedes any capture, and
kept for the life of the process: a captured graph holds only their
addresses, so none may be freed while it lives. Each is a few bytes. Callers
read them and never write them.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once; the
    same tensor for every later call with these arguments. Read only."""
    return torch.tensor(values, dtype=dtype, device=device)
