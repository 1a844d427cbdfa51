"""Carry the JAX package's parameters and BN statistics across to the port.

JAX layout (``dino_tracker_tpu.models.tracker.init_tracker``)::

    params      = {"delta_dino": {"layers": [{"conv": {"w", "b"},
                                               "bn": {"scale", "bias"}}, ...]},
                   "tracker_head": {"conv1": {"w", "b"}, "conv2": {"w", "b"}}}
    batch_stats = {"delta_dino": {"layers": [{"mean", "var"}, ...]}}

Conv weights are HWIO there and OIHW here. ``load_jax_checkpoint`` reads the
JAX package's ``state_<step>.msgpack`` (flax.serialization) without flax.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _as_list(x):
    """flax state dicts store lists as dicts keyed "0", "1", ..."""
    if isinstance(x, dict):
        return [x[str(i)] for i in range(len(x))]
    return list(x)


def _hwio_to_oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def state_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """JAX pytrees (nested dicts of arrays) -> the port's ``Tracker``
    state_dict (CPU f32 tensors)."""
    sd = {}
    layers = _as_list(params["delta_dino"]["layers"])
    stats = _as_list(batch_stats["delta_dino"]["layers"])
    for i, (layer, st) in enumerate(zip(layers, stats)):
        p = f"delta_dino.layers.{i}."
        sd[p + "conv.weight"] = _hwio_to_oihw(layer["conv"]["w"])
        sd[p + "conv.bias"] = _vec(layer["conv"]["b"])
        sd[p + "bn.weight"] = _vec(layer["bn"]["scale"])
        sd[p + "bn.bias"] = _vec(layer["bn"]["bias"])
        sd[p + "bn.running_mean"] = _vec(st["mean"])
        sd[p + "bn.running_var"] = _vec(st["var"])
    for name in ("conv1", "conv2"):
        conv = params["tracker_head"][name]
        sd[f"tracker_head.{name}.weight"] = _hwio_to_oihw(conv["w"])
        sd[f"tracker_head.{name}.bias"] = _vec(conv["b"])
    return sd


def state_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """Inverse of :func:`state_from_jax`: (params, batch_stats) as nested
    dicts of numpy f32 arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("delta_dino.")})
    layers, stats = [], []
    for i in range(n_layers):
        p = f"delta_dino.layers.{i}."
        layers.append({
            "conv": {"w": np.transpose(sd[p + "conv.weight"], (2, 3, 1, 0)),
                     "b": sd[p + "conv.bias"]},
            "bn": {"scale": sd[p + "bn.weight"], "bias": sd[p + "bn.bias"]}})
        stats.append({"mean": sd[p + "bn.running_mean"],
                      "var": sd[p + "bn.running_var"]})
    head = {name: {"w": np.transpose(sd[f"tracker_head.{name}.weight"],
                                     (2, 3, 1, 0)),
                   "b": sd[f"tracker_head.{name}.bias"]}
            for name in ("conv1", "conv2")}
    return ({"delta_dino": {"layers": layers}, "tracker_head": head},
            {"delta_dino": {"layers": stats}})


# ---------------------------------------------------------------------------
# flax msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax _MsgpackExtType


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    dtype = np.dtype(dtype_name.decode())  # bfloat16 leaves are not supported
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code} in checkpoint")


def _unchunk(d):
    """Arrays over flax's MAX_CHUNK_SIZE are stored as
    {"__msgpack_chunked_array__", "shape", "chunks"} dicts."""
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            shape = tuple(_as_list(d["shape"]))
            return np.concatenate(_as_list(d["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in d.items()}
    return d


def load_jax_checkpoint(path: str) -> dict:
    """Read a flax-serialized train state -> nested dicts of numpy arrays
    (equal to ``flax.serialization.msgpack_restore`` of the file)."""
    import msgpack
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


_MSGPACK_NAME = re.compile(r"state_(\d+)\.msgpack$")


def checkpoint_steps(ckpt_folder: str) -> list:
    """Steps of the JAX trainer's ``state_<step>.msgpack`` files in the
    folder, newest first (the JAX package's naming, training/checkpoint.py)."""
    if not os.path.isdir(ckpt_folder):
        return []
    return sorted((int(m.group(1)) for name in os.listdir(ckpt_folder)
                   if (m := _MSGPACK_NAME.match(name))), reverse=True)


def checkpoint_path(ckpt_folder: str, step: Optional[int] = None) -> str:
    """``state_<step>.msgpack`` in ``ckpt_folder``; the newest when step is
    None."""
    if step is None:
        steps = checkpoint_steps(ckpt_folder)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {ckpt_folder}")
        step = steps[0]
    return os.path.join(ckpt_folder, f"state_{step}.msgpack")
