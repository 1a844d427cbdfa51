"""Checkpointing of the port's trainer (port of
dino_tracker_tpu/training/checkpoint.py).

A checkpoint is ``state_<step>.pt`` (``torch.save``) holding the model's
state_dict, the optimizer's, the step and the step generator's state, so a
resumed run continues exactly where the saved one stood. Writes are atomic
(temp file + ``os.replace``), and the resume scan falls back past unreadable
files, so a process killed mid-save does not poison the next run.
"""

from __future__ import annotations

import logging
import os
import re
import threading

import torch

logger = logging.getLogger(__name__)

_NAME = re.compile(r"state_(\d+)\.pt$")


def checkpoint_file(ckpt_folder: str, step: int) -> str:
    return os.path.join(ckpt_folder, f"state_{step}.pt")


def save_state(ckpt_folder: str, state: dict, step: int) -> str:
    os.makedirs(ckpt_folder, exist_ok=True)
    path = checkpoint_file(ckpt_folder, step)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # atomic on POSIX: readers see old or new, never partial
    return path


def _to_cpu(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class AsyncSaver:
    """Write checkpoints from a thread while training goes on.

    Trap (in-place optimizer vs async save): the JAX saver could hand its
    immutable state to the thread. ``torch.optim`` updates parameters and
    moments in place, so a thread reading them would write a mix of steps.
    ``save`` therefore copies the state to host memory on the calling thread
    first; only the file write runs in the thread. ``join()`` waits for every
    pending write and re-raises the first failure.
    """

    def __init__(self):
        self._pending = []

    def save(self, ckpt_folder: str, state: dict, step: int):
        snapshot = _to_cpu(state)
        slot = {"exc": None}

        def run():
            try:
                save_state(ckpt_folder, snapshot, step)
            except BaseException as e:  # re-raised in join()
                slot["exc"] = e

        th = threading.Thread(target=run, name=f"ckpt:{step}", daemon=True)
        th.start()
        self._pending.append((th, slot))

    def join(self):
        pending, self._pending = self._pending, []
        first = None
        for th, slot in pending:
            th.join()
            if slot["exc"] is not None and first is None:
                first = slot["exc"]
        if first is not None:
            raise first


def checkpoint_steps(ckpt_folder: str):
    """Steps of the ``state_<step>.pt`` files in the folder, newest first."""
    if not os.path.isdir(ckpt_folder):
        return []
    return sorted((int(m.group(1)) for name in os.listdir(ckpt_folder)
                   if (m := _NAME.match(name))), reverse=True)


def load_state(ckpt_folder: str, step: int, map_location=None) -> dict:
    return torch.load(checkpoint_file(ckpt_folder, step),
                      map_location=map_location, weights_only=True)


def load_latest(ckpt_folder: str, map_location=None):
    """(state, step) of the newest READABLE checkpoint, or (None, -1): an
    unreadable newest file (e.g. truncated by a kill mid-save) is logged and
    skipped, so resume's step always matches the state it loaded."""
    for s in checkpoint_steps(ckpt_folder):
        try:
            return load_state(ckpt_folder, s, map_location), s
        except Exception as e:  # truncated or corrupt file
            logger.warning("checkpoint state_%d.pt unreadable (%s); falling "
                           "back", s, e)
    return None, -1
