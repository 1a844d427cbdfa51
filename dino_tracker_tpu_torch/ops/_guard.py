"""The device guard of every kernel launch of the port.

The libraries of ``csrc/`` launch with the CUDA runtime API, which launches
on the calling thread's current device, and the flash kernel's
``cudaFuncSetAttribute`` applies to the current device too. A launch into a
stream of another device fails. So every wrapper launches inside
``on_device(t.device)``, which makes the tensor's card current for the call
and yields the handle of that card's current stream: a tensor on ``cuda:1``
launches on ``cuda:1`` whatever device the process has made current.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for the enclosed launch and
    yield its current stream's handle (``cudaStream_t`` as an int)."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def count_launch(wrapper):
    """One more launch on ``wrapper.launches``, unless a CUDA graph capture
    only recorded it (its replays run no Python)."""
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        wrapper.launches += 1
