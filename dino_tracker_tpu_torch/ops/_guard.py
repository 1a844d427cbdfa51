"""Every launch of the port's hand-written kernels: its device guard, its
error check and its count.

The libraries of ``csrc/`` launch with the CUDA runtime API, which launches
on the calling thread's current device, and the flash kernel's
``cudaFuncSetAttribute`` applies to the current device too. A launch into a
stream of another device fails. So ``launch`` calls the entry inside
``on_device(t.device)``, which makes the tensor's card current for the call
and yields the handle of that card's current stream: a tensor on ``cuda:1``
launches on ``cuda:1`` whatever device the process has made current.

``KERNELS`` is the one list of the kernels whose launches the port counts
(``utils/profiling.kernel_launches`` reports them); a new kernel adds its
name here and names it where it counts.
"""

from __future__ import annotations

import contextlib

import torch

# each counted kernel, by the name its count goes under, with the ops module
# that launches it
KERNELS = {"blurpool_down_nhwc": "blurpool", "blurpool_up_nhwc": "blurpool",
           "flash_attention": "flash_attention", "corr_lookup": "window_gather",
           "head_conv_fwd": "head_conv", "head_conv_bwd": "head_conv",
           "batchnorm_fwd": "batchnorm", "batchnorm_bwd": "batchnorm"}
_counts = dict.fromkeys(KERNELS, 0)


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for the enclosed launch and
    yield its current stream's handle (``cudaStream_t`` as an int)."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launch(lib, entry: str, device: torch.device, *args, kernel: str | None = None):
    """Call ``lib.<entry>(*args, stream)`` with ``device`` current and its
    current stream's handle last; raise on a non-zero CUDA error, else count
    one launch of ``kernel`` where given."""
    with on_device(device) as stream:
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    if kernel is not None:
        count(kernel)


def count(kernel: str):
    """One more launch of ``kernel``, unless a CUDA graph capture only
    recorded it (its replays run no Python)."""
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        _counts[kernel] += 1


def launch_counts() -> dict[str, int]:
    """Each kernel's launches in this process since the last reset: one per
    eager launch (K5: one per ``batchnorm_cuda`` application and one per
    ``batchnorm_cuda_bwd`` call), none for a capture or a replay."""
    return dict(_counts)


def reset_counts():
    """Set every kernel's launch count to 0."""
    _counts.update(dict.fromkeys(_counts, 0))
