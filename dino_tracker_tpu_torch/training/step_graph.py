"""The train step captured once as a CUDA graph and replayed (the port of the
JAX trainer's fused step chunks, ``dino_tracker_tpu/training/train.py``
``make_train_step(..., steps_per_call=n)``).

The JAX package rolls ``steps_per_call`` iterations into one program with
``lax.scan``, so its host returns once a chunk. On CUDA the same thing (one
dispatch for n iterations, no host work between them) is a CUDA graph of one
whole step, replayed n times. ``StepGraph`` takes one real step first (the
warm-up capture needs: it builds the kernels, makes Adam's state, the cached
constants and cuBLAS's workspace on the capture stream), then captures the
step; each replay is one more real step.

Traps:

* The step's explicit ``torch.Generator`` is registered with the graph. A
  replay reads a registered generator's seed and offset and advances the
  offset by what one step draws, so replay k draws what the k-th eager step
  would. Unregistered, every replay would draw the captured batch again.
* Capture runs nothing: the parameters, BN statistics, Adam's moments, the
  schedule's count and the generator stay as the warm-up step left them, and
  the warm-up step counts as a step of the run.
* ``backward`` inside the capture allocates the gradients in the graph's
  memory pool (the step sets them to None first); every replay rewrites them.
* A kernel wrapper counts the launches it makes (``ops/blurpool.py``). A
  call inside the capture records a launch without making it and counts
  nothing, and a replay runs no Python: the kernels a replay runs are seen
  only in a trace of the card (``chip_smoke.py`` phase 5 counts them).
* A host sync inside the step (``.item()``, a pageable upload) cannot be
  captured. Capture runs under ``torch.cuda.set_sync_debug_mode("error")``,
  so such a sync raises where it is made, and the error names that line.
  Nothing falls back to the eager step.
"""

from __future__ import annotations

import contextlib
import functools
import traceback
from typing import Callable

import torch


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a card for every capture of the process: cuBLAS keeps
    a workspace for each stream it runs on, so a stream a capture would add
    a workspace each time."""
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def _syncs_raise():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class StepGraph:
    """``step`` (a whole train step, which reads and writes only tensors that
    outlive it) run once for real, then captured on ``device`` into a CUDA
    graph that ``replay`` runs again. ``generator`` is the one ``step``
    draws from. A capture that fails raises."""

    def __init__(self, step: Callable[[], None], generator: torch.Generator,
                 device: torch.device):
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(device)
        with torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                step()  # the warm-up: a real step of the run
            self.graph.register_generator_state(generator)
            try:
                with torch.cuda.graph(self.graph, stream=stream):
                    with _syncs_raise():
                        step()
            except RuntimeError as e:
                first = e
                while first.__context__ is not None:
                    first = first.__context__
                frame = traceback.extract_tb(first.__traceback__)[-1]
                raise RuntimeError(
                    f"the train step cannot be captured into a CUDA graph: "
                    f"{frame.filename}:{frame.lineno} `{frame.line}` raised: "
                    f"{first}") from e
            torch.cuda.current_stream(device).wait_stream(stream)

    def replay(self, n: int):
        """Take ``n`` more steps, with no host work or read between them."""
        with torch.cuda.device(self.device):
            for _ in range(n):
                self.graph.replay()
