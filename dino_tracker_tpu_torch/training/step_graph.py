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
* A kernel's launches are counted as they are made (``ops/_guard.py``). A
  call inside the capture records a launch without making it and counts
  nothing, and a replay runs no Python: the kernels a replay runs are seen
  only in a trace of the card (``chip_smoke.py`` phase 5 counts them).
* A host sync inside the step (``.item()``, a pageable upload) cannot be
  captured. Capture runs under ``torch.cuda.set_sync_debug_mode("error")``,
  so such a sync raises where it is made, and the error names that line.
  Nothing falls back to the eager step.

On a mesh (NCCL, one card a rank; ``mesh.capture_blocker``) each rank
captures its own graph of the whole data-parallel step, collectives
included, and replays it:

* NCCL's communicator is made at a group's first collective, with
  allocations and host waits that no capture can hold. The warm-up step runs
  every collective of the step, so the communicator exists before capture.
* ProcessGroupNCCL runs a collective on its own stream, which joins the
  capture through events, so the graph holds NCCL's kernels. A replay
  launches them; NCCL pairs the ranks' kernels in launch order, so every
  rank must replay the same steps: each rank captures and replays at the
  same iterations (``StepRunner`` decides from what every rank holds alike).
* The capture error mode is ``thread_local``, not PyTorch's default
  ``global``. In global mode a CUDA call that is unsafe during a capture
  fails, and invalidates that capture, from any thread of the process;
  ProcessGroupNCCL's watchdog thread polls the CUDA events of the eager
  collectives it tracks (the warm-up step's among them) on its own
  schedule. Thread-local mode
  confines the rule to the capturing thread. The sync check stays whole:
  ``set_sync_debug_mode`` is process-wide, so it also raises on autograd's
  device thread, where the backward runs. (``scripts/probe_nccl_capture.py``
  captures NCCL collectives in each mode.)
* The backward and its collectives run on autograd's device thread, on the
  stream of the forward (the capture stream), so they land in the capture.
* Capture runs nothing, so a rank whose capture fails leaves the others
  holding graphs whose first replay would wait in NCCL for it. Every rank's
  outcome, and the gradient set ``all_reduce_grads`` sums, are therefore
  gathered eagerly before any replay (``mesh.agree``): a failure or a
  differing gradient set on any rank raises on every rank. The vote goes
  over the mesh's gloo group, not NCCL: a capture that failed after the
  step's first collectives leaves that rank's communicator with work
  recorded that its peers recorded more of, and nothing that follows a
  failure may depend on it. (The warm-up step may sync: it fills the
  caches of constants the step reads.)
"""

from __future__ import annotations

import contextlib
import functools
import traceback
from typing import Callable

import torch

from ..parallel import mesh as mesh_lib

# see the module docstring
CAPTURE_ERROR_MODE = "thread_local"


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
    """``step`` (a whole train step of ``model``, which reads and writes only
    tensors that outlive it) run once for real, then captured on the card
    of ``generator`` (the one ``step`` draws from) into a CUDA graph that
    ``replay`` runs again. The capture must leave the gradient set
    ``all_reduce_grads`` sums (``mesh.grad_set``) as the warm-up did, alike
    on every rank of ``mesh``. A capture that fails raises, on every rank.

    ``captures`` and ``replays`` count, over the process, the captures made
    and the steps replayed (as ``ops/_guard.py`` counts kernel launches)."""

    captures = replays = 0

    def __init__(self, step: Callable[[], None], generator: torch.Generator,
                 model: torch.nn.Module, mesh=None):
        device = generator.device
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(device)
        error = cause = None
        what = "capturing the train step into a CUDA graph"
        with torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                step()  # the warm-up: a real step of the run
            before = mesh_lib.grad_set(model)
            self.graph.register_generator_state(generator)
            try:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode=CAPTURE_ERROR_MODE):
                    with _syncs_raise():
                        step()
            except RuntimeError as e:
                cause = first = e
                while first.__context__ is not None:
                    first = first.__context__
                frame = traceback.extract_tb(first.__traceback__)[-1]
                error = (f"{frame.filename}:{frame.lineno} `{frame.line}` raised: "
                         f"{first}")
            after = mesh_lib.grad_set(model)
            if error is None and after != before:
                error = f"the warm-up step left {before}, the captured one {after}"
            torch.cuda.current_stream(device).wait_stream(stream)
        try:  # before any replay: a rank's NCCL kernels would wait for a dead peer
            mesh_lib.agree(error, after, mesh, what)
        except RuntimeError as e:
            self.graph.reset()  # its kernels, NCCL's among them, go now
            raise e from cause
        StepGraph.captures += 1

    def replay(self, n: int):
        """Take ``n`` more steps, with no host work or read between them."""
        with torch.cuda.device(self.device):
            for _ in range(n):
                self.graph.replay()
        StepGraph.replays += n
