"""Data parallelism of the port over ranks (port of
dino_tracker_tpu/parallel/mesh.py).

The JAX package shards one program over a one-axis device mesh (``data``):
the train step's point batch and DeltaDINO frame set, the cycle loss's
per-pair point axis, the refine cache's frames and inference's flat
prediction rows, with parameters replicated and XLA inserting the gradient
psum; in preprocessing the ViT frames, RAFT's frames and pairs, the
best-buddy pairs and the ambiguity rows. The port runs the same layout the
way PyTorch does: one process per rank under ``torch.distributed`` (NCCL
with one card per rank; gloo on the CPU), every rank holding the whole
model, the whole video and the same random generator, and taking its share
of each sharded axis (``split_rows``). Collectives are the port's own autograd Functions: the
gather of a sharded axis (``all_gather_rows``, whose backward sums the
cotangent over ranks and keeps this rank's rows) and a differentiable sum
(``all_reduce_sum``); ``torch.distributed.nn`` is deprecated and
``nn.SyncBatchNorm`` refuses CPU tensors.

Preprocessing shards lists of batches instead of rows (``split_batches``):
each rank runs a contiguous share of the one-device path's batches (ViT
frame batches, RAFT decode batches, best-buddy pair batches, ambiguity
slabs), each batch whole, so every call a rank makes is one the one-device
path makes, at its shape; ``gather_batches`` puts the outputs back together
in batch order on every rank, whatever their dtype. ``broadcast_object``
hands rank 0's decision (a small host value) to every rank.

The train step's collectives are capture-safe: over NCCL each rank captures
its whole step, collectives included, into a CUDA graph
(``training/step_graph.py``); ``capture_blocker`` says where that cannot be
(gloo), and ``agree`` gathers the ranks' capture outcomes over host memory
so that one rank's failure raises on all.

``spawn`` starts the ranks and returns what each one returned. A world of
size 1 (``mesh=None`` everywhere) is the single-device path and needs no
process group. ``spawn(..., share_device=True)`` puts every rank on one card
over gloo (gloo stages CUDA collectives through host memory); it exists so
that a machine with one card can run the multi-rank path, and only the tests
and the smoke script use it.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the world: its rank, the world size, the
    device it computes on, the process group of the collectives, and a
    group over host memory (gloo) for the votes ``agree`` takes (None: the
    collectives' group, which is gloo itself)."""
    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    host_group: Any = None


def world_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world_size


def is_parallel(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.world_size > 1


def is_main(mesh: Optional[Mesh]) -> bool:
    """Rank 0, or the single-device path: the process that writes files."""
    return mesh is None or mesh.rank == 0


def split_sizes(n: int, parts: int) -> list[int]:
    """The sizes ``torch.tensor_split`` gives ``n`` rows in ``parts``: the
    first ``n % parts`` parts one row longer."""
    q, r = divmod(n, parts)
    return [q + 1] * r + [q] * (parts - r)


def row_range(n: int, mesh: Optional[Mesh]) -> tuple[int, int]:
    """[start, stop) of this rank's rows of an axis of ``n``."""
    if not is_parallel(mesh):
        return 0, n
    sizes = split_sizes(n, mesh.world_size)
    start = sum(sizes[:mesh.rank])
    return start, start + sizes[mesh.rank]


def split_rows(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """This rank's share of ``x`` along ``dim`` (uneven as
    ``torch.tensor_split``); all of it on a single device."""
    if not is_parallel(mesh):
        return x
    start, stop = row_range(x.shape[dim], mesh)
    return x.narrow(dim, start, stop - start)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; every rank gets the sum. Each rank's loss depends on
    the sum it holds, so the cotangent of every rank's input is the sum of
    the ranks' cotangents: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Differentiable sum of ``x`` over ranks (``x`` itself on one device)."""
    if not is_parallel(mesh):
        return x
    return _AllReduceSum.apply(x, mesh.group)


def _gather_padded(x: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    """Every rank's rows in rank order: each rank's ``x`` (``sizes[rank]``
    rows) padded to the longest, one all_gather, the padding dropped. bool
    travels as uint8, which gloo and NCCL both take."""
    if x.dtype == torch.bool:
        return _gather_padded(x.view(torch.uint8), sizes, group).view(torch.bool)
    longest = max(sizes)
    if x.shape[0] < longest:
        x = torch.cat([x, x.new_zeros((longest - x.shape[0], *x.shape[1:]))])
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


class _GatherRows(torch.autograd.Function):
    """The whole axis from every rank's rows. Every rank's loss may depend on
    every row, so a row's cotangent is the sum over ranks of the cotangents
    of the gathered axis: an all-reduce, then this rank's rows. (gloo has no
    reduce-scatter; the all-reduce moves twice its bytes.)"""

    @staticmethod
    def forward(ctx, x, sizes, rank, group):
        ctx.sizes, ctx.rank, ctx.group = sizes, rank, group
        return _gather_padded(x, sizes, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = sum(ctx.sizes[:ctx.rank])
        return g[start:start + ctx.sizes[ctx.rank]], None, None, None


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh], n: int,
                    dim: int = 0) -> torch.Tensor:
    """Inverse of ``split_rows``: this rank's share of an axis of ``n`` along
    ``dim`` -> the whole axis, on every rank; differentiable."""
    if not is_parallel(mesh):
        return x
    sizes = split_sizes(n, mesh.world_size)
    if x.shape[dim] != sizes[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {x.shape[dim]} rows of an axis "
                         f"of {n}; split_rows gives it {sizes[mesh.rank]}")
    y = _GatherRows.apply(x.movedim(dim, 0), tuple(sizes), mesh.rank, mesh.group)
    return y.movedim(0, dim)


def capture_blocker(mesh: Optional[Mesh]) -> Optional[str]:
    """None where the train step's collectives can be captured into a CUDA
    graph (``training/step_graph.py``): no mesh, or NCCL, which puts one card
    under each rank (it refuses two ranks on one card) and whose collectives
    are kernels on the ranks' streams. Else why not: gloo stages a CUDA
    collective through host memory and waits for it on the host, which no
    graph can hold (the CPU, ``share_device``). Decided from the backend,
    before any step runs."""
    if not is_parallel(mesh):
        return None
    backend = dist.get_backend(mesh.group)
    if backend != "nccl":
        return (f"{backend} collectives go through host memory and cannot be "
                f"captured into a CUDA graph")
    return None


def agree(error: Optional[str], summary: Any, mesh: Optional[Mesh], what: str):
    """Raise on every rank unless every rank did ``what`` alike: each rank's
    outcome (``error``, None where it succeeded) and ``summary`` (a small
    host value that must be equal on every rank) are gathered eagerly, so a
    rank that failed makes every rank raise instead of leaving its peers
    blocked in a collective it will never join. The vote goes over
    ``mesh.host_group`` (gloo), never through the NCCL communicator, which
    a capture that failed part-way may have left holding work its peers do
    not. On one device: raise if ``error``."""
    if not is_parallel(mesh):
        if error is not None:
            raise RuntimeError(f"{what}: {error}")
        return
    every = [None] * mesh.world_size
    host = mesh.host_group if mesh.host_group is not None else mesh.group
    dist.all_gather_object(every, (error, summary), group=host)
    failed = [f"rank {r}: {e}" for r, (e, _) in enumerate(every) if e is not None]
    if failed:
        raise RuntimeError(f"{what} failed on {len(failed)} of {mesh.world_size} "
                           f"ranks; " + "; ".join(failed))
    if any(s != every[0][1] for _, s in every):
        raise RuntimeError(f"{what} differs between ranks: "
                           + "; ".join(f"rank {r}: {s}" for r, (_, s) in enumerate(every)))


def broadcast_object(value: Any, mesh: Optional[Mesh], src: int = 0) -> Any:
    """Rank ``src``'s ``value`` (a small picklable host value) on every rank;
    ``value`` itself on one device. For a decision every rank must take
    alike though only rank 0 may look (a file rank 0 is about to write)."""
    if not is_parallel(mesh):
        return value
    box = [value if mesh.rank == src else None]
    # NCCL moves CUDA tensors only; gloo takes host tensors on any rank
    device = mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    dist.broadcast_object_list(box, src=src, group=mesh.group, device=device)
    return box[0]


def split_batches(batch_rows: Sequence[int], mesh: Optional[Mesh], first: int = 0
                  ) -> tuple[range, list[int]]:
    """Whole batches for each rank: ``batch_rows[i]`` is what batch i of the
    one-device path yields. Returns this rank's batch indices (a contiguous
    range in rank order: the batch count split as ``split_sizes`` splits it,
    its longer shares going to the ranks from ``first`` on, cyclically) and
    each rank's rows, the sum over its batches, which ``gather_batches``
    takes. A caller of many short calls moves ``first`` on by each call's
    batch count, so the ranks' loads differ by one batch at most. One
    device: every batch."""
    w = world_size(mesh)
    sizes = split_sizes(len(batch_rows), w)
    parts = [sizes[(r - first) % w] for r in range(w)]
    ends = np.cumsum([0] + parts).tolist()
    rows = [int(sum(batch_rows[a:b])) for a, b in zip(ends[:-1], ends[1:])]
    rank = 0 if mesh is None else mesh.rank
    return range(ends[rank], ends[rank + 1]), rows


def gather_batches(outputs: Sequence[Sequence[torch.Tensor]], rows: Sequence[int],
                   mesh: Optional[Mesh], name: str, n_out: int = 1) -> list[torch.Tensor]:
    """The outputs of every rank's batches, in batch order, on every rank.

    ``outputs`` holds one tuple of ``n_out`` tensors for each batch this rank
    ran (``split_batches``), batch rows leading; returns ``n_out`` tensors,
    each its batches' concatenation over every rank (any dtype). A rank
    with no batch learns the trailing shape and dtype from the first rank
    with one: call it with at least one batch in all. Each
    gather is timed, its bytes beside it, as the stage timer
    ``gather/<name>`` (waiting for the slowest rank included)."""
    cat = [torch.cat([o[i] for o in outputs]) if outputs else None for i in range(n_out)]
    if not is_parallel(mesh):
        return cat
    if sum(rows) == 0:
        raise ValueError("gather_batches needs at least one batch over the ranks")
    if min(rows) == 0:
        src = next(r for r, n in enumerate(rows) if n)
        metas = broadcast_object(None if cat[0] is None else
                                 [(tuple(x.shape[1:]), x.dtype) for x in cat], mesh, src)
        cat = [torch.empty((0, *shape), dtype=dtype, device=mesh.device)
               if x is None else x for x, (shape, dtype) in zip(cat, metas)]
    out = []
    for x in cat:
        nbytes = sum(rows) * int(np.prod(x.shape[1:])) * x.element_size()
        profiling.device_fence(x.device)
        with profiling.stage_timer(f"gather/{name}", fence=x.device, nbytes=nbytes):
            out.append(_gather_padded(x, rows, mesh.group))
    return out


def grad_set(model: torch.nn.Module) -> tuple:
    """The indices of the parameters that hold a gradient: the bucket
    ``all_reduce_grads`` sums."""
    return tuple(i for i, p in enumerate(model.parameters()) if p.grad is not None)


def all_reduce_grads(model: torch.nn.Module, mesh: Optional[Mesh]):
    """Sum every parameter's gradient over ranks in one flat bucket (the
    psum XLA inserts for replicated parameters). Every rank must hold
    gradients for the same parameters (``grad_set``): a captured step
    checks it across ranks and against its warm-up step
    (``training/step_graph.py``)."""
    if not is_parallel(mesh):
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier(mesh: Optional[Mesh]):
    """Wait until every rank got here (an all-reduce on the ranks' devices,
    which every backend takes)."""
    if is_parallel(mesh):
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad ``axis`` up to a multiple by repeating the last slice (the JAX
    package's copy, mesh.py:62-73)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    last = np.take(x, [-1], axis=axis)
    reps = [1] * x.ndim
    reps[axis] = rem
    return np.concatenate([x, np.tile(last, reps)], axis=axis)


def check_devices(n_devices: int, device_type: str, share_device: bool = False):
    """Raise unless ``n_devices`` ranks can each get what they need: one
    CUDA card each (or one card for all with ``share_device``), or the
    CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type {device_type!r}: ranks run on 'cuda' or 'cpu'")
    if n_devices < 1:
        raise ValueError(f"{n_devices} ranks")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        need = 1 if share_device else n_devices
        if have < need:
            raise RuntimeError(
                f"{n_devices} ranks need {need} CUDA device(s) and {have} are "
                f"visible: nothing runs on fewer ranks or on the CPU instead")


def _rank_main(rank, fn, n, device_type, share_device, workdir, args):
    if device_type == "cuda":
        index = 0 if share_device else rank
        torch.cuda.set_device(index)  # before any other CUDA call of the rank
        device = torch.device("cuda", index)
        backend = "gloo" if share_device else "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    # the ranks share one host: their sockets stay on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = dist.FileStore(os.path.join(workdir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    # agree's votes stay off NCCL
    host = dist.new_group(backend="gloo") if backend == "nccl" else None
    try:
        out = fn(Mesh(rank, n, device, dist.group.WORLD, host), *args)
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    except BaseException:
        # a rank that fails closes its connections, and its peers then fail
        # in their next collective: each rank leaves its own traceback
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _rank_errors(workdir: str, n: int) -> list:
    """The tracebacks the failed ranks of a ``spawn`` left, in rank order."""
    return [f"rank {r}:\n{open(path).read()}" for r in range(n)
            if os.path.exists(path := os.path.join(workdir, f"error_{r}.txt"))]


def spawn(fn: Callable, n_devices: int, device_type: str = "cuda",
          args: tuple = (), share_device: bool = False,
          timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``n_devices`` ranks, one spawned process
    each, and return each rank's return value (moved to host memory), in
    rank order.

    Rank r binds ``cuda:r`` (NCCL), or with ``share_device`` every rank binds
    ``cuda:0`` (gloo); ``device_type="cpu"`` runs gloo ranks on
    the CPU. Rendezvous is a ``FileStore`` in a temporary directory: no port,
    no network. ``fn`` and ``args`` must pickle (``fn`` a module-level
    function). A rank that raises makes ``spawn`` stop the others and raise;
    so does a run longer than ``timeout`` seconds. The error lists every
    failed rank's traceback: the first rank to fail need not be the first
    one reported. A rank that failed may not exit (NCCL's teardown waits
    for peers blocked in a collective it left), so the timeout's error
    lists the tracebacks of the ranks that failed before it too."""
    check_devices(n_devices, device_type, share_device)
    workdir = tempfile.mkdtemp(prefix="mesh-")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=n_devices, join=False, start_method="spawn",
            args=(fn, n_devices, device_type, share_device, workdir, tuple(args)))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None
                               else max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.terminate()
                    for p in ctx.processes:
                        p.join()
                    errors = _rank_errors(workdir, n_devices)
                    raise TimeoutError(f"{n_devices} ranks did not finish in {timeout} s; "
                                       f"{len(errors)} failed before\n" + "\n".join(errors))
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            errors = _rank_errors(workdir, n_devices)
            raise RuntimeError(f"{len(errors)} of {n_devices} ranks failed\n"
                               + "\n".join(errors or [str(e)])) from e
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n_devices)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
