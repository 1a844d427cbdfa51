"""Flow engine: adjacent and direct RAFT flows with cycle masks (port of
``dino_tracker_tpu/preprocessing/flow.py``).

Behaviour of the reference's ``get_flows_with_masks`` and
``compute_direct_flows_for_start_frame`` (preprocessing/
extract_trajectories.py:29-160). As in the JAX package, the per-frame
encoders run once per frame (``models/raft.py raft_encode``) and stay on the
device; every pair then runs only ``raft_decode``, in batches of
``pair_batch`` pairs. A short last batch is padded to ``pair_batch`` pairs by
repeating its last pair, as the JAX package pads it, though for another
reason: with TF32 off, cuDNN's f32 algorithm choice at 4-7 pairs ran a
decode batch in 3.4-4.0 s on an H100, against 0.45 s at 8 pairs and 0.06-0.12
s at 1-3 (PERF.md).

With a mesh (JAX ``flow.py:44-245``) each rank encodes its share of the
encoder's frame batches and decodes its share of the decode batches, each
batch whole and padded as on one device, so no rank decodes another batch
size (the JAX layout, a global batch split over the ranks, would hand each
of 2 ranks 4 pairs); encodings and flows are gathered in order on every
rank, and the cycle masks computed after the gather.

Not ported (XLA dispatch and TPU relay work): ``direct_sweep_traceable``,
the ``_decode_jit``/``_sweep_jit`` programs and ``retry_transient``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import raft
from ..parallel import mesh as mesh_lib
from ..utils.sampling import bilinear_sampler_pixel


@dataclasses.dataclass
class RaftFlowEngine:
    """A RAFT model and a video; serves flow queries on ``device``."""

    model: raft.RAFT  # on ``device``
    video_tchw: torch.Tensor  # T×3×H×W f32 in [0, 1] at the model resolution
    num_iters: int = 24
    pair_batch: int = 8
    encode_batch: int = 8
    compute_dtype: torch.dtype = torch.float32  # convs; corr and flow stay f32
    device: torch.device = torch.device("cuda")
    mesh: Optional[mesh_lib.Mesh] = None  # ranks sharing the batches

    def __post_init__(self):
        self.t, _, self.h, self.w = self.video_tchw.shape
        self.padder = raft.InputPadder(self.video_tchw.shape)
        self._enc = None  # (fmap, net, inp), T leading, on the device
        self._adj = None  # cached adjacent flows
        # pairs in each raft_decode call this process made -> calls
        self.decode_batch_sizes = collections.Counter()
        self._first_rank = 0  # the rank the next call's longer shares start at

    def encodings(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The encoders' outputs for every frame, computed once, in batches
        of ``encode_batch`` frames (this rank's batches, then gathered)."""
        if self._enc is None:
            video = self.video_tchw.to(self.device)
            starts = range(0, self.t, self.encode_batch)
            mine, rows = mesh_lib.split_batches(
                [min(self.encode_batch, self.t - s) for s in starts], self.mesh)
            outputs = [raft.raft_encode(self.model,
                                        self.padder.pad(video[s:s + self.encode_batch]),
                                        self.compute_dtype)
                       for s in (starts[i] for i in mine)]
            self._enc = tuple(mesh_lib.gather_batches(outputs, rows, self.mesh,
                                                      "raft_encodings", 3))
        return self._enc

    def decode(self, idx_a: np.ndarray, idx_b: np.ndarray) -> torch.Tensor:
        """Flow a→b for at most ``pair_batch`` pairs of frame indices ->
        N×2×h×w, unpadded; the batch runs padded to ``pair_batch`` pairs."""
        n = len(idx_a)
        if not 1 <= n <= self.pair_batch:
            raise ValueError(f"decode takes 1..{self.pair_batch} pairs, got {n}")
        fill = self.pair_batch - n
        ia, ib = (torch.as_tensor(np.concatenate([idx, np.repeat(idx[-1:], fill)]),
                                  dtype=torch.long, device=self.device)
                  for idx in (np.asarray(idx_a), np.asarray(idx_b)))
        fmaps, nets, inps = self.encodings()
        self.decode_batch_sizes[len(ia)] += 1
        flow = raft.raft_decode(self.model, fmaps[ia], fmaps[ib], nets[ia], inps[ia],
                                self.num_iters)
        return self.padder.unpad(flow[:n])

    def _batches(self, idx_a: np.ndarray, idx_b: np.ndarray
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Index arrays cut into decode batches of ``pair_batch`` pairs."""
        bsz = self.pair_batch
        return [(idx_a[s:s + bsz], idx_b[s:s + bsz]) for s in range(0, len(idx_a), bsz)]

    def _decode_batches(self, batches) -> torch.Tensor:
        """Flow a→b of every pair of ``batches`` (``_batches``' pieces), in
        order -> N×2×h×w on the device: this rank decodes its share of the
        batches, the flows are gathered. The longer shares of successive
        calls go round the ranks, so over a sweep of short calls the ranks'
        decodes differ by one at most (on the first ranks alone, 4 ranks
        would decode 104, 104, 78 and 78 of the 364 batches of T=50)."""
        mine, rows = mesh_lib.split_batches([len(a) for a, _ in batches], self.mesh,
                                            first=self._first_rank)
        self._first_rank = (self._first_rank + len(batches)) % mesh_lib.world_size(self.mesh)
        flows = [(self.decode(*batches[i]),) for i in mine]
        return mesh_lib.gather_batches(flows, rows, self.mesh, "raft_flows")[0]

    def adjacent_flows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """((t-1)×2×h×w forward i→i+1, backward i+1→i) on the device.
        Cached: both trajectory passes read them."""
        if self._adj is None:
            idx = np.arange(self.t - 1)
            flows = self._decode_batches(self._batches(idx, idx + 1)
                                         + self._batches(idx + 1, idx))
            self._adj = (flows[:self.t - 1], flows[self.t - 1:])
        return self._adj

    def direct_flows(self, start: int, threshold: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Direct flows start→f for every f > start with their cycle masks
        (reference :99-160), on the device and padded to the full frame
        count: ((t-1)×h×w×2 flows, (t-1)×h×w f32 masks); rows ≥ t-1-start
        are zero. The batches of start→f pairs and of f→start pairs are one
        axis of decode batches (shared by the ranks of a mesh)."""
        tm1 = self.t - 1
        flows = torch.zeros((tm1, self.h, self.w, 2), device=self.device)
        masks = torch.zeros((tm1, self.h, self.w), device=self.device)
        targets = np.arange(start + 1, self.t)
        k = len(targets)
        if k:
            sources = np.full_like(targets, start)
            both = self._decode_batches(self._batches(sources, targets)
                                        + self._batches(targets, sources))
            fwd, bwd = both[:k], both[k:]
            flows[:k] = fwd.permute(0, 2, 3, 1)
            masks[:k] = cycle_masks_batched(fwd, bwd, threshold).float()
        return flows, masks


def cycle_masks_batched(fwd_n2hw: torch.Tensor, bwd_n2hw: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Warp forward, sample the backward flow at the warped point, keep the
    pixels that return within ``threshold`` and whose warped point lies in
    the frame (reference :143-160; JAX ``flow.py:246-261``) -> N×h×w bool."""
    _, _, h, w = fwd_n2hw.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=fwd_n2hw.device),
                            torch.arange(w, dtype=torch.float32, device=fwd_n2hw.device),
                            indexing="ij")
    coords = torch.stack([xs, ys], dim=-1)[None]  # 1×h×w×2
    coords1 = coords + fwd_n2hw.permute(0, 2, 3, 1)
    warped_b = bilinear_sampler_pixel(bwd_n2hw, coords1)
    coords2 = coords1 + warped_b.permute(0, 2, 3, 1)
    err = torch.sqrt(((coords - coords2) ** 2).sum(dim=-1))
    upper = torch.tensor([w - 1.0, h - 1.0], device=fwd_n2hw.device)
    in_b = ((coords1 >= 0) & (coords1 <= upper)).all(dim=-1)
    return (err < threshold) & in_b
