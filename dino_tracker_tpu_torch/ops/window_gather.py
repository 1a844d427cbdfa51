"""RAFT correlation lookup (K3): the ctypes wrapper of ``csrc/corr_lookup.cu``
and the plain PyTorch version beside it.

The TPU kernel ``dino_tracker_tpu/ops/window_gather.py:37
_window_gather_kernel`` copied one 10×10 window per source pixel out of that
pixel's own (padded) correlation map; the JAX package then combined the four
integer-shifted 9×9 sub-windows with the pixel's bilinear weights in XLA
(``models/raft.py corr_lookup``). K3 does both in one kernel, for the four
pyramid levels of one GRU iteration, straight from the unpadded maps. Its
``.cu`` file says what bounds it on the card and what its design does about
that.

- ``window_gather_reference``: the gather alone, one window per row (JAX
  ``window_gather_reference``); the parity oracle of the TPU kernel.
- ``corr_lookup_reference``: the whole lookup, a port of the JAX
  ``corr_lookup`` gather path (pad each level by 2r+2, gather, combine; the
  grid-sample tap path for degenerate levels). It is the CPU path and K3's
  oracle.
- ``corr_lookup_cuda``: launches K3 on CUDA tensors and raises on anything
  else.

The library is built with nvcc at first use (``ops/_build.py``), never at
import. ``models/raft.py corr_lookup`` dispatches on the device.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build, _guard

CORR_LEVELS = 4
CORR_RADIUS = 4
LIBRARY = "corr_lookup"  # csrc/corr_lookup.cu
# the levels, their heights and widths, coords, out, B, h, w, stream
SIGNATURES = {"corr_lookup_fwd": (ctypes.c_int, (
    (ctypes.c_void_p,) * CORR_LEVELS + (ctypes.c_int,) * (2 * CORR_LEVELS)
    + (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p)))}


def window_gather_reference(vol: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                            side: int = 10) -> torch.Tensor:
    """out[n] = vol[n, sy[n]:sy[n]+side, sx[n]:sx[n]+side] for vol (≥N, H, W)
    and in-bounds integer starts sy, sx (N,) -> (N, side, side)."""
    k = torch.arange(side, device=vol.device)
    rows = (sy.long()[:, None] + k)[:, :, None]
    cols = (sx.long()[:, None] + k)[:, None, :]
    n = torch.arange(sy.shape[0], device=vol.device)[:, None, None]
    return vol[n, rows, cols]


def _tap_lookup(vol: torch.Tensor, centre: torch.Tensor, r: int) -> torch.Tensor:
    """The JAX package's grid-sample tap path for a level with a side under
    2 (``raft.py:323-338``): 81 taps per pixel, an axis of size 1 sends every
    tap's coordinate to 0. vol (N, hl, wl), centre (N, 2) -> (N, 81)."""
    _, hl, wl = vol.shape
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=vol.device)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([di, dj], dim=-1).reshape(-1, 2)  # (dx, dy), dx-major
    pts = centre[:, None, :] + delta[None]
    gx = (2 * pts[..., 0] / (wl - 1) - 1 if wl > 1 else torch.zeros_like(pts[..., 0]))
    gy = (2 * pts[..., 1] / (hl - 1) - 1 if hl > 1 else torch.zeros_like(pts[..., 1]))
    grid = torch.stack([gx, gy], dim=-1)[:, None]  # N×1×81×2
    return F.grid_sample(vol[:, None], grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)[:, 0, 0]


def corr_lookup_reference(pyramid: Sequence[torch.Tensor],
                          coords: torch.Tensor) -> torch.Tensor:
    """The 9×9 windows (radius r = 4) of every level at coords / 2^l ->
    B×(L·81)×h×w f32.

    pyramid: L levels of (B·h·w, h_l, w_l) f32; coords: B×2×h×w pixel (x, y).
    Channel l·81 + i·9 + j samples (x/2^l + i - r, y/2^l + j - r): the x
    offset is the slower index. Taps outside a map read 0 (grid_sample zero
    padding): each level is padded by 2r+2 and the centre clamped just past
    the all-outside boundary, so every window lies inside the padded map."""
    b, _, h, w = coords.shape
    r = CORR_RADIUS
    side = pad = 2 * r + 2
    win = 2 * r + 1
    xy = coords.permute(0, 2, 3, 1).reshape(-1, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        n, hl, wl = vol.shape
        c = xy / (2 ** lvl)
        if hl < 2 or wl < 2:
            out.append(_tap_lookup(vol, c, r))
            continue
        cx = torch.clamp(c[:, 0], -(r + 1.0), wl - 1 + r + 1.0)
        cy = torch.clamp(c[:, 1], -(r + 1.0), hl - 1 + r + 1.0)
        x0, y0 = torch.floor(cx), torch.floor(cy)
        fx, fy = (cx - x0)[:, None], (cy - y0)[:, None]
        patch = window_gather_reference(F.pad(vol, (pad, pad, pad, pad)),
                                        (y0 - r + pad).long(), (x0 - r + pad).long(),
                                        side)  # N×10×10 (y, x)

        def sub(dy, dx):  # the 9×9 window shifted by (dy, dx), dx-major
            return patch[:, dy:dy + win, dx:dx + win].transpose(1, 2).reshape(n, -1)

        out.append((1 - fy) * (1 - fx) * sub(0, 0) + (1 - fy) * fx * sub(0, 1)
                   + fy * (1 - fx) * sub(1, 0) + fy * fx * sub(1, 1))
    return torch.cat(out, dim=1).reshape(b, h, w, -1).permute(0, 3, 1, 2).contiguous()


def load_library():
    return _build.load(LIBRARY, SIGNATURES)


def _check(pyramid: Sequence[torch.Tensor], coords: torch.Tensor):
    if coords.device.type != "cuda":
        raise ValueError(f"corr_lookup_cuda needs CUDA tensors, coords are on "
                         f"{coords.device}")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords must be B×2×h×w, got {tuple(coords.shape)}")
    b, _, h, w = coords.shape
    if len(pyramid) != CORR_LEVELS:
        raise ValueError(f"corr_lookup_cuda takes {CORR_LEVELS} levels, got "
                         f"{len(pyramid)}")
    for name, t in [("coords", coords)] + [(f"level {i}", v)
                                           for i, v in enumerate(pyramid)]:
        if t.device != coords.device:
            raise ValueError(f"corr_lookup_cuda: {name} is on {t.device}, "
                             f"coords on {coords.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"corr_lookup_cuda takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"corr_lookup_cuda needs contiguous tensors, {name} "
                             f"is not")
    for i, v in enumerate(pyramid):
        if v.dim() != 3 or v.shape[0] != b * h * w or min(v.shape[1:]) < 1:
            raise ValueError(f"level {i} must be (B·h·w = {b * h * w}, h_l ≥ 1, "
                             f"w_l ≥ 1), got {tuple(v.shape)}")
        if v.shape[1] * v.shape[2] >= 2 ** 31 or b * h * w >= 2 ** 31:
            raise ValueError("corr_lookup_cuda: a map, or B·h·w source pixels, "
                             "of 2^31 or more")


def corr_lookup_cuda(pyramid: Sequence[torch.Tensor],
                     coords: torch.Tensor) -> torch.Tensor:
    """Launch K3: the lookup of ``corr_lookup_reference`` (radius 4, four
    levels) on contiguous f32 CUDA tensors -> B×324×h×w f32."""
    _check(pyramid, coords)
    lib, _ = load_library()
    b, _, h, w = coords.shape
    out = torch.empty((b, CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, h, w),
                      dtype=torch.float32, device=coords.device)
    sizes = [s for v in pyramid for s in v.shape[1:]]
    _guard.launch(lib, "corr_lookup_fwd", coords.device, *[v.data_ptr() for v in pyramid],
                  *sizes, coords.data_ptr(), out.data_ptr(), b, h, w, kernel="corr_lookup")
    return out
