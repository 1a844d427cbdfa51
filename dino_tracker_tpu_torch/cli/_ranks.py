"""``--devices N`` of the port's preprocessing, training and inference CLIs.

0 or 1: one process on ``--device``. N > 1: N processes under
``torch.distributed`` (``parallel/mesh.py``): with ``--device cuda`` rank r
on ``cuda:r`` over NCCL (fewer than N cards raise), with ``--device cpu`` N
gloo processes on the CPU, and with ``--share-device`` every rank on
``cuda:0`` over gloo, a mode for machines with one card.
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..parallel import mesh as mesh_lib


def add_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--devices", type=int, default=0,
                        help="data-parallel ranks: 0 or 1 run on --device; N > 1 "
                             "runs one process per rank, rank r on cuda:r (NCCL), "
                             "or N gloo processes with --device cpu")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on")
    parser.add_argument("--share-device", action="store_true",
                        help="with --devices N > 1 and --device cuda: every rank on "
                             "cuda:0, over gloo (for machines with one card)")


def run(work, args: argparse.Namespace) -> list:
    """``work(mesh, args)`` on the ranks ``args`` ask for (``mesh`` None on
    one device); returns each rank's return value, in rank order. A rank
    that fails makes this raise."""
    if args.devices < 0:
        raise ValueError(f"--devices {args.devices}: give 0, 1 or a rank count")
    if args.devices <= 1:
        return [work(None, args)]
    device = torch.device(args.device)
    if device.index is not None:
        raise ValueError(f"--devices {args.devices} puts rank r on cuda:r; pass "
                         f"--device {device.type}, not {device}")
    return mesh_lib.spawn(work, args.devices, device.type, args=(args,),
                          share_device=args.share_device)


def setup(mesh, args) -> torch.device:
    """A rank's logging (tagged with its rank) and device."""
    fmt = logging.BASIC_FORMAT
    if mesh is not None:
        fmt = f"[rank {mesh.rank}] {fmt}"
    logging.basicConfig(level=logging.INFO, format=fmt)
    return mesh.device if mesh is not None else torch.device(args.device)
