"""The yardstick's operation and byte counts equal a hand count at small
shapes."""

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from yardstick import counts, peaks


def test_k1_counts_by_hand():
    # 1×5×6×2: the half-size tensor is 1×3×3×2 = 18 values, 16 FMAs each
    flops, nbytes = counts.k1_counts((1, 5, 6, 2), itemsize=2)
    assert flops == 32 * 18 and nbytes == (60 + 18) * 2
    assert counts.k1_bound_s((1, 5, 6, 2)) == max(flops / peaks.BF16_FLOPS,
                                                  nbytes / peaks.HBM_BYTES)


def test_k2_counts_by_hand():
    # QK^T and PV: 2 GEMMs of s×s×d multiply-adds per head
    flops, nbytes = counts.k2_counts(2, 3, 5, 4)
    assert flops == 2 * 3 * (2 * 2 * 5 * 5 * 4) and nbytes == 4 * (2 * 3 * 5 * 4) * 2


def test_k3_counts_by_hand():
    # one pixel at (1.5, 1.5) into a 4×4 and a 2×2 level, radius 1 (4×4
    # windows): level 0 window x, y in [0, 4) -> 16 cells; level 1 at
    # (0.75, 0.75): floor - 1 = -1 -> [0, 2) -> 4 cells
    coords = torch.tensor([[[[1.5]], [[1.5]]]])
    cells = counts.k3_in_map_cells([(4, 4), (2, 2)], coords, radius=1)
    assert cells == 20
    flops, nbytes = counts.k3_counts(cells, 1, levels=2, radius=1)
    assert flops == 7 * 18 and nbytes == 4 * 20 + 8 + 4 * 18


def _measured(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_delta_dino_and_head_flops_match_torch_flop_counter():
    ch, h, w = (3, 4, 6, 8, 16), 20, 28
    terms = counts.delta_dino_frame_flops(ch, h, w)
    x = torch.zeros(1, ch[0], h, w)
    for (name, f), i in zip(terms.items(), range(4)):
        wt = torch.zeros(ch[i + 1], ch[i], 5, 5)
        assert f == _measured(lambda: F.conv2d(x, wt, padding=2)), name
        x = torch.zeros(1, ch[i + 1], (x.shape[2] + 1) // 2 if i < 3 else x.shape[2],
                        (x.shape[3] + 1) // 2 if i < 3 else x.shape[3])
    maps = torch.zeros(1, 1, 9, 13)
    w1, w2 = torch.zeros(16, 1, 3, 3), torch.zeros(1, 16, 3, 3)
    assert counts.head_map_flops(9 * 13) == _measured(
        lambda: F.conv2d(F.conv2d(maps, w1, padding=1), w2, padding=1))


def test_train_step_terms_by_hand():
    train = {"batch_n_frames": 2, "train_batch_size": 6, "cyc_n_frames": 2,
             "cyc_batch_size_per_frame": 3, "cl_n_frames": 2, "cl_points_per_pair": 4}
    ch, hw, c = (3, 4, 6, 8, 16), (9, 13), 16
    on = counts.train_step_terms(train, (70, 98), hw, ch, True, True)
    off = counts.train_step_terms(train, (70, 98), hw, ch, False, False)
    n = 9 * 13
    corr = lambda b: _measured(lambda: torch.zeros(b, c) @ torch.zeros(c, n))
    assert on["flow: correlation, fwd+bwd"] == 3 * corr(6)
    assert on["cycle: filter, two predictions, no grad"] == 2 * (corr(6) + 6 * counts.head_map_flops(n))
    assert on["refined best buddies: mining affinity, no grad"] == 2 * _measured(
        lambda: torch.zeros(n, c) @ torch.zeros(c, n))
    assert on["dino best buddies: InfoNCE, fwd+bwd"] == 3 * 2 * 2 * corr(4)
    assert set(on) - set(off) == {"cycle: filter, two predictions, no grad",
                                  "cycle: loss, both directions, fwd+bwd",
                                  "refined best buddies: mining affinity, no grad",
                                  "refined best buddies: InfoNCE, fwd+bwd"}
    frames = sum(v for k, v in on.items() if k.startswith("delta_dino"))
    assert frames == 3 * 4 * sum(counts.delta_dino_frame_flops(ch, 70, 98).values())
    assert math.isclose(counts.train_step_flops(train, (70, 98), hw, ch, True, True),
                        sum(on.values()))
