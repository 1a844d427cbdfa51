"""The rule ``chip_smoke.py`` holds a chunk of replays of the captured train
step to (``train_chunks``: 25 replays against three eager runs A, B, C from
one state), on the CPU, at the edge where it missed on the card.

A cycle-consistency point whose cycle distance lies at the filter's 4 px
threshold lands on either side in two valid runs (their parameters differ
by index_add's atomics from the first step on). Where the graph kept it and
three eager runs dropped it (or the other way round), the cycle term moves
at that step by about 1/n of itself (n points kept), far beyond what three
runs that agree on the kept set spread. ``LOSS_CYC`` is such a series, as an
H100 recorded it in phase 5's chunks with the gates on: the graph's step 8
lies 0.25% below eager runs that agree to 0.05% there. The repaired rule
(``loss_rules``) leaves such steps out of the terms the filter enters, and
only where ``cycle_flips`` shows the kept sets differ and each point kept
otherwise lies at the threshold within the runs' noise; every other row,
and every row of a chunk with no such step, is the rule as it was.
"""

import os
import sys
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from dino_tracker_tpu_torch.training.train import METRICS  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

# loss_cyc step by step (graph, eager A, B, C), phase 5, gates on
LOSS_CYC = {
    "graph": [5.16808e-06, 5.24116e-06, 5.26448e-06, 5.03909e-06, 5.29008e-06, 4.93761e-06,
              5.03241e-06, 5.12586e-06, 4.54791e-06, 4.97597e-06, 5.01091e-06, 5.04674e-06,
              5.3169e-06, 5.09805e-06, 5.16373e-06, 5.26249e-06, 5.17551e-06, 5.43681e-06,
              5.29925e-06, 5.49472e-06, 5.27316e-06, 5.12639e-06, 5.34959e-06, 5.43693e-06,
              5.28863e-06],
    "A": [5.16808e-06, 5.24117e-06, 5.26448e-06, 5.03912e-06, 5.29011e-06, 4.93768e-06,
          5.03245e-06, 5.12613e-06, 4.55921e-06, 4.97622e-06, 5.01079e-06, 5.04634e-06,
          5.31661e-06, 5.09797e-06, 5.16363e-06, 5.26245e-06, 5.17546e-06, 5.4368e-06,
          5.29923e-06, 5.49475e-06, 5.27309e-06, 5.12632e-06, 5.34964e-06, 5.43681e-06,
          5.28862e-06],
    "B": [5.16808e-06, 5.24114e-06, 5.26446e-06, 5.0391e-06, 5.29008e-06, 4.93766e-06,
          5.03251e-06, 5.12617e-06, 4.56062e-06, 4.97619e-06, 5.0107e-06, 5.04625e-06,
          5.31661e-06, 5.09793e-06, 5.16366e-06, 5.26242e-06, 5.17544e-06, 5.43674e-06,
          5.29917e-06, 5.49472e-06, 5.27304e-06, 5.1264e-06, 5.34956e-06, 5.43673e-06,
          5.28846e-06],
    "C": [5.16808e-06, 5.24117e-06, 5.26446e-06, 5.03909e-06, 5.29011e-06, 4.93768e-06,
          5.03241e-06, 5.12572e-06, 4.56129e-06, 4.97576e-06, 5.0106e-06, 5.04639e-06,
          5.31666e-06, 5.09798e-06, 5.16369e-06, 5.26258e-06, 5.1755e-06, 5.43685e-06,
          5.2992e-06, 5.49471e-06, 5.27309e-06, 5.12637e-06, 5.34959e-06, 5.43686e-06,
          5.28857e-06],
}
FLIP_STEP, POINT, P, THRESH = 8, 5, 16, 4.0
CYC = METRICS.index("loss_cyc")


def recorder(run, kept_at_flip=False, dist_at_flip=THRESH + 1e-5):
    """A ``StepRecorder``'s buffers for one run: every term but loss_cyc
    equal in every run, loss_cyc the recorded series; 16 cycle points drawn
    a step, POINT at the threshold, kept at FLIP_STEP where asked."""
    n = len(LOSS_CYC[run])
    losses = torch.ones((n, len(METRICS)))
    losses[:, CYC] = torch.tensor(LOSS_CYC[run])
    dists = torch.linspace(0.5, 8.0, P).repeat(n, 1)
    dists[:, POINT] = THRESH + 1e-5
    dists[FLIP_STEP, POINT] = dist_at_flip
    drawn = torch.ones((n, P), dtype=torch.bool)
    kept = drawn & (dists <= THRESH)
    kept[FLIP_STEP, POINT] = kept_at_flip
    return types.SimpleNamespace(losses=losses, dists=dists, drawn=drawn, kept=kept)


def eager_runs(**kwargs):
    return [recorder(k, **kwargs) for k in "ABC"]


def graph_run(**kwargs):
    return recorder("graph", kept_at_flip=True, dist_at_flip=THRESH - 1e-5, **kwargs)


def missed(rows):
    return [r[0] for r in rows if r[1] > r[3]]


def test_the_rule_before_misses_the_recorded_step():
    """Over every step, loss_cyc misses: the edge the card ran into."""
    _, _, every_step, _ = chip_smoke.loss_rules(graph_run(), eager_runs(), THRESH)
    assert missed(every_step) == ["loss_cyc"]
    ok, line = chip_smoke.spread_summary("losses", every_step)
    assert not ok and "loss_cyc MISSED" in line


def test_a_point_kept_otherwise_at_the_threshold_is_left_out():
    (f_ok, f_line), (ok, _), every_step, held = chip_smoke.loss_rules(
        graph_run(), eager_runs(), THRESH)
    assert f_ok is True and ok
    assert f"at steps [{FLIP_STEP}]" in f_line and f"point {POINT}" in f_line
    assert missed(held) == []
    # only the cycle terms leave the step out; their bounds shrink with it
    for before, after in zip(every_step, held):
        if before[0] in chip_smoke.CYCLE_TERMS:
            assert after[3] <= before[3]
        else:
            assert after == before


def test_a_jump_with_the_same_points_kept_still_misses():
    graph = recorder("graph")  # the same kept sets as the eager runs'
    (f_ok, f_line), (ok, line), _, held = chip_smoke.loss_rules(graph, eager_runs(), THRESH)
    assert f_ok and "at steps []" in f_line
    assert not ok and missed(held) == ["loss_cyc"]


def test_a_point_kept_otherwise_far_from_the_threshold_misses():
    graph = recorder("graph", kept_at_flip=True, dist_at_flip=THRESH - 0.5)
    (f_ok, f_line), _, _, _ = chip_smoke.loss_rules(graph, eager_runs(), THRESH)
    assert not f_ok and f"at steps [{FLIP_STEP}]" in f_line


def test_points_drawn_otherwise_miss():
    graph = graph_run()
    graph.drawn[3, 0] = False
    (f_ok, f_line), _, _, _ = chip_smoke.loss_rules(graph, eager_runs(), THRESH)
    assert not f_ok and "NOT equal" in f_line


def test_a_graph_that_kept_what_one_eager_run_kept_is_held_at_every_step():
    eager = eager_runs()
    eager[1] = recorder("B", kept_at_flip=True, dist_at_flip=THRESH - 1e-5)
    (f_ok, f_line), _, every_step, held = chip_smoke.loss_rules(graph_run(), eager, THRESH)
    assert f_ok and "at steps []" in f_line and "differ at 1 steps" in f_line
    assert held == every_step


@pytest.mark.parametrize("gates", [False, True])
def test_with_no_step_left_out_the_rule_is_the_one_before(gates):
    """Phase 5's data with no flip: every row as the parent's rule held it
    (gates off: the cycle filter does not run, and its buffers stay empty)."""
    runs = [recorder(k) for k in ("graph", "A", "B", "C")]
    for r in runs:
        r.losses[:, CYC] = torch.tensor(LOSS_CYC["A"]) * (1 + 1e-6 * torch.rand(25))
        if not gates:
            r.drawn[:], r.kept[:], r.dists[:] = False, False, 0.0
    (f_ok, f_line), (ok, _), every_step, held = chip_smoke.loss_rules(runs[0], runs[1:],
                                                                       THRESH)
    assert f_ok and ok and held == every_step
    assert ("not run" in f_line) != gates


def test_a_miss_names_every_row_and_its_series():
    _, (ok, line), _, held = chip_smoke.loss_rules(recorder("graph"), eager_runs(), THRESH)
    assert not ok
    for name in METRICS:
        assert name in line.split("[every row:")[1]
    series = chip_smoke.loss_series(METRICS, held, list(recorder("graph").losses.T),
                                    [list(r.losses.T) for r in eager_runs()])
    assert series.startswith("loss_cyc per step: graph [") and "loss_of" not in series
    assert series.count("eager") == 3


def test_a_point_whose_own_spread_is_below_the_steps_noise_is_held_to_the_steps():
    """Three eager runs can agree on one point's distance far closer than
    the step's points spread (an H100 run: 4.00128 / 4.00147 / 4.00131 where
    the graph had 3.99959): the point is held to the step's median spread
    where that is larger."""
    gen = torch.Generator().manual_seed(0)
    eager = eager_runs()
    for r in eager:
        r.dists[FLIP_STEP] += 2e-3 * torch.rand(P, generator=gen)
        r.dists[FLIP_STEP, POINT] = THRESH + 1e-5  # the point: no spread of its own
    graph = recorder("graph", kept_at_flip=True, dist_at_flip=THRESH - 2e-3)
    steps, ok, line = chip_smoke.cycle_flips(graph, eager, THRESH)
    assert steps == [FLIP_STEP] and ok, line
    graph = recorder("graph", kept_at_flip=True, dist_at_flip=THRESH - 0.1)  # beyond it
    assert not chip_smoke.cycle_flips(graph, eager, THRESH)[1]


def test_a_point_moved_by_the_heads_choice_is_explained_by_it():
    """A point kept otherwise far from the threshold (its cycle distance 3.57
    px in the run, 8.33 in three eager runs that agree, as on an H100) is
    explained where the run's hard argmax of it in the cycle filter's
    backward call differs from the eager runs': the distance moved with that
    choice, which argmax_flips judges. With no head record it is not."""
    b = 4  # the flow term's batch before the filter's two calls
    graph = recorder("graph", kept_at_flip=True, dist_at_flip=3.57)
    eager = eager_runs(dist_at_flip=8.33)
    for r in (graph, *eager):
        r.argmax = torch.zeros((len(r.dists), b + 4 * P), dtype=torch.long)
    graph.argmax[FLIP_STEP, b + P + POINT] = 7  # the backward call's argmax
    assert not chip_smoke.cycle_flips(graph, eager, THRESH)[1]
    steps, ok, line = chip_smoke.cycle_flips(graph, eager, THRESH, head_offset=b)
    assert steps == [FLIP_STEP] and ok, line
    graph.argmax[FLIP_STEP, b + P + POINT] = 0  # the head chose alike: a jump
    assert not chip_smoke.cycle_flips(graph, eager, THRESH, head_offset=b)[1]


def with_head(r, b=4):
    """A recorder with a head record where every run chose alike."""
    n = len(r.dists)
    r.argmax = torch.zeros((n, b + 4 * P), dtype=torch.long)
    r.top = torch.stack([torch.ones((n, b + 4 * P)), torch.zeros((n, b + 4 * P))], -1)
    r.drawn_query = torch.ones((n, b + 4 * P), dtype=torch.bool)
    return r


def test_choices_after_the_first_are_listed_not_judged():
    """After the run's first choice that no eager run took, its points no
    longer share the eager runs' history: a later point kept otherwise far
    from the threshold is listed and not judged; the same point at the
    first such step is."""
    eager = [with_head(r) for r in eager_runs()]
    graph = with_head(graph_run())  # the flip at FLIP_STEP, at the threshold
    later = FLIP_STEP + 3
    graph.dists[later, 2], graph.kept[later, 2] = THRESH + 2.0, False  # a jump
    steps, ok, line = chip_smoke.choice_flips(graph, eager, THRESH, 4)
    assert steps == [FLIP_STEP, later] and ok, line
    graph = with_head(recorder("graph"))  # no flip at FLIP_STEP: the jump is first
    graph.dists[later, 2], graph.kept[later, 2] = THRESH + 2.0, False
    steps, ok, line = chip_smoke.choice_flips(graph, eager, THRESH, 4)
    assert steps == [later] and not ok
