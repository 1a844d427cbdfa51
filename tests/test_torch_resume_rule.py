"""The check ``chip_smoke.py`` phase 5 holds a resumed training run to
(``resume_check``), and the comparison of a Trainer's state in memory with
the checkpoint it wrote (``SavedAt``, ``compare_saved``), on the CPU.

R is a Trainer run through its checkpoint to the end, every step recorded
(``StepRecorder``: batches, cycle filter, the head's hard argmax). From the
checkpoint the Trainer runs to the end again three times (E1-E3) and once
more (S; replays of a captured step on the card, eager here); on the CPU
they are bit-equal to R, so the eager runs' spread is 0 and the rule holds
R to them within its floor alone. The check must pass a faithful resume and
miss each fault planted in the file: Adam's moments zeroed, the BN running
statistics reset, the generator state of the step before. A run that follows
another run's recorded choices (``FollowChoices``, the reference E_R the rule
holds R to where R took a choice no eager run took) takes them and records
its own.
"""

import dataclasses
import os
import sys
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from dino_tracker_tpu_torch.training import checkpoint, train  # noqa: E402
from test_torch_model_slice import configs  # noqa: E402
from test_torch_train_step import CFG, CHANNELS, port_data, video_arrays  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

CPU = torch.device("cpu")
# gates at 2, the checkpoint at 4, the end at 7: the resumed steps run the
# cycle filter and both contrastive terms
LONG = dataclasses.replace(CFG, total_iterations=7, checkpoint_interval=4,
                           apply_cyc_after=2, apply_cl_ref_after=2, cl_points_per_pair=16)
AT, END, LOG = LONG.checkpoint_interval, LONG.total_iterations, 100


@pytest.fixture(scope="module")
def run_r(tmp_path_factory, one_thread):
    """R: the Trainer from its init to END, recorded, its state at AT kept."""
    data = port_data(video_arrays(4))
    tcfg = configs(CHANNELS)[1]
    folder = str(tmp_path_factory.mktemp("R"))
    with chip_smoke.StepRecorder(END, LONG, CPU) as rec, \
            chip_smoke.SavedAt(AT, data) as saved:
        model = train.Trainer(LONG, tcfg, data, folder, seed=2, device=CPU).train(
            log_interval=LOG)
    return types.SimpleNamespace(
        data=data, tcfg=tcfg, folder=folder, rows=rec.rows(AT, END - AT), all_rows=rec,
        snap=saved.snap, names=chip_smoke.model_state(model)[::2],
        fresh=train.Trainer(LONG, tcfg, data, folder, seed=2, device=CPU).init_model(),
        work=tmp_path_factory.mktemp("work"))


def check(r, work, start=None):
    return chip_smoke.resume_check(CPU, LONG, r.tcfg, r.data, r.folder, LOG, r.names,
                                   r.rows, str(work), start)


def test_recorder_keeps_every_step_and_head_call(run_r):
    """Every step of R is a row: the batches differ from step to step, the
    cycle filter ran from the gate on, and every head call of a step left
    its argmax (the flow term alone before the gate)."""
    rec, b, p = run_r.all_rows, LONG.train_batch_size, (
        LONG.cyc_n_frames * LONG.cyc_batch_size_per_frame)
    assert int(rec.i) == END % END
    assert all(not torch.equal(rec.src[k], rec.src[k + 1]) for k in range(END - 1))
    gate = LONG.apply_cyc_after
    assert not rec.drawn[:gate].any() and rec.drawn[gate:].any(axis=1).all()
    assert (rec.argmax[:gate, :b] >= 0).all() and (rec.argmax[:gate, b:] == -1).all()
    assert (rec.argmax[gate:] >= 0).all()
    # drawn queries: the flow term, the filter's forward, the loss's sources
    want = torch.zeros(b + 4 * p, dtype=torch.bool)
    want[:b + p] = True
    want[b + 2 * p:b + 3 * p] = True
    assert torch.equal(rec.drawn_query[gate], want)
    assert (rec.top[gate:, :, 0] >= rec.top[gate:, :, 1]).all()
    assert (rec.head_grads > 0).all()


def test_state_in_memory_equals_the_checkpoint(run_r):
    """The Trainer's state at AT equals its state_AT.pt bit for bit; a file
    that lacks a parameter, or whose Adam moment or generator differs, does
    not."""
    state = checkpoint.load_state(run_r.folder, AT)
    ok, line = chip_smoke.compare_saved(run_r.snap, state, run_r.fresh, run_r.data, LONG)
    assert ok and line.endswith("all equal bit for bit"), line
    lacking = dict(state, model={k: v for k, v in state["model"].items()
                                 if k != "tracker_head.conv2.weight"})
    ok, line = chip_smoke.compare_saved(run_r.snap, lacking, run_r.fresh, run_r.data, LONG)
    assert not ok and "tracker_head.conv2.weight" in line
    moved = chip_smoke.planted(state, chip_smoke.RESUME_FAULTS[0], None)
    ok, line = chip_smoke.compare_saved(run_r.snap, moved, run_r.fresh, run_r.data, LONG)
    assert not ok and "exp_avg" in line
    other = dict(state, generator=torch.Generator().manual_seed(9).get_state())
    ok, line = chip_smoke.compare_saved(run_r.snap, other, run_r.fresh, run_r.data, LONG)
    assert not ok and "generator" in line


def test_resume_check_passes_a_faithful_resume(run_r):
    """From R's own file every run equals R: no choice of R or S that no
    eager run took, every row within its bound."""
    ok, results, only = check(run_r, run_r.work / "faithful")
    assert ok, [line for good, line in results if not good]
    assert only == {"R": [], "S": []}


@pytest.fixture(scope="module")
def faults(run_r):
    """``resume_faults``: the check from a file with each fault planted."""
    return {kind: (met, results) for kind, met, results in chip_smoke.resume_faults(
        CPU, LONG, run_r.tcfg, run_r.data, run_r.folder, LOG, run_r.names, run_r.rows,
        str(run_r.work / "faults"))}


@pytest.mark.parametrize("kind", chip_smoke.RESUME_FAULTS)
def test_resume_check_misses_a_planted_fault(faults, kind):
    """A file with Adam's moments zeroed, the BN statistics reset or the
    generator of the step before: the runs resumed from it leave R, and the
    check misses."""
    met, results = faults[kind]
    assert not met
    missed = " ".join(line for good, line in results if not good)
    want = {0: "parameters' change", 1: "BN statistics' change", 2: "generator"}
    assert want[chip_smoke.RESUME_FAULTS.index(kind)] in missed, missed


def test_follow_choices_takes_the_recorded_choices(run_r):
    """A run from R's file following R's recorded choices ends equal to R;
    following a record whose kept cycle points differ at one step, it
    records its own kept points and its cycle term moves at that step."""
    path = checkpoint.checkpoint_file(run_r.folder, AT)
    final_r = checkpoint.load_state(run_r.folder, END)
    same, rows = chip_smoke.resumed_run(LONG, run_r.tcfg, run_r.data,
                                        str(run_r.work / "follow"), path, CPU, LOG, False,
                                        follow=run_r.rows)
    assert all(torch.equal(same["model"][k], final_r["model"][k]) for k in final_r["model"])
    other = types.SimpleNamespace(**vars(run_r.rows))
    other.kept = run_r.rows.kept.clone()
    k = 1
    other.kept[k] = other.drawn[k] & ~other.kept[k]
    moved, own = chip_smoke.resumed_run(LONG, run_r.tcfg, run_r.data,
                                        str(run_r.work / "follow_other"), path, CPU, LOG, False,
                                        follow=other)
    assert torch.equal(own.kept[:k + 1], run_r.rows.kept[:k + 1])
    cyc = train.METRICS.index("loss_cyc")
    assert torch.equal(own.losses[:k, cyc], run_r.rows.losses[:k, cyc])
    assert not torch.equal(own.losses[k, cyc], run_r.rows.losses[k, cyc])


def recorded(argmax, top, drawn_query):
    return types.SimpleNamespace(argmax=torch.tensor(argmax), top=torch.tensor(top),
                                 drawn_query=torch.tensor(drawn_query))


@pytest.mark.parametrize("gap, explained", [(1e-6, True), (0.05, False)])
def test_argmax_flips_judge_drawn_queries_by_their_top_two(gap, explained):
    """Point 0 (a drawn query) takes another cell in the run than in every
    eager run: explained where the run's two largest values lie within 4x
    the eager runs' spread of the largest (2e-6 here) plus 1e-4 of it;
    point 1, whose query the step predicted, moves too and is counted, not
    judged."""
    drawn = [[True, False, True]]
    tops = lambda first: [[[first, first - gap], [0.5, 0.4], [0.7, 0.1]]]
    eager = [recorded([[4, 7, 2]], tops(0.9 + d), drawn) for d in (0.0, 1e-6, 2e-6)]
    got = recorded([[3, 8, 2]], tops(0.9), drawn)
    steps, ok, line = chip_smoke.argmax_flips(got, eager)
    assert steps == [0] and ok is explained, line
    assert "1 with drawn queries" in line and "1 with queries the step predicted" in line
    steps, ok, line = chip_smoke.argmax_flips(eager[0], eager[1:])
    assert steps == [] and ok


def test_a_reference_run_replaces_the_eager_median():
    """``spread_rows`` with a ``ref`` run: the error is the distance to it
    alone, the spread and the bound those of the eager runs."""
    base = [torch.zeros(3)]
    eager = [[torch.tensor([1.0, 0, 0])], [torch.tensor([1.01, 0, 0])],
             [torch.tensor([1.02, 0, 0])]]
    got = [torch.tensor([1.5, 0, 0])]
    (name, e, spread, bound, scale), = chip_smoke.spread_rows(["w"], got, eager, base)
    assert e == pytest.approx(0.49, rel=1e-3) and e > bound
    (_, e, s2, b2, _), = chip_smoke.spread_rows(["w"], got, eager, base,
                                                ref=[torch.tensor([1.5005, 0, 0])])
    assert e == pytest.approx(5e-4, rel=1e-3) and (s2, b2) == (spread, bound) and e <= b2
