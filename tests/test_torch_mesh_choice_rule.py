"""The rule ``chip_smoke.py`` holds a chunk of replays on an NCCL mesh to
(``train_chunks``), on 2 gloo ranks on the CPU: the whole step's discrete
choices judged from every rank's share (``chunk_choices``), and where the
graph took one that no eager run took, eager G on every rank
(``follow_run``), each taking its own share of the recorded choices.

Each rank's ``StepRecorder`` holds the head's calls of its own share of the
step: its rows of the flow term's batch, its share of every pair's points
in the cycle filter's two calls and in the cycle loss. (a) Both ranks'
records of one eager mesh step from the Trainer's init, rebuilt in one
device's layout (``whole_record``), equal one device's record of the same
step: the head's argmax rows and the cycle filter's kept points. (b) A
choice planted in rank 1's share alone (a flow point whose raw map ties its
two largest values in every run, its argmax moved in the graph's record)
makes both ranks reach one verdict and run G: rank 1's G takes the planted
argmax (its flow share moves at that step and no earlier), rank 0's G its
own unplanted share (its shares at that step stay), and G's replicas are
bitwise equal. (c) The same choice where the two values lie far apart
misses on both ranks. (d) Ranks whose records of one run hold different
kept sets miss, and the miss names the rank.

On the CPU every run is eager and bit-equal to every other on the same
ranks: the eager runs A-C spread zero, and "the graph" is such a run too.
The cycle threshold lies halfway between two of the one-device step's
middle distances, so no point of (a)'s step lies at it, where the 2-rank
step's other order of summation could put it on the other side
(``test_torch_mesh_train.py``). The ranks import this module, so it
imports JAX only in the parent's fixture.
"""

import dataclasses
import os
import sys

import pytest
import torch

from dino_tracker_tpu_torch.config import TrainConfig
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from dino_tracker_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

SPAWN_TIMEOUT = 120
CPU = torch.device("cpu")
N_STEPS, AT = 3, 1  # the runs' steps (gates on), the step a choice is planted at
L_OF = train.METRICS.index("loss_of")
EAGER = ("eager A", "eager B", "eager C")


def fresh(cfg, tcfg, data, mesh):
    """The Trainer's init (seed 2) and a runner of its eager steps, as
    ``train_chunks`` starts each run."""
    model = train.Trainer(cfg, tcfg, data, "", seed=2, device=CPU, mesh=mesh
                          ).init_model().train()
    opt, sched = train.make_optimizer(model, cfg)
    runner = train.StepRunner(model, opt, sched, torch.Generator().manual_seed(2), cfg,
                              tcfg, mesh)
    return model, runner


def recorded(cfg, tcfg, data, mesh, n=N_STEPS):
    """n eager steps with the gates on from the Trainer's init, recorded ->
    (the recorder's rows, parameters, BN statistics)."""
    model, runner = fresh(cfg, tcfg, data, mesh)
    with chip_smoke.StepRecorder(n, cfg, CPU, runner.sched.lr) as rec:
        for _ in range(n):
            runner.step(data, True, True)
    return (rec.rows(0, n), *chip_smoke.model_state(model)[1::2])


def copied(rec):
    return type(rec)(**{k: v.clone() for k, v in vars(rec).items()})


def plant_argmax(runs, cfg, tcfg, tie):
    """Rank 1's records: at step AT, the flow point of its share with the
    widest gap between its map's two largest values takes a cell half the
    map away in the graph's record (``runs[0]``); with ``tie`` every run's
    two largest values of it are made equal (the point lies at its
    threshold)."""
    graph = runs[0]
    b = mesh_lib.split_sizes(cfg.train_batch_size, 2)[1]
    top = graph.top[AT, :b]
    j = int((top[:, 0] - top[:, 1]).argmax())
    cells = tcfg.feat_hw[0] * tcfg.feat_hw[1]
    graph.argmax[AT, j] = (graph.argmax[AT, j] + cells // 2) % cells
    if tie:
        for r in runs:
            r.top[AT, j, 1] = r.top[AT, j, 0]


def verdict(choices):
    return (choices.steps, choices.ok, choices.first, choices.took, choices.misses)


def rank_run(mesh, payload):
    torch.set_num_threads(1)
    cfg, tcfg, data = payload
    runs = {name: recorded(cfg, tcfg, data, mesh) for name in ("graph",) + EAGER}
    recs = lambda: [copied(runs[k][0]) for k in ("graph",) + EAGER]
    out = {}
    # (a) as recorded: the whole step, rebuilt, and no choice
    as_recorded = recs()
    choices = chip_smoke.chunk_choices(as_recorded[0], as_recorded[1:], cfg, mesh)
    out["whole"] = choices.whole[0]
    out["as recorded"] = verdict(choices)
    # (b) a tie on rank 1's share; every rank runs its G from its own record
    planted = recs()
    if mesh.rank == 1:
        plant_argmax(planted, cfg, tcfg, tie=True)
    choices = chip_smoke.chunk_choices(planted[0], planted[1:], cfg, mesh)
    out["tie"] = verdict(choices)
    if choices.steps:
        model, runner = fresh(cfg, tcfg, data, mesh)
        g = chip_smoke.follow_run(model, runner.sched.lr,
                                  lambda: runner.step(data, True, True), N_STEPS, cfg, CPU,
                                  planted[0])
        out["G"] = dict(losses=g[0].losses.clone(), state=g[1] + g[2],
                        digest=chip_smoke.digest(g[1] + g[2]))
    out["A"] = dict(losses=runs["eager A"][0].losses, state=runs["eager A"][1]
                    + runs["eager A"][2])
    # (c) the same choice, the two values far apart
    planted = recs()
    if mesh.rank == 1:
        plant_argmax(planted, cfg, tcfg, tie=False)
    out["far"] = verdict(chip_smoke.chunk_choices(planted[0], planted[1:], cfg, mesh))
    # (d) rank 1's graph record keeps another set of points at step AT
    planted = recs()
    if mesh.rank == 1:
        point = int(planted[0].drawn[AT].nonzero()[0])
        planted[0].kept[AT, point] = ~planted[0].kept[AT, point]
    out["kept"] = verdict(chip_smoke.chunk_choices(planted[0], planted[1:], cfg, mesh))
    return out


@pytest.fixture(scope="module")
def payload():
    import test_torch_train_step as tts
    cfg = TrainConfig(**{f.name: getattr(tts.CFG, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    tcfg = tts.configs(tts.CHANNELS, "float32")[1]
    data = tts.port_data(tts.video_arrays())
    # the first step's distances do not depend on the threshold
    rec = recorded(dataclasses.replace(cfg, cyc_thresh=1e9), tcfg, data, None, 1)[0]
    d = torch.sort(rec.dists[0][rec.drawn[0]]).values
    mid = len(d) // 2
    return cfg, dataclasses.replace(cfg, cyc_thresh=float(d[mid - 1] + d[mid]) / 2), \
        tcfg, data


@pytest.fixture(scope="module")
def one_device(payload):
    _, cfg, tcfg, data = payload
    return recorded(cfg, tcfg, data, None, 1)[0]


@pytest.fixture(scope="module")
def ranks(payload):
    return mesh_lib.spawn(rank_run, 2, "cpu", args=(payload[1:],), timeout=SPAWN_TIMEOUT)


def test_head_columns_cover_one_devices_row_once(payload):
    """Every rank's columns together are each column of one device's row
    once; rank 0's come first in each call, as ``split_rows`` gives."""
    cfg = payload[1]
    width = cfg.train_batch_size + 4 * cfg.cyc_n_frames * cfg.cyc_batch_size_per_frame
    for world in (1, 2, 3):
        cols = chip_smoke.head_columns(cfg, world)
        assert torch.equal(torch.cat(cols).sort().values, torch.arange(width))
    assert torch.equal(chip_smoke.head_columns(cfg, 1)[0], torch.arange(width))
    rank0 = chip_smoke.head_columns(cfg, 2)[0]
    assert rank0[0] == 0 and rank0[cfg.train_batch_size // 2] == cfg.train_batch_size


def test_ranks_rebuilt_equal_one_device(ranks, one_device):
    """(a) The 2-rank step's records rebuilt in one device's layout: the
    argmax rows, the drawn queries and the kept points equal one device's;
    the raw maps' two largest values and the distances within float
    rounding; no choice, held to A-C on both ranks."""
    for r in ranks:
        whole = r["whole"]
        assert (one_device.argmax[0] >= 0).all()
        assert torch.equal(whole.argmax[:1], one_device.argmax)
        assert torch.equal(whole.drawn_query[:1], one_device.drawn_query)
        assert torch.equal(whole.kept[:1], one_device.kept)
        assert one_device.kept[0].any() and not one_device.kept[0].all()
        torch.testing.assert_close(whole.top[:1], one_device.top, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(whole.dists[:1], one_device.dists, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(whole.losses[:1], one_device.losses, rtol=1e-4, atol=1e-7)
        assert r["as recorded"] == ([], True, [], [], [])


def test_a_tie_on_one_ranks_share_runs_g_on_every_rank(ranks):
    """(b) Both ranks find the choice at step AT in rank 1's share, explained,
    and run G; rank 1's G takes the planted argmax (its flow share moves at
    AT, not before), rank 0's takes its own (its shares at AT stay); G's
    replicas are bitwise equal and moved from A's."""
    for r in ranks:
        assert r["tie"] == ([AT], True, [1], [1], []), r["tie"]
        assert "G" in r
    g = [r["G"]["losses"] for r in ranks]
    a = [r["A"]["losses"] for r in ranks]
    for k in (0, 1):
        assert torch.equal(g[k][:AT], a[k][:AT])
    assert g[1][AT, L_OF] != a[1][AT, L_OF]
    assert torch.equal(g[0][AT], a[0][AT])
    assert ranks[0]["G"]["digest"] == ranks[1]["G"]["digest"]
    assert any(not torch.equal(x, y) for x, y in zip(ranks[0]["G"]["state"],
                                                     ranks[0]["A"]["state"]))


def test_a_choice_far_from_its_threshold_misses_on_every_rank(ranks):
    """(c) The planted argmax with the map's two largest values as recorded,
    far apart: the same miss on both ranks."""
    steps, ok, first, took, misses = ranks[0]["far"]
    assert (steps, ok, first, took, misses) == ([AT], False, [1], [1], [])
    assert ranks[1]["far"] == ranks[0]["far"]


def test_ranks_with_other_kept_sets_miss_naming_the_rank(ranks):
    """(d) Rank 1's graph record keeps another set of points at AT: a miss
    on both ranks that names rank 1, the run and the step; the verdict
    itself is taken from one layout."""
    for r in ranks:
        steps, ok, _, _, misses = r["kept"]
        assert misses == [f"graph: rank 1's kept differs from rank 0's at steps [{AT}]"]
        assert (steps, ok) == ([], True)
