"""The conditions under which each rank of a mesh captures its train step
into a CUDA graph, checked on 2 (and 3) gloo ranks on the CPU, and the
chunked mesh Trainer held against the stepwise one and the JAX Trainer.

A CUDA graph replays the launches it captured, so every rank's step must
make the same collectives, in the same order, with the same shapes and
dtypes, at every step of a variant, and none that a graph cannot hold: no
object collective, no barrier and no read of a tensor on the host
(``.item()``, ``bool()``, ``.tolist()``, ...). (a) records every
``torch.distributed`` call and every such read that ``train.train_step``
makes over three steps with the gates off and three with them on. Adam on
the CPU is not capturable and reads its step counts on the host, so the
reads are recorded outside ``opt.step``; on a card Adam is capturable and
the card's sync check (``chip_smoke.py``) holds the whole step, reads in C++
included.

(b) The choice between replays and the eager step is made from the backend:
eager on the CPU and over gloo, captured over NCCL (the backend mocked
here); the Trainer logs it. (c) ``mesh.agree``: when one rank reports a
failed capture, or ranks report different gradient sets, every rank
raises; the vote goes over the mesh's host group. (d) The 2-rank Trainer in chunks of 5 (``steps_per_call``) equals
the 2-rank Trainer one step a chunk bit for bit (model, checkpoints, log
lines); with the random parts injected (one fixed batch, cycle data and
contrastive frame pairs every step, full-take subset sizes, as
``test_torch_train_step.py`` injects them) its logged f32 losses match the
JAX ``Trainer`` on ``make_mesh(2)`` with the same ``steps_per_call`` within
1e-4 relative. (e) ``StepRunner``'s capturing path, with a stand-in graph
whose replays are eager steps: every rank captures anew at the same steps
(once a set of gates), and not at the in-place bank rotations. The ranks
import this module, so it imports JAX only in the parent's fixtures.
"""

import dataclasses
import logging
import re
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dino_tracker_tpu_torch.config import TrainConfig
from dino_tracker_tpu_torch.models import tracker
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from dino_tracker_tpu_torch.training import checkpoint as ckpt
from dino_tracker_tpu_torch.training import contrastive, cycle, train
from test_torch_threads import one_thread  # noqa: F401

SPAWN_TIMEOUT = 240
RECORDED_STEPS = 3
# what a captured step may not do: object collectives, barriers, host reads
OBJECT_COLLECTIVES = ("broadcast_object_list", "all_gather_object", "gather_object",
                      "scatter_object_list", "send_object_list", "recv_object_list")
BARRIERS = ("barrier", "monitored_barrier")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "reduce", "all_to_all",
               "all_to_all_single", "gather", "scatter", "send", "recv", "isend",
               "irecv", "batch_isend_irecv")
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
              "__index__")
# (d): the Trainer's schedule, chunks of 5 meeting the gates, logs and the
# checkpoint at their boundaries; learning rates of 1e-4 (the config's 1e-2
# / 100): Adam turns gradients that are float noise into steps of ±lr, which
# at these widths move two valid orders of summation apart by 1e-4 of a
# loss within 6-10 steps at 1e-2 (the JAX Trainer on one device against
# make_mesh(2) too), and stay within 4e-6 over 15 steps at 1e-4
RUN = dict(total_iterations=15, apply_cyc_after=5, apply_cl_ref_after=5,
           checkpoint_interval=10, steps_per_call=5, lr_delta_dino=1e-4,
           lr_cnn_refiner=1e-4)
LOG_EVERY = 5
LOSS_RTOL = 1e-4


def _describe(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    return None


class Recorder:
    """While entered: every ``torch.distributed`` collective, object
    collective and barrier (name, the shapes and dtypes of its tensor
    arguments, its op), and every host read of a tensor (``reads``, paused
    by ``paused``), appended to ``calls``."""

    def __init__(self):
        self.calls, self.pause = [], 0

    def __enter__(self):
        self.saved = {}
        for name in COLLECTIVES + OBJECT_COLLECTIVES + BARRIERS:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[(dist, name)] = fn
            setattr(dist, name, self._wrap(name, fn))
        for name in HOST_READS:
            fn = getattr(torch.Tensor, name)
            self.saved[(torch.Tensor, name)] = fn
            setattr(torch.Tensor, name, self._read(name, fn))
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in self.saved.items():
            setattr(owner, name, fn)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            op = kwargs.get("op", args[1] if name == "all_reduce" and len(args) > 1 else None)
            self.calls.append((name, _describe(list(args)), str(op)))
            return fn(*args, **kwargs)
        return call

    def _read(self, name, fn):
        def read(t, *args, **kwargs):
            if not self.pause:
                self.calls.append(("host read " + name, _describe([t]), None))
            return fn(t, *args, **kwargs)
        return read

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _model(state, pcfg):
    model = tracker.Tracker(pcfg)
    model.load_state_dict(state)
    return model.train()


def recorded_steps(mesh, state, data, cfg, pcfg):
    """The calls of RECORDED_STEPS train_steps under each set of gates:
    [(gates, calls)]."""
    model = _model(state, pcfg)
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator().manual_seed(3)
    steps = []
    with Recorder() as rec:
        adam = opt.step

        def quiet_step(*args, **kwargs):  # the CPU's Adam reads its counts
            rec.pause += 1
            try:
                return adam(*args, **kwargs)
            finally:
                rec.pause -= 1

        opt.step = quiet_step
        for gates in (False, True):
            for _ in range(RECORDED_STEPS):
                train.train_step(model, opt, sched, data, gen, gates, gates, cfg, pcfg,
                                 mesh)
                steps.append((gates, rec.take()))
        # what the recorder sees of the calls a step may not make
        torch.ones(()).item()
        bool(torch.ones(()))
        dist.barrier()
        mesh_lib.broadcast_object(1, mesh)
        steps.append(("forbidden", rec.take()))
    return steps


def agreements(mesh):
    """``mesh.agree`` when rank 1 failed, when the ranks' summaries differ
    and when all agree, and when rank 1 failed on a mesh whose collectives'
    group cannot be used (the vote must go over its host group): each
    rank's error message, or None."""
    out = {}
    off_group = dataclasses.replace(mesh, group="the NCCL group, not for votes",
                                    host_group=mesh.group)
    for case, (error, summary, m) in {
            "rank 1 failed": ("boom at step.py:7" if mesh.rank == 1 else None, (1, 2), mesh),
            "summaries differ": (None, (1, 2, mesh.rank), mesh),
            "all agree": (None, (1, 2), mesh),
            "over the host group": ("boom at step.py:7" if mesh.rank == 1 else None,
                                    (1, 2), off_group)}.items():
        try:
            mesh_lib.agree(error, summary, m, "capturing the step")
            out[case] = None
        except RuntimeError as e:
            out[case] = str(e)
    return out


def _fixed(sample, cyc, pairs):
    """Patches of the step's random draws: every step gets ``sample``, the
    cycle data ``cyc`` and the contrastive frame pairs ``pairs``."""
    dino_cl, ref_cl = contrastive.dino_bb_contrastive_loss, \
        contrastive.refined_bb_contrastive_loss
    return {
        (train, "sample_batch"): lambda *a, **k: sample,
        (cycle, "generate_cycle_data"): lambda *a, **k: cyc,
        (contrastive, "dino_bb_contrastive_loss"):
            lambda *a, **k: dino_cl(*a, **{**k, "pair_sel": pairs[0]}),
        (contrastive, "refined_bb_contrastive_loss"):
            lambda *a, **k: ref_cl(*a, **{**k, "pair_sel": pairs[1]}),
    }


class FakeGraph:
    """Stands in for ``StepGraph`` on the CPU, so that ``StepRunner`` takes
    its capturing path: the warm-up step, then each replay one eager step.
    ``log`` records after how many steps of the process each capture came."""
    log, steps = [], 0

    def __init__(self, step, generator, model, mesh=None):
        FakeGraph.log.append(FakeGraph.steps)
        self.step, self.graph = step, types.SimpleNamespace(reset=lambda: None)
        self.replay(1)

    def replay(self, n):
        for _ in range(n):
            self.step()
            FakeGraph.steps += 1


def run_trainer(mesh, cfg, pcfg, data, folder, state, fixed=None, rotator=None):
    """A Trainer run from ``state`` -> (model state, checkpoints, logged
    lines); with ``fixed``, module attributes patched (the step's random
    draws replaced, or its capture)."""

    class Trainer(train.Trainer):
        def init_model(self):
            return _model(state, self.tcfg).to(self.device)

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = train.logger
    keep, level = Keep(logging.INFO), log.level
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    saved = {}
    try:
        for (mod, name), fn in (fixed or {}).items():
            saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, fn)
        if rotator is not None:
            fg, bg = rotator.current()
            data = data._replace(fg_bank=fg, bg_bank=bg)
        model = Trainer(cfg, pcfg, data, folder, seed=3, device=torch.device("cpu"),
                        mesh=mesh, bank_rotator=rotator).train(log_interval=LOG_EVERY)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        log.removeHandler(keep)
        log.setLevel(level)
    states = {s: ckpt.load_state(folder, s) for s in ckpt.checkpoint_steps(folder)}
    return {k: v.clone() for k, v in model.state_dict().items()}, states, lines


def run_all(mesh, payload):
    torch.set_num_threads(1)
    out = {"steps": recorded_steps(mesh, *payload["record"]),
           "agree": agreements(mesh)}
    if mesh.world_size == 2:
        t = payload["trainer"]
        for name, spc, fixed in (("stepwise", 1, None), ("chunked", 5, None),
                                 ("injected", 5, _fixed(*t["fixed"]))):
            cfg = dataclasses.replace(t["cfg"], steps_per_call=spc)
            out[name] = run_trainer(mesh, cfg, t["pcfg"], t["data"],
                                    f"{t['folder']}/{name}", t["state"], fixed)
        # the capturing path: banks rotated in place every 3 steps, the gates
        # at 5, chunks of 5
        from dino_tracker_tpu_torch.training.sampler import BankRotator
        cfg = dataclasses.replace(t["cfg"], sampler_batch_iterations=3)
        out["captured"] = run_trainer(
            mesh, cfg, t["pcfg"], t["data"], f"{t['folder']}/captured", t["state"],
            {(train, "StepGraph"): FakeGraph, (train, "eager_because"): lambda d, m: None},
            BankRotator(*t["trajectories"], window=100))[::2] + (list(FakeGraph.log),)
    return out


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    import test_torch_train_step as tts
    from dino_tracker_tpu_torch import convert
    from test_torch_train_losses import weights
    cfg = TrainConfig(**{f.name: getattr(tts.CFG, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    arrays = tts.video_arrays()
    data = tts.port_data(arrays)
    state = convert.state_from_jax(*weights(20))
    pcfg = tts.configs(tts.CHANNELS, "float32")[1]
    sample, cyc, dino_pairs, ref_pairs = tts.injected(data)
    return dict(record=(state, data, cfg, pcfg), trainer=dict(
        cfg=dataclasses.replace(cfg, **RUN), pcfg=pcfg, data=data, state=state,
        trajectories=arrays[3],
        folder=str(tmp_path_factory.mktemp("mesh_graph")),
        fixed=(sample, cycle.CycleData(*map(torch.from_numpy, cyc)),
               (dino_pairs, ref_pairs))))


@pytest.fixture(scope="module")
def spawned(payload):
    """Each rank's results at W = 2 and W = 3 (both worlds at once)."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {w: pool.submit(mesh_lib.spawn, run_all, w, "cpu", args=(payload,),
                               timeout=SPAWN_TIMEOUT) for w in (2, 3)}
        return {w: job.result() for w, job in jobs.items()}


@pytest.mark.parametrize("w", [2, 3])
def test_every_rank_and_step_makes_the_same_collectives(spawned, w):
    """(a) The conditions for capture that hold without a card."""
    ranks = spawned[w]
    first = ranks[0]["steps"]
    seen = [name for name, _, _ in first[-1][1] if first[-1][0] == "forbidden"]
    assert seen[:3] == ["host read item", "host read __bool__", "barrier"], seen
    assert "broadcast_object_list" in seen, seen
    for gates in (False, True):
        calls = [c for g, c in first if g is gates]
        assert len(calls) == RECORDED_STEPS
        assert calls[0], f"gates {gates}: no collective recorded"
        for c in calls[1:]:
            assert c == calls[0], f"gates {gates}: steps differ"
        names = {name for name, _, _ in calls[0]}
        assert names <= {"all_reduce", "all_gather"}, names
    with_gates = [c for g, c in first if g is True][0]
    assert len(with_gates) > len([c for g, c in first if g is False][0])  # the cycle's
    for r in ranks[1:]:
        assert r["steps"][:-1] == first[:-1], f"rank {ranks.index(r)} differs from rank 0"


def test_the_choice_of_replays_is_made_from_the_backend(monkeypatch, caplog, tmp_path):
    """(b) CPU and gloo: eager, saying why; NCCL: captured (backend mocked,
    on a device that is never touched)."""
    cuda = torch.device("cuda", 0)
    two = mesh_lib.Mesh(0, 2, cuda, group="a group")
    assert mesh_lib.capture_blocker(None) is None
    assert mesh_lib.capture_blocker(mesh_lib.Mesh(0, 1, cuda)) is None
    for backend, graphed in (("nccl", True), ("gloo", False)):
        monkeypatch.setattr(mesh_lib.dist, "get_backend", lambda group: backend)
        why = mesh_lib.capture_blocker(two)
        assert (why is None) == graphed, backend
        assert graphed or "gloo" in why
        assert (train.eager_because(cuda, two) is None) == graphed
    assert "cpu" in train.eager_because(torch.device("cpu"), None)
    monkeypatch.undo()

    from test_torch_train_step import tiny_trainer
    with caplog.at_level(logging.INFO, logger=train.__name__):
        tiny_trainer(tmp_path, 1).train(log_interval=1)
    assert any(re.match(r"train steps: eager \(cpu", m) for m in caplog.messages)


def test_the_trainer_on_cpu_ranks_says_it_steps_eagerly(spawned):
    for r in spawned[2]:
        lines = r["chunked"][2]
        assert lines[0].startswith("train steps: eager (cpu tensors"), lines[0]


@pytest.mark.parametrize("w", [2, 3])
def test_a_failed_capture_on_one_rank_raises_on_every_rank(spawned, w):
    """(c) ``mesh.agree``."""
    for r in spawned[w]:
        got = r["agree"]
        assert "rank 1: boom at step.py:7" in got["rank 1 failed"]
        assert "failed on 1 of" in got["rank 1 failed"]
        assert "differs between ranks" in got["summaries differ"]
        assert got["all agree"] is None
        assert "failed on 1 of" in got["over the host group"]


def _assert_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_equal(u, v, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


def test_chunked_mesh_trainer_equals_stepwise(spawned):
    """(d) Bit for bit, on every rank: the model, every checkpoint and every
    log line; every rank holds the same model."""
    for r in spawned[2]:
        _assert_equal(r["chunked"], r["stepwise"], "chunked vs stepwise")
        _assert_equal(r["chunked"][0], spawned[2][0]["chunked"][0], "replicas")
    assert sorted(spawned[2][0]["chunked"][1]) == [10, 15]


def _losses(lines):
    """The metrics dicts of the ``iter N: {...}`` lines."""
    import ast
    return [(int(m.group(1)), ast.literal_eval(m.group(2)))
            for m in (re.match(r"iter (\d+): (\{.*\})", line) for line in lines) if m]


def jax_trainer_losses(t, folder, devices=2):
    """The JAX ``Trainer`` of ``payload``'s ``trainer`` ``t`` on
    ``make_mesh(devices)`` with the same weights, ``steps_per_call`` and
    injected draws: its logged losses."""
    import jax
    import jax.numpy as jnp
    import test_torch_train_step as tts
    from dino_tracker_tpu.config import TrainConfig as JaxTrainConfig
    from dino_tracker_tpu.parallel.mesh import make_mesh
    from dino_tracker_tpu.training import contrastive as jcl
    from dino_tracker_tpu.training import cycle as jcycle
    from dino_tracker_tpu.training import sampler as jsampler
    from dino_tracker_tpu.training import train as jtrain
    from test_torch_train_losses import weights
    cfg = JaxTrainConfig(**{f.name: getattr(t["cfg"], f.name)
                            for f in dataclasses.fields(JaxTrainConfig)})
    jcfg = tts.configs(tts.CHANNELS, "float32")[0]
    sample, cyc, (dino_pairs, ref_pairs) = t["fixed"]
    jsample = jsampler.TrainSample(*[jnp.asarray(x.numpy()) for x in sample])
    jcyc = jcycle.CycleData(*[jnp.asarray(x.numpy()) for x in cyc])
    params, stats = weights(20)
    video, dino, masks, (fg, bg), bb = tts.video_arrays()
    data = jtrain.VideoData(
        jnp.asarray(video), jnp.asarray(dino), jnp.asarray(masks),
        jtrain.BBData(**{k: jnp.asarray(v) for k, v in bb.items()}),
        jsampler.build_bank(fg), jsampler.build_bank(bg))
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    dino_cl, ref_cl = jcl.dino_bb_contrastive_loss, jcl.refined_bb_contrastive_loss
    keep = Keep(logging.INFO)
    jtrain.logger.addHandler(keep)
    level = jtrain.logger.level
    jtrain.logger.setLevel(logging.INFO)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtrain, "sample_batch", lambda *a, **k: jsample)
            mp.setattr(jcycle, "generate_cycle_data", lambda *a, **k: jcyc)
            mp.setattr(jcl, "dino_bb_contrastive_loss",
                       lambda *a, **k: dino_cl(*a, **{**k, "pair_sel": dino_pairs}))
            mp.setattr(jcl, "refined_bb_contrastive_loss",
                       lambda *a, **k: ref_cl(*a, **{**k, "pair_sel": ref_pairs}))
            mp.setattr(jtrain, "init_train_state", lambda key, c, tc: jtrain.TrainState(
                params, stats, jtrain.make_optimizer(c).init(params),
                jnp.asarray(0, jnp.int32)))
            jtrain.Trainer(cfg, jcfg, data, folder, seed=3,
                           mesh=make_mesh(devices) if devices > 1 else None).train(
                               log_interval=LOG_EVERY, progress=False)
    finally:
        jtrain.logger.removeHandler(keep)
        jtrain.logger.setLevel(level)
    jax.clear_caches()
    return _losses(lines)


def test_injected_mesh_trainer_matches_the_jax_mesh_trainer(spawned, payload, tmp_path):
    """(d) The logged f32 losses of the 2-rank Trainer in chunks of 5 and
    of the JAX Trainer on ``make_mesh(2)`` in chunks of 5, each the mean
    over its 5 steps, from the same weights with the same draws."""
    want = jax_trainer_losses(payload["trainer"], str(tmp_path))
    assert [i for i, _ in want] == [5, 10, 15]
    assert want[0][1]["loss_cyc"] == 0 and want[-1][1]["loss_cyc"] > 0
    got = _losses(spawned[2][0]["injected"][2])  # rank 0 logs
    assert [i for i, _ in got] == [i for i, _ in want]
    for (i, g), (_, j) in zip(got, want):
        assert set(g) == set(j), i
        for k in j:
            np.testing.assert_allclose(g[k], j[k], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"iter {i} {k}")
    assert not _losses(spawned[2][1]["injected"][2])


def test_every_rank_recaptures_at_the_same_steps(spawned):
    """``StepRunner``'s capturing path (a stand-in graph whose replays are
    eager steps) on 2 ranks: each rank captures at the same steps, once a
    set of gates (steps 0 and 5), and not at the in-place bank rotations
    (every 3 steps); the ranks' models stay equal."""
    runs = [r["captured"] for r in spawned[2]]
    for model, lines, captures in runs:
        assert captures == [0, 5], captures
        assert lines[0].startswith("train steps: replays of the step captured"), lines[0]
        _assert_equal(model, runs[0][0], "replicas")
