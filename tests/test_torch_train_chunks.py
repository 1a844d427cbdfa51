"""The port's training loop in the JAX trainer's chunks
(``TrainConfig.steps_per_call``): the chunk schedule against the JAX
``Trainer._next_chunk``, the device learning-rate schedule against the JAX
``dd_schedule`` in f32, and a Trainer run in chunks against the same run one
step a chunk (bit for bit: parameters, BN statistics, Adam's state, the
generator, every checkpoint and every log line), its resume mid-run, and the
resume from a checkpoint in the layout written while the schedule was a
``LambdaLR``.

On the CPU a chunk is the eager step n times; the CUDA graph a chunk replays
on the card is held against the eager steps by ``chip_smoke.py`` phase 5.
"""

import dataclasses
import logging
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tracker_tpu.config import TrainConfig as JaxTrainConfig
from dino_tracker_tpu.training import train as jtrain
from dino_tracker_tpu_torch.config import TrainConfig
from dino_tracker_tpu_torch.models import tracker
from dino_tracker_tpu_torch.training import checkpoint as ckpt
from dino_tracker_tpu_torch.training import sampler, train
from test_torch_model_slice import configs
from test_torch_train_step import CFG, CHANNELS, port_data, video_arrays
from test_torch_threads import one_thread  # noqa: F401

GATES = {"at 0": (0, 0), "mid-run": (30, 45), "never": (10**6, 10**6)}


@pytest.mark.parametrize("gates", GATES)
@pytest.mark.parametrize("steps_per_call", [1, 7, 25])
def test_next_chunk_matches_jax(steps_per_call, gates):
    """Every iteration of a run is a resume point: from each, the chunk
    length equals the JAX method's, called unbound on an object holding only
    the config, over totals, log, checkpoint and rotation intervals."""
    cyc, cl_ref = GATES[gates]
    n_cases = 0
    for total in (9, 60, 101):
        for log_interval in (1, 20, 100):
            for ckpt_every, rotate_every in ((7, 100_000), (50, 13), (2500, 25)):
                cfg = JaxTrainConfig(
                    total_iterations=total, steps_per_call=steps_per_call,
                    apply_cyc_after=cyc, apply_cl_ref_after=cl_ref,
                    checkpoint_interval=ckpt_every,
                    sampler_batch_iterations=rotate_every)
                holder = types.SimpleNamespace(cfg=cfg)
                for i in range(total):
                    want = jtrain.Trainer._next_chunk(holder, i, log_interval)
                    assert train.next_chunk(cfg, i, log_interval) == want, (
                        total, log_interval, ckpt_every, rotate_every, i)
                    n_cases += 1
    assert n_cases == 9 * 170


def jax_dd_schedule(cfg, counts):
    """The JAX ``make_optimizer``'s ``dd_schedule``
    (dino_tracker_tpu/training/train.py:62-64) compiled by JAX on int32
    counts, as optax's ``scale_by_schedule`` calls it."""
    return np.asarray(jax.jit(lambda count: cfg.lr_delta_dino * cfg.scheduler_gamma ** (
        count // cfg.apply_scheduler_every))(jnp.asarray(counts, jnp.int32)))


def schedule_values(cfg, n):
    opt, sched = train.make_optimizer(tracker.Tracker(configs(CHANNELS)[1]), cfg)
    values = []
    for _ in range(n):
        assert opt.param_groups[0]["lr"] is sched.lr
        values.append(sched.lr.clone())
        sched.step()
    return torch.stack(values).numpy()


@pytest.mark.parametrize("lr,gamma", [(0.01, 0.999), (1e-4, 0.97), (3e-3, 0.5),
                                      (0.02, 0.95)])
def test_device_schedule_matches_jax_dd_schedule(lr, gamma):
    """The learning rate the schedule writes for counts 0..200 (every 40, so
    a 25-step chunk crosses a boundary) against the JAX schedule in f32:
    equal at the config's defaults (the first case); elsewhere within one
    f32 ulp, since XLA's ``pow`` and the correctly rounded one PyTorch calls
    on the CPU may round γ^k apart."""
    cfg = TrainConfig(lr_delta_dino=lr, scheduler_gamma=gamma,
                      apply_scheduler_every=40)
    ours = schedule_values(cfg, 201)
    want = jax_dd_schedule(cfg, np.arange(201))
    assert ours.dtype == want.dtype == np.float32
    if (lr, gamma) == (0.01, 0.999):
        np.testing.assert_array_equal(ours, want)
    else:
        np.testing.assert_array_max_ulp(ours, want, maxulp=1)
    assert (np.diff(ours.reshape(-1)[:200].reshape(5, 40), axis=1) == 0).all()


RUN = dict(total_iterations=60, apply_cyc_after=30, apply_cl_ref_after=30,
           checkpoint_interval=50, sampler_batch_iterations=15,
           cl_points_per_pair=16)
LOG_EVERY = 20


def trainer(folder, arrays, steps_per_call, **changes):
    """A Trainer of the tiny test config with a bank rotator (windows of 100
    of 150 rows, rotated every 15 steps)."""
    cfg = dataclasses.replace(CFG, **{**RUN, **changes},
                              steps_per_call=steps_per_call)
    rotator = sampler.BankRotator(*arrays[3], window=100)
    fg, bg = rotator.current()
    data = port_data(arrays)._replace(fg_bank=fg, bg_bank=bg)
    return train.Trainer(cfg, configs(CHANNELS)[1], data, str(folder), seed=3,
                         bank_rotator=rotator, device=torch.device("cpu"))


def run(tr):
    """Train; returns (model, chunk lengths, logged lines)."""
    chunks, lines = [], []
    step_run = train.StepRunner.run

    def spy(self, data, use_cyc, use_cl_ref, n):
        chunks.append(n)
        return step_run(self, data, use_cyc, use_cl_ref, n)

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger(train.__name__)
    keep, level = Keep(logging.INFO), log.level
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train.StepRunner, "run", spy)
            model = tr.train(log_interval=LOG_EVERY)
    finally:
        log.removeHandler(keep)
        log.setLevel(level)
    return model, chunks, lines


def assert_equal(a, b, what):
    """Nested dicts/lists of tensors and numbers equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (u, v) in enumerate(zip(a, b)):
            assert_equal(u, v, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def arrays():
    return video_arrays(5)


@pytest.fixture(scope="module")
def stepwise(arrays, tmp_path_factory):
    """The run one step a chunk: (folder, model, log lines)."""
    folder = tmp_path_factory.mktemp("stepwise")
    model, chunks, lines = run(trainer(folder, arrays, 1))
    assert chunks == [1] * 60
    return folder, model, lines


@pytest.mark.parametrize("steps_per_call", [7, 25])
def test_chunked_trainer_equals_stepwise(steps_per_call, arrays, stepwise,
                                         tmp_path):
    """60 iterations, gates at 30, a checkpoint at 50, a log every 20, a bank
    rotation every 15: the chunks stop at each of them and are otherwise
    ``steps_per_call`` long, and the run equals the one-step-a-chunk run bit
    for bit."""
    folder, model1, lines1 = stepwise
    model, chunks, lines = run(trainer(tmp_path, arrays, steps_per_call))
    want = {7: [7, 7, 1, 5, 7, 3, 7, 3, 5, 5, 7, 3], 25: [15, 5, 10, 10, 5, 5, 10]}
    assert chunks == want[steps_per_call] and sum(chunks) == 60
    assert lines == lines1 and len(lines) == 4  # the step mode, then 3 logs
    assert lines[0] == "train steps: eager (cpu tensors: CUDA graphs hold only CUDA work)"
    assert_equal(model.state_dict(), model1.state_dict(), "model")
    assert ckpt.checkpoint_steps(str(tmp_path)) == [60, 50]
    for step in (50, 60):
        assert_equal(ckpt.load_state(str(tmp_path), step),
                     ckpt.load_state(str(folder), step), f"state_{step}")


def test_resume_mid_run_equals_uninterrupted(arrays, stepwise, tmp_path):
    """A run cut at 50 (its last checkpoint) and resumed to 60, in chunks of
    25, equals the uninterrupted run."""
    folder, model1, _ = stepwise
    trainer(tmp_path, arrays, 25, total_iterations=50).train(log_interval=LOG_EVERY)
    tr = trainer(tmp_path, arrays, 25)
    for _ in range(50 // RUN["sampler_batch_iterations"]):  # the cut run's windows
        tr.bank_rotator.advance()
    model = tr.train(log_interval=LOG_EVERY)
    assert_equal(model.state_dict(), model1.state_dict(), "model")
    assert_equal(ckpt.load_state(str(tmp_path), 60),
                 ckpt.load_state(str(folder), 60), "state_60")


def test_resume_from_a_lambdalr_checkpoint(arrays, stepwise, tmp_path):
    """state_50 of the uninterrupted run rewritten in the layout of the files
    written while the schedule was a ``LambdaLR`` (Adam's groups with float
    rates, ``initial_lr`` and no device state; the scheduler's full
    ``state_dict``): the resumed run ends equal to the uninterrupted one."""
    folder, model1, _ = stepwise
    state = ckpt.load_state(str(folder), 50)
    cfg = trainer(tmp_path, arrays, 25).cfg
    model = tracker.Tracker(configs(CHANNELS)[1])
    gamma, every = cfg.scheduler_gamma, cfg.apply_scheduler_every
    opt = torch.optim.Adam(  # the optimizer and schedule of those files
        [{"params": model.delta_dino.parameters(), "lr": cfg.lr_delta_dino},
         {"params": model.tracker_head.parameters(), "lr": cfg.lr_cnn_refiner}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, [lambda k: gamma ** (k // every), lambda k: 1.0])
    opt.load_state_dict({"state": state["optimizer"]["state"],
                         "param_groups": opt.state_dict()["param_groups"]})
    with warnings.catch_warnings():  # the updates ran before: no warning
        warnings.simplefilter("ignore")
        for _ in range(50):
            sched.step()
    old = dict(state, optimizer=opt.state_dict(), scheduler=sched.state_dict())
    assert isinstance(old["optimizer"]["param_groups"][0]["lr"], float)
    assert "initial_lr" in old["optimizer"]["param_groups"][0]
    assert old["scheduler"]["last_epoch"] == 50 and "base_lrs" in old["scheduler"]
    ckpt.save_state(str(tmp_path), old, 50)

    tr = trainer(tmp_path, arrays, 25)
    for _ in range(50 // RUN["sampler_batch_iterations"]):
        tr.bank_rotator.advance()
    resumed = tr.train(log_interval=LOG_EVERY)
    assert_equal(resumed.state_dict(), model1.state_dict(), "model")
    assert_equal(ckpt.load_state(str(tmp_path), 60),
                 ckpt.load_state(str(folder), 60), "state_60")


def test_bank_rotator_writes_the_next_window_in_place():
    """``advance`` rewrites the tensors ``current`` handed out (a captured
    step reads them), with the next window, and keeps the counts."""
    rng = np.random.default_rng(7)
    traj = rng.random((50, 6, 2)).astype(np.float32)
    rot = sampler.BankRotator(traj, traj[:30], window=20)
    fg, bg = rot.current()
    ptrs = (fg.coords.data_ptr(), fg.valid.data_ptr(), bg.coords.data_ptr())
    fg2, bg2 = rot.advance()
    assert (fg2.coords.data_ptr(), fg2.valid.data_ptr(), bg2.coords.data_ptr()) == ptrs
    np.testing.assert_array_equal(fg.coords.numpy(), traj[20:40])
    np.testing.assert_array_equal(bg.coords.numpy(), traj[(20 + np.arange(20)) % 30])
    assert (fg2.count, bg2.count) == (20, 20)
