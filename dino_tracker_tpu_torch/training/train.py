"""The train step and the per-video training loop (port of
dino_tracker_tpu/training/train.py; reference train loop
dino_tracker.py:392-448).

One step: sample a batch of trajectory point pairs, run DeltaDINO ONCE on the
step's frame set (train-mode BN updates the running statistics in place),
build one ``FrameView`` shared by every loss term, compute the six losses
(optical flow, cycle consistency, the two best-buddy contrastive terms and
the two refined-embedding regularisers), backpropagate and take one Adam
step. Phase gates switch cycle consistency and the refined-buddy term on at
``apply_cyc_after`` / ``apply_cl_ref_after``. The step makes no host sync
and no upload from host memory: the schedule's learning rate is device
state (``LRSchedule``) and the constants it needs are made once.

The loop runs the JAX trainer's chunks: ``next_chunk`` gives the longest run
of at most ``cfg.steps_per_call`` steps that crosses no phase gate, log,
checkpoint or bank rotation, and within it the host does no work between
steps and reads nothing back (``StepRunner``). On a CUDA device, with no
mesh or on each rank of an NCCL mesh, a chunk is n replays of one captured
CUDA graph of the whole step, collectives included
(``step_graph.StepGraph``), captured once per variant as the JAX
``Trainer._step_fn`` compiles one program per phase and ``fg_batch``; on the
CPU and over gloo (whose collectives cannot be captured) it is the eager
step n times. The metrics' all-reduce, the log, rank 0's saves, the bank
rotation and the ranks' closing timers and barrier run between chunks.

Parallelism (``mesh``, ``parallel/mesh.py``): every rank holds the same
parameters and the same generator, so every rank draws the single-device
batch, cycle points and contrastive pairs. The DeltaDINO frame set, the
point batch and the cycle loss's per-pair points shard over the ranks (the
JAX package's ``constrain_batch`` / ``constrain_axis``); the terms computed
from the whole refined stack (the two contrastive terms, the two
regularisers) run on every rank, scaled by 1/W. Each rank's loss is then
its share of the single-device loss, and the gradients summed over ranks
(``all_reduce_grads``) are the single-device ones, so Adam keeps the
parameters replicated.

``cfg`` is the port's ``config.TrainConfig`` (or any object with its
fields).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
from typing import NamedTuple, Optional

import torch

from ..config import TrackerConfig
from ..models import tracker
from ..parallel import mesh as mesh_lib
from ..structures import BBData
from ..utils import profiling
from ..utils.profiling import stage_timer, step_span
from . import checkpoint as ckpt_lib
from . import contrastive, cycle, losses
from .sampler import TrajectoryBank, TrainSample, resolve_fg_batch, sample_batch
from .step_graph import StepGraph

logger = logging.getLogger(__name__)

METRICS = ("loss_of", "loss_cyc", "loss_cl_refiner", "loss_cl_dino_bb",
           "loss_emb_norm_reg", "loss_angle_reg", "loss_total")


class VideoData(NamedTuple):
    """Per-video training data, resident on the training device."""
    video: torch.Tensor        # T×3×H×W float32 in [0, 1]
    dino_embed: torch.Tensor   # T×C×h'×w', f16 (the artifact dtype) or f32
    fg_masks: torch.Tensor     # T×H×W float32
    bb: BBData
    fg_bank: TrajectoryBank
    bg_bank: TrajectoryBank


class LRSchedule:
    """DeltaDINO's learning rate as device state: ``lr`` (the tensor its
    Adam group reads) holds lr·γ^(k // every) for the k-th update, k counted
    from 0, computed on the device from the update count in f32 as optax's
    ``dd_schedule`` is inside the JAX program (train.py:62-64). A captured
    step advances it with no host work, including across an ``every``
    boundary inside a chunk. ``state_dict`` keeps LambdaLR's ``last_epoch``
    (the count), the layout of checkpoints written before."""

    def __init__(self, lr: torch.Tensor, base: float, gamma: float, every: int):
        self.lr = lr
        self.count = torch.zeros((), dtype=torch.int64, device=lr.device)
        self._base, self._every = base, every
        self._gamma = torch.full((), gamma, dtype=torch.float32, device=lr.device)
        self._write()

    def _write(self):
        self.lr.copy_(self._base * torch.pow(self._gamma, self.count // self._every))

    def step(self):
        """After an update: the next update's rate."""
        self.count += 1
        self._write()

    def state_dict(self) -> dict:
        """Reads the count back (a host sync)."""
        return {"last_epoch": int(self.count)}

    def load_state_dict(self, state: dict):
        self.count.fill_(int(state["last_epoch"]))
        self._write()


def make_optimizer(model: tracker.Tracker, cfg):
    """Adam per parameter group with the reference's learning rates
    (optimization/schedulers.py:4-8, dino_tracker.py:110-121), as the JAX
    ``make_optimizer`` builds them from optax. Returns (optimizer,
    ``LRSchedule``); step the schedule after each update.

    DeltaDINO's group reads its learning rate from the schedule's device
    tensor; the head's is a constant. On CUDA the optimizer is
    ``capturable``: its step counts and bias corrections stay on the device
    (in f32, as optax computes them), so a CUDA graph can hold the update.
    The CPU has no capturable Adam: there the corrections are f64 host
    numbers.

    Trap (optimizer equivalence): optax's ``scale_by_adam`` defaults are
    β = (0.9, 0.999) and ε = 1e-8 added outside the square root, with no
    weight decay — torch's Adam update is the same. The schedule's k counts
    updates from 0, as optax's ``count`` does.

    Trap (gradients zero in exact math): DeltaDINO's conv biases are
    detached in training and get no update; ``tracker_head.conv2.bias``
    shifts the softmax logits by a constant, so its gradient is float noise
    that Adam turns into steps of about ±lr, as in the JAX package."""
    dev = next(model.parameters()).device
    lr = torch.full((), cfg.lr_delta_dino, dtype=torch.float32, device=dev)
    opt = torch.optim.Adam(
        [{"params": model.delta_dino.parameters(), "lr": lr},
         {"params": model.tracker_head.parameters(), "lr": cfg.lr_cnn_refiner}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
        capturable=dev.type == "cuda")
    return opt, LRSchedule(lr, cfg.lr_delta_dino, cfg.scheduler_gamma,
                           cfg.apply_scheduler_every)


def optimizer_state(opt) -> dict:
    """``opt.state_dict()`` with each group's learning rate as a float, as
    checkpoints held it when it was one (reads the rate back: a host
    sync)."""
    sd = opt.state_dict()
    return {"state": sd["state"], "param_groups": [
        {**g, "lr": float(g["lr"])} for g in sd["param_groups"]]}


def load_optimizer_state(opt, saved: dict):
    """Adam's moments and step counts from a checkpoint's ``optimizer``
    entry. The groups' settings stay this optimizer's own: files written
    before the schedule moved to the device hold a float rate and no
    ``capturable``, and ``load_state_dict`` would put copies in place of the
    rate tensor the schedule writes."""
    lrs = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict({"state": saved["state"],
                         "param_groups": opt.state_dict()["param_groups"]})
    for g, lr in zip(opt.param_groups, lrs):
        g["lr"] = lr


def step_losses(model: tracker.Tracker, data: VideoData, sample: TrainSample,
                generator: torch.Generator, cfg, tcfg: TrackerConfig,
                use_cyc: bool, use_cl_ref: bool,
                cyc_data: Optional[cycle.CycleData] = None,
                dino_pair_sel=None, ref_pair_sel=None, mesh=None):
    """The loss of one step (the JAX ``loss_fn`` of make_train_step,
    train.py:113-181) on a sampled batch -> (total, metrics). The model must
    be in train mode. ``cyc_data`` and the two ``*_pair_sel`` replace the
    step's own random draws of those terms (tests inject them). With a
    ``mesh`` both are this rank's share: summed over ranks
    (``reduce_metrics``) they are the single-device values."""
    frames_set_t = sample.frames_set_t
    with step_span("train/step/refiner"):
        refined, raw = tracker.get_refined_embeddings(
            model, data.video, data.dino_embed, frames_set_t, tcfg, mesh=mesh)
    # the backward pass: the terms' part ends, the refiner's begins, once
    # every term's gradient of the refined stack is summed
    refined = profiling.step_boundary(refined, ends="train/step/backward_terms",
                                      begins="train/step/refiner_bwd")
    with step_span("train/step/view"):
        # one cast+norm pass of the refined stack, shared by every loss term
        view = tracker.make_frame_view(refined, tcfg.torch_compute_dtype)
    with step_span("train/step/flow_term"):
        # the flow term: the mean over the batch of this rank's points' sum
        rows = lambda x: mesh_lib.split_rows(x, mesh)
        coords = tracker.get_point_predictions(
            model, rows(sample.t1_points), rows(sample.source_frame_indices),
            rows(sample.target_frame_indices), refined, tcfg, view=view)
        labels = sample.t2_points_normalized[:, :2]
        l_of = losses.huber(coords, rows(labels)).sum() / labels.numel()
    total = l_of
    zero = torch.zeros((), device=refined.device)

    l_cyc = zero
    if use_cyc:
        with step_span("train/step/cycle"):
            if cyc_data is None:
                cyc_data = cycle.generate_cycle_data(
                    generator, model, refined, frames_set_t, data.fg_masks, tcfg,
                    cfg.cyc_n_frames, cfg.cyc_batch_size_per_frame,
                    cfg.cyc_fg_points_ratio, cfg.cyc_thresh, view=view, mesh=mesh)
            l_cyc = cycle.cycle_consistency_loss(
                model, refined, cyc_data, tcfg, cfg.cyc_gamma,
                group_size=cfg.cyc_batch_size_per_frame, view=view, mesh=mesh)
        total = total + cfg.lambda_cyc * l_cyc

    # the terms of the whole refined stack: every rank computes them whole
    # and takes 1/W of each
    share = lambda v: v / mesh.world_size if mesh_lib.is_parallel(mesh) else v
    l_cl_ref = zero
    if use_cl_ref:
        with step_span("train/step/contrastive_ref"):
            l_cl_ref = share(contrastive.refined_bb_contrastive_loss(
                generator, refined, frames_set_t, data.fg_masks, tcfg,
                cfg.cl_n_frames, cfg.cl_points_per_pair, cfg.cl_fg_points_ratio,
                cfg.cl_temp, cfg.cl_div_ref_bb, view=view, pair_sel=ref_pair_sel))
        total = total + cfg.lambda_cl_ref_bb * l_cl_ref

    with step_span("train/step/contrastive_dino"):
        l_cl_dino = share(contrastive.dino_bb_contrastive_loss(
            generator, refined, frames_set_t, data.bb, data.fg_masks, tcfg,
            cfg.cl_n_frames, cfg.cl_points_per_pair, cfg.cl_fg_points_ratio,
            cfg.cl_temp, cfg.cl_div_dino_bb, cfg.bb_amb_sig_a, cfg.bb_amb_sig_b,
            view=view, pair_sel=dino_pair_sel))
    with step_span("train/step/regularisers"):
        l_norm = share(losses.emb_norm_regularization(refined, raw))
        l_angle = share(losses.emb_angle_regularization(refined, raw))
    total = (total + cfg.lambda_cl_dino_bb * l_cl_dino
             + cfg.lambda_emb_norm * l_norm + cfg.lambda_angle * l_angle)
    values = (l_of, l_cyc, l_cl_ref, l_cl_dino, l_norm, l_angle, total)
    return total, {k: v.detach() for k, v in zip(METRICS, values)}


def reduce_metrics(metrics: dict, mesh=None) -> dict:
    """The ranks' shares of ``step_losses``'s metrics summed (one
    all-reduce): the single-device values on every rank."""
    if not mesh_lib.is_parallel(mesh):
        return metrics
    keys = list(metrics)
    total = mesh_lib.all_reduce_sum(torch.stack([metrics[k] for k in keys]), mesh)
    return dict(zip(keys, total))


def train_step(model: tracker.Tracker, opt, sched, data: VideoData,
               generator: torch.Generator, use_cyc: bool, use_cl_ref: bool,
               cfg, tcfg: TrackerConfig, mesh=None) -> dict:
    """One training iteration (the body of the JAX make_train_step,
    train.py:98-187): sample, losses, backward, Adam step. Returns the
    metrics as device scalars (reading them is the caller's sync); with a
    ``mesh``, this rank's shares of them (``reduce_metrics``), after the
    gradients were summed over the ranks."""
    with step_span("train/step"):
        with step_span("train/step/sampler"):
            fg_batch = resolve_fg_batch(data.fg_bank, data.bg_bank,
                                        cfg.train_batch_size, cfg.fg_traj_ratio)
            sample = sample_batch(generator, data.fg_bank, data.bg_bank,
                                  cfg.train_batch_size, cfg.batch_n_frames,
                                  cfg.fg_traj_ratio, data.video.shape[0],
                                  cfg.video_resw, cfg.video_resh, fg_batch=fg_batch)
        total, metrics = step_losses(model, data, sample, generator, cfg, tcfg,
                                     use_cyc, use_cl_ref, mesh=mesh)
        opt.zero_grad(set_to_none=True)
        # the backward pass from the loss down to the refined stack's
        # gradient, then through DeltaDINO (``step_losses`` marks the turn)
        profiling.step_boundary(total, begins="train/step/backward_terms").backward()
        profiling.step_span_end("train/step/refiner_bwd")
        with (step_span("train/step/all_reduce") if mesh_lib.is_parallel(mesh)
              else contextlib.nullcontext()):  # a part only on a mesh
            mesh_lib.all_reduce_grads(model, mesh)
        with step_span("train/step/optimizer"):
            opt.step()
            sched.step()
    return metrics


def train_state(model, opt, sched, generator, step: int) -> dict:
    """What a checkpoint holds: everything a resumed run needs to continue
    exactly."""
    return {"model": model.state_dict(), "optimizer": optimizer_state(opt),
            "scheduler": sched.state_dict(), "generator": generator.get_state(),
            "step": step}


def next_chunk(cfg, i: int, log_interval: int) -> int:
    """The JAX ``Trainer._next_chunk`` (train.py:251-265): the longest run of
    steps from iteration ``i``, at most ``cfg.steps_per_call``, that crosses
    no phase gate, log, checkpoint or bank-rotation boundary."""
    n = min(max(cfg.steps_per_call, 1), cfg.total_iterations - i)
    for boundary in (cfg.apply_cyc_after, cfg.apply_cl_ref_after):
        if i < boundary:
            n = min(n, boundary - i)
    for interval in (log_interval, cfg.checkpoint_interval,
                     cfg.sampler_batch_iterations):
        if interval > 0:
            n = min(n, ((i // interval) + 1) * interval - i)
    return max(n, 1)


def _leaves(x):
    if isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _same_data(a: VideoData, b: VideoData) -> bool:
    return all(u is v if isinstance(u, torch.Tensor) else u == v
               for u, v in zip(_leaves(a), _leaves(b)))


def eager_because(device: torch.device, mesh=None) -> Optional[str]:
    """None where the train step on ``device`` (and ``mesh``) is captured
    into a CUDA graph and replayed; else why it runs eagerly."""
    if device.type != "cuda":
        return f"{device.type} tensors: CUDA graphs hold only CUDA work"
    return mesh_lib.capture_blocker(mesh)


class StepRunner:
    """Runs the steps of a chunk and keeps their metrics' sums on the device
    (``metrics``, in ``METRICS`` order), so the host reads nothing between
    steps. On a CUDA device with no mesh, or on an NCCL mesh
    (``mesh.capture_blocker``), the steps are replays of a ``StepGraph``,
    captured anew for each variant: the phase gates and the resolved
    ``fg_batch`` (the JAX ``Trainer._step_fn``'s key), or data other than
    the captured tensors. The first step of a variant is the capture's
    warm-up, a real step. Elsewhere each step runs eagerly, and
    ``eager_because`` says why.

    On a mesh every rank captures and replays its own graph of the whole
    data-parallel step, its collectives included, and every rank must
    capture anew at the same step: it does by construction, since the
    variant and ``_same_data`` are decided from what every rank holds alike
    (the same gates, the same bank counts and data, rotated in place at the
    same iteration).

    ``spans`` times the step's parts (``train/step/<part>``,
    ``profiling.StepSpans``): a captured step always holds their events, an
    eager step records them while a profiler records."""

    def __init__(self, model, opt, sched, generator: torch.Generator, cfg,
                 tcfg: TrackerConfig, mesh=None):
        self.model, self.opt, self.sched = model, opt, sched
        self.generator, self.cfg, self.tcfg, self.mesh = generator, cfg, tcfg, mesh
        self.metrics = torch.zeros(len(METRICS), device=generator.device)
        self.eager_because = eager_because(generator.device, mesh)
        self.graphed = self.eager_because is None
        self._graph = self._variant = self._data = None
        self.spans = profiling.StepSpans(generator.device)

    def step(self, data: VideoData, use_cyc: bool, use_cl_ref: bool):
        capturing = self.spans.cuda and torch.cuda.is_current_stream_capturing()
        with self.spans.taking(capturing):
            m = train_step(self.model, self.opt, self.sched, data, self.generator,
                           use_cyc, use_cl_ref, self.cfg, self.tcfg, self.mesh)
        self.metrics.add_(torch.stack([m[k] for k in METRICS]))

    def run(self, data: VideoData, use_cyc: bool, use_cl_ref: bool, n: int):
        """Take ``n`` steps under these gates. While a profiler records, the
        newest step's parts are then read (``profiling.StepSpans``): whoever
        traces waits for the card right after."""
        self._run(data, use_cyc, use_cl_ref, n)
        self.spans.read()

    def _run(self, data: VideoData, use_cyc: bool, use_cl_ref: bool, n: int):
        if not self.graphed:
            for _ in range(n):
                self.step(data, use_cyc, use_cl_ref)
            return
        variant = (use_cyc, use_cl_ref,
                   resolve_fg_batch(data.fg_bank, data.bg_bank,
                                    self.cfg.train_batch_size,
                                    self.cfg.fg_traj_ratio))
        if (self._graph is None or variant != self._variant
                or not _same_data(data, self._data)):
            self.release()
            self._graph = StepGraph(
                functools.partial(self.step, data, use_cyc, use_cl_ref),
                self.generator, self.model, self.mesh)
            self._variant, self._data = variant, data
            n -= 1
        if n:
            self._graph.replay(n)
            self.spans.replayed()

    def take_metrics(self) -> dict:
        """The metrics' sums since the last call (device scalars); resets
        them."""
        sums = dict(zip(METRICS, self.metrics.clone()))
        self.metrics.zero_()
        return sums

    def release(self):
        """Drop the graph, and the gradients that live in its memory pool:
        the pool's memory returns once both are gone."""
        if self._graph is not None:
            self._graph.graph.reset()
            self._graph = self._variant = self._data = None
            self.opt.zero_grad(set_to_none=True)


def steps_stage(cyc: bool, cl_ref: bool) -> str:
    """The stage-timer name (``utils/profiling.py``) of a run of training
    steps under these phase gates."""
    if cyc == cl_ref:
        return f"train/steps_gates_{'on' if cyc else 'off'}"
    return f"train/steps_{'cycle' if cyc else 'cl_ref'}_on"


@dataclasses.dataclass
class Trainer:
    """Per-video training driver: phase gates, logging, checkpointing and
    resume, trajectory-bank rotation (reference dino_tracker.py:392-448).
    Stage timers, fenced on the device: the model's init or resume
    (``train/init``), the steps under each set of gates (``steps_stage``),
    and apart from them the log's metric reads (``train/log``), the
    checkpoints' snapshots and the final save (``train/checkpoint``) and the
    bank rotations (``train/bank_rotation``); while a profiler records, each
    log also reads the newest step's parts into the registry.

    With a ``mesh`` (``parallel/mesh.py``) every rank runs this loop on its
    own device with the same seed: the metrics are summed over the ranks for
    the log, rank 0 alone logs and writes checkpoints, every rank resumes from
    the same file, and the timers are each rank's own, with the slowest
    rank's steps added as ``<stage>/slowest_rank``."""

    cfg: object  # config.TrainConfig, or any object with its fields
    tcfg: TrackerConfig
    data: VideoData
    ckpt_folder: str
    seed: int = 2
    bank_rotator: Optional[object] = None  # sampler.BankRotator for long videos
    device: torch.device = torch.device("cuda")
    mesh: Optional[mesh_lib.Mesh] = None

    def __post_init__(self):
        if self.mesh is not None:
            self.device = self.mesh.device

    def init_model(self) -> tracker.Tracker:
        """The seeded initial model (drawn on the CPU, so every device starts
        from the same weights), on the training device."""
        model = tracker.Tracker(self.tcfg)
        model.reset_parameters(torch.Generator().manual_seed(self.seed))
        return model.to(self.device)

    def train(self, log_interval: int = 100) -> tracker.Tracker:
        cfg = self.cfg
        with stage_timer("train/init", fence=self.device):
            model = self.init_model().train()
            opt, sched = make_optimizer(model, cfg)
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
            state, i = ckpt_lib.load_latest(self.ckpt_folder, map_location="cpu")
            if state is not None:
                model.load_state_dict(state["model"])
                load_optimizer_state(opt, state["optimizer"])
                sched.load_state_dict(state["scheduler"])
                generator.set_state(state["generator"])
                logger.info("resumed from iter %d", i)
        i = max(i, 0)

        runner = StepRunner(model, opt, sched, generator, cfg, self.tcfg, self.mesh)
        if runner.graphed:
            logger.info("train steps: replays of the step captured into a CUDA "
                        "graph once per phase%s", " on every rank"
                        if mesh_lib.is_parallel(self.mesh) else "")
        else:
            logger.info("train steps: eager (%s)", runner.eager_because)
        running_n = 0
        main = mesh_lib.is_main(self.mesh)
        saver = ckpt_lib.AsyncSaver()
        steps, gates = contextlib.ExitStack(), None  # the open timer of a run of steps
        try:
            while i < cfg.total_iterations:
                n = next_chunk(cfg, i, log_interval)
                on = (i >= cfg.apply_cyc_after, i >= cfg.apply_cl_ref_after)
                if on != gates:
                    steps.close()
                    steps.enter_context(stage_timer(steps_stage(*on), fence=self.device))
                    gates = on
                runner.run(self.data, *on, n)
                running_n += n
                i += n
                log = i % log_interval == 0
                save = i % cfg.checkpoint_interval == 0 and i < cfg.total_iterations
                rotate = (self.bank_rotator is not None
                          and i % cfg.sampler_batch_iterations == 0
                          and i < cfg.total_iterations)
                if log or save or rotate:  # host work, timed apart from the steps
                    steps.close()
                    gates = None
                if log:
                    with stage_timer("train/log", fence=self.device):
                        running = reduce_metrics(runner.take_metrics(), self.mesh)
                        if main:
                            logger.info("iter %d: %s", i, {
                                k: float(v) / running_n for k, v in running.items()})
                        runner.spans.read()  # while a profiler records
                    running_n = 0
                if save and main:
                    with stage_timer("train/checkpoint", fence=self.device):
                        saver.save(self.ckpt_folder,
                                   train_state(model, opt, sched, generator, i), i)
                if rotate:  # new windows, written into the banks' own tensors
                    with stage_timer("train/bank_rotation", fence=self.device):
                        fg_bank, bg_bank = self.bank_rotator.advance()
                        self.data = self.data._replace(fg_bank=fg_bank, bg_bank=bg_bank)
            steps.close()
        finally:
            runner.release()
        if main:
            with stage_timer("train/checkpoint", fence=self.device):
                saver.join()  # every interval save landed (or its failure raises)
                ckpt_lib.save_state(self.ckpt_folder,
                                    train_state(model, opt, sched, generator,
                                                cfg.total_iterations),
                                    cfg.total_iterations)
        if mesh_lib.is_parallel(self.mesh):
            profiling.add_slowest_rank(self.mesh, "train/steps")
            mesh_lib.barrier(self.mesh)  # the final checkpoint is on disk
        return model
