"""The train step and the per-video training loop (port of
dino_tracker_tpu/training/train.py; reference train loop
dino_tracker.py:392-448).

One step: sample a batch of trajectory point pairs, run DeltaDINO ONCE on the
step's frame set (train-mode BN updates the running statistics in place),
build one ``FrameView`` shared by every loss term, compute the six losses
(optical flow, cycle consistency, the two best-buddy contrastive terms and
the two refined-embedding regularisers), backpropagate and take one Adam
step. Phase gates switch cycle consistency and the refined-buddy term on at
``apply_cyc_after`` / ``apply_cl_ref_after``. PyTorch runs eagerly, so the
JAX package's two compiled phase variants and its ``steps_per_call``
``lax.scan`` chunking have no counterpart: the loop runs one step per
iteration.

``cfg`` is the port's ``config.TrainConfig`` (or any object with its
fields).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import NamedTuple, Optional

import torch

from ..config import TrackerConfig
from ..models import tracker
from ..structures import BBData
from ..utils.profiling import stage_timer
from . import checkpoint as ckpt_lib
from . import contrastive, cycle, losses
from .sampler import TrajectoryBank, TrainSample, resolve_fg_batch, sample_batch

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


def make_optimizer(model: tracker.Tracker, cfg):
    """Adam per parameter group with the reference's learning rates
    (optimization/schedulers.py:4-8, dino_tracker.py:110-121), as the JAX
    ``make_optimizer`` builds them from optax.

    Trap (optimizer equivalence): optax's ``scale_by_adam`` defaults are
    β = (0.9, 0.999) and ε = 1e-8 added outside the square root, with no
    weight decay — torch's Adam update is the same. DeltaDINO's learning rate
    is lr·γ^(k // every) for the k-th update, k counted from 0 as optax's
    schedule ``count`` is: a ``LambdaLR`` starts at k = 0 and is stepped after
    each update. The head's learning rate is constant.

    Trap (gradients zero in exact math): DeltaDINO's conv biases are
    detached in training and get no update; ``tracker_head.conv2.bias``
    shifts the softmax logits by a constant, so its gradient is float noise
    that Adam turns into steps of about ±lr, as in the JAX package.
    Returns (optimizer, scheduler)."""
    opt = torch.optim.Adam(
        [{"params": model.delta_dino.parameters(), "lr": cfg.lr_delta_dino},
         {"params": model.tracker_head.parameters(), "lr": cfg.lr_cnn_refiner}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    gamma, every = cfg.scheduler_gamma, cfg.apply_scheduler_every
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, [lambda k: gamma ** (k // every), lambda k: 1.0])
    return opt, sched


def step_losses(model: tracker.Tracker, data: VideoData, sample: TrainSample,
                generator: torch.Generator, cfg, tcfg: TrackerConfig,
                use_cyc: bool, use_cl_ref: bool,
                cyc_data: Optional[cycle.CycleData] = None,
                dino_pair_sel=None, ref_pair_sel=None):
    """The loss of one step (the JAX ``loss_fn`` of make_train_step,
    train.py:113-181) on a sampled batch -> (total, metrics). The model must
    be in train mode. ``cyc_data`` and the two ``*_pair_sel`` replace the
    step's own random draws of those terms (tests inject them)."""
    frames_set_t = sample.frames_set_t
    refined, raw = tracker.get_refined_embeddings(
        model, data.video, data.dino_embed, frames_set_t, tcfg)
    # one cast+norm pass of the refined stack, shared by every loss term
    view = tracker.make_frame_view(refined, tcfg.torch_compute_dtype)
    coords = tracker.get_point_predictions(
        model, sample.t1_points, sample.source_frame_indices,
        sample.target_frame_indices, refined, tcfg, view=view)
    l_of = losses.huber(coords, sample.t2_points_normalized[:, :2]).mean()
    total = l_of
    zero = torch.zeros((), device=refined.device)

    l_cyc = zero
    if use_cyc:
        if cyc_data is None:
            cyc_data = cycle.generate_cycle_data(
                generator, model, refined, frames_set_t, data.fg_masks, tcfg,
                cfg.cyc_n_frames, cfg.cyc_batch_size_per_frame,
                cfg.cyc_fg_points_ratio, cfg.cyc_thresh, view=view)
        l_cyc = cycle.cycle_consistency_loss(
            model, refined, cyc_data, tcfg, cfg.cyc_gamma,
            group_size=cfg.cyc_batch_size_per_frame, view=view)
        total = total + cfg.lambda_cyc * l_cyc

    l_cl_ref = zero
    if use_cl_ref:
        l_cl_ref = contrastive.refined_bb_contrastive_loss(
            generator, refined, frames_set_t, data.fg_masks, tcfg,
            cfg.cl_n_frames, cfg.cl_points_per_pair, cfg.cl_fg_points_ratio,
            cfg.cl_temp, cfg.cl_div_ref_bb, view=view, pair_sel=ref_pair_sel)
        total = total + cfg.lambda_cl_ref_bb * l_cl_ref

    l_cl_dino = contrastive.dino_bb_contrastive_loss(
        generator, refined, frames_set_t, data.bb, data.fg_masks, tcfg,
        cfg.cl_n_frames, cfg.cl_points_per_pair, cfg.cl_fg_points_ratio,
        cfg.cl_temp, cfg.cl_div_dino_bb, cfg.bb_amb_sig_a, cfg.bb_amb_sig_b,
        view=view, pair_sel=dino_pair_sel)
    l_norm = losses.emb_norm_regularization(refined, raw)
    l_angle = losses.emb_angle_regularization(refined, raw)
    total = (total + cfg.lambda_cl_dino_bb * l_cl_dino
             + cfg.lambda_emb_norm * l_norm + cfg.lambda_angle * l_angle)
    values = (l_of, l_cyc, l_cl_ref, l_cl_dino, l_norm, l_angle, total)
    return total, {k: v.detach() for k, v in zip(METRICS, values)}


def train_step(model: tracker.Tracker, opt, sched, data: VideoData,
               generator: torch.Generator, use_cyc: bool, use_cl_ref: bool,
               cfg, tcfg: TrackerConfig) -> dict:
    """One training iteration (the body of the JAX make_train_step,
    train.py:98-187): sample, losses, backward, Adam step. Returns the
    metrics as device scalars (reading them is the caller's sync)."""
    fg_batch = resolve_fg_batch(data.fg_bank, data.bg_bank,
                                cfg.train_batch_size, cfg.fg_traj_ratio)
    sample = sample_batch(generator, data.fg_bank, data.bg_bank,
                          cfg.train_batch_size, cfg.batch_n_frames,
                          cfg.fg_traj_ratio, data.video.shape[0],
                          cfg.video_resw, cfg.video_resh, fg_batch=fg_batch)
    total, metrics = step_losses(model, data, sample, generator, cfg, tcfg,
                                 use_cyc, use_cl_ref)
    opt.zero_grad(set_to_none=True)
    total.backward()
    opt.step()
    sched.step()
    return metrics


def train_state(model, opt, sched, generator, step: int) -> dict:
    """What a checkpoint holds: everything a resumed run needs to continue
    exactly."""
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "scheduler": sched.state_dict(), "generator": generator.get_state(),
            "step": step}


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
    bank rotations (``train/bank_rotation``)."""

    cfg: object  # config.TrainConfig, or any object with its fields
    tcfg: TrackerConfig
    data: VideoData
    ckpt_folder: str
    seed: int = 2
    bank_rotator: Optional[object] = None  # sampler.BankRotator for long videos
    device: torch.device = torch.device("cuda")

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
                opt.load_state_dict(state["optimizer"])
                sched.load_state_dict(state["scheduler"])
                generator.set_state(state["generator"])
                logger.info("resumed from iter %d", i)
        i = max(i, 0)

        running, running_n = {}, 0
        saver = ckpt_lib.AsyncSaver()
        steps, gates = contextlib.ExitStack(), None  # the open timer of a run of steps
        while i < cfg.total_iterations:
            on = (i >= cfg.apply_cyc_after, i >= cfg.apply_cl_ref_after)
            if on != gates:
                steps.close()
                steps.enter_context(stage_timer(steps_stage(*on), fence=self.device))
                gates = on
            metrics = train_step(model, opt, sched, self.data, generator, *on,
                                 cfg, self.tcfg)
            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + v
            running_n += 1
            i += 1
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
                    logger.info("iter %d: %s", i, {
                        k: float(v) / running_n for k, v in running.items()})
                running, running_n = {}, 0
            if save:
                with stage_timer("train/checkpoint", fence=self.device):
                    saver.save(self.ckpt_folder,
                               train_state(model, opt, sched, generator, i), i)
            if rotate:
                with stage_timer("train/bank_rotation", fence=self.device):
                    fg_bank, bg_bank = self.bank_rotator.advance()
                    self.data = self.data._replace(fg_bank=fg_bank, bg_bank=bg_bank)
        steps.close()
        with stage_timer("train/checkpoint", fence=self.device):
            saver.join()  # every interval save landed (or its failure raises)
            ckpt_lib.save_state(self.ckpt_folder,
                                train_state(model, opt, sched, generator,
                                            cfg.total_iterations),
                                cfg.total_iterations)
        return model
