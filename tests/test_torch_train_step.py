"""The port's training slice as a whole: one full train step held against
the JAX package, the optimizer and its schedule, checkpoints and resume, and
the training CLI followed by the inference CLI on a tiny video directory.

The full step recomposes the JAX body of ``make_train_step``
(dino_tracker_tpu/training/train.py:113-181) from the package's public
functions and differentiates it with ``jax.grad`` (``jax_step`` of
scripts/gen_full_width_golden.py, which also makes the full-width
golden of the step); the port runs
``train.step_losses`` and ``backward``. Both get the same weights (numpy,
JAX layout, carried over by ``convert.state_from_jax``) and the same
injected batch, cycle data and contrastive frame pairs, with full-take
subset sizes so the random selections do not matter.

Trap (gradients that are zero in exact math): DeltaDINO's conv biases are
detached in training (a train-mode BN cancels them; the JAX package's
stop_gradient gives exact zeros) and ``tracker_head.conv2.bias`` shifts the
softmax logits by a constant, so its gradient is float noise in both
packages. Those are not compared; every other gradient is, per tensor,
within a tolerance relative to the tensor's largest magnitude. Adam's first
step turns any gradient into about ±lr, so post-step parameters are compared
only where the gradient is clearly non-null, and the Adam update itself on
identical gradients in its own test.

Tolerances. f32 (TF32 off): loss terms rtol 1e-4, gradients 1e-4 of each
tensor's max (measured: 7.4e-7 and 4.4e-5). bf16 compute: the two conv
libraries round bf16 at other points (see test_torch_model_slice), which
train-mode BN re-scales at every layer, and the early layers' gradients sum
many cotangents that cancel. bf16 moves each package's own gradients that
far: JAX's bf16 gradients differ from its f32 ones by up to 0.28 of a
tensor's max (DeltaDINO layer 2's BN bias), the port's by 0.20. So in bf16
the loss terms hold to rtol 2e-2 (measured 5.9e-3) and the gradients to
0.35 of each tensor's max (measured 0.22): a check of sign and scale, while
the f32 case checks the algorithm.
"""

import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from dino_tracker_tpu.config import TrainConfig
from dino_tracker_tpu.training import cycle as jcycle
from dino_tracker_tpu.training import train as jtrain
from dino_tracker_tpu.utils import video_io
from dino_tracker_tpu_torch import convert
from dino_tracker_tpu_torch.cli import inference_grid
from dino_tracker_tpu_torch.cli import train as train_cli
from dino_tracker_tpu_torch.structures import BBData
from dino_tracker_tpu_torch.training import checkpoint as ckpt
from dino_tracker_tpu_torch.training import cycle, sampler
from dino_tracker_tpu_torch.training import train
from test_torch_model_slice import H, W, configs, torch_model
from test_torch_train_losses import N_FEAT, weights

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from gen_full_width_golden import jax_step  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

T, C = 8, 16
CHANNELS = (3, 8, 8, 8, C)
BB_CAP = 24
CFG = TrainConfig(video_resh=H, video_resw=W, train_batch_size=32,
                  batch_n_frames=4, cyc_n_frames=2, cyc_batch_size_per_frame=16,
                  cl_n_frames=3, cl_points_per_pair=2 * N_FEAT,
                  cl_fg_points_ratio=0.5, compute_dtype="float32",
                  total_iterations=4, checkpoint_interval=2,
                  apply_cyc_after=2, apply_cl_ref_after=2)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 0.35)}  # (loss rtol, grad)
NULL_GRADS = {"tracker_head.conv2.bias"}  # float noise in both packages


def video_arrays(seed=0, t=T, c=C):
    """Frames, an f16 feature stack (static per-position pattern + noise),
    fg masks, trajectory banks and padded best buddies, as numpy."""
    rng = np.random.default_rng(seed)
    _, pcfg = configs(CHANNELS)
    hp, wp = pcfg.feat_hw
    video = rng.random((t, 3, H, W), dtype=np.float32)
    dino = (rng.standard_normal((1, c, hp, wp)) * 2
            + rng.standard_normal((t, c, hp, wp))).astype(np.float16)
    masks = (rng.random((t, H, W)) < 0.4).astype(np.float32) * 255
    trajs = []
    for _ in range(2):
        tr = (rng.random((150, t, 2)) * [W - 1, H - 1]).astype(np.float32)
        tr[rng.random((150, t)) > 0.8] = np.nan
        trajs.append(tr)
    nvalid = rng.integers(5, BB_CAP, (t, t))
    bb = dict(
        source_coords=(rng.random((t, t, BB_CAP, 2)) * [W - 1, H - 1]).astype(np.float32),
        target_coords=(rng.random((t, t, BB_CAP, 2)) * [W - 1, H - 1]).astype(np.float32),
        cos_sims=(0.2 + 0.8 * rng.random((t, t, BB_CAP))).astype(np.float32),
        r=rng.random((t, t, BB_CAP)).astype(np.float32),
        valid=np.arange(BB_CAP)[None, None] < nvalid[..., None])
    return video, dino, masks, trajs, bb


def port_data(arrays) -> train.VideoData:
    video, dino, masks, (fg, bg), bb = arrays
    return train.VideoData(
        torch.from_numpy(video), torch.from_numpy(dino), torch.from_numpy(masks),
        BBData(**{k: torch.from_numpy(v) for k, v in bb.items()}),
        sampler.build_bank(fg), sampler.build_bank(bg))


def injected(data, seed=1):
    """A sampled batch (the port's sampler), cycle data in per-pair blocks
    and the contrastive frame pairs, to be handed to both packages."""
    gen = torch.Generator().manual_seed(seed)
    sample = sampler.sample_batch(gen, data.fg_bank, data.bg_bank,
                                  CFG.train_batch_size, CFG.batch_n_frames,
                                  CFG.fg_traj_ratio, T, W, H)
    rng = np.random.default_rng(seed)
    k, p = CFG.cyc_batch_size_per_frame, CFG.cyc_n_frames
    set_size = len(sample.frames_set_t)
    src, tgt = rng.integers(0, set_size, p), rng.integers(0, set_size, p)
    frames = sample.frames_set_t.numpy()

    def pts(sel):
        return np.concatenate(
            [rng.random((p, k, 2)) * [W - 1, H - 1],
             np.broadcast_to(frames[sel][:, None, None], (p, k, 1))],
            2).reshape(-1, 3).astype(np.float32)

    cyc = (pts(src), pts(tgt), np.repeat(src, k), np.repeat(tgt, k),
           (rng.random(p * k) * 4).astype(np.float32), rng.random(p * k) < 0.7)
    n = CFG.cl_n_frames
    dino_pairs = (rng.integers(0, set_size, n),)
    dino_pairs += ((dino_pairs[0] + rng.integers(1, set_size, n)) % set_size,)
    ref_pairs = (rng.integers(0, set_size, n), rng.integers(0, set_size, n))
    return sample, cyc, dino_pairs, ref_pairs


@functools.lru_cache(maxsize=None)
def jax_reference(compute_dtype):
    """The JAX step of ``test_train_step_matches_jax``'s inputs, both phases,
    computed once per dtype for the module."""
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype)
    jcfg, _ = configs(CHANNELS, compute_dtype)
    params, stats = weights(20)
    arrays = video_arrays()
    video, dino, masks, _, bb = arrays
    sample, cyc, dino_pairs, ref_pairs = injected(port_data(arrays))
    return jax_step(params, stats, {"video": video, "dino": dino, "masks": masks, "bb": bb},
                    {k: v.numpy() for k, v in sample._asdict().items()},
                    dict(zip(jcycle.CycleData._fields, cyc)), dino_pairs, ref_pairs, cfg,
                    jcfg)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gates", [False, True])
def test_train_step_matches_jax(gates, compute_dtype):
    """All six loss terms and every gradient that is not null in exact math,
    with both phase gates off and on; then BN's running statistics, and the
    parameters after one Adam step where the gradient's sign is certain
    (|g| above twice the gradient tolerance), within 1e-3 of the step size
    (Adam's first step is lr·g/(|g|+ε), which amplifies gradient noise where
    |g| is not far above ε)."""
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype)
    jcfg, pcfg = configs(CHANNELS, compute_dtype)
    loss_rtol, grad_tol = TOL[compute_dtype]
    params, stats = weights(20)
    arrays = video_arrays()
    data = port_data(arrays)
    sample, cyc, dino_pairs, ref_pairs = injected(data)
    ref, jgrads, jstats = jax_reference(compute_dtype)[gates]

    model = torch_model(params, stats, pcfg).train()
    opt, sched = train.make_optimizer(model, cfg)
    total, metrics = train.step_losses(
        model, data, sample, torch.Generator().manual_seed(0), cfg, pcfg,
        gates, gates, cyc_data=cycle.CycleData(*map(torch.from_numpy, cyc)),
        dino_pair_sel=dino_pairs, ref_pair_sel=ref_pairs)
    total.backward()
    assert set(metrics) == set(train.METRICS)
    for k in train.METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=loss_rtol, atol=1e-7, err_msg=k)
    assert (float(metrics["loss_cyc"]) > 0) == gates
    assert (float(metrics["loss_cl_refiner"]) > 0) == gates

    jgrad_sd = convert.state_from_jax(jax.tree.map(np.asarray, jgrads),
                                      jax.tree.map(np.asarray, jstats))
    masks = {}
    for name, p in model.named_parameters():
        ref_g = jgrad_sd[name].numpy()
        if p.grad is None:  # a detached DeltaDINO conv bias
            assert name.startswith("delta_dino.") and name.endswith("conv.bias")
            assert not np.abs(ref_g).any(), name
            continue
        if name in NULL_GRADS:
            continue
        scale = np.abs(ref_g).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref_g, rtol=0,
                                   atol=grad_tol * scale, err_msg=name)
        masks[name] = np.abs(ref_g) > 2 * grad_tol * scale
    for layer, s in zip(model.delta_dino.layers, jstats["delta_dino"]["layers"]):
        np.testing.assert_allclose(layer.bn.running_mean.numpy(), s["mean"],
                                   rtol=loss_rtol, atol=1e-5)
        np.testing.assert_allclose(layer.bn.running_var.numpy(), s["var"],
                                   rtol=loss_rtol, atol=1e-5)

    tx = jtrain.make_optimizer(cfg)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    new_sd = convert.state_from_jax(
        jax.tree.map(np.asarray, optax.apply_updates(params, updates)),
        jax.tree.map(np.asarray, jstats))
    opt.step()
    for name, p in model.named_parameters():
        if name in masks:
            np.testing.assert_allclose(p.detach().numpy()[masks[name]],
                                       new_sd[name].numpy()[masks[name]],
                                       rtol=0, atol=1e-3 * cfg.lr_delta_dino,
                                       err_msg=name)


def test_optimizer_and_schedule_match_optax():
    """Three Adam updates on identical gradients, with the schedule decaying
    every update (apply_scheduler_every=1), against optax's
    make_optimizer: atol 2e-7 plus one f32 ulp of the value. The two differ
    in one known place: optax computes Adam's bias correction 1 − β2^t in
    float32, where β2 = 0.999 rounds to 0.99900001, so its ν̂ is 1.3e-5
    larger and its step 6.4e-6 smaller than torch's float64 correction
    gives; over these three steps (lr 0.01, 0.005, 0.0025) that is 1.1e-7
    (measured 1.3e-7 with rounding)."""
    cfg = TrainConfig(apply_scheduler_every=1, scheduler_gamma=0.5,
                      lr_delta_dino=0.01, lr_cnn_refiner=0.003)
    params, stats = weights(21)
    _, pcfg = configs(CHANNELS)
    model = torch_model(params, stats, pcfg)
    opt, sched = train.make_optimizer(model, cfg)
    tx = jtrain.make_optimizer(cfg)
    state = tx.init(params)
    rng = np.random.default_rng(21)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        gsd = convert.state_from_jax(grads, stats)
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        opt.step()
        sched.step()
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        ref = convert.state_from_jax(params, stats)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       rtol=2.0 ** -23, atol=2e-7, err_msg=name)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.01 * 0.5 ** 3)
    assert opt.param_groups[1]["lr"] == 0.003


def tiny_trainer(folder, total, arrays=None):
    cfg = dataclasses.replace(CFG, total_iterations=total,
                              checkpoint_interval=1000, cl_points_per_pair=16)
    _, pcfg = configs(CHANNELS)
    return train.Trainer(cfg, pcfg, port_data(arrays or video_arrays()),
                         str(folder), seed=3, device=torch.device("cpu"))


def test_resume_is_exact(tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, a fresh process-like
    restart and 2 more (the checkpoint carries the model, Adam's moments,
    the schedule and the step generator's state). The phase gates switch on
    at step 2, so the resumed half runs the second phase."""
    arrays = video_arrays(2)
    straight = tiny_trainer(tmp_path / "a", 4, arrays).train()
    tiny_trainer(tmp_path / "b", 2, arrays).train()
    assert ckpt.checkpoint_steps(str(tmp_path / "b")) == [2]
    resumed = tiny_trainer(tmp_path / "b", 4, arrays).train()
    sd_a, sd_b = straight.state_dict(), resumed.state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_b[k], sd_a[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(sd_a["tracker_head.conv1.weight"],
                           tiny_trainer(tmp_path / "c", 0).init_model()
                           .state_dict()["tracker_head.conv1.weight"])


def test_trainer_times_host_work_apart_from_the_steps(tmp_path):
    """The Trainer's stage timers: a run of steps under the same gates is cut
    where the log, a checkpoint or a bank rotation runs, and those are timed
    on their own. 4 steps, gates at 2, log every 2, a checkpoint at 3 (and
    the last at 4), a rotation at 2."""
    from dino_tracker_tpu_torch.utils import profiling
    arrays = video_arrays(4)
    trainer = tiny_trainer(tmp_path, 4, arrays)
    trainer.cfg = dataclasses.replace(trainer.cfg, checkpoint_interval=3,
                                      sampler_batch_iterations=2)
    trainer.bank_rotator = sampler.BankRotator(*arrays[3], window=100)
    profiling.reset_stage_timers()
    try:
        trainer.train(log_interval=2)
        calls = {k: v["calls"] for k, v in profiling.stage_report().items()}
    finally:
        profiling.reset_stage_timers()
    assert calls == {"train/init": 1, "train/steps_gates_off": 1, "train/steps_gates_on": 2,
                     "train/log": 2, "train/checkpoint": 2, "train/bank_rotation": 1}
    assert ckpt.checkpoint_steps(str(tmp_path)) == [4, 3]


def test_checkpoint_atomic_and_falls_back_past_truncated(tmp_path):
    state = {"model": {"w": torch.arange(6.0)}, "step": 5}
    good = ckpt.save_state(str(tmp_path), state, 5)
    assert os.listdir(tmp_path) == ["state_5.pt"]  # no temp file left behind
    with open(good, "rb") as f:
        blob = f.read()
    with open(os.path.join(tmp_path, "state_10.pt"), "wb") as f:
        f.write(blob[: len(blob) // 2])  # a kill mid-write
    loaded, step = ckpt.load_latest(str(tmp_path))
    assert step == 5 and torch.equal(loaded["model"]["w"], torch.arange(6.0))
    with pytest.raises(Exception):
        ckpt.load_state(str(tmp_path), 10)
    assert ckpt.load_latest(str(tmp_path / "none")) == (None, -1)


def test_async_save_writes_the_state_of_its_call(tmp_path):
    """Trap (in-place optimizer vs async save): parameters changed in place
    right after ``save`` returns must not reach the file."""
    _, pcfg = configs(CHANNELS)
    model = torch_model(*weights(22), pcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    saver = ckpt.AsyncSaver()
    for step in range(1, 4):
        saver.save(str(tmp_path), {"model": model.state_dict()}, step)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    saver.join()
    for step in range(1, 4):
        saved = ckpt.load_state(str(tmp_path), step)["model"]
        for k, v in before.items():
            expect = v + (step - 1) if v.is_floating_point() and "running" not in k else v
            torch.testing.assert_close(saved[k], expect, msg=k)


def test_async_save_reraises_writer_failure(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a folder")
    saver = ckpt.AsyncSaver()
    saver.save(str(blocker), {"step": 1}, 1)
    with pytest.raises(OSError):
        saver.join()


def write_video_dir(root, arrays, c):
    """A per-video directory in the JAX package's layout, with every
    artifact training reads."""
    video, dino, masks, (fg, bg), bb = arrays
    for sub, imgs in (("video", (video.transpose(0, 2, 3, 1) * 255)),
                      ("masks", masks)):
        os.makedirs(os.path.join(root, sub))
        for i, f in enumerate(imgs):
            Image.fromarray(np.round(f).astype(np.uint8)).save(
                os.path.join(root, sub, f"{i:05d}.png"))
    video_io.save_npz(os.path.join(root, "dino_embeddings",
                                   "dino_embed_video.npz"), features=dino)
    for name, tr in (("fg", fg), ("bg", bg)):
        video_io.save_npz(os.path.join(root, "of_trajectories",
                                       f"{name}_trajectories.npz"),
                          trajectories=tr)
    os.makedirs(os.path.join(root, "dino_best_buddies"))
    np.savez(os.path.join(root, "dino_best_buddies",
                          "dino_best_buddies_filtered.npz"), **bb)
    with open(os.path.join(root, "train.yaml"), "w") as f:
        f.write(f"video_resh: {H}\nvideo_resw: {W}\n"
                "dino_model_name: dinov2_vits14\ncompute_dtype: float32\n"
                "total_iterations: 4\ncheckpoint_interval: 2\n"
                "apply_cyc_after: 2\napply_cl_ref_after: 2\n"
                "train_batch_size: 16\nbatch_n_frames: 3\n"
                "cyc_n_frames: 2\ncyc_batch_size_per_frame: 8\n"
                "cl_n_frames: 2\ncl_points_per_pair: 16\n")
    assert c == TrainConfig.from_yaml(os.path.join(root, "train.yaml")).dino_embed_dim


def test_train_cli_then_inference_cli(tmp_path):
    """``cli.train --device cpu`` across the phase boundary writes
    state_2.pt (async, mid-run) and state_4.pt; ``cli.inference_grid`` then
    serves the newest one. A second train call resumes at 4 and only
    rewrites the final checkpoint."""
    root = str(tmp_path)
    arrays = video_arrays(4, t=5, c=384)
    write_video_dir(root, arrays, 384)
    args = ["--config", os.path.join(root, "train.yaml"), "--data-path", root,
            "--device", "cpu"]
    train_cli.main(args)
    folder = os.path.join(root, "models", "dino_tracker")
    assert ckpt.checkpoint_steps(folder) == [4, 2]
    state = ckpt.load_state(folder, 4)
    assert state["step"] == 4 and state["scheduler"]["last_epoch"] == 4
    first = state["model"]["tracker_head.conv1.weight"]
    train_cli.main(args)
    torch.testing.assert_close(ckpt.load_state(folder, 4)["model"]
                               ["tracker_head.conv1.weight"], first)

    inference_grid.main(args + ["--interval", "20"])
    trajs = np.load(os.path.join(root, "grid_trajectories", "grid_trajectories.npy"))
    occ = np.load(os.path.join(root, "grid_occlusions", "grid_occlusions.npy"))
    assert trajs.shape[1:] == (5, 2) and occ.shape == trajs.shape[:2]
    assert np.isfinite(trajs).all() and len(trajs) > 0
