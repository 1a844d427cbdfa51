"""The port's data-parallel training step, refine cache and inference on W
gloo ranks on the CPU, held against one device and against the JAX
package's ``make_mesh`` paths.

A W-rank step (frame set, point batch and cycle points sharded; BN
statistics over the ranks; the gradients summed over them) against the
one-device step on the same weights and the same generator seed, with the
gates on and the real random draws (the cycle threshold sits between two
of the one-device step's cycle distances, so both survivors and rejects
exist and none is on the edge). f32: every loss within 1e-5 relative,
every gradient that is not null in exact math within 1e-4 of its tensor's
largest magnitude, the BN running statistics within 1e-6. bf16: the
losses within 2e-2 relative and the gradients within 0.35 of each tensor's
max, the sign-and-scale rule of the bf16 parity tests (two orders of
summation round bf16 operands apart, and train-mode BN rescales the
difference at every layer). After 3 Trainer-style steps across the phase
boundary every rank holds bitwise the same parameters, BN statistics and
generator state. The inputs are fixed, and at these sizes no
pre-activation lies within f32 rounding of a ReLU's kink; where one does,
two valid orders of summation put it on different sides and move a
gradient by that element's whole cotangent (at full width, millions of
activations a layer, this happens on one device against f64 too).

The refine cache and ``ModelInference`` at W = 2 against the JAX package's
``cache_refined_embeddings(..., mesh=make_mesh(2))`` and
``ModelInference(..., mesh=make_mesh(2))`` (refined features 1e-4,
trajectories 1e-3 px, occlusion flags equal), and at W = 3 against the
port on one device. One spawn per rank count runs all of it; the ranks
import this module, so it imports JAX only in the parent's fixtures.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.config import TrainConfig
from dino_tracker_tpu_torch.inference.infer import ModelInference
from dino_tracker_tpu_torch.models import tracker
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from dino_tracker_tpu_torch.training import cycle, train
from dino_tracker_tpu_torch.training.sampler import sample_batch
from test_torch_threads import one_thread  # noqa: F401

SPAWN_TIMEOUT = 120
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 0.35)}  # (loss rtol, grad)
NULL_GRADS = {"tracker_head.conv2.bias"}  # float noise in exact math
N_STEPS = 3
ANCHOR_COS, COS = 0.7, 0.6


def _model(state, pcfg, train_mode):
    model = tracker.Tracker(pcfg)
    model.load_state_dict(state)
    return model.train(train_mode)


def one_step(mesh, state, data, cfg, pcfg):
    """One step's losses (summed over the ranks), gradients (summed) and
    new BN statistics, gates on, from the generator seed 1."""
    model = _model(state, pcfg, True)
    gen = torch.Generator().manual_seed(1)
    sample = sample_batch(gen, data.fg_bank, data.bg_bank, cfg.train_batch_size,
                          cfg.batch_n_frames, cfg.fg_traj_ratio,
                          data.video.shape[0], cfg.video_resw, cfg.video_resh)
    total, metrics = train.step_losses(model, data, sample, gen, cfg, pcfg,
                                       True, True, mesh=mesh)
    total.backward()
    mesh_lib.all_reduce_grads(model, mesh)
    metrics = train.reduce_metrics(metrics, mesh)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                buffers={n: b.clone() for n, b in model.named_buffers()})


def steps(mesh, state, data, cfg, pcfg):
    """N_STEPS train_step calls with the gates switching on at step 1."""
    model = _model(state, pcfg, True)
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator().manual_seed(3)
    for i in range(N_STEPS):
        train.train_step(model, opt, sched, data, gen, i >= 1, i >= 1, cfg, pcfg,
                         mesh)
    return dict(state={k: v.clone() for k, v in model.state_dict().items()},
                generator=gen.get_state())


def infer(mesh, state, video, dino, pcfg, queries):
    model = _model(state, pcfg, False)
    refined = tracker.cache_refined_embeddings(model, video, dino, pcfg,
                                               frames_chunk=4, mesh=mesh)
    mi = ModelInference(model=model, refined_features=refined, cfg=pcfg,
                        anchor_cosine_similarity_threshold=ANCHOR_COS,
                        cosine_similarity_threshold=COS, chunk=64, mesh=mesh)
    return dict(refined=refined, predictions=mi.infer(queries))


def empty_cycle_loss(mesh, state, pcfg):
    """The cycle loss of a batch in which no point survived the filter, on
    a random refined stack: each rank's share of it and its gradient."""
    model = _model(state, pcfg, True)
    g = torch.Generator().manual_seed(5)
    n_frames, pairs, k = 4, 2, 16
    emb = torch.randn((n_frames, *pcfg.feat_hw, pcfg.delta_channels[-1]),
                      generator=g).requires_grad_()
    scale = torch.tensor([pcfg.video_w - 1.0, pcfg.video_h - 1.0])
    sel = torch.arange(pairs).repeat_interleave(k)

    def points(frames):
        return torch.cat([torch.rand((pairs * k, 2), generator=g) * scale,
                          frames[:, None].float()], 1)

    data = cycle.CycleData(points(sel), points(sel + 1), sel, sel + 1,
                           torch.rand(pairs * k, generator=g),
                           torch.zeros(pairs * k, dtype=torch.bool))
    loss = cycle.cycle_consistency_loss(model, emb, data, pcfg, 0.8, k, mesh=mesh)
    loss.backward()
    return float(loss.detach()), emb.grad


def run_all(mesh, payload):
    if mesh is not None:
        torch.set_num_threads(1)
    out = {dtype: one_step(mesh, *payload["train"][dtype])
           for dtype in ("float32", "bfloat16")}
    out["steps"] = steps(mesh, *payload["train"]["float32"])
    out["infer"] = infer(mesh, *payload["infer"])
    out["empty_cycle"] = empty_cycle_loss(mesh, payload["infer"][0], payload["infer"][3])
    return out


def _cycle_threshold(state, data, cfg, pcfg):
    """A threshold halfway between two middle cycle distances of the
    one-device step's draws: about half the points survive, none on the
    edge."""
    model = _model(state, pcfg, True)
    gen = torch.Generator().manual_seed(1)
    sample = sample_batch(gen, data.fg_bank, data.bg_bank, cfg.train_batch_size,
                          cfg.batch_n_frames, cfg.fg_traj_ratio,
                          data.video.shape[0], cfg.video_resw, cfg.video_resh)
    with torch.no_grad():
        refined, _ = tracker.get_refined_embeddings(
            model, data.video, data.dino_embed, sample.frames_set_t, pcfg)
        cyc = cycle.generate_cycle_data(
            gen, model, refined, sample.frames_set_t, data.fg_masks, pcfg,
            cfg.cyc_n_frames, cfg.cyc_batch_size_per_frame,
            cfg.cyc_fg_points_ratio, 1e9)
    d = torch.sort(cyc.dists[cyc.valid]).values
    mid = len(d) // 2
    return float(d[mid - 1] + d[mid]) / 2.0


@pytest.fixture(scope="module")
def payload():
    import test_torch_train_step as tts
    from test_torch_inference import QUERIES, scene
    from test_torch_model_slice import CHANNELS, configs
    from test_torch_train_losses import weights
    from dino_tracker_tpu_torch import convert
    cfg = TrainConfig(**{f.name: getattr(tts.CFG, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    data = tts.port_data(tts.video_arrays())
    state = convert.state_from_jax(*weights(20))
    per_dtype = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        pcfg = tts.configs(tts.CHANNELS, dtype)[1]
        if dtype == "float32":
            thresh = _cycle_threshold(state, data, c, pcfg)
        per_dtype[dtype] = (state, data, dataclasses.replace(c, cyc_thresh=thresh), pcfg)
    params, stats = weights(11, CHANNELS)
    pcfg = configs()[1]
    video, dino = scene(pcfg.delta_channels[-1])
    return dict(train=per_dtype,
                infer=(convert.state_from_jax(params, stats), torch.from_numpy(video),
                       torch.from_numpy(dino), pcfg, QUERIES))


@pytest.fixture(scope="module")
def jax_mesh_inference():
    """The JAX package's refine cache and inference of ``payload``'s inputs
    on ``make_mesh(2)``."""
    import jax.numpy as jnp
    from dino_tracker_tpu.inference.infer import ModelInference as JModelInference
    from dino_tracker_tpu.models import tracker as jtracker
    from dino_tracker_tpu.parallel.mesh import make_mesh
    from test_torch_inference import QUERIES, scene
    from test_torch_model_slice import CHANNELS, configs
    from test_torch_train_losses import weights
    params, stats = weights(11, CHANNELS)
    jcfg, pcfg = configs()
    video, dino = scene(pcfg.delta_channels[-1])
    refined = jtracker.cache_refined_embeddings(
        params, stats, jnp.asarray(video), jnp.asarray(dino), jcfg, frames_chunk=4,
        mesh=make_mesh(2))
    mi = JModelInference(params=params, refined_features=refined, cfg=jcfg,
                         anchor_cosine_similarity_threshold=ANCHOR_COS,
                         cosine_similarity_threshold=COS, chunk=64,
                         mesh=make_mesh(2))
    return np.asarray(refined), mi.infer(QUERIES)


@pytest.fixture(scope="module")
def one_device(payload):
    return run_all(None, payload)


@pytest.fixture(scope="module")
def spawned(payload):
    """Each rank's results at W = 2 and W = 3 (both worlds at once)."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {w: pool.submit(mesh_lib.spawn, run_all, w, "cpu", args=(payload,),
                               timeout=SPAWN_TIMEOUT) for w in (2, 3)}
        return {w: job.result() for w, job in jobs.items()}


@pytest.mark.parametrize("w", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_matches_one_device(spawned, one_device, dtype, w):
    """Losses, gradients and BN statistics of the W-rank step against the
    one-device step; every rank holds the same values."""
    results = spawned[w]
    loss_rtol, grad_tol = TOL[dtype]
    ref = one_device[dtype]
    assert 0 < ref["metrics"]["loss_cyc"] and 0 < ref["metrics"]["loss_cl_refiner"]
    for r in results:
        got = r[dtype]
        assert set(got["metrics"]) == set(train.METRICS)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=loss_rtol,
                                       atol=1e-7, err_msg=f"W={w} {k}")
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in ref["grads"].items():
            if name in NULL_GRADS:
                continue
            scale = float(g.abs().max())
            assert scale > 0, name
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=0,
                                       atol=grad_tol * scale, err_msg=f"W={w} {name}")
        for name, b in ref["buffers"].items():
            tol = 1e-6 if dtype == "float32" else loss_rtol
            np.testing.assert_allclose(got["buffers"][name].numpy(), b.numpy(),
                                       rtol=tol, atol=tol, err_msg=f"W={w} {name}")
        for name, g in got["grads"].items():
            assert torch.equal(g, results[0][dtype]["grads"][name]), name


@pytest.mark.parametrize("w", [2, 3])
def test_ranks_stay_replicated(spawned, w):
    """After 3 steps across the phase boundary: bitwise equal parameters, BN
    statistics and generator state on every rank."""
    results = spawned[w]
    first = results[0]["steps"]
    for r in results[1:]:
        for k, v in first["state"].items():
            assert torch.equal(r["steps"]["state"][k], v), f"W={w} {k}"
        assert torch.equal(r["steps"]["generator"], first["generator"])


@pytest.mark.parametrize("w", [2, 3])
def test_refine_and_inference_match_one_device(spawned, one_device, w):
    results = spawned[w]
    ref = one_device["infer"]
    for r in results:
        got = r["infer"]
        torch.testing.assert_close(got["refined"], ref["refined"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["predictions"][0], ref["predictions"][0],
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(got["predictions"][1], ref["predictions"][1])


def test_refine_and_inference_match_the_jax_mesh(spawned, jax_mesh_inference):
    """The port on 2 ranks against the JAX package on a ``make_mesh(2)`` of
    the CPU devices ``tests/conftest.py`` forces."""
    refined, (trajs, occ) = jax_mesh_inference
    for r in spawned[2]:
        got = r["infer"]
        np.testing.assert_allclose(got["refined"].numpy(), refined.transpose(0, 2, 3, 1),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["predictions"][0], trajs, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(got["predictions"][1], occ)



@pytest.mark.parametrize("w", [2, 3])
def test_an_all_invalid_cycle_batch_gives_zero_loss(spawned, one_device, w):
    """No survivor on any rank: every rank's share of the cycle loss is 0
    (the normaliser is the global count, which every rank holds) and so is
    its gradient, as on one device."""
    assert one_device["empty_cycle"][0] == 0.0
    for r in spawned[w]:
        loss, grad = r["empty_cycle"]
        assert loss == 0.0
        assert grad is None or not grad.any()
