"""Port parity: DeltaDINO, tracker head, correlations and predictions of
dino_tracker_tpu_torch held against the JAX package on the same inputs.

Weights come from the JAX ``init_tracker`` and go through
``convert.state_from_jax``. DeltaDINO's last conv is zero-initialised there,
which would make the residual identically 0 and hide every blurpool error,
so the last layer's conv and every BN's running statistics are overwritten
with seeded non-zero values first. Everything compares in f32 with TF32 off;
tolerance 1e-4 relative (the two frameworks sum in different orders).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dino_tracker_tpu.models import delta_dino as jdd
from dino_tracker_tpu.models import nn as jnn
from dino_tracker_tpu.models import tracker as jtracker
from dino_tracker_tpu.models import tracker_head as jth
from dino_tracker_tpu_torch import convert
from dino_tracker_tpu_torch.config import TrackerConfig
from dino_tracker_tpu_torch.models import nn as pnn
from dino_tracker_tpu_torch.models import tracker
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 70, 98
CHANNELS = (3, 4, 4, 4, 16)
RTOL, ATOL = 1e-4, 1e-5


def configs(channels=CHANNELS, compute_dtype="float32"):
    jcfg = jtracker.TrackerConfig(video_h=H, video_w=W, delta_channels=channels,
                                  compute_dtype=compute_dtype)
    pcfg = TrackerConfig(video_h=H, video_w=W, delta_channels=channels,
                         compute_dtype=compute_dtype)
    return jcfg, pcfg


def jax_weights(seed=0, channels=CHANNELS):
    """JAX (params, batch_stats) with a non-zero DeltaDINO residual, as
    nested dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    jcfg, _ = configs(channels)
    params, stats = jax.tree.map(np.asarray, jtracker.init_tracker(
        jax.random.PRNGKey(seed), jcfg))
    last = params["delta_dino"]["layers"][-1]
    last["conv"] = {
        "w": (rng.standard_normal(last["conv"]["w"].shape) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(last["conv"]["b"].shape) * 0.1).astype(np.float32)}
    last["bn"]["scale"] = (1.0 + rng.random(last["bn"]["scale"].shape)).astype(np.float32)
    for s in stats["delta_dino"]["layers"]:
        s["mean"] = (rng.standard_normal(s["mean"].shape) * 0.1).astype(np.float32)
        s["var"] = (rng.random(s["var"].shape) + 0.5).astype(np.float32)
    # The head divides each 3×3 kernel by its spatial sum; a kaiming draw can
    # put that sum near 0 and amplify f32 summation-order noise by 1/|sum|.
    # Shift the taps so the normalization is well conditioned.
    for conv in params["tracker_head"].values():
        conv["w"] = conv["w"] + np.float32(0.1)
    return params, stats


def torch_model(params, stats, pcfg):
    model = tracker.Tracker(pcfg)
    model.load_state_dict(convert.state_from_jax(params, stats))
    return model.eval()


def close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("channels_last", [False, True])
def test_delta_dino_matches_jax(channels_last, train):
    """Eval mode (running statistics) and train mode (batch statistics, with
    the running buffers updated in place as torch's BatchNorm2d does). In
    train mode every layer renormalizes by its batch statistics, which
    re-scales summation-order noise to the unit output scale: atol 1e-4."""
    jcfg, pcfg = configs()
    params, stats = jax_weights()
    frames = np.random.default_rng(1).random((3, 3, H, W), dtype=np.float32)
    ref, ref_stats = jdd.apply_delta_dino(
        params["delta_dino"], stats["delta_dino"], jnp.asarray(frames),
        jcfg.feat_hw, train=train, channels_last=channels_last)
    model = torch_model(params, stats, pcfg).train(train)
    with torch.no_grad():
        ours = model.delta_dino(torch.from_numpy(frames), pcfg.feat_hw,
                                channels_last=channels_last)
    assert np.abs(np.asarray(ref)).max() > 1e-2  # the residual is non-zero
    close(ours, ref, atol=1e-4 if train else ATOL)
    for layer, s in zip(model.delta_dino.layers, ref_stats["layers"]):
        close(layer.bn.running_mean, s["mean"])
        close(layer.bn.running_var, s["var"])


@pytest.mark.parametrize("channels_last", [False, True])
def test_delta_dino_bf16_matches_jax(channels_last):
    """Eval mode with bf16 conv operands, the dtype the runtime serves with.
    Both sides hold every conv and BN output in bf16, but the conv
    libraries sum and round in their own order (JAX also adds the bias to
    the already-rounded conv output), so a value near a rounding boundary
    lands an ulp apart and carries through the next layers: atol two bf16
    ulps at the residual's largest magnitude (measured: about one)."""
    jcfg, pcfg = configs(compute_dtype="bfloat16")
    params, stats = jax_weights()
    frames = np.random.default_rng(1).random((3, 3, H, W), dtype=np.float32)
    ref, _ = jdd.apply_delta_dino(
        params["delta_dino"], stats["delta_dino"], jnp.asarray(frames),
        jcfg.feat_hw, train=False, compute_dtype=jnp.bfloat16,
        channels_last=channels_last)
    ref = np.asarray(ref, np.float32)
    with torch.no_grad():
        ours = torch_model(params, stats, pcfg).delta_dino(
            torch.from_numpy(frames), pcfg.feat_hw,
            compute_dtype=pcfg.torch_compute_dtype, channels_last=channels_last)
    assert ours.dtype == torch.float32
    two_ulps = 2 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    close(ours, ref, rtol=0, atol=two_ulps)


def test_batchnorm_train_forward_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32) * 2 + 0.5
    scale, bias = rng.random(6).astype(np.float32), rng.random(6).astype(np.float32)
    mean, var = rng.random(6).astype(np.float32), rng.random(6).astype(np.float32) + 1
    ref, ref_stats = jnn.batchnorm(jnp.asarray(x), {"scale": scale, "bias": bias},
                                   {"mean": mean, "var": var}, train=True)
    bn = pnn.BatchNorm(6)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    with torch.no_grad():
        ours, (new_mean, new_var) = pnn.batchnorm(torch.from_numpy(x), bn, True)
    close(ours, ref)
    close(new_mean, ref_stats["mean"])
    close(new_var, ref_stats["var"])


def test_blurpool_dispatch_rejects_other_configs():
    x = torch.zeros(1, 8, 8, 2)
    for kw in ({"stride": 1}, {"filt_size": 3}):
        with pytest.raises(ValueError, match="filt_size=4, stride=2"):
            pnn.blurpool(x, **kw)


def test_tracker_head_matches_jax():
    _, pcfg = configs()
    params, stats = jax_weights(3)
    hp, wp = pcfg.feat_hw
    cv = np.abs(np.random.default_rng(3).standard_normal((7, 1, hp, wp))
                ).astype(np.float32)
    cv[0] = 0.0  # all-zero map: uniform fallback path
    ref = jth.apply_tracker_head(params["tracker_head"], jnp.asarray(cv), (H, W))
    model = torch_model(params, stats, pcfg)
    with torch.no_grad():
        ours = model.head(torch.from_numpy(cv), pcfg)
    close(ours, ref)


def frame_stack(n=4, c=16, seed=4):
    _, pcfg = configs()
    hp, wp = pcfg.feat_hw
    return np.random.default_rng(seed).standard_normal(
        (n, hp, wp, c)).astype(np.float32)


def query_points(b, n, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(b) * (W - 1), rng.random(b) * (H - 1),
                     rng.integers(0, n, b)], -1).astype(np.float32)


def test_corr_maps_match_jax():
    frames = frame_stack()
    rng = np.random.default_rng(6)
    src = rng.standard_normal((9, frames.shape[-1])).astype(np.float32)
    tgt = rng.integers(0, frames.shape[0], 9)
    ref = jtracker.get_corr_maps(jnp.asarray(src), jnp.asarray(frames),
                                 jnp.asarray(tgt), channels_last=True)
    ours = tracker.get_corr_maps(torch.from_numpy(src), torch.from_numpy(frames),
                                 torch.from_numpy(tgt))
    close(ours, ref)


def test_point_predictions_flat_matches_jax():
    jcfg, pcfg = configs()
    params, stats = jax_weights(7)
    frames = frame_stack()
    q = query_points(11, frames.shape[0])
    tgt = np.random.default_rng(7).integers(0, frames.shape[0], 11)
    inp = jtracker.TrackerInput(jnp.asarray(q), jnp.asarray(q[:, 2].astype(np.int32)),
                                jnp.asarray(tgt), jnp.arange(frames.shape[0]))
    ref = jtracker.get_point_predictions(params, inp, jnp.asarray(frames), jcfg,
                                         channels_last=True)
    model = torch_model(params, stats, pcfg)
    with torch.no_grad():
        ours = tracker.get_point_predictions(
            model, torch.from_numpy(q), torch.from_numpy(q[:, 2]).long(),
            torch.from_numpy(tgt), torch.from_numpy(frames), pcfg)
    close(ours, ref)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_multi_target_predictions_match_jax(compute_dtype):
    """bf16 operands: both sides round the GEMM operands to bf16 and
    multiply exactly into f32, so the f32 tolerance still holds."""
    jcfg, pcfg = configs(compute_dtype=compute_dtype)
    params, stats = jax_weights(8)
    frames = frame_stack()
    n = frames.shape[0]
    q = query_points(6, n)
    targets = np.random.default_rng(8).integers(0, n, (6, 5))
    ref = jtracker.get_point_predictions_multi_target(
        params, jnp.asarray(q), jnp.asarray(q[:, 2].astype(np.int32)),
        jnp.asarray(targets), jnp.asarray(frames), jcfg, channels_last=True)
    model = torch_model(params, stats, pcfg)
    with torch.no_grad():
        ours = tracker.get_point_predictions_multi_target(
            model, torch.from_numpy(q), torch.from_numpy(q[:, 2]).long(),
            torch.from_numpy(targets), torch.from_numpy(frames), pcfg)
    assert ours.shape == (6, 5, 2)
    close(ours, ref)
