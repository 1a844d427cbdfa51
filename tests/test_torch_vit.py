"""The port's DINOv2 ViT (``models/vit.py``, ``models/vit_convert.py``) held
against the JAX package's ``models/vit.py`` on the CPU.

Weights: one random DINOv2-layout state dict made with numpy from a seed,
with non-zero pos-embed and layerscale so the bicubic resize and the ls
products do work. The JAX side reads it through its own converter; the port
through ``vit_state_from_jax`` (the JAX pytree carried across) or
``load_dinov2_state_dict`` (the same dict on disk, plus keys it must drop).

Tolerances: f32 features within 1e-4 of the reference's largest magnitude
(the same math in another summation order, through 3 blocks). bf16: per-token
cosine ≥ 0.995 against the JAX package's bf16 features, the bound the JAX
package sets its own bf16 features (tests/test_vit.py:325-338). The two
differ by design: JAX rounds its parameters to bf16 but its f32 pos-embed
resize promotes the residual stream, so every later matmul there multiplies
f32 activations by bf16 weights; the port keeps the declared contract, bf16
operands for the linears and attention with f32 accumulation.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tracker_tpu.models import vit as jvit
from dino_tracker_tpu.models.vit_convert import convert_dinov2_state_dict
from dino_tracker_tpu_torch.models import vit as pvit
from dino_tracker_tpu_torch.models import vit_convert
from test_torch_vit_attention import dinov2_state_dict
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the small configs of tests/test_vit.py:197-221
SMALL = pvit.ViTConfig(embed_dim=32, depth=3, num_heads=4, mlp_ratio=2,
                       patch_size=14, pretrain_grid=5)
SMALL_V1 = pvit.ViTConfig(embed_dim=32, depth=3, num_heads=4, mlp_ratio=2,
                          patch_size=8, pretrain_grid=6, layerscale=False)
CASES = {"small": (SMALL, 7, (42, 56)), "small_v1": (SMALL_V1, 4, (32, 40))}
F32_TOL = 1e-4  # of the reference's largest magnitude


def jax_cfg(cfg: pvit.ViTConfig) -> jvit.ViTConfig:
    return jvit.ViTConfig(**{f: getattr(cfg, f) for f in (
        "embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size",
        "pretrain_grid", "layerscale", "ln_eps")})


def models(cfg, seed=0):
    """(JAX params, port model) from one state dict."""
    params = convert_dinov2_state_dict(dinov2_state_dict(cfg, seed), jax_cfg(cfg))
    return params, vit_convert.build_vit(vit_convert.vit_state_from_jax(params), cfg,
                                         "cpu")


def assert_close_to_max(ours, ref, tol=F32_TOL):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def token_cosines(a, b):
    """Per-token cosine of two T×D×h×w feature videos."""
    a = a.reshape(a.shape[0], a.shape[1], -1)
    b = b.reshape(b.shape[0], b.shape[1], -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("facet", ["tokens", "keys", "queries", "values"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_features_matches_jax(case, facet):
    cfg, stride, (h, w) = CASES[case]
    params, model = models(cfg, seed=len(facet))
    img = np.random.default_rng(1).standard_normal((2, 3, h, w)).astype(np.float32)
    ref, grid = jvit.forward_features(params, jnp.asarray(img), jax_cfg(cfg), stride,
                                      layers=[1, 2], facet=facet, attn_impl="xla")
    with torch.no_grad():
        ours, grid_p = model.forward_features(torch.from_numpy(img), stride, [1, 2],
                                              facet)
    assert grid_p == grid
    for o, r in zip(ours, ref):
        assert_close_to_max(o.numpy(), r)


def test_forward_features_rejects_out_of_range_layer():
    _, model = models(SMALL)
    img = torch.zeros(1, 3, 42, 56)
    with pytest.raises(ValueError, match="out of range for a 3-block"):
        model.forward_features(img, 7, [1, 15])


def test_pos_embed_matches_jax():
    """The bicubic resize (F.interpolate with the +0.1 scale factors) against
    the JAX package's matrix emulation, off and on the pretrain grid."""
    params, model = models(SMALL)
    for grid in ((5, 7), (9, 4), (5, 5)):
        ref = jvit.interpolate_pos_embed(params, grid, jax_cfg(SMALL))
        ours = model.interpolate_pos_embed(grid, torch.float32)
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=2e-5)


def test_for_model_presets():
    v2 = pvit.ViTConfig.for_model("dinov2_vitl14")
    assert (v2.embed_dim, v2.depth, v2.num_heads, v2.patch_size, v2.layerscale
            ) == (1024, 24, 16, 14, True)
    for name in ("dinov2_vits14", "dinov2_vitb14", "dino_vits8", "dino_vitb16"):
        p, j = pvit.ViTConfig.for_model(name), jvit.ViTConfig.for_model(name)
        assert jax_cfg(p) == j, name
        assert p.embed_dim // p.num_heads == 64  # the head dim K2 takes
    # ViT-g/14 on its own: DINOv2's vit_giant2 has SwiGLU FFNs, which the JAX
    # package's preset (a GELU MLP) lacks
    g = pvit.ViTConfig.for_model("dinov2_vitg14")
    assert (g.embed_dim, g.depth, g.num_heads, g.patch_size, g.layerscale, g.ffn,
            g.hidden_dim) == (1536, 40, 24, 14, True, "swiglu", 4096)
    assert g.embed_dim // g.num_heads == 64
    with pytest.raises(ValueError):
        pvit.ViTConfig.for_model("dino_vitl16")


def test_extract_feature_video_matches_jax_f32():
    params, model = models(SMALL, seed=3)
    video = np.random.default_rng(2).random((3, 3, 42, 56), dtype=np.float32)
    ref = jvit.extract_feature_video(params, jnp.asarray(video), jax_cfg(SMALL),
                                     stride=7, layer=[0, 2], frames_per_batch=2,
                                     attn_impl="xla")
    ours = pvit.extract_feature_video(model, torch.from_numpy(video), stride=7,
                                      layer=[0, 2], frames_per_batch=2)
    assert [o.shape for o in ours] == [(3, 32, 5, 7)] * 2
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        assert_close_to_max(o.numpy(), r)


def test_extract_feature_video_bf16_cosine_vs_jax():
    """bf16: per-token cosine ≥ 0.995 against the JAX package's bf16 features
    (see the module docstring for why the two differ)."""
    params, model = models(SMALL, seed=4)
    video = np.random.default_rng(5).random((2, 3, 42, 56), dtype=np.float32)
    ref = np.asarray(jvit.extract_feature_video(
        params, jnp.asarray(video), jax_cfg(SMALL), stride=7, layer=2,
        attn_impl="xla", compute_dtype=jnp.bfloat16))
    ours = pvit.extract_feature_video(model, torch.from_numpy(video), stride=7,
                                      layer=2, compute_dtype=torch.bfloat16)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    cos = token_cosines(ours.numpy(), ref)
    assert cos.min() >= 0.995, cos.min()


def test_extract_feature_video_single_pass_and_batching():
    """A layer list equals separate single-layer sweeps, and frames_per_batch
    2 (ragged last batch, not padded) equals 5."""
    _, model = models(SMALL, seed=6)
    video = torch.from_numpy(np.random.default_rng(7).random((5, 3, 42, 56),
                                                             dtype=np.float32))
    multi = pvit.extract_feature_video(model, video, layer=[0, 2], frames_per_batch=2)
    assert isinstance(multi, list) and len(multi) == 2
    for li, got in zip((0, 2), multi):
        single = pvit.extract_feature_video(model, video, layer=li, frames_per_batch=2)
        torch.testing.assert_close(got, single, rtol=0, atol=0)
        whole = pvit.extract_feature_video(model, video, layer=li, frames_per_batch=5)
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-5)


def test_weights_from_disk_match_jax_conversion(tmp_path):
    """load_dinov2_state_dict (.npz and .pth, with an extra ``mask_token``
    it must drop) gives the same model as vit_state_from_jax of the JAX
    converter's pytree."""
    sd = dinov2_state_dict(SMALL, seed=8)
    params = convert_dinov2_state_dict(sd, jax_cfg(SMALL))
    via_jax = vit_convert.vit_state_from_jax(params)
    np.savez(os.path.join(tmp_path, "w.npz"), **sd)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               os.path.join(tmp_path, "w.pth"))
    video = torch.from_numpy(np.random.default_rng(9).random((2, 3, 42, 56),
                                                             dtype=np.float32))
    ref = pvit.extract_feature_video(vit_convert.build_vit(via_jax, SMALL, "cpu"),
                                     video)
    for name in ("w.npz", "w.pth"):
        loaded, cfg = vit_convert.load_dinov2_state_dict(
            os.path.join(tmp_path, name), cfg=SMALL)
        assert cfg == SMALL
        assert "mask_token" not in loaded and loaded.keys() == via_jax.keys()
        for k in via_jax:
            torch.testing.assert_close(loaded[k], via_jax[k], rtol=0, atol=0)
        torch.testing.assert_close(
            pvit.extract_feature_video(vit_convert.build_vit(loaded, cfg, "cpu"),
                                       video),
            ref, rtol=0, atol=0)
    assert vit_convert.load_dinov2_state_dict.__defaults__[0] == "dinov2_vitl14"
    assert vit_convert.build_vit.__defaults__ == ("cuda",)  # the card unless asked


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_keys_self_similarity_and_attention_maps_match_jax(case, layer):
    """``keys_self_similarity`` and ``attention_maps`` (f32) within 1e-5 of
    the JAX functions' largest magnitude; every attention row sums to one
    (tests/test_misc_utils.py:35)."""
    cfg, stride, (h, w) = CASES[case]
    params, model = models(cfg, seed=7 + layer)
    img = np.random.default_rng(2).random((1, 3, h, w), dtype=np.float32)
    sim = pvit.keys_self_similarity(model, torch.from_numpy(img), stride, layer)
    jsim = jvit.keys_self_similarity(params, jnp.asarray(img), jax_cfg(cfg), stride, layer,
                                     attn_impl="xla")
    assert_close_to_max(sim, jsim, 1e-5)
    attn = pvit.attention_maps(model, torch.from_numpy(img), stride, layer)
    jattn = jvit.attention_maps(params, jnp.asarray(img), jax_cfg(cfg), stride, layer)
    s = sim.shape[-1]
    assert attn.shape == (1, cfg.num_heads, s, s) and attn.dtype == torch.float32
    assert_close_to_max(attn, jattn, 1e-5)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=1e-5)
