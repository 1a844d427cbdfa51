"""Kernel K2 (flash attention forward) of the port, its plain version, and the
ViT feature stage on the card.

On the CPU: ``attention_reference`` (the plain version) held against the JAX
package's ``xla_attention`` and its Pallas flash kernel (interpret mode,
through the JAX dispatch that pads S to a block multiple), f32, atol 2e-5 —
the bound tests/test_vit.py holds the Pallas kernel to against XLA. On the
card (``cuda`` marker, skipped without one): the CUDA kernel against the
plain version at one frame of the ViT-L/14 feature stage ([1, 16, 8108, 64])
and at ragged small S that exercise the bounds masks. Bounds there: f32
2e-5 absolute; bf16 2^-6 · max|out| (two to four bf16 ulps at the top of
the output's range), because the kernel rounds the unnormalised
probabilities exp(s - m) to bf16 and divides once at the end, while the
plain version rounds the normalised ones; both round the output to bf16.
A normalisation off by 2% or a skipped key tile moves the output by more at
S = 8108, and keys past S left unmasked do at S = 65 and 100. The bf16
kernel also runs on the permuted q/k/v views of one qkv buffer (the ViT's
layout, read through TMA tensor maps), at S across the 128-key tile and
the 128/192-row block edges, with both consumer counts, and refuses a view
its tensor maps cannot express. Then a small f32 ViT
(head dim 64) through ``extract_feature_video`` and ``compute_fg_masks`` on
the card against the CPU: features within 1e-4 of their max, masks equal.

On the CPU as well: ``tma_layout`` (the tensor-map arithmetic of the bf16
wrapper) turns the permuted views of a qkv buffer into numbers that
``torch.as_strided`` turns back into exactly those views, and refuses the
layouts TMA cannot take; ``multi_head_attention`` gives the same result on
those views as on contiguous copies.

The JAX side is imported inside a fixture that pins it to the CPU, so this
file also runs on a GPU machine without JAX:
``python -m pytest tests/test_torch_vit_attention.py --noconftest``.
"""

import math
import types

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.models import vit as pvit
from dino_tracker_tpu_torch.models import vit_convert
from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.ops import attention as pattn
from dino_tracker_tpu_torch.ops import flash_attention as pflash
from dino_tracker_tpu_torch.preprocessing import fg_mask
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# one frame of the ViT-L/14 feature stage at 854×476, stride 7: 16 heads,
# 67·121 + 1 = 8108 tokens, head dim 64; then ragged small S
REAL_SHAPE = (1, 16, 8108, 64)
SMALL_SHAPES = [(2, 3, 100, 64), (1, 2, 1000, 64), (1, 1, 1, 64),
                (1, 2, 65, 64), (3, 1, 64, 64)]
BF16_TOL = 2.0 ** -6  # of the plain output's largest magnitude


@pytest.fixture
def jax_ref():
    jax = pytest.importorskip("jax")
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dino_tracker_tpu.ops import attention as jattn
    return types.SimpleNamespace(jnp=jnp, attn=jattn)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K2 has no CPU mode)")
    return torch.device("cuda")


def launches():
    """K2's launch count."""
    return _guard.launch_counts()["flash_attention"]


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def dinov2_state_dict(cfg: pvit.ViTConfig, seed: int = 0) -> dict:
    """Random f32 numpy weights under the DINOv2 keys (plus the unused
    ``mask_token``), with non-zero pos-embed and layerscale; linear scales
    ~1/√din keep activations O(1)."""
    rng = np.random.default_rng(seed)
    d, hid, p = cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim, cfg.patch_size

    def u(shape, scale):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    sd = {"patch_embed.proj.weight": u((d, 3, p, p), 1 / np.sqrt(3 * p * p)),
          "patch_embed.proj.bias": u((d,), 0.1),
          "cls_token": u((1, 1, d), 1.0),
          "pos_embed": u((1, 1 + cfg.pretrain_grid ** 2, d), 1.0),
          "mask_token": u((1, d), 1.0)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                                  "mlp.fc1": (hid, d), "mlp.fc2": (d, hid)}.items():
            sd[f"{b}{name}.weight"] = u((dout, din), 1 / np.sqrt(din))
            sd[f"{b}{name}.bias"] = u((dout,), 0.1)
        for name in ("norm1", "norm2"):
            sd[f"{b}{name}.weight"] = 1 + u((d,), 0.2)
            sd[f"{b}{name}.bias"] = u((d,), 0.1)
        if cfg.layerscale:
            sd[f"{b}ls1.gamma"] = u((d,), 1.0)
            sd[f"{b}ls2.gamma"] = u((d,), 1.0)
    return sd


@pytest.mark.parametrize("s", [100, 256, 384])
def test_reference_matches_jax(jax_ref, s):
    q, k, v = qkv((1, 2, s, 64), s)
    scale = 1.0 / 8.0
    ours = pattn.attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    jq, jk, jv = map(jax_ref.jnp.asarray, (q, k, v))
    xla = jax_ref.attn.xla_attention(jq, jk, jv, scale)
    flash = jax_ref.attn.multi_head_attention(jq, jk, jv, scale, impl="flash",
                                              interpret=True)
    for ref in (xla, flash):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-5)


def test_reference_matches_jax_bf16(jax_ref):
    """bf16 q, k, v: f32 scores and softmax, probabilities rounded to bf16,
    bf16 P·V in both packages: within one bf16 ulp of the output's max."""
    q, k, v = qkv((1, 2, 96, 64), 7)
    bf16 = jax_ref.jnp.bfloat16
    jq, jk, jv = (jax_ref.jnp.asarray(a, bf16) for a in (q, k, v))
    ref = np.asarray(jax_ref.attn.xla_attention(jq, jk, jv, 0.125).astype(
        jax_ref.jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jax_ref.jnp.float32))
                                   ).bfloat16() for a in (jq, jk, jv))
    ours = pattn.multi_head_attention(tq, tk, tv, 0.125)
    assert ours.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=ulp)


def test_dispatch_takes_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, qkv((1, 2, 30, 8), 1))
    before = launches()
    out = pattn.multi_head_attention(q, k, v, 0.3)
    assert launches() == before
    torch.testing.assert_close(out, pattn.attention_reference(q, k, v, 0.3),
                               rtol=0, atol=0)


def test_cuda_wrapper_rejects_cpu_tensors():
    """No fallback: the kernel's wrapper refuses a CPU tensor and does not
    count the refused call."""
    q = torch.zeros(1, 2, 8, 64)
    before = launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        pflash.flash_attention_cuda(q, q, q, 0.125)
    assert launches() == before


def qkv_views(b, s, h, dtype=torch.float32, device="cpu", seed=0):
    """One [B, S, 3·H·64] qkv buffer and its q, k, v views [B, H, S, 64], as
    models/vit.py makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * 64), generator=g, device=device).to(dtype)
    return qkv, qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)


@pytest.mark.parametrize("b,s,h", [(4, 811, 16), (1, 100, 2), (2, 1, 3), (1, 65, 1)])
def test_tma_layout_round_trips_qkv_views(b, s, h):
    qkv, views = qkv_views(b, s, h, torch.bfloat16)
    flat = qkv.flatten()
    for view in views:
        lay = pflash.tma_layout(view.shape, view.stride(), view.element_size(),
                                view.data_ptr())
        d_, h_, s_, b_ = lay.dims
        assert (b_, h_, s_, d_) == tuple(view.shape)
        sh, ss, sb = (n // 2 for n in lay.byte_strides)
        assert all(n % 16 == 0 for n in lay.byte_strides)
        back = torch.as_strided(flat, (b_, h_, s_, d_), (sb, sh, ss, 1),
                                (lay.address - qkv.data_ptr()) // 2)
        assert back.data_ptr() == view.data_ptr()
        assert torch.equal(back, view)
    # k and v start one and two head blocks (H·64 values) into each row
    offsets = [pflash.tma_layout(v.shape, v.stride(), 2, v.data_ptr()).address
               - qkv.data_ptr() for v in views]
    assert offsets == [0, h * 128, 2 * h * 128]


@pytest.mark.parametrize("case", ["d_not_contiguous", "stride_not_16B", "unaligned_base"])
def test_tma_layout_rejects_what_tma_cannot_express(case):
    buf = torch.zeros(2 * 16 * 65 * 64 + 8, dtype=torch.bfloat16)
    if case == "d_not_contiguous":
        t = buf[:2 * 16 * 64 * 64].view(2, 16, 64, 64).transpose(2, 3)
        match = "contiguous"
    elif case == "stride_not_16B":  # rows of 65 values: 130 bytes apart
        t = buf[:2 * 16 * 65 * 64].view(2, 16, 64, 65)[..., :64]
        match = "multiple of 16"
    else:
        t = buf[1:1 + 2 * 16 * 64 * 64].view(2, 16, 64, 64)
        match = "aligned"
    with pytest.raises(ValueError, match=match):
        pflash.tma_layout(t.shape, t.stride(), t.element_size(), t.data_ptr())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_head_attention_on_qkv_views_matches_contiguous(dtype):
    _, (q, k, v) = qkv_views(2, 37, 3, dtype, seed=5)
    assert not q.is_contiguous()
    out = pattn.multi_head_attention(q, k, v, 0.125)
    ref = pattn.multi_head_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), 0.125)
    assert out.shape == ref.shape == (2, 3, 37, 64) and out.dtype == dtype
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def max_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [REAL_SHAPE] + SMALL_SHAPES)
def test_kernel_matches_reference(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(shape[2])
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(shape[-1])
    before = launches()
    out = pattn.multi_head_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert out.dtype == dtype and out.shape == shape
    ref = pattn.attention_reference(q, k, v, scale)
    bound = (2e-5 if dtype == torch.float32
             else BF16_TOL * ref.float().abs().max().item())
    err = max_err(out, ref)
    assert err <= bound, (err, bound)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(TypeError):
        pflash.flash_attention_cuda(q.half(), q.half(), q.half(), 0.1)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 16, 32, device=cuda)
        pflash.flash_attention_cuda(z, z, z, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 16, 2, 64, device=cuda).transpose(1, 2)
        pflash.flash_attention_cuda(t, t, t, 0.1)
    with pytest.raises(ValueError, match="shape"):
        pflash.flash_attention_cuda(q, q[:, :, :8].contiguous(), q, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(1, 8108, 16)] + [
    (1, s, 2) for s in (1, 64, 65, 100, 127, 128, 129, 1000)] + [(2, 577, 3)])
def test_kernel_on_qkv_views(cuda, b, s, h):
    """bf16 K2 on the permuted views of one qkv buffer, as the ViT passes
    them: within 2^-6·max|out| of the plain version, nothing copied, the
    output a [B, H, S, 64] view of a [B, S, H, 64] buffer."""
    _, (q, k, v) = qkv_views(b, s, h, torch.bfloat16, cuda, seed=s)
    before = launches()
    out = pattn.multi_head_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert out.shape == (b, h, s, 64) and out.dtype == torch.bfloat16
    assert out.stride() == (s * h * 64, 64, h * 64, 1)
    assert out.transpose(1, 2).reshape(b, s, h * 64).data_ptr() == out.data_ptr()
    ref = pattn.attention_reference(q, k, v, 0.125)
    assert max_err(out, ref) <= BF16_TOL * ref.float().abs().max().item()


@pytest.mark.cuda
def test_kernel_rejects_unaligned_bf16_views(cuda):
    """A bf16 layout the tensor maps cannot express raises, with no copy and
    no launch."""
    buf = torch.zeros(2 * 16 * 65 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    unaligned = buf[1:1 + 2 * 16 * 64 * 64].view(2, 16, 64, 64)
    odd_rows = buf[:2 * 16 * 65 * 64].view(2, 16, 64, 65)[..., :64]
    ok = torch.zeros(2, 16, 64, 64, dtype=torch.bfloat16, device=cuda)
    before = launches()
    for bad, match in ((unaligned, "aligned"), (odd_rows, "multiple of 16")):
        with pytest.raises(ValueError, match=match):
            pattn.multi_head_attention(bad, ok, ok, 0.125)
        with pytest.raises(ValueError, match=match):
            pattn.multi_head_attention(ok, ok, bad, 0.125)
    assert launches() == before


@pytest.mark.cuda
def test_feature_stage_on_card_matches_cpu(cuda):
    """f32 features through K2 on the card within 1e-4 of the CPU's max, and
    equal fg masks (head dim 64, the dim K2 takes)."""
    cfg = pvit.ViTConfig(embed_dim=128, depth=3, num_heads=2, mlp_ratio=2,
                         patch_size=14, pretrain_grid=5)
    sd = {k: torch.from_numpy(v) for k, v in dinov2_state_dict(cfg, 13).items()}
    state, _ = vit_convert.load_dinov2_state_dict(sd, cfg=cfg)
    video = torch.from_numpy(np.random.default_rng(14).random((3, 3, 70, 98),
                                                              dtype=np.float32))
    out = {}
    before = launches()
    for dev in (torch.device("cpu"), cuda):
        model = vit_convert.build_vit(state, cfg, dev)
        f = pvit.extract_feature_video(model, video.to(dev), layer=[1, 2])
        out[dev.type] = [x.cpu() for x in f] + [
            fg_mask.compute_fg_masks(f[1], (70, 98)).cpu()]
    assert launches() == before + 3  # blocks 0..2
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=0, atol=0)
