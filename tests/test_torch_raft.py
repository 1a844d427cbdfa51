"""RAFT of the port and its correlation lookup (kernel K3), held against the
JAX package.

On the CPU, on the same numpy inputs and weights (``raft_state_from_jax``):
instance norm and eval BN; the correlation pyramid level by level; the plain
lookup against the JAX ``corr_lookup`` gather path with coordinates inside,
at the edge and far outside the map and with degenerate levels, within 1e-5
of the output's max; ``window_gather_reference`` against the Pallas kernel in
interpret mode, equal; the upsampling, the GRU, the motion encoder and the
whole f32 forward within 1e-4 of max|flow|; the princeton-vl golden fixture
at atol 5e-4; bf16 against the port's own f32 under the JAX package's bound
(mean end-point error < 0.15 px, ``tests/test_raft.py:252``).

On the card (``cuda`` marker, skipped without one): K3 against the plain
version at the main path's shape (8 pairs, 60×107, a pyramid of random
256-channel fmaps), at ragged sizes, far outside the map, with degenerate
levels and on levels that start off a 16-byte boundary, within 1e-5 of
max|out|: both compute the same products in f32 and
differ only where the compiler fuses a multiply and an add (one rounding);
then the f32 forward on the card against the CPU's.

The JAX side is imported inside a fixture that pins it to the CPU, so the
file also runs on a GPU machine without JAX:
``python -m pytest tests/test_torch_raft.py --noconftest``.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.models import raft as praft
from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.ops import window_gather as pwg
from dino_tracker_tpu_torch.utils import sampling as psampling
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "raft_realscale_golden.npz")
LOOKUP_TOL = 1e-5  # of the output's largest magnitude
FLOW_TOL = 1e-4  # of max|flow|


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dino_tracker_tpu.models import raft as jraft
    from dino_tracker_tpu.ops import window_gather as jwg
    return types.SimpleNamespace(jax=jax, jnp=jnp, raft=jraft, wg=jwg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K3 has no CPU mode)")
    return torch.device("cuda")


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def nhwc(a):
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def jax_params(jx, seed):
    """The JAX package's init_raft tree as numpy, with random BN statistics
    and affine parameters, so the cnet's BNs do work."""
    rng = np.random.default_rng(seed)
    tree = jx.jax.tree.map(np.asarray, jx.raft.init_raft(jx.jax.random.PRNGKey(seed)))

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["scale"].shape[0]
                return {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                        "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                        "var": (0.5 + rng.random(c)).astype(np.float32)}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return node

    return perturb(tree)


def port_model(params, device="cpu"):
    return praft.load_raft_state_dict(praft.raft_state_from_jax(params), device)


@pytest.fixture(scope="module")
def weights(jx):
    params = jax_params(jx, 3)
    return params, port_model(params)


def images(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.random((n, 3, h, w), dtype=np.float32) for _ in range(2)]


def assert_close_rel(ours, ref, tol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_instance_and_batch_norm_match_jax(jx):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 6, 5, 7)) * 3 + 1).astype(np.float32)  # NCHW
    ref = nchw(jx.raft.instance_norm(jx.jnp.asarray(nhwc(x))))
    np.testing.assert_allclose(praft.instance_norm(torch.from_numpy(x)).numpy(), ref,
                               rtol=0, atol=1e-5)
    p = {"scale": rng.standard_normal(6), "bias": rng.standard_normal(6),
         "mean": rng.standard_normal(6), "var": rng.random(6) + 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bn = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, ours).copy_(torch.from_numpy(p[theirs]))
    ref = nchw(jx.raft.batch_norm_eval(jx.jnp.asarray(nhwc(x)), p))
    np.testing.assert_allclose(praft.batch_norm_eval(torch.from_numpy(x), bn).detach().numpy(),
                               ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,h,w", [(2, 7, 9), (1, 5, 13), (1, 3, 5)])
def test_corr_pyramid_matches_jax(jx, b, h, w):
    """Level 0 (f32 GEMM / √C), floor-semantics pooling, and an unpooled
    level once a side drops under 2 (the last case)."""
    rng = np.random.default_rng(h * w)
    f1, f2 = (rng.standard_normal((b, 16, h, w)).astype(np.float32) for _ in range(2))
    ours = praft.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    ref = jx.raft.build_corr_pyramid(jx.jnp.asarray(nhwc(f1)), jx.jnp.asarray(nhwc(f2)))
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.dtype == torch.float32 and o.shape == (b * h * w,) + r.shape[2:]
        np.testing.assert_allclose(o.numpy(), r[:, 0], rtol=0, atol=1e-5 * np.abs(r).max())


def lookup_case(case):
    """(fmaps shape, coords B×2×h×w) for the lookup cases."""
    rng = np.random.default_rng(len(case))
    b, h, w = {"inside": (2, 16, 19), "edge": (2, 16, 19), "outside": (2, 16, 19),
               "degenerate": (2, 3, 5), "tiny_image": (1, 6, 8)}[case]
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    coords = np.broadcast_to(np.stack([xs, ys]), (b, 2, h, w)).copy()
    if case == "inside":
        coords += rng.normal(0, 1.3, coords.shape).astype(np.float32)
    elif case == "edge":  # windows that straddle each side of every level
        coords[:, 0] = rng.uniform(-6, 6, (b, h, w)) + np.where(
            rng.random((b, h, w)) < 0.5, 0, w - 1)
        coords[:, 1] = rng.uniform(-6, 6, (b, h, w)) + np.where(
            rng.random((b, h, w)) < 0.5, 0, h - 1)
    elif case == "outside":
        coords += rng.normal(0, 4, coords.shape).astype(np.float32)
        coords[0, :, 0, :4] = [[-14.2, -40.0, 200.0, 25.5], [-7.0, 90.3, -100.0, 3.0]]
        coords[1, :, -1, -3:] = [[40.7, -5.01, 19.0], [-13.0, 16.2, 15.99]]
    else:  # level sides of 1: the grid-sample tap path
        coords += rng.normal(0, 2.0, coords.shape).astype(np.float32)
    return (b, 32, h, w), coords.astype(np.float32)


@pytest.mark.parametrize("case", ["inside", "edge", "outside", "degenerate", "tiny_image"])
def test_corr_lookup_reference_matches_jax(jx, case):
    shape, coords = lookup_case(case)
    rng = np.random.default_rng(7)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pyramid = praft.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    ours = praft.corr_lookup(pyramid, torch.from_numpy(coords))
    jpyr = jx.raft.build_corr_pyramid(jx.jnp.asarray(nhwc(f1)), jx.jnp.asarray(nhwc(f2)))
    ref = nchw(jx.raft.corr_lookup(jpyr, jx.jnp.asarray(coords), impl="gather"))
    assert ours.shape == (shape[0], 324) + shape[2:] and ours.dtype == torch.float32
    assert_close_rel(ours.numpy(), ref, LOOKUP_TOL)
    if case == "degenerate":
        assert min(pyramid[-1].shape[1:]) == 1
    if case == "outside":  # windows outside the map at every level read zeros
        assert not ours[0, :, 0, 1:3].any() and ours[1, :, -1, -3].any()


@pytest.mark.parametrize("n,hp,wp,side,block", [(70, 26, 33, 10, 32), (5, 16, 17, 4, 16)])
def test_window_gather_reference_matches_pallas_kernel(jx, n, hp, wp, side, block):
    rng = np.random.default_rng(n)
    vol = rng.standard_normal((n, hp, wp)).astype(np.float32)
    sy = rng.integers(0, hp - side + 1, n).astype(np.int32)
    sx = rng.integers(0, wp - side + 1, n).astype(np.int32)
    ref = jx.wg.window_gather(jx.jnp.asarray(vol), jx.jnp.asarray(sy), jx.jnp.asarray(sx),
                              side=side, block=block, interpret=True)
    ours = pwg.window_gather_reference(*map(torch.from_numpy, (vol, sy, sx)), side=side)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_bilinear_sampler_pixel_matches_jax(jx):
    from dino_tracker_tpu.utils import sampling as jsampling
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    coords = rng.uniform(-2, 12, (2, 5, 7, 2)).astype(np.float32)
    ours = psampling.bilinear_sampler_pixel(torch.from_numpy(img), torch.from_numpy(coords))
    ref = jsampling.bilinear_sampler_pixel(jx.jnp.asarray(img), jx.jnp.asarray(coords))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_input_padder_matches_jax(jx):
    x = np.random.default_rng(2).random((2, 3, 30, 41), dtype=np.float32)
    ours, ref = praft.InputPadder(x.shape), jx.raft.InputPadder(x.shape)
    padded = ours.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(ref.pad(jx.jnp.asarray(x))))
    assert padded.shape[-2:] == (32, 48)
    np.testing.assert_array_equal(ours.unpad(padded).numpy(), x)


def test_convex_upsample_matches_jax(jx):
    rng = np.random.default_rng(3)
    flow = rng.standard_normal((2, 2, 4, 5)).astype(np.float32)
    mask = rng.standard_normal((2, 576, 4, 5)).astype(np.float32)
    ours = praft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    ref = nchw(jx.raft.convex_upsample(jx.jnp.asarray(nhwc(flow)), jx.jnp.asarray(nhwc(mask))))
    assert ours.shape == (2, 2, 32, 40)
    assert_close_rel(ours.numpy(), ref, 1e-6)


def test_update_block_matches_jax(jx, weights):
    """The SepConvGRU, the motion encoder and the flow head on the same
    inputs and converted weights."""
    params, model = weights
    up, jup = model.update_block, params["update"]
    rng = np.random.default_rng(4)
    b, h, w = 2, 6, 7
    hid = rng.standard_normal((b, 128, h, w)).astype(np.float32)
    x = rng.standard_normal((b, 256, h, w)).astype(np.float32)
    flow = (rng.standard_normal((b, 2, h, w)) * 3).astype(np.float32)
    corr = rng.standard_normal((b, 324, h, w)).astype(np.float32)
    j = jx.jnp.asarray
    with torch.no_grad():
        gru = up.gru(torch.from_numpy(hid), torch.from_numpy(x))
        motion = up.encoder(torch.from_numpy(flow), torch.from_numpy(corr))
        head = up.flow_head(torch.from_numpy(hid))
    assert_close_rel(gru.numpy(), nchw(jx.raft._sep_conv_gru(jup["gru"], j(nhwc(hid)),
                                                             j(nhwc(x)))), 1e-5)
    assert_close_rel(motion.numpy(), nchw(jx.raft._motion_encoder(
        jup["enc"], j(nhwc(flow)), j(nhwc(corr)))), 1e-5)
    assert_close_rel(head.numpy(), nchw(jx.raft._flow_head(jup["flow_head"],
                                                           j(nhwc(hid)))), 1e-5)


@pytest.mark.parametrize("h,w,iters", [(128, 128, 2), (64, 80, 3)])
def test_raft_forward_matches_jax(jx, weights, h, w, iters):
    """f32 RAFT end to end: at 128×128 every pyramid level has sides ≥ 2;
    at 64×80 the last level is 1×1 (the tap path)."""
    params, model = weights
    img1, img2 = images(h + iters, 2, h, w)
    ours = praft.raft_forward(model, torch.from_numpy(img1), torch.from_numpy(img2), iters)
    ref = jx.raft.raft_forward(params, jx.jnp.asarray(img1), jx.jnp.asarray(img2),
                               num_iters=iters)
    assert ours.dtype == torch.float32 and ours.shape == (2, 2, h, w)
    assert_close_rel(ours.numpy(), ref, FLOW_TOL)
    assert np.abs(np.asarray(ref)).max() > 0.5  # the flow does move


def test_raft_golden_fixture(jx):
    """The princeton-vl-layout state dict of ``gen_random_ckpts.raft_state_dict
    (seed=0)``, loaded by ``load_raft_state_dict``, reproduces the checked-in
    flow of tests/fixtures/raft_realscale_golden.npz (48×64, 4 iterations,
    degenerate levels 2-3) at the JAX golden test's atol."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from gen_random_ckpts import raft_state_dict
    sd = raft_state_dict(seed=0)
    assert all(k.startswith("module.") for k in sd)
    model = praft.load_raft_state_dict(sd, "cpu")
    rng = np.random.default_rng(1)
    img1 = rng.random((1, 3, 48, 64), dtype=np.float64).astype(np.float32)
    img2 = rng.random((1, 3, 48, 64), dtype=np.float64).astype(np.float32)
    flow = praft.raft_forward(model, torch.from_numpy(img1), torch.from_numpy(img2), 4)
    with np.load(FIXTURE, allow_pickle=False) as fx:
        np.testing.assert_allclose(flow.numpy(), fx["flow"], rtol=0, atol=5e-4)


def test_bf16_compute_close_to_f32(weights):
    """bf16 convs (corr volume, lookup and flow coordinates in f32): f32
    output within the JAX package's bf16 bound of the port's own f32."""
    _, model = weights
    img1, img2 = (torch.from_numpy(a) for a in images(9, 1, 64, 80))
    f32 = praft.raft_forward(model, img1, img2, 4)
    bf16 = praft.raft_forward(model, img1, img2, 4, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32 and bool(bf16.isfinite().all())
    err = torch.linalg.vector_norm(f32 - bf16, dim=1)
    assert float(err.mean()) < 0.15, float(err.mean())


def test_load_raft_state_dict_layouts(tmp_path):
    """A ``module.``-prefixed dict with ``num_batches_tracked`` (a published
    checkpoint's layout), as a file, loads; a missing key raises."""
    ref = praft.RAFT()
    sd = {f"module.{k}": v for k, v in ref.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in sd)
    path = str(tmp_path / "raft-things.pth")
    torch.save(sd, path)
    model = praft.load_raft_state_dict(path, "cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref.state_dict()[k], rtol=0, atol=0)
    del sd["module.update_block.mask.2.bias"]
    with pytest.raises(RuntimeError, match="mask.2.bias"):
        praft.load_raft_state_dict(sd, "cpu")


def test_load_raft_state_dict_takes_a_published_checkpoints_norm3():
    """princeton-vl's strided batch-norm blocks register their downsample BN
    twice, as ``norm3`` and ``downsample.1``, so a published raft-things.pth
    holds ``cnet.layer{2,3}.0.norm3.*`` too. The JAX converter never reads
    them; the port loads such a dict to the same model (it raised on the
    unexpected keys before)."""
    ref = praft.RAFT()
    sd = {f"module.{k}": v for k, v in ref.state_dict().items()}
    for k in [k for k in sd if k.startswith("module.cnet.") and ".downsample.1." in k]:
        sd[k.replace(".downsample.1.", ".norm3.")] = sd[k].clone()
    assert sum(".norm3." in k for k in sd) == 10
    model = praft.load_raft_state_dict(sd, "cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref.state_dict()[k], rtol=0, atol=0)


def test_corr_lookup_dispatch():
    """CPU tensors take the plain version without touching K3; the kernel's
    wrapper refuses a CPU tensor uncounted; another device raises."""
    shape, coords = lookup_case("inside")
    rng = np.random.default_rng(8)
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for _ in range(2))
    pyramid = praft.build_corr_pyramid(f1, f2)
    before = launches()
    out = praft.corr_lookup(pyramid, torch.from_numpy(coords))
    torch.testing.assert_close(out, pwg.corr_lookup_reference(pyramid, torch.from_numpy(coords)),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pwg.corr_lookup_cuda(pyramid, torch.from_numpy(coords))
    assert launches() == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        praft.corr_lookup(pyramid, torch.from_numpy(coords).to("meta"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def launches():
    """K3's launch count."""
    return _guard.launch_counts()["corr_lookup"]


def card_pyramid(dev, b, h, w, c=256, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    f1, f2 = (torch.randn((b, c, h, w), generator=g, device=dev) for _ in range(2))
    return praft.build_corr_pyramid(f1, f2), g


# main path: 8 pairs at 60×107; ragged; far outside; degenerate levels;
# B·h·w = 429, a multiple of neither 32 nor 64, with pixel tiles that cross
# frame boundaries; fewer pixels than one tile
CARD_CASES = [(8, 60, 107, 2.0), (3, 13, 17, 3.0), (2, 16, 19, 40.0), (2, 3, 5, 2.0),
              (1, 6, 8, 2.0), (1, 1, 1, 2.0), (3, 11, 13, 3.0), (1, 5, 5, 2.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,spread", CARD_CASES)
def test_kernel_matches_reference(cuda, b, h, w, spread):
    pyramid, g = card_pyramid(cuda, b, h, w, seed=h * w)
    coords = praft.coords_grid(b, h, w, cuda)
    coords = (coords + torch.randn(coords.shape, generator=g, device=cuda) * spread).contiguous()
    before = launches()
    out = praft.corr_lookup(pyramid, coords)
    torch.cuda.synchronize()
    assert launches() == before + 1
    ref = pwg.corr_lookup_reference(pyramid, coords)
    assert out.shape == ref.shape == (b, 324, h, w) and out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= LOOKUP_TOL * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_levels_off_16_bytes(cuda, offset):
    """Levels that start 4, 8 or 12 bytes past a 16-byte boundary, in NaN
    that no output may show: K3's 4-byte copies take any f32 address."""
    b, h, w = 3, 11, 13
    pyramid, g = card_pyramid(cuda, b, h, w, seed=offset)
    views = []
    for v in pyramid:
        buf = torch.full((v.numel() + 8,), float("nan"), device=cuda)
        views.append(buf[offset:offset + v.numel()].view(v.shape))
        views[-1].copy_(v)
        assert views[-1].data_ptr() % 16 == 4 * offset
    coords = praft.coords_grid(b, h, w, cuda)
    coords = (coords + torch.randn(coords.shape, generator=g, device=cuda) * 4.0).contiguous()
    out = pwg.corr_lookup_cuda(views, coords)
    ref = pwg.corr_lookup_reference(pyramid, coords)
    err = (out - ref).abs().max().item()
    assert err <= LOOKUP_TOL * ref.abs().max().item(), err


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    pyramid, _ = card_pyramid(cuda, 1, 8, 8, c=8)
    coords = praft.coords_grid(1, 8, 8, cuda)
    with pytest.raises(TypeError):
        pwg.corr_lookup_cuda([v.double() for v in pyramid], coords)
    with pytest.raises(ValueError, match="levels"):
        pwg.corr_lookup_cuda(pyramid[:3], coords)
    with pytest.raises(ValueError, match="level 0"):
        pwg.corr_lookup_cuda([pyramid[0][:10]] + pyramid[1:], coords)
    with pytest.raises(ValueError, match="contiguous"):
        pwg.corr_lookup_cuda(pyramid, coords.transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pwg.corr_lookup_cuda(pyramid, coords.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(128, 128), (48, 64)])
def test_raft_forward_on_card_matches_cpu(cuda, h, w):
    """f32 RAFT through K3 on the card within 1e-4 of max|flow| of the CPU's
    (48×64: degenerate levels)."""
    with torch.random.fork_rng():  # torch's default conv init, from a seed
        torch.manual_seed(0)
        sd = praft.RAFT().state_dict()
    img1, img2 = (torch.from_numpy(a) for a in images(h, 2, h, w))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        m = praft.load_raft_state_dict(sd, dev)
        out[dev.type] = praft.raft_forward(m, img1.to(dev), img2.to(dev), 6).cpu()
    assert_close_rel(out["cuda"].numpy(), out["cpu"].numpy(), FLOW_TOL)
