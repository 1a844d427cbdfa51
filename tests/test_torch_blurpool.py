"""Kernel K1 (blurpool forward K1-fwd and backward K1-bwd) of the port, and
the f32 conv gradients of DeltaDINO's CUDA path.

On the CPU: the plain PyTorch version and its autograd held against the JAX
package's Pallas kernel (interpret mode, as tests/test_blurpool_pallas.py
runs it) and its banded-matmul form, forward and VJP; and a numpy mirror of
K1-bwd's quad weights (interior constants and edge tables) against the
autograd VJP of the plain version, for every axis length 3..40. On the card
(``cuda`` marker, skipped without one): the CUDA kernels held against the
plain version and its autograd, at the shapes DeltaDINO gives them in a
refine chunk and a training step, at small odd/even shapes and where K1-bwd's
vector path meets the quad edges; and f32 conv gradients on the card against
the CPU (TF32 must stay off in the backward).

The JAX side is imported inside a fixture, so this file also runs on a GPU
machine without JAX: ``python -m pytest tests/test_torch_blurpool.py
--noconftest`` (tests/conftest.py configures JAX); the JAX cases skip there.

Tolerances: f32 atol 1e-6 against JAX (same exact taps, different summation
order), 1e-5 kernel against plain. bf16 IO: one bf16 ulp at the output's
largest magnitude — every form accumulates in f32, but a sum near a
rounding boundary may land one step apart, and the Pallas kernel also rounds
its intermediate (after the H pass) to bf16.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.ops import blurpool as bp
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# even and odd H/W, including the smallest legal sizes (reflect pad 2 needs 3)
SHAPES = [(2, 3, 5, 4), (1, 4, 3, 3), (2, 5, 4, 8), (2, 16, 24, 8),
          (1, 15, 27, 16), (2, 9, 8, 5)]
# the three DeltaDINO blurpool inputs of one 16-frame refine chunk
REAL_SHAPES = [(16, 476, 854, 64), (16, 238, 427, 128), (16, 119, 214, 256)]
# ... and of one training step (8-frame set)
TRAIN_SHAPES = [(8, 476, 854, 64), (8, 238, 427, 128), (8, 119, 214, 256)]


def bf16_ulp(y: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7))


@pytest.fixture
def jax_ref():
    """The JAX package's blurpool forms, with arrays returned as f32 numpy."""
    jax = pytest.importorskip("jax")
    if jax.config.jax_platforms != "cpu":
        # run without tests/conftest.py on a GPU machine that has JAX: keep
        # the reference on the CPU (JAX's GPU matmuls default to TF32)
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dino_tracker_tpu.models import nn as jnn
    from dino_tracker_tpu.ops.blurpool import blurpool_pallas

    def as_f32(x):
        return np.array(jnp.asarray(x, jnp.float32))

    def vjp(fn, x, g):
        return jax.vjp(fn, x)[1](g)[0]

    return types.SimpleNamespace(jnp=jnp, as_f32=as_f32, vjp=vjp,
                                 pallas=lambda x: blurpool_pallas(x, True),
                                 matmul=lambda x: jnn.blurpool(x, impl="matmul"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_f32(jax_ref, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ours = bp.blurpool(torch.from_numpy(x)).numpy()
    assert ours.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2,
                          shape[3])
    for ref in (jax_ref.pallas, jax_ref.matmul):
        np.testing.assert_allclose(
            ours, jax_ref.as_f32(ref(jax_ref.jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_bf16(jax_ref, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    xj = jax_ref.jnp.asarray(x, jax_ref.jnp.bfloat16)
    xt = torch.from_numpy(jax_ref.as_f32(xj)).to(torch.bfloat16)  # same values
    ours = bp.blurpool(xt)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    for ref in (jax_ref.pallas, jax_ref.matmul):
        out = ref(xj)
        assert out.dtype == jax_ref.jnp.bfloat16
        np.testing.assert_allclose(ours, jax_ref.as_f32(out), rtol=0,
                                   atol=bf16_ulp(ours))


def reference_vjp(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain backward: autograd of ``blurpool_reference`` at x."""
    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(bp.blurpool_reference(x), x, g)[0]


def out_shape(shape):
    return (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, shape[3])


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_vjp_matches_jax_f32(jax_ref, shape):
    """The plain backward (autograd of the plain version) against the VJPs of
    the Pallas kernel (its _up_kernel) and of the banded-matmul form."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(out_shape(shape)).astype(np.float32)
    ours = reference_vjp(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert ours.shape == shape
    xj, gj = jax_ref.jnp.asarray(x), jax_ref.jnp.asarray(g)
    for ref in (jax_ref.pallas, jax_ref.matmul):
        np.testing.assert_allclose(ours, jax_ref.as_f32(jax_ref.vjp(ref, xj, gj)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_vjp_matches_jax_bf16(jax_ref, shape):
    """bf16 cotangents: one bf16 ulp at the largest magnitude (the Pallas
    backward also rounds its intermediate after the first axis)."""
    rng = np.random.default_rng(3)
    bf16 = jax_ref.jnp.bfloat16
    xj = jax_ref.jnp.asarray(rng.standard_normal(shape), bf16)
    gj = jax_ref.jnp.asarray(rng.standard_normal(out_shape(shape)), bf16)
    ours = reference_vjp(torch.from_numpy(jax_ref.as_f32(xj)).to(torch.bfloat16),
                         torch.from_numpy(jax_ref.as_f32(gj)).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    for ref in (jax_ref.pallas, jax_ref.matmul):
        out = jax_ref.vjp(ref, xj, gj)
        assert out.dtype == bf16
        np.testing.assert_allclose(ours, jax_ref.as_f32(out), rtol=0,
                                   atol=bf16_ulp(ours))


def launches():
    """K1-fwd's and K1-bwd's launch counts."""
    counts = _guard.launch_counts()
    return counts["blurpool_down_nhwc"], counts["blurpool_up_nhwc"]


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused, and a
    refused call is not counted as a launch."""
    before = launches()[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp.blurpool_cuda(torch.zeros(1, 4, 4, 2))
    assert launches()[0] == before
    before = launches()[1]
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp.blurpool_cuda_bwd(torch.zeros(1, 2, 2, 2), 4, 4)
    assert launches()[1] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REAL_SHAPES + SHAPES)
def test_kernel_matches_reference(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = launches()[0]
    y = bp.blurpool_cuda(x)
    torch.cuda.synchronize()
    assert launches()[0] == before + 1
    assert y.dtype == dtype and y.shape == (shape[0], (shape[1] + 1) // 2,
                                            (shape[2] + 1) // 2, shape[3])
    ref = bp.blurpool_reference(x).float().cpu().numpy()
    atol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref)
    np.testing.assert_allclose(y.float().cpu().numpy(), ref, rtol=0, atol=atol)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(TypeError):
        bp.blurpool_cuda(torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        bp.blurpool_cuda(torch.zeros(1, 8, 8, 4, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="H, W >= 3"):
        bp.blurpool_cuda(torch.zeros(1, 2, 8, 4, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REAL_SHAPES + TRAIN_SHAPES + SHAPES)
def test_kernel_backward_matches_reference(cuda, shape, dtype):
    """K1-bwd, launched by the autograd backward of K1-fwd, against the plain
    backward (autograd of blurpool_reference) on the same cotangent."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(out_shape(shape), generator=gen, device=cuda).to(dtype)
    xk = x.clone().requires_grad_(True)
    before = launches()
    gx = torch.autograd.grad(bp.blurpool(xk), xk, g)[0]
    torch.cuda.synchronize()
    assert launches() == (
        before[0] + 1, before[1] + 1)
    assert gx.dtype == dtype and gx.shape == shape
    ref = reference_vjp(x, g).float()
    atol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.abs().max().item())
    err = (gx.float() - ref).abs().max().item()  # on the card: gx is large
    assert err <= atol, (err, atol)


def reflect(i: int, n: int) -> int:
    return -i if i < 0 else (2 * n - 2 - i if i >= n else i)


def quad_axis_matrix(length: int) -> np.ndarray:
    """K1-bwd's weights along one axis as a length × ceil(length/2) matrix M
    (gx = M @ g along that axis), built the way ``csrc/blurpool.cu`` builds
    them: quad m covers outputs 2m, 2m+1 and reads o = m-1..m+1; interior
    quads (1 <= m, 2m + 5 <= length) take the constant weights (a3, a1, 0) and
    (0, a2, a0); edge quads take ``axis_weights``' table from the definition
    (a_k added to output r where reflect(2o - 1 + k) = 2m + r)."""
    a = bp.TAPS
    lo = (length + 1) // 2
    mat = np.zeros((length, lo))
    for m in range(lo):
        table = np.zeros((2, 3))
        for d in range(3):
            o = m - 1 + d
            if 0 <= o < lo:
                for k in range(4):
                    i = reflect(2 * o - 1 + k, length)
                    for r in range(2):
                        table[r, d] += a[k] if i == 2 * m + r else 0.0
        if m >= 1 and 2 * m + 5 <= length:  # the kernel's interior branch
            interior = np.array([[a[3], a[1], 0.0], [0.0, a[2], a[0]]])
            np.testing.assert_array_equal(table, interior)
            table = interior
        for r in range(2):
            for d in range(3):
                o = m - 1 + d
                if not (0 <= o < lo and 2 * m + r < length):
                    assert table[r, d] == 0.0, (length, m, r, d)  # weight 0 off g / gx
                else:
                    mat[2 * m + r, o] += table[r, d]
    return mat


def reference_1d(x: torch.Tensor) -> torch.Tensor:
    """The plain version along one axis: reflect pad (1, 2), taps, stride 2."""
    a = torch.tensor(bp.TAPS, dtype=x.dtype)
    return F.conv1d(F.pad(x[None, None], (1, 2), mode="reflect"), a.view(1, 1, 4),
                    stride=2)[0, 0]


@pytest.mark.parametrize("length", range(3, 41))
def test_quad_weights_match_reference_vjp_1d(length):
    """The quad tap algebra of K1-bwd, interior and edges, equals the
    transpose of the 1-D plain version's Jacobian (autograd), exactly: every
    weight is a sum of eighths."""
    x = torch.zeros(length, dtype=torch.float64)
    jac = torch.autograd.functional.jacobian(reference_1d, x)  # ceil(L/2) × L
    np.testing.assert_array_equal(quad_axis_matrix(length), jac.numpy().T)


@pytest.mark.parametrize("shape", SHAPES)
def test_quad_weights_match_reference_vjp_2d(shape):
    """Composed along H and W per channel, the quad weights give the plain
    backward (autograd of blurpool_reference, which computes in f32) at every
    shape of the CPU set."""
    rng = np.random.default_rng(5)
    n, h, w, c = shape
    g = rng.standard_normal(out_shape(shape)).astype(np.float32)
    ref = reference_vjp(torch.zeros(shape), torch.from_numpy(g))
    ours = np.einsum("io,nopc,jp->nijc", quad_axis_matrix(h), g, quad_axis_matrix(w))
    np.testing.assert_allclose(ours, ref.numpy(), rtol=0, atol=1e-6)


# where K1-bwd's vector path meets the quad edges: an axis of length 3 (four
# taps on one g cell), odd H and W (half quads), the fewest quad rows H allows
# (H = 3 and 4: two quad rows, both edges), one frame, C = 24 (3 bf16 / 6 f32
# channel vectors a pixel) and C = 1032 bf16 (129 channel vectors: the loop
# over channel vectors)
EDGE_CASES = [((2, 3, 20, 8), torch.bfloat16), ((2, 20, 3, 8), torch.bfloat16),
              ((1, 3, 3, 8), torch.bfloat16), ((2, 3, 20, 4), torch.float32),
              ((2, 20, 3, 4), torch.float32), ((1, 3, 3, 4), torch.float32),
              ((1, 13, 17, 8), torch.bfloat16), ((1, 13, 17, 8), torch.float32),
              ((3, 4, 9, 8), torch.bfloat16), ((1, 3, 30, 8), torch.float32),
              ((2, 11, 10, 24), torch.bfloat16), ((2, 11, 10, 24), torch.float32),
              ((1, 9, 7, 1032), torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", EDGE_CASES)
def test_kernel_backward_quad_edges(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    g = torch.randn(out_shape(shape), generator=gen, device=cuda).to(dtype)
    before = launches()[1]
    gx = bp.blurpool_cuda_bwd(g, shape[1], shape[2])
    torch.cuda.synchronize()
    assert launches()[1] == before + 1
    assert gx.dtype == dtype and gx.shape == shape
    ref = reference_vjp(torch.zeros(shape, device=cuda, dtype=dtype), g).float()
    atol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.abs().max().item())
    err = (gx.float() - ref).abs().max().item()
    assert err <= atol, (err, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_unaligned(cuda, dtype):
    """Contiguous tensors that start 2 bytes past a 16-byte boundary take the
    scalar form, in the same quad layout."""
    shape = (2, 9, 12, 8)
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randn(int(np.prod(out_shape(shape))) + 1, generator=gen,
                       device=cuda).to(dtype)
    g = flat[1:].view(out_shape(shape))
    assert g.data_ptr() % 16 != 0
    gx = bp.blurpool_cuda_bwd(g, shape[1], shape[2])
    ref = reference_vjp(torch.zeros(shape, device=cuda, dtype=dtype), g).float()
    atol = 1e-5 if dtype == torch.float32 else bf16_ulp(ref.abs().max().item())
    assert (gx.float() - ref).abs().max().item() <= atol


@pytest.mark.cuda
def test_kernel_backward_rejects_bad_inputs(cuda):
    g = torch.zeros(1, 4, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="output shape"):
        bp.blurpool_cuda_bwd(g, 9, 8)
    with pytest.raises(ValueError, match="contiguous"):
        bp.blurpool_cuda_bwd(g.transpose(1, 2), 8, 8)
    with pytest.raises(TypeError):
        bp.blurpool_cuda_bwd(g.half(), 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dilation,padding_mode", [(1, "reflect"), (2, "reflect"),
                                                   (1, "zeros")])
def test_f32_conv_gradients_match_cpu(cuda, dilation, padding_mode):
    """f32 conv gradients on the card within 1e-5 relative of the CPU's.

    cuDNN runs f32 convs in TF32 by default. The port turns TF32 off for its
    f32 convs, and must do so for the backward too: autograd runs dgrad and
    wgrad after the forward's call has returned. TF32 keeps ~3 decimal
    digits, so a TF32 backward misses this bound by orders of magnitude.
    The test switches TF32 back on globally to show the port overrides it."""
    from dino_tracker_tpu_torch.models import nn as pnn
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 21, 30, 16)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((24, 16, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    gy = None
    grads = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev in ("cpu", cuda):
            xs, ws, bs = (t.to(dev).requires_grad_(True) for t in (x, wt, b))
            y = pnn.conv2d(xs, ws, bs, dilation=dilation, padding=2 * dilation,
                           padding_mode=padding_mode)
            if gy is None:
                gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
            grads[str(dev)] = [t.cpu().numpy() for t in torch.autograd.grad(
                y, (xs, ws, bs), gy.to(dev))]
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for ours, ref in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(ours, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
