"""Kernel K5 (DeltaDINO's BatchNorm and the ReLU after it, forward K5-fwd
and backward K5-bwd) of the port.

On the CPU: a torch mirror of the kernels' arithmetic (``csrc/batchnorm.cu``:
the normalisation from the statistics, the backward's two sums through the
ReLU's recomputed mask and the input gradient from them) against autograd
of the plain chain (``nn.batchnorm_plain`` and its ReLU) in bf16 and f32,
train and eval mode, with and without the ReLU; the two-shard composition a
mesh relies on; ``nn.batchnorm`` on CPU tensors taking the plain chain with
no launch; the wrapper's refusals. On the card (``cuda`` marker, skipped
without one): the kernels against the plain chain and a float64 reference
at the refiner's four layer shapes (N cut to 2 frames) and at C = 1,536,
eval mode, the scalar path and empty batches, a captured graph's replay
against eager launches bit for bit, the two-shard composition, two ranks
sharing the card (gloo) against one device, and a DeltaDINO train step
launching K5 once a layer a direction.

On the GPU machine: ``python -m pytest tests/test_torch_batchnorm_kernel.py
--noconftest -m cuda``.

K5 takes the batch's statistics from ``nn.batch_moments``, the plain chain's
own reductions, so its output equals the chain's bit for bit. The input
gradient is rounded as autograd of the chain rounds it: its direct term
(g′·w)·inv and its statistics' term −inv·w·(Σg′/n + x̂·Σg′x̂/n) each to x's
dtype, then their sum (the chain reads x through two casts to f32 and adds
their gradients in x's dtype). The cotangents (``inputs``) make the
statistics term as large as the direct one, so that a backward that drops,
flips or miscounts either sum misses every bound below by far. Tolerances:
an input gradient is held entry by entry against the summed magnitudes of
its three terms, m = |inv·w|·(|g′| + Σ|g′|/n + |x̂|·Σ|g′x̂|/n): K5, the
mirror and the plain chain within 2^-6·m of the float64 value in bf16
(three roundings of at most 2^-8 of a term each) and 2e-5·m in f32; in train
mode its sum over the rows, 0 in exact arithmetic, within as much of the
summed m. The mirror lies within 2^-7·m of the chain at the CPU shapes (a
unit of a term: its f32 sums, in another order than the chain's, move the
statistics term across a rounding's edge). On the card K5's input gradient
is the mirror's arithmetic from K5's own sums, bit for bit, and those sums,
the parameter gradients, f32 sums over every row, lie within 1e-5 of the
summed magnitudes of their terms. The float64 reference takes the ReLU's
mask from the chain's output: at real-valued inputs an output within a
rounding of zero lands on either side.
"""

import pytest
import torch

from dino_tracker_tpu_torch.models import delta_dino as dd
from dino_tracker_tpu_torch.models import nn as pnn
from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.ops import batchnorm as bn_ops
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from test_torch_threads import SPAWN_TIMEOUT, one_thread  # noqa: F401

EPS = 1e-5
DTYPES = [torch.bfloat16, torch.float32]
# C a multiple of 8 and not (12: f32 vectors only; 3)
CPU_SHAPES = [(2, 4, 8, 8), (1, 8, 16, 12), (4, 2, 4, 3)]
# the refiner's four BN inputs at 854×476 frames, N cut from 8 to 2, and the
# last layer at ViT-g's C = 1,536
LAYER_SHAPES = [(2, 476, 854, 64), (2, 238, 427, 128), (2, 119, 214, 256),
                (2, 60, 107, 1024), (2, 60, 107, 1536)]
CHAIN_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}
MATCH_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2e-5}
SUM_TOL = 1e-5


def relu_of(shape) -> bool:
    """Layers 0-2 (C <= 256) have a ReLU after their BN, the last does not."""
    return shape[-1] <= 256


def inputs(shape, seed, dtype, device="cpu", running=False):
    """(x, g, weight, bias[, running mean, running var]): x normal with a
    per-channel offset (a conv output's); a cotangent g with a per-channel
    offset and a per-channel multiple of x's normal part besides its own
    noise, so that the input gradient's statistics term inv·w·(Σg′/n +
    x̂·Σg′x̂/n) is of the size of its direct term (a zero-mean g drawn apart
    from x leaves both sums ~1/√n of it, and a backward that drops, flips or
    miscounts them within tolerance); weights of either sign with |w| in
    [0.5, 1.5), biases of about 0.3; with ``running``, eval mode's
    statistics."""
    c = shape[-1]
    gen = torch.Generator(device=device).manual_seed(seed)
    offset = torch.randn(c, generator=gen, device=device)
    z = torch.randn(shape, generator=gen, device=device)
    x = (z * 0.5 + offset).to(dtype)
    g_offset = torch.randn(c, generator=gen, device=device)
    g_slope = torch.randn(c, generator=gen, device=device)
    g = (g_offset + g_slope * z + torch.randn(shape, generator=gen, device=device)).to(dtype)
    sign = torch.where(torch.rand(c, generator=gen, device=device) < 0.25, -1.0, 1.0)
    weight = (torch.rand(c, generator=gen, device=device) + 0.5) * sign
    bias = torch.randn(c, generator=gen, device=device) * 0.3
    if not running:
        return x, g, weight, bias
    rmean = offset + torch.randn(c, generator=gen, device=device) * 0.1
    rvar = torch.rand(c, generator=gen, device=device) * 0.3 + 0.1
    return x, g, weight, bias, rmean, rvar


def make_bn(weight, bias, running=None):
    bn = pnn.BatchNorm(weight.shape[0]).to(weight.device)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        if running is not None:
            bn.running_mean.copy_(running[0])
            bn.running_var.copy_(running[1])
    return bn


def autograd_of(batchnorm, x, g, bn, train, relu, mesh=None):
    """(out, x's, weight's and bias's gradients, new statistics) by autograd
    of ``batchnorm`` (``nn.batchnorm`` or ``nn.batchnorm_plain``)."""
    x = x.detach().clone().requires_grad_(True)
    bn.weight.grad = bn.bias.grad = None
    out, stats = batchnorm(x, bn, train, mesh=mesh, relu=relu)
    out.backward(g)
    mesh_lib.all_reduce_grads(bn, mesh)
    return out.detach(), x.grad, bn.weight.grad.clone(), bn.bias.grad.clone(), stats


# --- a torch mirror of csrc/batchnorm.cu's arithmetic -------------------------------


def mirror_sums(x):
    """A shard's [Σx, Σx², n], as ``nn.batch_moments`` all-reduces them."""
    xf = x.float().reshape(-1, x.shape[-1])
    return torch.cat([xf.sum(0), (xf * xf).sum(0), xf.new_full((1,), xf.shape[0])])


def moments_of(sums):
    """mean and biased variance from [Σx, Σx², n], as ``nn.batch_moments``."""
    c = (sums.shape[0] - 1) // 2
    n = sums[2 * c]
    mean = sums[:c] / n
    return mean, torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)


def mirror_apply(x, weight, bias, relu, mean, var, acc=torch.float32):
    """K5-fwd: y and [mean, var, inv]; y rounded once to x's dtype (kept in
    ``acc`` when that is float64)."""
    mean, var = mean.to(acc), var.to(acc)
    inv = torch.rsqrt(var + EPS)
    y = (x.to(acc) - mean) * inv * weight.to(acc) + bias.to(acc)
    if acc == torch.float32:
        y = y.to(x.dtype)
    return (torch.relu(y) if relu else y), torch.cat([mean, var, inv])


def _xh_and_gp(g, x, stat, weight, bias, relu, acc, mask=None):
    """x̂ and g′: g where the forward's output passed the ReLU (``mask``, or
    its rounded output recomputed from x, above 0)."""
    c = x.shape[-1]
    xh = (x.to(acc) - stat[:c]) * stat[2 * c:]
    gp = g.to(acc)
    if relu:
        if mask is None:
            y = xh * weight.to(acc) + bias.to(acc)
            mask = (y.to(x.dtype) if acc == torch.float32 else y) > 0
        gp = torch.where(mask, gp, 0.0)
    return xh, gp


def mirror_grad_sums(g, x, stat, weight, bias, relu, acc=torch.float32, mask=None):
    """K5-bwd's sums: [Σg′, Σg′x̂, n]."""
    c = x.shape[-1]
    xh, gp = _xh_and_gp(g, x, stat, weight, bias, relu, acc, mask)
    gp, xh = gp.reshape(-1, c), xh.reshape(-1, c)
    return torch.cat([gp.sum(0), (gp * xh).sum(0), gp.new_full((1,), gp.shape[0])])


def mirror_grad_apply(g, x, stat, weight, bias, relu, sums, acc=torch.float32, mask=None):
    """K5-bwd's input gradient from the (all-reduced) sums, ``sums`` None in
    eval mode: the direct term and the statistics' term each rounded to x's
    dtype, then their sum (exact in ``acc`` when that is float64)."""
    c = x.shape[-1]
    xh, gp = _xh_and_gp(g, x, stat, weight, bias, relu, acc, mask)
    inv, w = stat[2 * c:], weight.to(acc)
    direct = gp * w * inv
    if sums is None:
        stats_term = torch.zeros_like(direct)
    else:
        n = sums[2 * c]
        stats_term = -(inv * w * (sums[:c] / n + xh * (sums[c:2 * c] / n)))
    if acc != torch.float32:
        return direct + stats_term
    return (direct.to(x.dtype).float() + stats_term.to(x.dtype).float()).to(x.dtype)


def reference64(x, g, weight, bias, relu, running=None, mask=None):
    """The float64 output, [mean, var, inv], input gradient, parameter
    gradients [Σg′, Σg′x̂] and the gradient's term magnitudes m; the ReLU's
    mask from ``mask`` where given."""
    c = x.shape[-1]
    acc = torch.float64
    if running is None:
        mean, var = moments_of(mirror_sums(x.double()))
    else:
        mean, var = running
    y, stat = mirror_apply(x, weight, bias, relu, mean, var, acc)
    gsums = mirror_grad_sums(g, x, stat, weight, bias, relu, acc, mask)
    gx = mirror_grad_apply(g, x, stat, weight, bias, relu,
                           None if running is not None else gsums, acc, mask)
    xh, gp = _xh_and_gp(g, x, stat, weight, bias, relu, acc, mask)
    n = gsums[2 * c]
    mags = (stat[2 * c:] * weight.to(acc)).abs() * (
        gp.abs() + gp.abs().reshape(-1, c).sum(0) / n
        + xh.abs() * (gp * xh).abs().reshape(-1, c).sum(0) / n)
    param_mags = torch.cat([gp.abs().reshape(-1, c).sum(0),
                            (gp * xh).abs().reshape(-1, c).sum(0)])
    return dict(y=y, stat=stat, gx=gx, gsums=gsums[:2 * c], mags=mags, param_mags=param_mags,
                train=running is None)


def assert_within(got, want, scale, tol, what):
    excess = ((got.double() - want.double()).abs() - tol * scale.double()).max().item()
    assert excess <= 0, (what, excess)


def assert_grads(gx, gw, gb, ref, dtype, what):
    """gx within CHAIN_TOL·m of the float64 value and, in train mode, its
    per-channel sum over the rows (0 in exact arithmetic) within CHAIN_TOL of
    the rows' summed m; the parameter gradients within SUM_TOL of their
    magnitudes."""
    c = gx.shape[-1]
    assert_within(gx, ref["gx"], ref["mags"], CHAIN_TOL[dtype], f"{what} gx")
    if ref["train"]:
        rows = gx.double().reshape(-1, c).sum(0)
        assert_within(rows, torch.zeros_like(rows), ref["mags"].reshape(-1, c).sum(0),
                      CHAIN_TOL[dtype], f"{what} gx summed over the rows")
    assert_within(gb, ref["gsums"][:c], ref["param_mags"][:c], SUM_TOL, f"{what} grad bias")
    assert_within(gw, ref["gsums"][c:], ref["param_mags"][c:], SUM_TOL, f"{what} grad weight")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_mirror_matches_autograd_of_the_plain_chain(shape, dtype, relu):
    """Train mode: from ``batch_moments``' statistics the mirror's output
    equals the plain chain's bit for bit (the same f32 steps); its input and
    parameter gradients and the chain's lie within tolerance of the float64
    ones, and its input gradient within 2^-7·m of the chain's (the same
    roundings)."""
    x, g, weight, bias = inputs(shape, 1, dtype)
    out, gx_c, gw_c, gb_c, stats = autograd_of(pnn.batchnorm_plain, x, g,
                                               make_bn(weight, bias), True, relu)
    ref = reference64(x, g, weight, bias, relu, mask=out > 0 if relu else None)
    mean, var, _ = pnn.batch_moments(x)
    y, stat = mirror_apply(x, weight, bias, relu, mean, var)
    assert torch.equal(y, out)
    gsums = mirror_grad_sums(g, x, stat, weight, bias, relu)
    gx = mirror_grad_apply(g, x, stat, weight, bias, relu, gsums)
    c = shape[-1]
    assert gx.dtype == dtype
    assert_grads(gx, gsums[c:2 * c], gsums[:c], ref, dtype, "mirror")
    assert_grads(gx_c, gw_c, gb_c, ref, dtype, "plain chain")
    assert_within(gx, gx_c, ref["mags"], MATCH_TOL[dtype], "mirror against the chain")
    torch.testing.assert_close(stats[0], 0.1 * mean)  # the running update, from 0


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mirror_in_eval_mode_matches_the_plain_chain(dtype, relu):
    """Eval mode (the inference cache): the running statistics normalise, the
    output equals the chain's bit for bit, and so does the input gradient
    (g′·w)·inv (the statistics are constants)."""
    x, g, weight, bias, rmean, rvar = inputs((2, 4, 8, 8), 2, dtype, running=True)
    out, gx_c, gw_c, gb_c, stats = autograd_of(pnn.batchnorm_plain, x, g,
                                               make_bn(weight, bias, (rmean, rvar)), False, relu)
    ref = reference64(x, g, weight, bias, relu, running=(rmean, rvar),
                      mask=out > 0 if relu else None)
    y, stat = mirror_apply(x, weight, bias, relu, rmean, rvar)
    assert torch.equal(y, out)
    assert torch.equal(stats[0], rmean) and torch.equal(stats[1], rvar)
    gsums = mirror_grad_sums(g, x, stat, weight, bias, relu)
    gx = mirror_grad_apply(g, x, stat, weight, bias, relu, None)
    assert_grads(gx, gsums[8:16], gsums[:8], ref, dtype, "mirror")
    assert_grads(gx_c, gw_c, gb_c, ref, dtype, "plain chain")
    assert torch.equal(gx, gx_c)  # one path, the same f32 steps


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_shards_compose_as_one_batch(dtype, relu):
    """The mesh's composition: two halves' [Σx, Σx², n], added, give the
    whole batch's statistics, and each half normalised with them is the whole
    batch's output there; the halves' backward sums, added, are the whole
    batch's (and so its parameter gradients), and each half's input gradient
    from them is the whole batch's."""
    shape = (4, 2, 4, 8)
    _, g, weight, bias = inputs(shape, 3, dtype)
    x = (torch.randint(-8, 9, shape) / 4).to(dtype)  # exact sums: any order, the same bits
    halves = [(x[:2], g[:2]), (x[2:], g[2:])]
    sums = mirror_sums(halves[0][0]) + mirror_sums(halves[1][0])
    assert torch.equal(sums, mirror_sums(x))
    mean, var = moments_of(sums)
    whole_y, stat = mirror_apply(x, weight, bias, relu, mean, var)
    ys = [mirror_apply(xs, weight, bias, relu, mean, var)[0] for xs, _ in halves]
    assert torch.equal(torch.cat(ys), whole_y)
    local = [mirror_grad_sums(gs, xs, stat, weight, bias, relu) for xs, gs in halves]
    total = local[0] + local[1]
    whole = mirror_grad_sums(g, x, stat, weight, bias, relu)
    ref = reference64(x, g, weight, bias, relu, mask=whole_y > 0 if relu else None)
    assert_within(total[:16], whole[:16], ref["param_mags"], SUM_TOL, "summed local sums")
    gx = torch.cat([mirror_grad_apply(gs, xs, stat, weight, bias, relu, total)
                    for xs, gs in halves])
    assert_grads(gx, total[8:16], total[:8], ref, dtype, "two shards")


@pytest.mark.parametrize("fault", ["drop", "flip", "shard_count"])
def test_the_bounds_catch_a_backward_that_mishandles_the_sums(fault):
    """A backward that drops the statistics term's Σg′/n, flips its sign, or
    divides the two shards' summed sums by one shard's rows (the mesh's n)
    misses the input gradient's bounds tenfold and more, entry by entry and
    in its sum over the rows; the sound arithmetic meets them."""
    shape, c, dtype = (2, 30, 54, 64), 64, torch.bfloat16
    x, g, weight, bias = inputs(shape, 5, dtype)
    mean, var, _ = pnn.batch_moments(x)
    y, stat = mirror_apply(x, weight, bias, True, mean, var)
    ref = reference64(x, g, weight, bias, True, mask=y > 0)
    sums = mirror_grad_sums(g, x, stat, weight, bias, True)
    bad = sums.clone()
    if fault == "drop":
        bad[:c] = 0
    elif fault == "flip":
        bad[:c] = -bad[:c]
    else:
        bad[2 * c] = x[:1].numel() // c

    def over(gx):
        """The largest error over its bound, entry by entry and summed over the rows."""
        entry = (gx.double() - ref["gx"]).abs() / (CHAIN_TOL[dtype] * ref["mags"])
        rows = gx.double().reshape(-1, c).sum(0).abs() / (
            CHAIN_TOL[dtype] * ref["mags"].reshape(-1, c).sum(0))
        return entry.max().item(), rows.max().item()

    assert max(over(mirror_grad_apply(g, x, stat, weight, bias, True, sums))) <= 1
    assert min(over(mirror_grad_apply(g, x, stat, weight, bias, True, bad))) > 10


def test_batch_moments_are_the_sums_formula():
    """With no mesh the statistics are the chain's means; the mesh's formula
    over one shard's sums gives the same numbers (to f32 rounding), and the
    unbiased variance takes n / (n − 1)."""
    x = inputs((2, 3, 5, 8), 4, torch.float32)[0]
    mean, var, unbiased = pnn.batch_moments(x)
    m2, v2 = moments_of(mirror_sums(x))
    torch.testing.assert_close(mean, m2)
    torch.testing.assert_close(var, v2)
    torch.testing.assert_close(unbiased, var * 30 / 29)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_cpu_tensors_take_the_plain_chain(monkeypatch, train, relu):
    """``nn.batchnorm`` on CPU tensors never reaches K5: it is the plain
    chain, and with ``relu`` the chain then ``torch.relu`` (what DeltaDINO
    ran after it before K5), bit for bit, gradients included."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached K5")

    monkeypatch.setattr(bn_ops, "batchnorm_cuda", refuse)
    x, g, weight, bias, rmean, rvar = inputs((2, 3, 5, 4), 4, torch.bfloat16, running=True)
    bn = make_bn(weight, bias, (rmean, rvar))
    got = autograd_of(pnn.batchnorm, x, g, bn, train, relu)

    def old_chain(x_, bn_, train_, mesh=None, relu=False):
        out, stats = pnn.batchnorm_plain(x_, bn_, train_)
        return (torch.relu(out) if relu else out), stats

    want = autograd_of(old_chain, x, g, bn, train, relu)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[4], want[4]))


def launches():
    """K5-fwd's and K5-bwd's counts (wrapper calls)."""
    counts = _guard.launch_counts()
    return counts["batchnorm_fwd"], counts["batchnorm_bwd"]


def test_delta_dino_on_the_cpu_launches_no_kernel(monkeypatch):
    """DeltaDINO's train and eval forward on the CPU take the plain chain at
    every layer (K5's wrapper would raise)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached K5")

    before = launches()
    monkeypatch.setattr(bn_ops, "batchnorm_cuda", refuse)
    model = dd.DeltaDINO((3, 8, 8, 8, 16))
    model.reset_parameters(torch.Generator().manual_seed(0))
    frames = torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    model.train()
    model(frames, (8, 12)).square().sum().backward()
    model.eval()
    with torch.no_grad():
        model(frames, (8, 12))
    assert launches() == before


def _wrapper_args(x):
    c = x.shape[-1]
    ones, zeros = torch.ones(c), torch.zeros(c)
    return x, ones, zeros, zeros.clone(), ones.clone()


def test_cuda_wrapper_rejects_cpu_tensors():
    """The wrapper never falls back: CPU tensors are refused, and a refused
    call is not counted."""
    x = torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16)
    before = launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        bn_ops.batchnorm_cuda(*_wrapper_args(x), True, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bn_ops.batchnorm_cuda_bwd(x, x, torch.zeros(24), torch.ones(8), torch.zeros(8),
                                  True, True)
    assert launches() == before


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_cuda_wrapper_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bn_ops.batchnorm_cuda(*_wrapper_args(torch.zeros(2, 3, 4, 8, dtype=dtype)), True, True)


def test_cuda_wrapper_rejects_other_layouts():
    """Non-contiguous NHWC (an NCHW tensor permuted to NHWC), other ranks,
    and per-channel parameters or statistics of another shape or dtype."""
    nchw = torch.zeros(2, 8, 3, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        bn_ops.batchnorm_cuda(*_wrapper_args(nchw.permute(0, 2, 3, 1)), True, True)
    with pytest.raises(ValueError, match="N×H×W×C"):
        bn_ops.batchnorm_cuda(*_wrapper_args(torch.zeros(6, 4, 8)), True, True)
    x, w, b, mean, var = _wrapper_args(torch.zeros(2, 3, 4, 8))
    with pytest.raises(ValueError, match="float32 of shape"):
        bn_ops.batchnorm_cuda(x, w[:4], b, mean, var, True, True)
    with pytest.raises(ValueError, match="float32 of shape"):
        bn_ops.batchnorm_cuda(x, w, b.bfloat16(), mean, var, True, True)
    with pytest.raises(ValueError, match="float32 of shape"):
        bn_ops.batchnorm_cuda(x, w, b, mean.double(), var, True, True)
    with pytest.raises(ValueError, match="cotangent"):
        bn_ops.batchnorm_cuda_bwd(x[:1], x, torch.zeros(24), w, b, True, True)


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K5 has no CPU mode)")
    yield torch.device("cuda")


def check_against_chain(x, g, weight, bias, relu, running=None):
    """K5 through ``nn.batchnorm`` (one launch a direction) against the
    plain chain on the same card and the float64 reference: the output and
    the new statistics bit for bit, the gradients within tolerance; the
    input gradient is the mirror's arithmetic from K5's own sums (its
    parameter gradients and the row count) bit for bit."""
    dtype = x.dtype
    before = launches()
    got = autograd_of(pnn.batchnorm, x, g, make_bn(weight, bias, running), running is None,
                      relu)
    torch.cuda.synchronize()
    assert launches() == (before[0] + 1, before[1] + 1)
    chain = autograd_of(pnn.batchnorm_plain, x, g, make_bn(weight, bias, running),
                        running is None, relu)
    assert torch.equal(got[0], chain[0])
    assert all(torch.equal(a, b) for a, b in zip(got[4], chain[4]))
    ref = reference64(x, g, weight, bias, relu, running=running,
                      mask=chain[0] > 0 if relu else None)
    assert_grads(*got[1:4], ref, dtype, f"K5 {tuple(x.shape)} {dtype}")
    assert_grads(*chain[1:4], ref, dtype, f"chain {tuple(x.shape)} {dtype}")
    if running is None:
        mean, var, _ = pnn.batch_moments(x)
        sums = torch.cat([got[3], got[2], got[3].new_full((1,), x.numel() // x.shape[-1])])
    else:
        (mean, var), sums = running, None
    stat = torch.cat([mean, var, torch.rsqrt(var + EPS)])
    assert torch.equal(got[1], mirror_grad_apply(g, x, stat, weight, bias, relu, sums))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [(s, torch.bfloat16) for s in LAYER_SHAPES]
                         + [(LAYER_SHAPES[0], torch.float32), (LAYER_SHAPES[4], torch.float32)])
def test_kernels_match_the_plain_chain(cuda, shape, dtype):
    check_against_chain(*inputs(shape, 10, dtype, cuda), relu_of(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
def test_eval_mode_matches_the_plain_chain(cuda, dtype, relu):
    x, g, weight, bias, rmean, rvar = inputs(LAYER_SHAPES[1], 11, dtype, cuda, running=True)
    check_against_chain(x, g, weight, bias, relu, running=(rmean, rvar))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", [
    ((3, 5, 7, 12), torch.bfloat16, 0),   # C not a multiple of 8: one channel a thread
    ((2, 3, 5, 6), torch.float32, 0),     # nor of 4
    ((2, 9, 11, 64), torch.bfloat16, 1),  # starts off 16 bytes
    ((1, 1, 2, 520), torch.bfloat16, 0),  # 65 vectors: one short row of threads
    ((2, 17, 3, 2064), torch.bfloat16, 0),  # 258 vectors: two channel chunks
])
def test_other_widths_and_alignments(cuda, shape, dtype, offset):
    """The scalar path and the channel chunks against the chain."""
    x, g, weight, bias = inputs(shape, 12, dtype, cuda)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        x = buf[offset:].view(shape).copy_(x)
    check_against_chain(x, g, weight, bias, True)


@pytest.mark.cuda
def test_empty_batch(cuda):
    """No rows (a mesh rank's share may be empty): an empty output and input
    gradient, backward sums of zero with a count of 0, and no launch."""
    x = torch.zeros(0, 5, 7, 64, dtype=torch.bfloat16, device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    stat = torch.cat([b, w, w])
    assert bn_ops.apply_cuda(x, w, b, b, w, True).shape == x.shape
    sums = bn_ops.grad_sums_cuda(x, x, stat, w, b, True)
    assert torch.count_nonzero(sums).item() == 0
    given = torch.cat([b, b, torch.ones(1, device=cuda)])
    assert bn_ops.grad_apply_cuda(x, x, stat, w, b, True, given).shape == x.shape


@pytest.mark.cuda
def test_graph_replay_matches_eager_bit_for_bit(cuda):
    """Both directions captured into one CUDA graph: each replay gives the
    eager launches' bits (the backward's sums are added in a fixed order),
    two eager runs agree, and a capture counts no launch."""
    shape = LAYER_SHAPES[0]
    x, g, weight, bias = inputs(shape, 13, torch.bfloat16, cuda)

    def both():
        mean, var, _ = pnn.batch_moments(x)
        y = bn_ops.batchnorm_cuda(x, weight, bias, mean, var, True, True)
        stat = torch.cat([mean, var, torch.rsqrt(var + EPS)])
        gx, gw, gb = bn_ops.batchnorm_cuda_bwd(g, x, stat, weight, bias, True, True)
        return y, gx, gw, gb

    with torch.no_grad():
        eager = both()
        again = both()
        assert all(torch.equal(a, b) for a, b in zip(eager, again))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            both()
        torch.cuda.current_stream().wait_stream(side)
        before = launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = both()
        assert launches() == before
        replays = []
        for _ in range(2):
            for t in captured:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            replays.append([t.clone() for t in captured])
    for replay in replays:
        assert all(torch.equal(a, b) for a, b in zip(replay, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
def test_two_shards_compose_on_the_card(cuda, relu):
    """The kernels on two halves of a batch, normalised with the whole
    batch's statistics: the outputs are the whole's; the halves' backward
    sums, added, are the whole's within f32 rounding, and each half's input
    gradient from them is the mirror's from the same sums bit for bit and
    within tolerance of the whole batch's."""
    shape = LAYER_SHAPES[2]
    x, g, weight, bias = inputs(shape, 14, torch.bfloat16, cuda)
    mean, var, _ = pnn.batch_moments(x)
    inv = torch.rsqrt(var + EPS)
    stat = torch.cat([mean, var, inv])
    halves = [(x[:1], g[:1]), (x[1:], g[1:])]
    whole_y = bn_ops.apply_cuda(x, weight, bias, mean, inv, relu)
    ys = [bn_ops.apply_cuda(xs, weight, bias, mean, inv, relu) for xs, _ in halves]
    assert torch.equal(torch.cat(ys), whole_y)
    local = [bn_ops.grad_sums_cuda(gs, xs, stat, weight, bias, relu) for xs, gs in halves]
    total = local[0] + local[1]
    ref = reference64(x, g, weight, bias, relu, mask=whole_y > 0 if relu else None)
    c = shape[-1]
    assert_within(total[:2 * c], bn_ops.grad_sums_cuda(g, x, stat, weight, bias, relu)[:2 * c],
                  ref["param_mags"], SUM_TOL, "summed local sums")
    gxs = [bn_ops.grad_apply_cuda(gs, xs, stat, weight, bias, relu, total) for xs, gs in halves]
    for gx_half, (xs, gs) in zip(gxs, halves):  # the count is the whole batch's
        assert torch.equal(gx_half, mirror_grad_apply(gs, xs, stat, weight, bias, relu, total))
    assert_grads(torch.cat(gxs), total[c:2 * c], total[:c], ref, torch.bfloat16, "two shards")


def _mesh_rank(mesh, data):
    """One rank of ``test_two_ranks_on_one_card``: its share of the batch
    through ``nn.batchnorm`` with the mesh, counting the all-reduces the
    BN makes (before the gradients' own)."""
    import torch.distributed as dist
    calls, real = [], dist.all_reduce

    def counting(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)

    x, g, weight, bias = (t.to(mesh.device) for t in data)
    share = lambda t: mesh_lib.split_rows(t, mesh)  # noqa: E731
    runs = {}
    for name, batchnorm in (("k5", pnn.batchnorm), ("plain", pnn.batchnorm_plain)):
        bn = make_bn(weight, bias)
        xs = share(x).clone().requires_grad_(True)
        calls.clear()
        dist.all_reduce = counting
        try:
            out, stats = batchnorm(xs, bn, True, mesh=mesh, relu=True)
            out.backward(share(g))
        finally:
            dist.all_reduce = real
        mesh_lib.all_reduce_grads(bn, mesh)
        runs[name] = dict(out=out.detach(), x_grad=xs.grad, stats=stats, calls=list(calls),
                          weight_grad=bn.weight.grad, bias_grad=bn.bias.grad)
    return runs


@pytest.mark.cuda
def test_two_ranks_on_one_card(cuda):
    """Two gloo ranks sharing the card, each with its share of the frames:
    K5 makes one all-reduce of 2C + 1 a direction, as the plain chain does;
    its outputs and new statistics are the chain's over the same ranks bit
    for bit, its input and summed parameter gradients within tolerance of
    the float64 reference of the whole batch, every rank's the same."""
    shape = (3, 119, 214, 256)
    data = inputs(shape, 15, torch.bfloat16, "cpu")
    results = mesh_lib.spawn(_mesh_rank, 2, "cuda", args=(data,), share_device=True,
                             timeout=SPAWN_TIMEOUT)
    x, g, weight, bias = (t.to(cuda) for t in data)
    c = shape[-1]
    for r in results:
        assert r["k5"]["calls"] == r["plain"]["calls"] == [2 * c + 1, 2 * c + 1]
        assert torch.equal(r["k5"]["out"], r["plain"]["out"])
        assert all(torch.equal(a, b) for a, b in zip(r["k5"]["stats"], r["plain"]["stats"]))
    out = torch.cat([r["k5"]["out"] for r in results]).to(cuda)
    ref64 = reference64(x, g, weight, bias, True, mask=out > 0)
    gx = torch.cat([r["k5"]["x_grad"] for r in results]).to(cuda)
    for r in results:
        k5 = r["k5"]
        assert_grads(gx, k5["weight_grad"].to(cuda), k5["bias_grad"].to(cuda), ref64,
                     torch.bfloat16, "two ranks")
        assert torch.equal(k5["weight_grad"], results[0]["k5"]["weight_grad"])
        assert all(torch.equal(a, b) for a, b in zip(k5["stats"], results[0]["k5"]["stats"]))


@pytest.mark.cuda
def test_delta_dino_train_step_launches_k5(cuda, monkeypatch):
    """A DeltaDINO train step on the card: one K5-fwd and one K5-bwd a layer;
    the residual as the plain chain gives it on the card, bit for bit, and the
    parameter gradients and running statistics within the chain's own spread
    between two runs (the card's f32 sums, its atomics among them, differ
    between runs) plus 1e-5 of their size."""
    model = dd.DeltaDINO((3, 64, 128, 256, 64))
    gen = torch.Generator().manual_seed(16)
    model.reset_parameters(gen)
    for layer in model.layers:  # the last conv drawn too: a residual that is not 0
        pnn.init_conv_(layer.conv, gen)
    frames = torch.rand(2, 3, 70, 112, generator=gen)
    probe = torch.randn(2, 64, 8, 15, generator=gen)
    outs = []
    for batchnorm in (pnn.batchnorm, pnn.batchnorm_plain, pnn.batchnorm_plain):
        monkeypatch.setattr(pnn, "batchnorm", batchnorm)
        m = dd.DeltaDINO((3, 64, 128, 256, 64)).to(cuda)
        m.load_state_dict(model.state_dict())
        m.train()
        before = launches()
        res = m(frames.to(cuda), (8, 15))
        (res * probe.to(cuda)).sum().backward()
        torch.cuda.synchronize()
        n = len(m.layers) if batchnorm is not pnn.batchnorm_plain else 0
        assert launches() == (before[0] + n, before[1] + n)
        outs.append([res.detach(), *[p.grad for p in m.parameters() if p.grad is not None],
                     *[b for name, b in m.named_buffers() if "running" in name]])
    assert torch.equal(outs[0][0], outs[1][0])
    for got, a, b in zip(*outs):
        spread = (a - b).norm().item()
        assert (got - a).norm().item() <= 4 * spread + 1e-5 * a.norm().item()


@pytest.mark.cuda
def test_bad_inputs_raise_on_the_card(cuda):
    x = torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16, device=cuda)
    w, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    before = launches()
    with pytest.raises(TypeError):
        bn_ops.batchnorm_cuda(x.half(), w, b, b, w, True, True)
    with pytest.raises(ValueError, match="contiguous"):
        bn_ops.batchnorm_cuda(x.permute(0, 2, 1, 3), w, b, b, w, True, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bn_ops.batchnorm_cuda(x, w.cpu(), b, b, w, True, True)
    with pytest.raises(ValueError, match="float32 of shape"):
        bn_ops.batchnorm_cuda(x, w[:4], b, b, w, True, True)
    with pytest.raises(ValueError, match="sums"):
        bn_ops.grad_apply_cuda(x, x, torch.zeros(24, device=cuda), w, b, True,
                               torch.zeros(16, device=cuda))
    assert launches() == before
