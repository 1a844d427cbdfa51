"""Kernel K4 (the tracker head's conv1 + ReLU + conv2, forward K4-fwd and
backward K4-bwd) of the port.

On the CPU: the wrapper's refusals (CPU tensors, bf16, wrong channel counts,
non-contiguous maps), ``TrackerHead`` on CPU maps taking the plain chain with
no launch, and a numpy mirror of the kernels' tile arithmetic
(``csrc/tracker_head.cu``: the same tile, windows, gathers of v_o and u_o and
phase 2's running sums, read from the source's own tile constants) held in
float64 against autograd of the plain version, at edge shapes and at shapes
of several tiles. On the card (``cuda`` marker, skipped without one): both
kernels against the plain f32 chain (TF32 off) and a float64 reference at
the train step's map shapes and at edge shapes, an empty batch, a captured
graph's replay against the eager launches bit for bit, two replays alike,
and ``TrackerHead`` launching K4 once a direction.

On the GPU machine: ``python -m pytest tests/test_torch_tracker_head_kernel.py
--noconftest -m cuda``.

Tolerance, against a float64 reference on the same inputs (the kernel and
the plain f32 chain add the same products in other orders): every output
entry within 1e-5 of the summed magnitudes of the terms it adds (the plain
version on absolute values), which bounds f32 rounding over sums of up to
a few hundred terms in sequence, the depth of the kernels' and cuDNN's sums
over 2,048 maps of 67×121 pixels. So the logits, g_x and the weight and
conv1-bias gradients are held relative to their size, and g_b2, the
cotangent's sum, which is zero in exact math when every map's cotangent sums
to zero (a softmax's does) and whose sign is noise, absolutely against the
cotangent's summed magnitude.
"""

import os
import re

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.models import tracker_head as th
from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.ops import head_conv as hc
from test_torch_threads import one_thread  # noqa: F401

# the train step's maps: the flow term's batch and a cycle-loss direction,
# on the 67×121 feature grid of 854×476 frames
TRAIN_SHAPES = [(512, 67, 121), (2048, 67, 121)]
EDGE_SHAPES = [(1, 1, 1), (3, 1, 7), (2, 5, 3)]
# several tiles down and across, ragged at both ends
TILED_SHAPES = [(2, 9, 70), (1, 17, 130), (1, 67, 121)]
REL_TOL = 1e-5
HIDDEN = hc.HIDDEN
CU = os.path.join(os.path.dirname(hc.__file__), os.pardir, "csrc", "tracker_head.cu")


def kernel_tiles():
    """K4-fwd's and K4-bwd's tiles, (rows, columns), as the kernel source
    defines them."""
    with open(CU) as f:
        src = f.read()
    rows, cols = re.search(r"constexpr int kTH = (\d+), kTW = (\d+);", src).groups()
    fwd_rows = re.search(r"constexpr int kFwdTH = (\d+),", src).group(1)
    return (int(fwd_rows), int(cols)), (int(rows), int(cols))


def head_weights(seed, dtype=torch.float32, device="cpu"):
    """The head's normalised weights and biases from its training init."""
    head = th.TrackerHead()
    head.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ws = (th.normalized_weight(head.conv1), head.conv1.bias,
              th.normalized_weight(head.conv2), head.conv2.bias)
    return [w.detach().to(device=device, dtype=dtype).contiguous() for w in ws]


def maps_and_cotangent(shape, seed, dtype=torch.float32, device="cpu"):
    """Post-ReLU correlation-like maps and a cotangent that sums to zero on
    every map, as a softmax's does."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.rand(shape, generator=g, dtype=torch.float64) * 1.4 - 0.4)
    gy = torch.randn(shape, generator=g, dtype=torch.float64)
    gy = gy - gy.mean(dim=(1, 2), keepdim=True)
    return x.to(device, dtype), gy.to(device, dtype)


def dyadic_inputs(shape, seed, device="cpu"):
    """Maps on a 1/32 grid in [0, 1), about a third of them 0 as after a
    ReLU, and a cotangent on a 1/64 grid that sums to zero on every map, as
    a softmax's does (a map minus itself rolled by one pixel)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.clamp(torch.randint(-10, 32, shape, generator=g), min=0) / 32
    a = torch.randint(0, 16, shape, generator=g)
    gy = (a - a.flatten(1).roll(1, 1).reshape(shape)) / 64
    return x.to(device, torch.float32), gy.to(device, torch.float32)


def dyadic_weights(seed, device="cpu"):
    """Weights and biases on a 1/8 grid; each (out, in) kernel's taps sum to
    1, as a normalised kernel's do. With ``dyadic_inputs`` every
    pre-activation is exact in f32, so the kernel, the plain f32 chain and a
    float64 reference take the same ReLU branch at every hidden value (at
    real-valued inputs the sign of a pre-activation within a rounding of
    zero is noise, and one flipped branch moves g_x by a whole term)."""
    g = torch.Generator().manual_seed(seed)

    def kernels():
        k = torch.randint(-2, 3, (HIDDEN, 9), generator=g)
        k[:, 4] += 8 - k.sum(1)  # the centre tap brings the sum to 8 eighths
        return k / 8

    ws = (kernels().reshape(hc.W1_SHAPE), torch.randint(-4, 5, hc.B1_SHAPE, generator=g) / 8,
          kernels().reshape(hc.W2_SHAPE), torch.randint(-4, 5, hc.B2_SHAPE, generator=g) / 8)
    return [w.to(device, torch.float32) for w in ws]


def reference_grads(x, gy, ws):
    """Logits and (g_x, g_w1n, g_b1, g_w2n, g_b2) by autograd of the plain version."""
    x = x.detach().requires_grad_(True)
    ws = [w.detach().requires_grad_(True) for w in ws]
    y = hc.head_conv_reference(x, *ws)
    return (y.detach(), *torch.autograd.grad(y, [x, *ws], gy))


# --- a numpy mirror of csrc/tracker_head.cu's arithmetic ----------------------------


def _window(m, row0, col0, th_, tw_):
    """xs: map rows row0 - 2 .. row0 + th_ + 1, columns col0 - 2 .., 0 outside."""
    h, w = m.shape
    out = np.zeros((th_ + 4, tw_ + 4))
    r0, c0 = row0 - 2, col0 - 2
    rs, cs = max(r0, 0), max(c0, 0)
    re_, ce = min(r0 + th_ + 4, h), min(c0 + tw_ + 4, w)
    out[rs - r0:re_ - r0, cs - c0:ce - c0] = m[rs:re_, cs:ce]
    return out


def _region_mask(h, w, row0, col0, th_, tw_):
    r = np.arange(th_ + 2)[:, None] + row0 - 1
    c = np.arange(tw_ + 2)[None, :] + col0 - 1
    return (r >= 0) & (r < h) & (c >= 0) & (c < w)


def _taps(a, top, left, rows, cols, flip=False):
    """a[top + ky][left + kx] (flip: a[top + 2 - ky][left + 2 - kx]) over
    rows × cols, for the nine taps k = 3 ky + kx."""
    return np.stack([a[top + (2 - k // 3 if flip else k // 3):][:rows,
                       left + (2 - k % 3 if flip else k % 3):][:, :cols] for k in range(9)])


def _gather(v, rows, cols, flip=False):
    """sum_k v[k][r + ky][c + kx] (flip: v[k][r + 2 - ky][c + 2 - kx])."""
    return sum(v[k, (2 - k // 3 if flip else k // 3):][:rows,
                 (2 - k % 3 if flip else k % 3):][:, :cols] for k in range(9))


def mirror_fwd(x, w1, b1, w2, b2, tile):
    th_, tw_ = tile
    w1, w2 = w1.reshape(16, 9), w2.reshape(16, 9)
    b, h, w = x.shape
    y = np.zeros_like(x)
    for m in range(b):
        for row0 in range(0, h, th_):
            for col0 in range(0, w, tw_):
                xs = _window(x[m], row0, col0, th_, tw_)
                xn = _taps(xs, 0, 0, th_ + 2, tw_ + 2)
                hv = np.maximum(np.einsum("ck,kij->cij", w1, xn) + b1[:, None, None], 0)
                v = np.einsum("ck,cij->kij", w2, hv) * _region_mask(h, w, row0, col0, th_, tw_)
                out = _gather(v, th_, tw_) + b2[0]
                rr, cc = min(th_, h - row0), min(tw_, w - col0)
                y[m, row0:row0 + rr, col0:col0 + cc] = out[:rr, :cc]
    return y


def mirror_bwd(x, gy, w1, b1, w2, tile):
    th_, tw_ = tile
    w1, w2 = w1.reshape(16, 9), w2.reshape(16, 9)
    b, h, w = x.shape
    gx = np.zeros_like(x)
    gw1, gb1, gw2, gb2 = np.zeros((16, 9)), np.zeros(16), np.zeros((16, 9)), 0.0
    for m in range(b):
        for row0 in range(0, h, th_):
            for col0 in range(0, w, tw_):
                xs = _window(x[m], row0, col0, th_, tw_)
                gys = _window(gy[m], row0, col0, th_, tw_)
                inside = _region_mask(h, w, row0, col0, th_, tw_)
                # phase 1 over the region
                pre = np.einsum("ck,kij->cij", w1, _taps(xs, 0, 0, th_ + 2, tw_ + 2)) \
                    + b1[:, None, None]
                gh = np.einsum("ck,kij->cij", w2, _taps(gys, 0, 0, th_ + 2, tw_ + 2, flip=True))
                hv = np.maximum(pre, 0) * inside
                gp = np.where(pre > 0, gh, 0) * inside
                u = np.einsum("ck,cij->kij", w1, gp)
                out = _gather(u, th_, tw_, flip=True)
                rr, cc = min(th_, h - row0), min(tw_, w - col0)
                gx[m, row0:row0 + rr, col0:col0 + cc] = out[:rr, :cc]
                # phase 2 over the tile's own pixels
                hv_own, gp_own = hv[:, 1:1 + th_, 1:1 + tw_], gp[:, 1:1 + th_, 1:1 + tw_]
                gw1 += np.einsum("cij,kij->ck", gp_own, _taps(xs, 1, 1, th_, tw_))
                gb1 += gp_own.sum((1, 2))
                gw2 += np.einsum("cij,kij->ck", hv_own, _taps(gys, 1, 1, th_, tw_, flip=True))
                gb2 += gys[2:2 + th_, 2:2 + tw_].sum()
    return gx, gw1.reshape(16, 1, 3, 3), gb1, gw2.reshape(1, 16, 3, 3), np.array([gb2])


@pytest.mark.parametrize("shape", EDGE_SHAPES + TILED_SHAPES)
def test_mirror_of_the_kernels_matches_autograd(shape):
    """The kernels' arithmetic (tiles of the source's size, the 2-pixel
    windows, the v_o and u_o gathers, the column sums of phase 2) against the
    plain version and its autograd, all in float64."""
    x, gy = maps_and_cotangent(shape, 3, torch.float64)
    ws = head_weights(4, torch.float64)
    ref = reference_grads(x, gy, ws)
    fwd_tile, bwd_tile = kernel_tiles()
    npw = [w.numpy() for w in ws]
    got = (mirror_fwd(x.numpy(), *npw, fwd_tile),
           *mirror_bwd(x.numpy(), gy.numpy(), *npw[:3], bwd_tile))
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * max(1.0, np.abs(r).max()))


def launches():
    """K4-fwd's and K4-bwd's launch counts."""
    counts = _guard.launch_counts()
    return counts["head_conv_fwd"], counts["head_conv_bwd"]


def test_cuda_wrappers_reject_cpu_tensors():
    """The wrappers never fall back: CPU tensors are refused, and a refused
    call is not counted."""
    x, gy = maps_and_cotangent((2, 5, 6), 0)
    ws = head_weights(0)
    before = launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        hc.head_conv_cuda(x, *ws)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hc.head_conv_cuda_bwd(x, gy, *ws[:3])
    assert launches() == before


@pytest.mark.parametrize("which", ["maps", "w1", "b1", "w2", "b2"])
def test_cuda_wrapper_rejects_bf16(which):
    x, _ = maps_and_cotangent((2, 5, 6), 0)
    args = [x, *head_weights(0)]
    i = ["maps", "w1", "b1", "w2", "b2"].index(which)
    args[i] = args[i].bfloat16()
    with pytest.raises(TypeError, match="float32 only"):
        hc.head_conv_cuda(*args)


@pytest.mark.parametrize("which,shape", [
    ("w1", (8, 1, 3, 3)), ("w1", (16, 2, 3, 3)), ("b1", (8,)), ("w2", (2, 16, 3, 3)),
    ("w2", (1, 8, 3, 3)), ("w1", (16, 1, 5, 5)), ("b2", (2,))])
def test_cuda_wrapper_rejects_wrong_channel_counts(which, shape):
    x, _ = maps_and_cotangent((2, 5, 6), 0)
    args = [x, *head_weights(0)]
    args[["w1", "b1", "w2", "b2"].index(which) + 1] = torch.zeros(shape)
    with pytest.raises(ValueError, match="must have shape"):
        hc.head_conv_cuda(*args)


def test_cuda_wrapper_rejects_other_maps():
    ws = head_weights(0)
    with pytest.raises(ValueError, match="contiguous"):
        hc.head_conv_cuda(torch.zeros(2, 6, 5).transpose(1, 2), *ws)
    with pytest.raises(ValueError, match="B×H'×W'"):
        hc.head_conv_cuda(torch.zeros(2, 1, 5, 6), *ws)
    with pytest.raises(ValueError, match="H', W' >= 1"):
        hc.head_conv_cuda(torch.zeros(2, 0, 6), *ws)
    x, gy = maps_and_cotangent((2, 5, 6), 0)
    with pytest.raises(ValueError, match="must have shape"):
        hc.head_conv_cuda_bwd(x, gy[:1], *ws[:3])


def test_tracker_head_on_cpu_takes_the_plain_chain(monkeypatch):
    """CPU maps never reach the kernel wrapper; the head's output is the plain
    chain's, bit for bit."""
    def refuse(*args):
        raise AssertionError("a CPU map reached K4")

    head = th.TrackerHead()
    head.reset_parameters(torch.Generator().manual_seed(1))
    cost, _ = maps_and_cotangent((3, 9, 14), 1)
    cost = cost[:, None]
    want = head(cost, (70, 105))
    before = launches()
    monkeypatch.setattr(hc, "head_conv_cuda", refuse)
    got = head(cost, (70, 105))
    assert torch.equal(got, want)
    assert launches() == before
    # the chain: the normalised convs in NHWC, which the plain version matches
    x = torch.relu(th.normalized_conv2d(cost.permute(0, 2, 3, 1), head.conv1))
    logits = th.normalized_conv2d(x, head.conv2)[..., 0]
    torch.testing.assert_close(logits, hc.head_conv_reference(cost[:, 0], *head_weights(1)),
                               rtol=0, atol=1e-5)


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K4 has no CPU mode)")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain chain in f32, backward too
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def kernel_grads(x, gy, ws):
    y = hc.head_conv_cuda(x, *ws)
    return (y, *hc.head_conv_cuda_bwd(x, gy, *ws[:3]))


def magnitudes(x, gy, ws):
    """The plain version's outputs on |x|, |weights| and |g_y| in float64:
    for each output, the sum of the magnitudes of the terms it adds (every
    pre-activation is then positive, so no ReLU drops a term). For g_b2 it is
    the cotangent's summed magnitude."""
    return reference_grads(x.double().abs(), gy.double().abs(),
                           [w.double().abs() for w in ws])


def assert_close_to(got, ref64, mags, what):
    """Each output within REL_TOL of the summed magnitudes of its terms, entry
    by entry: relative to the size of the sum, and for g_b2 (zero in exact
    math here) an absolute tolerance against the cotangent's scale."""
    names = ("logits", "g_x", "g_w1n", "g_b1", "g_w2n", "g_b2")
    for name, g, r, m in zip(names, got, ref64, mags):
        assert g.shape == r.shape, (what, name)
        excess = ((g.double() - r).abs() - REL_TOL * m).max().item()
        assert excess <= 0, (what, name, excess)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_SHAPES + EDGE_SHAPES + TILED_SHAPES)
def test_kernels_match_reference(cuda, shape):
    x, gy = dyadic_inputs(shape, 5, device=cuda)
    ws = dyadic_weights(6, device=cuda)
    before = launches()
    got = kernel_grads(x, gy, ws)
    torch.cuda.synchronize()
    assert launches() == \
        (before[0] + 1, before[1] + 1)
    ref64 = reference_grads(x.double(), gy.double(), [w.double() for w in ws])
    mags = magnitudes(x, gy, ws)
    assert_close_to(got, ref64, mags, f"K4 {shape}")
    assert_close_to(reference_grads(x, gy, ws), ref64, mags, f"plain f32 chain {shape}")


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    ws = head_weights(0, device=cuda)
    x = torch.zeros(0, 67, 121, device=cuda)
    before = launches()
    y, gx, gw1, gb1, gw2, gb2 = kernel_grads(x, x.clone(), ws)
    assert y.shape == gx.shape == x.shape
    assert all(torch.count_nonzero(g).item() == 0 for g in (gw1, gb1, gw2, gb2))
    assert (gw1.shape, gb1.shape, gw2.shape, gb2.shape) == (
        hc.W1_SHAPE, hc.B1_SHAPE, hc.W2_SHAPE, hc.B2_SHAPE)
    assert launches() == before


@pytest.mark.cuda
def test_kernels_reject_bad_inputs_on_the_card(cuda):
    x, gy = maps_and_cotangent((2, 5, 6), 0, device=cuda)
    ws = head_weights(0, device=cuda)
    with pytest.raises(TypeError):
        hc.head_conv_cuda(x.bfloat16(), *ws)
    with pytest.raises(ValueError, match="contiguous"):
        hc.head_conv_cuda(x.transpose(1, 2), *ws)
    with pytest.raises(ValueError, match="must have shape"):
        hc.head_conv_cuda(x, ws[0][:8], *ws[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        hc.head_conv_cuda(x, ws[0].cpu(), *ws[1:])


@pytest.mark.cuda
def test_graph_replay_matches_eager_bit_for_bit(cuda):
    """Both kernels captured into one CUDA graph: each replay gives the eager
    launches' bits (the parameter gradients are added in a fixed order), and
    a capture counts no launch."""
    x, gy = dyadic_inputs(TRAIN_SHAPES[0], 7, device=cuda)
    ws = dyadic_weights(8, device=cuda)
    eager = kernel_grads(x, gy, ws)
    again = kernel_grads(x, gy, ws)
    assert all(torch.equal(a, b) for a, b in zip(eager, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel_grads(x, gy, ws)
    torch.cuda.current_stream().wait_stream(side)
    before = launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel_grads(x, gy, ws)
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
def test_tracker_head_on_the_card_launches_k4(cuda):
    """``TrackerHead`` on CUDA maps: one K4-fwd, and one K4-bwd in its
    backward; points and gradients as the plain chain gives them on the CPU
    (on dyadic maps and kernels, whose normalisation divides by 1, so both
    take the same ReLU branches; the rest differs by f32 rounding, 1e-4 of
    the largest magnitude)."""
    head = th.TrackerHead()
    with torch.no_grad():
        for conv, w, b in zip((head.conv1, head.conv2), *[iter(dyadic_weights(9))] * 2):
            conv.weight.copy_(w)
            conv.bias.copy_(b)
    cost, _ = dyadic_inputs((64, 67, 121), 9)
    cost = cost[:, None]
    outs = {}
    for dev in ("cpu", "cuda"):
        h = (head if dev == "cpu" else th.TrackerHead()).to(dev)
        if dev == "cuda":
            h.load_state_dict(head.state_dict())
        c = cost.to(dev).detach().clone().requires_grad_(True)
        before = launches()
        pts = h(c, (476, 854))
        pts.square().sum().backward()
        after = launches()
        assert after == (before if dev == "cpu" else (before[0] + 1, before[1] + 1))
        outs[dev] = [pts.detach().cpu(), c.grad.cpu(),
                     *[p.grad.cpu() for p in (h.conv1.weight, h.conv1.bias, h.conv2.weight)]]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * scale
