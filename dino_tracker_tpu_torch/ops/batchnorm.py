"""DeltaDINO's BatchNorm and the ReLU after it (K5), over N×H×W×C
activations (NHWC, contiguous, bf16 or f32), train and eval mode, forward
(K5-fwd) and backward (K5-bwd).

``batchnorm_cuda`` launches the hand-written Hopper kernels in
``csrc/batchnorm.cu``. K5-fwd normalises x with the statistics it is given
and applies the ReLU in one pass; its autograd backward launches K5-bwd, two
passes: the per-channel sums [Σg′, Σg′·x̂] (g′ the cotangent through the
ReLU's mask, recomputed from x), then the input gradient. It saves only the
input activation and [mean, var, inv], no f32 copy of anything. They replace
no TPU kernel (XLA fuses the JAX package's BatchNorm): PyTorch's eager chain
moved ~70 bytes an element forward and over 100 backward. The ``.cu`` file's
note says what bounds them and what their design does about that.

The batch's mean and variance come from the caller (``models/nn.py
batch_moments``), computed by the plain chain's own reductions, and ``inv =
rsqrt(var + eps)`` by its own op here, so the output ``(x − mean)·inv·w + b``
(in that order, rounded once to x's dtype, then the ReLU) has the chain's
bits. The backward's input gradient is the sum of the chain's two autograd
paths, ``(g′·w)·inv`` and ``−inv·w·(Σg′/n + x̂·Σg′x̂/n)``, each rounded to
x's dtype and their sum rounded again, as autograd of the chain rounds them
(it reads x through two casts to f32 and adds their gradients in x's dtype).
Only the order of the backward's f32 sums differs from the chain: its
blocks write partials that a second kernel adds in block order (no atomics),
so the same inputs give the same bits, eager or replayed from a CUDA graph.

With a process ``group`` (a mesh of several ranks, each holding its share of
the rows) the statistics given are the whole batch's, and the backward makes
one all-reduce of a copy of [Σg′, Σg′x̂, n] for the input gradient, as the
plain chain's differentiable all-reduce does. The parameter gradients stay
this rank's own sums: the caller sums them over ranks
(``mesh.all_reduce_grads``). Nothing syncs with the host, scratch comes from
``torch.empty`` and every launch goes to the current stream, so a train step
with K5 can be captured into a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from . import _build, _guard

DTYPES = (torch.bfloat16, torch.float32)
VEC_BYTES = 16  # a thread's channel vector: one 16-byte load
LIBRARY = "batchnorm"  # csrc/batchnorm.cu
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# each launch: its tensors and sizes as the wrappers below pass them, then the stream
SIGNATURES = {
    "bn_sum_blocks": (_I64, (_I64, _I64, _I32, _I32)),
    "bn_fwd": (_I32, (_P, _P, _I32, _I32, _I64, _I64, _I32, _P, _P, _P, _P, _I32, _P)),
    "bn_bwd_sums": (_I32, (_P, _P, _I32, _I32, _I64, _I64, _I32, _P, _P, _P, _I32, _P, _P,
                           ctypes.c_float, _P)),
    "bn_bwd_apply": (_I32, (_P, _P, _P, _I32, _I32, _I64, _I64, _I32, _P, _P, _P, _I32, _P,
                            _P))}
_sms = {}  # device index -> SMs


def load_library():
    return _build.load(LIBRARY, SIGNATURES)


def _check_inputs(what: str, x: torch.Tensor, *params: torch.Tensor, g=None, stat=None):
    """Raise on anything the kernels do not take: x (and the cotangent g)
    N×H×W×C, contiguous, bf16 or f32; the per-channel parameters C f32 and
    ``stat`` 3C f32, contiguous; all on one CUDA device."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} takes bfloat16 or float32 activations, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what} takes N×H×W×C activations, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c < 1:
        raise ValueError(f"{what} needs C >= 1, got shape {tuple(x.shape)}")
    if g is not None and (g.dtype != x.dtype or g.shape != x.shape):
        raise ValueError(f"{what}: the cotangent must be {x.dtype} of shape {tuple(x.shape)}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    named = [(x, "activation", None), (g, "cotangent", None), (stat, "stat", (3 * c,))]
    named += [(t, "per-channel parameter", (c,)) for t in params]
    named = [(t, name, shape) for t, name, shape in named if t is not None]
    for t, name, shape in named:
        if shape is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"{what}: the {name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs a contiguous {name} (NHWC for the activations)")
    for t, name, _ in named:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the {name} needs a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{what}: the {name} is on {t.device}, the activation on "
                             f"{x.device}")


def _check_sums(sums: torch.Tensor, x: torch.Tensor):
    """[two sums of C, the count]: 2C + 1 f32 on x's device, contiguous."""
    want = (2 * x.shape[-1] + 1,)
    if sums.dtype != torch.float32 or tuple(sums.shape) != want or not sums.is_contiguous():
        raise ValueError(f"batchnorm sums must be contiguous float32 of shape {want}, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    if sums.device != x.device:
        raise ValueError(f"batchnorm sums are on {sums.device}, the activation on {x.device}")


def _vec(*tensors: torch.Tensor) -> int:
    """Elements a thread loads at once: a 16-byte vector where C divides into
    them and every tensor starts on 16 bytes, else 1."""
    x = tensors[0]
    vec = VEC_BYTES // x.element_size()
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in tensors)
    return vec if aligned and x.shape[-1] % vec == 0 else 1


def _sm_count(device: torch.device) -> int:
    index = device.index  # a CUDA tensor's device always has one
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _geometry(x: torch.Tensor):
    """(rows, C, bf16 flag, SMs) of x."""
    c = x.shape[-1]
    return x.numel() // c, c, int(x.dtype == torch.bfloat16), _sm_count(x.device)


def apply_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
               inv: torch.Tensor, relu: bool) -> torch.Tensor:
    """K5-fwd: ``(x − mean)·inv·w + b`` in x's dtype and shape, the ReLU
    applied where ``relu``."""
    _check_inputs("batchnorm apply", x, weight, bias, mean, inv)
    y = torch.empty_like(x)
    vec = _vec(x, y)
    rows, c, bf16, sms = _geometry(x)
    lib, _ = load_library()
    _guard.launch(lib, "bn_fwd", x.device, x.data_ptr(), y.data_ptr(), bf16, vec, rows, c, sms,
                  mean.data_ptr(), inv.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  int(relu))
    return y


def grad_sums_cuda(g: torch.Tensor, x: torch.Tensor, stat: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """K5-bwd's sums: [Σg′ (C), Σg′·x̂ (C), rows] f32, g′ the cotangent where
    the forward's rounded output passed the ReLU (all of it without one)."""
    _check_inputs("batchnorm grad sums", x, weight, bias, g=g, stat=stat)
    vec = _vec(x, g)
    rows, c, bf16, sms = _geometry(x)
    lib, _ = load_library()
    blocks = lib.bn_sum_blocks(rows, c, vec, sms) if rows else 0
    partials = torch.empty(blocks * 2 * c, dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    _guard.launch(lib, "bn_bwd_sums", x.device, g.data_ptr(), x.data_ptr(), bf16, vec, rows, c,
                  sms, stat.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(relu),
                  partials.data_ptr(), sums.data_ptr(), float(rows))
    return sums


def grad_apply_cuda(g: torch.Tensor, x: torch.Tensor, stat: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, relu: bool, sums: torch.Tensor | None) -> torch.Tensor:
    """K5-bwd's input gradient (x's dtype) from the (all-reduced) [Σg′, Σg′x̂,
    n] of train mode, or with ``sums`` None in eval mode (the statistics
    constants: (g′·w)·inv)."""
    _check_inputs("batchnorm grad apply", x, weight, bias, g=g, stat=stat)
    if sums is not None:
        _check_sums(sums, x)
    gx = torch.empty_like(x)
    vec = _vec(x, g, gx)
    rows, c, bf16, sms = _geometry(x)
    lib, _ = load_library()
    _guard.launch(lib, "bn_bwd_apply", x.device, g.data_ptr(), x.data_ptr(), gx.data_ptr(), bf16,
                  vec, rows, c, sms, stat.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  int(relu), None if sums is None else sums.data_ptr())
    return gx


def batchnorm_cuda_bwd(g: torch.Tensor, x: torch.Tensor, stat: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor, train: bool, relu: bool,
                       group=None, need_input_grad: bool = True):
    """Launch K5-bwd: from the output's cotangent ``g``, the forward's input
    ``x`` and its [mean, var, inv] ``stat`` (3C f32), the input gradient
    (None unless ``need_input_grad``), and this rank's gradients of the
    weight (Σg′x̂) and the bias (Σg′). With a ``group``, the input gradient
    takes a copy of the sums all-reduced over it, the parameter gradients
    this rank's own."""
    sums = grad_sums_cuda(g, x, stat, weight, bias, relu)
    c = x.shape[-1]
    gx = None
    if need_input_grad:
        total = sums
        if train and group is not None:
            total = sums.clone()
            dist.all_reduce(total, group=group)
        gx = grad_apply_cuda(g, x, stat, weight, bias, relu, total if train else None)
    _guard.count("batchnorm_bwd")  # a wrapper call, not its three launches
    return gx, sums[c:2 * c], sums[:c]


class _BatchNorm(torch.autograd.Function):
    """K5-fwd with K5-bwd as its VJP; saves x and [mean, var, inv] only."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, train, relu, eps, group):
        stat = torch.stack([mean, var, torch.rsqrt(var + eps)])  # inv: the chain's own op
        y = apply_cuda(x, weight, bias, stat[0], stat[2], relu)
        _guard.count("batchnorm_fwd")
        ctx.save_for_backward(x, stat.view(-1), weight, bias)
        ctx.conf = (train, relu, group)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, stat, weight, bias = ctx.saved_tensors
        train, relu, group = ctx.conf
        gx, gw, gb = batchnorm_cuda_bwd(gy.contiguous(), x, stat, weight, bias, train, relu,
                                        group, need_input_grad=ctx.needs_input_grad[0])
        return (gx, gw if ctx.needs_input_grad[1] else None,
                gb if ctx.needs_input_grad[2] else None, None, None, None, None, None, None)


def batchnorm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, train: bool, relu: bool,
                   eps: float = 1e-5, group=None) -> torch.Tensor:
    """Launch K5-fwd on contiguous NHWC bf16 or f32 CUDA activations with
    the f32 affine weight and bias and the f32 ``mean`` and biased ``var``
    to normalise with: in train mode the batch's (over every rank of
    ``group``), which the backward differentiates through, in eval mode the
    running ones, constants. Returns y in x's dtype, ReLU applied where
    ``relu``. Its autograd backward launches K5-bwd."""
    _check_inputs("batchnorm_cuda", x, weight, bias, mean, var)
    return _BatchNorm.apply(x, weight, bias, mean, var, train, relu, eps, group)
