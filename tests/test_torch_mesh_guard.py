"""The seam of the port's kernel launches (``ops/_guard.py``, ``ops/_build.py``).

The libraries launch on the current CUDA device, so a tensor on ``cuda:1``
in a process whose current device is ``cuda:0`` broke at its first launch.
Every wrapper launches through ``_guard.launch``, inside
``_guard.on_device(t.device)``. On the CPU no kernel can launch (the
wrappers' checks refuse CPU tensors), so these tests check the helper
against a fake ``torch.cuda`` and each of the nine launch sites against a
fake library: the library is called inside the guard, with the guard's
stream, the guard gets the tensor's device, and the launch is counted under
its kernel's name. They also pin the list of counted kernels, the launch's
error check and each module's signature table. The ``cuda`` case launches
each kernel on ``cuda:1`` where two cards exist.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.ops import _build, _guard
from dino_tracker_tpu_torch.ops import batchnorm as bn
from dino_tracker_tpu_torch.ops import blurpool as bp
from dino_tracker_tpu_torch.ops import flash_attention as fa
from dino_tracker_tpu_torch.ops import head_conv as hc
from dino_tracker_tpu_torch.ops import window_gather as wg
from test_torch_threads import one_thread  # noqa: F401

STREAM = 0x5EED


def test_on_device_makes_the_device_current_and_yields_its_stream(monkeypatch):
    events = []

    @contextlib.contextmanager
    def fake_device(device):
        events.append(("enter", device))
        yield
        events.append(("exit", device))

    class Stream:
        cuda_stream = STREAM

    def fake_current_stream(device):
        events.append(("stream", device))
        return Stream()

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_current_stream)
    dev = torch.device("cuda", 1)
    with _guard.on_device(dev) as stream:
        events.append(("launch", stream))
    assert events == [("enter", dev), ("stream", dev), ("launch", STREAM),
                      ("exit", dev)]


class FakeLibrary:
    """Each entry point records whether it ran inside the guard and with
    the guard's stream, and returns success."""

    def __init__(self, guard):
        self.guard, self.calls = guard, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, self.guard.inside, args[-1]))
            return 0
        return entry


class FakeGuard:
    def __init__(self):
        self.inside, self.devices = False, []

    @contextlib.contextmanager
    def __call__(self, device):
        self.devices.append(device)
        self.inside = True
        try:
            yield STREAM
        finally:
            self.inside = False


@pytest.fixture
def counts():
    """The process's launch counts, restored after the test."""
    before = _guard.launch_counts()
    yield
    _guard._counts.update(before)


@pytest.fixture
def fakes(monkeypatch, counts):
    guard = FakeGuard()
    lib = FakeLibrary(guard)
    monkeypatch.setattr(_guard, "on_device", guard)
    for mod in (bp, fa, wg, hc, bn):
        monkeypatch.setattr(mod, "load_library", lambda: (lib, 0.0))
    for mod, check in ((bp, "_check"), (fa, "_check"), (wg, "_check"), (hc, "_check_inputs"),
                       (bn, "_check_inputs")):
        monkeypatch.setattr(mod, check, lambda *a, **k: None)
    monkeypatch.setattr(hc, "_blocks", lambda lib, device: (4, 4))
    monkeypatch.setattr(bn, "_sm_count", lambda device: 132)
    yield guard, lib


def _call_k1_fwd():
    x = torch.zeros(1, 6, 6, 8)
    bp._launch(x)
    return "blurpool_down_nhwc", x.device


def _call_k1_bwd():
    g = torch.zeros(1, 3, 3, 8)
    bp.blurpool_cuda_bwd(g, 6, 6)
    return "blurpool_up_nhwc", g.device


def _call_k2_bf16():
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    fa._launch_bf16(q, q, q, 0.125)
    return "flash_attention_fwd_bf16", q.device


def _call_k2_f32():
    q = torch.zeros(1, 2, 16, 64)
    fa._launch_f32(q, q, q, 0.125)
    return "flash_attention_fwd_f32", q.device


def _call_k3():
    coords = torch.zeros(1, 2, 3, 4)
    pyramid = [torch.zeros(12, 8 >> i, 8 >> i) for i in range(4)]
    wg.corr_lookup_cuda(pyramid, coords)
    return "corr_lookup_fwd", coords.device


def _call_k4_fwd():
    x = torch.zeros(2, 5, 6)
    hc._launch(x, *(torch.zeros(s) for s in (hc.W1_SHAPE, hc.B1_SHAPE, hc.W2_SHAPE,
                                               hc.B2_SHAPE)))
    return "head_conv_fwd", x.device


def _call_k4_bwd():
    x = torch.zeros(2, 5, 6)
    hc.head_conv_cuda_bwd(x, x, *(torch.zeros(s) for s in (hc.W1_SHAPE, hc.B1_SHAPE,
                                                            hc.W2_SHAPE)))
    return "head_conv_bwd", x.device


def _bn_args():
    x, c = torch.zeros(2, 3, 4, 8), torch.zeros(8)
    return x, torch.zeros(24), c, c


def _call_k5_fwd():
    x, _, w, b = _bn_args()
    bn.apply_cuda(x, w, b, w, w, True)
    return "bn_fwd", x.device


def _call_k5_sums():
    x, stat, w, b = _bn_args()
    bn.grad_sums_cuda(x, x, stat, w, b, True)
    return "bn_bwd_sums", x.device


def _call_k5_apply():
    x, stat, w, b = _bn_args()
    bn.grad_apply_cuda(x, x, stat, w, b, True, None)
    return "bn_bwd_apply", x.device


# each launch site, its module and the kernel its launch is counted under
# (K5's launches are not: its wrappers count their calls)
LAUNCHES = {"k1_fwd": (_call_k1_fwd, bp, "blurpool_down_nhwc"),
            "k1_bwd": (_call_k1_bwd, bp, "blurpool_up_nhwc"),
            "k2_bf16": (_call_k2_bf16, fa, "flash_attention"),
            "k2_f32": (_call_k2_f32, fa, "flash_attention"),
            "k3": (_call_k3, wg, "corr_lookup"), "k4_fwd": (_call_k4_fwd, hc, "head_conv_fwd"),
            "k4_bwd": (_call_k4_bwd, hc, "head_conv_bwd"), "k5_fwd": (_call_k5_fwd, bn, None),
            "k5_sums": (_call_k5_sums, bn, None), "k5_apply": (_call_k5_apply, bn, None)}


@pytest.mark.parametrize("site", LAUNCHES)
def test_every_launch_runs_inside_the_guard_of_its_tensors_device(fakes, site):
    """One call of the library's entry, inside the guard of the tensor's
    device with its stream last, counted once under the kernel of the
    module that launched it and nowhere else."""
    guard, lib = fakes
    call, mod, kernel = LAUNCHES[site]
    before = _guard.launch_counts()
    name, device = call()
    assert [c for c in lib.calls if c[0] != "bn_sum_blocks"] == [(name, True, STREAM)]
    assert guard.devices == [device]
    counted = {k: n - before[k] for k, n in _guard.launch_counts().items() if n != before[k]}
    assert counted == ({kernel: 1} if kernel else {})
    if kernel:
        assert mod.__name__ == f"dino_tracker_tpu_torch.ops.{_guard.KERNELS[kernel]}"


def test_the_registry_lists_the_eight_counted_kernels():
    """The kernels whose launches every rank reports, in this order, each
    with the ops module that launches it."""
    assert list(_guard.KERNELS.items()) == [
        ("blurpool_down_nhwc", "blurpool"), ("blurpool_up_nhwc", "blurpool"),
        ("flash_attention", "flash_attention"), ("corr_lookup", "window_gather"),
        ("head_conv_fwd", "head_conv"), ("head_conv_bwd", "head_conv"),
        ("batchnorm_fwd", "batchnorm"), ("batchnorm_bwd", "batchnorm")]
    assert list(_guard.launch_counts()) == list(_guard.KERNELS)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_k5_counts_a_wrapper_call_not_its_launches(fakes, direction):
    """One ``batchnorm_fwd`` an application of ``batchnorm_cuda`` (one
    launch) and one ``batchnorm_bwd`` a ``batchnorm_cuda_bwd`` call (two)."""
    guard, lib = fakes
    x, stat, w, b = _bn_args()
    before = _guard.launch_counts()
    if direction == "fwd":
        bn.batchnorm_cuda(x, w, b, w, w + 1, True, True)
    else:
        bn.batchnorm_cuda_bwd(x, x, stat, w, b, True, True)
    launched = [c[0] for c in lib.calls if c[0] != "bn_sum_blocks"]
    assert launched == (["bn_fwd"] if direction == "fwd" else ["bn_bwd_sums", "bn_bwd_apply"])
    counted = {k: n - before[k] for k, n in _guard.launch_counts().items() if n != before[k]}
    assert counted == {f"batchnorm_{direction}": 1}


@pytest.mark.parametrize("err", [0, 2, 719])
def test_launch_checks_the_cuda_error_and_counts_only_a_launch(monkeypatch, counts, err):
    """A non-zero code raises naming the entry and counts nothing; 0 counts
    one launch of the named kernel; a launch naming no kernel counts none."""
    guard = FakeGuard()
    monkeypatch.setattr(_guard, "on_device", guard)
    calls = []

    def entry(*args):
        calls.append((args, guard.inside))
        return err

    lib = types.SimpleNamespace(k3_entry=entry)
    dev = torch.device("cuda", 1)
    for kernel in ("corr_lookup", None):
        before = _guard.launch_counts()
        if err:
            with pytest.raises(RuntimeError, match=f"^k3_entry launch failed: CUDA error {err}$"):
                _guard.launch(lib, "k3_entry", dev, 7, 8, kernel=kernel)
        else:
            _guard.launch(lib, "k3_entry", dev, 7, 8, kernel=kernel)
        after = _guard.launch_counts()
        want = dict(before, corr_lookup=before["corr_lookup"] + 1) if kernel and not err \
            else before
        assert after == want
    assert calls == [((7, 8, STREAM), True)] * 2 and guard.devices == [dev] * 2
    _guard.reset_counts()
    assert set(_guard.launch_counts().values()) == {0}
    with pytest.raises(KeyError):  # an unlisted kernel cannot be counted
        _guard.count("not_a_kernel")


P, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# each library's entries as the modules bound them one by one before the tables
OLD_BINDINGS = {
    bp: {"blurpool_down_nhwc": (I32, [P, P, I64, I64, I64, I64, I32, P]),
         "blurpool_up_nhwc": (I32, [P, P, I64, I64, I64, I64, I32, P])},
    fa: {"flash_attention_fwd_bf16": (I32, [P, P, P, P, I64, I64, I64, I64, ctypes.POINTER(I64),
                                            ctypes.POINTER(I64), F32, P]),
         "flash_attention_fwd_f32": (I32, [P, P, P, P, I64, I64, I64, F32, P])},
    wg: {"corr_lookup_fwd": (I32, [P] * 4 + [I32] * 8 + [P, P, I64, I32, I32, P])},
    hc: {"head_conv_fwd": (I32, [P, P, P, P, P, P, I64, I64, I64, I64, P]),
         "head_conv_bwd": (I32, [P, P, P, P, P, P, P, P, I64, I64, I64, I64, P]),
         "head_conv_max_blocks": (I32, [ctypes.POINTER(I32)] * 2)},
    bn: {"bn_sum_blocks": (I64, [I64, I64, I32, I32]),
         "bn_fwd": (I32, [P, P, I32, I32, I64, I64, I32, P, P, P, P, I32, P]),
         "bn_bwd_sums": (I32, [P, P, I32, I32, I64, I64, I32, P, P, P, I32, P, P, F32, P]),
         "bn_bwd_apply": (I32, [P, P, P, I32, I32, I64, I64, I32, P, P, P, I32, P, P])}}


@pytest.mark.parametrize("mod", OLD_BINDINGS, ids=lambda m: m.LIBRARY)
def test_signature_tables_bind_what_the_libraries_export(monkeypatch, mod):
    """``_build.load`` binds each entry of the module's table onto the
    library once a process; the types are those each entry takes."""
    entries = {name: types.SimpleNamespace() for name in OLD_BINDINGS[mod]}
    built = []
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda name: (built.append(name) or f"lib{name}.so", 1.5))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path, **entries))
    lib, seconds = mod.load_library()
    assert (lib.path, seconds) == (f"lib{mod.LIBRARY}.so", 1.5)
    assert mod.load_library() == (lib, 0.0) and built == [mod.LIBRARY]
    assert set(mod.SIGNATURES) == set(OLD_BINDINGS[mod])
    for name, (restype, argtypes) in OLD_BINDINGS[mod].items():
        fn = getattr(lib, name)
        assert fn.restype is restype and list(fn.argtypes) == argtypes, name


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_kernels_launch_on_the_second_card_from_the_first(two_cards):
    """K1-fwd, K1-bwd, K2 and K3 on ``cuda:1`` tensors while ``cuda:0`` is
    current, each against its plain version on the same card."""
    from dino_tracker_tpu_torch.ops import attention
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 40, 54, 64, device=dev, generator=gen).requires_grad_()
    y = bp.blurpool_cuda(x)
    g = torch.randn(y.shape, device=dev, generator=gen)
    (gx,) = torch.autograd.grad(y, x, g)
    xr = x.detach().clone().requires_grad_()
    yr = bp.blurpool_reference(xr)
    (gxr,) = torch.autograd.grad(yr, xr, g)
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gx, gxr, rtol=1e-5, atol=1e-5)
    q, k, v = (torch.randn(1, 4, 300, 64, device=dev, generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    out = fa.flash_attention_cuda(q, k, v, 0.125).float()
    ref = attention.attention_reference(q.float(), k.float(), v.float(), 0.125)
    assert float((out - ref).abs().max()) <= 2.0 ** -6 * float(ref.abs().max())
    b, h, w = 2, 6, 8
    pyramid = [torch.randn(b * h * w, max(h >> i, 1), max(w >> i, 1), device=dev,
                           generator=gen) for i in range(4)]
    coords = torch.rand(b, 2, h, w, device=dev, generator=gen) * 8
    torch.testing.assert_close(wg.corr_lookup_cuda(pyramid, coords),
                               wg.corr_lookup_reference(pyramid, coords),
                               rtol=1e-5, atol=1e-5)
    assert torch.cuda.current_device() == 0
    assert np.isfinite(out.cpu().numpy()).all()
