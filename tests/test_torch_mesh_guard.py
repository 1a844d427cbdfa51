"""The device guard of the port's kernel launches (``ops/_guard.py``).

The libraries launch on the current CUDA device, so a tensor on ``cuda:1``
in a process whose current device is ``cuda:0`` broke at its first launch.
Every wrapper now launches inside ``_guard.on_device(t.device)``. On the
CPU no kernel can launch (``_check`` refuses CPU tensors), so these tests
check the helper against a fake ``torch.cuda`` and each of the five call
sites against a fake library: the library is called inside the guard, with
the guard's stream, and the guard gets the tensor's device. The ``cuda``
case launches each kernel on ``cuda:1`` where two cards exist.
"""

import contextlib

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.ops import blurpool as bp
from dino_tracker_tpu_torch.ops import flash_attention as fa
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
def fakes(monkeypatch):
    guard = FakeGuard()
    lib = FakeLibrary(guard)
    monkeypatch.setattr(_guard, "on_device", guard)
    for mod in (bp, fa, wg):
        monkeypatch.setattr(mod, "load_library", lambda: (lib, 0.0))
    monkeypatch.setattr(bp, "_check", lambda *a: None)
    monkeypatch.setattr(fa, "_check", lambda *a: None)
    monkeypatch.setattr(wg, "_check", lambda *a: None)
    counts = (bp.blurpool_cuda.launches, bp.blurpool_cuda_bwd.launches,
              fa.flash_attention_cuda.launches, wg.corr_lookup_cuda.launches)
    yield guard, lib
    (bp.blurpool_cuda.launches, bp.blurpool_cuda_bwd.launches,
     fa.flash_attention_cuda.launches, wg.corr_lookup_cuda.launches) = counts


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


@pytest.mark.parametrize("call", [_call_k1_fwd, _call_k1_bwd, _call_k2_bf16,
                                  _call_k2_f32, _call_k3],
                         ids=["k1_fwd", "k1_bwd", "k2_bf16", "k2_f32", "k3"])
def test_every_launch_runs_inside_the_guard_of_its_tensors_device(fakes, call):
    guard, lib = fakes
    name, device = call()
    assert lib.calls == [(name, True, STREAM)]
    assert guard.devices == [device]


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
