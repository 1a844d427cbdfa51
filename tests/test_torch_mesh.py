"""The port's mesh (``dino_tracker_tpu_torch/parallel/mesh.py``) on gloo
ranks on the CPU: uneven splits, the gather's and the all-reduce's values
and gradients, cross-rank BatchNorm against one-device BatchNorm, a failing
rank, the device checks, and ``pad_to_multiple`` against the JAX package's.

Each rank count runs once for the module: ``mesh.spawn`` starts W processes
(a FileStore in a temporary directory: no port), each returns its results,
and the tests compare them here against the one-device computation. Every
spawn carries its own timeout. The spawned ranks import this module, so it
imports JAX only inside a test.
"""

import time

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.cli import inference_benchmark, inference_grid
from dino_tracker_tpu_torch.cli import train as train_cli
from dino_tracker_tpu_torch.models import nn as pnn
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from test_torch_threads import one_thread  # noqa: F401

N_ROWS, C = 7, 3      # the gathered axis: uneven over 2 and 3 ranks
BN_SHAPE = (5, 4, 6, 3)  # N×H×W×C frames for BatchNorm, uneven too
SPAWN_TIMEOUT = 60


def inputs(w):
    rng = np.random.default_rng(w)
    return dict(
        x=torch.from_numpy(rng.standard_normal((N_ROWS, C)).astype(np.float32)),
        # each rank's loss weights the gathered rows its own way, so the
        # ranks' cotangents differ and their sum is what is checked
        weights=torch.from_numpy(rng.standard_normal((w, N_ROWS, C)).astype(np.float32)),
        bn_x=torch.from_numpy((rng.standard_normal(BN_SHAPE) * 2 + 0.5).astype(np.float32)),
        bn_g=torch.from_numpy(rng.standard_normal(BN_SHAPE).astype(np.float32)),
        bn_params=(torch.from_numpy((0.5 + rng.random(C)).astype(np.float32)),
                   torch.from_numpy(rng.standard_normal(C).astype(np.float32))))


def make_bn(params):
    bn = pnn.BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(params[0])
        bn.bias.copy_(params[1])
        bn.running_mean.fill_(0.25)
        bn.running_var.fill_(2.0)
    return bn


def run_bn(bn, x, g, mesh=None):
    x = x.clone().requires_grad_()
    out, stats = pnn.batchnorm(x, bn, train=True, mesh=mesh)
    (out * g).sum().backward()
    mesh_lib.all_reduce_grads(bn, mesh)
    return dict(out=out.detach(), x_grad=x.grad, stats=stats,
                weight_grad=bn.weight.grad, bias_grad=bn.bias.grad)


def _rank(mesh, data):
    torch.set_num_threads(1)
    x, weights = data["x"], data["weights"]
    local = mesh_lib.split_rows(x, mesh).clone().requires_grad_()
    gathered = mesh_lib.all_gather_rows(local * 2.0, mesh, N_ROWS)
    (gathered * weights[mesh.rank]).sum().backward()
    # the same axis as dim 1 of a transposed view
    local_t = mesh_lib.split_rows(x.T.contiguous(), mesh, dim=1).clone().requires_grad_()
    gathered_t = mesh_lib.all_gather_rows(local_t, mesh, N_ROWS, dim=1)
    (gathered_t * weights[mesh.rank].T).sum().backward()
    part = mesh_lib.split_rows(x, mesh).clone().requires_grad_()
    total = mesh_lib.all_reduce_sum(part.sum(0), mesh)
    (total * weights[mesh.rank][0]).sum().backward()
    bn = make_bn(data["bn_params"])
    bn_out = run_bn(bn, mesh_lib.split_rows(data["bn_x"], mesh),
                    mesh_lib.split_rows(data["bn_g"], mesh), mesh)
    return dict(rows=mesh_lib.row_range(N_ROWS, mesh), gathered=gathered.detach(),
                grad=local.grad, gathered_t=gathered_t.detach(), grad_t=local_t.grad,
                total=total.detach(), sum_grad=part.grad, bn=bn_out)


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    mesh_lib.barrier(mesh)


def _fail_on_rank_1_then_hang(mesh):
    """Rank 1 raises and never exits, as a rank does whose NCCL teardown
    waits for peers blocked in a collective it left; rank 0 waits."""
    if mesh.rank == 1:
        import torch.distributed as dist
        dist.destroy_process_group = lambda *a, **k: time.sleep(120)
        raise RuntimeError("rank 1 fails and hangs")
    time.sleep(120)


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request):
    w = request.param
    data = inputs(w)
    return w, data, mesh_lib.spawn(_rank, w, "cpu", args=(data,),
                                   timeout=SPAWN_TIMEOUT)


def test_split_sizes_are_tensor_splits():
    for n in range(0, 12):
        for w in range(1, 5):
            want = [len(c) for c in torch.tensor_split(torch.arange(n), w)]
            assert mesh_lib.split_sizes(n, w) == want
    assert mesh_lib.row_range(7, None) == (0, 7)
    assert mesh_lib.world_size(None) == 1 and mesh_lib.is_main(None)
    assert not mesh_lib.is_parallel(mesh_lib.Mesh(0, 1, torch.device("cpu")))


def test_gather_and_its_gradient(ranks):
    """Every rank gets the whole axis; a row's gradient is the sum over
    ranks of the gathered row's cotangents (here 2·Σ_r weights_r)."""
    w, data, results = ranks
    x, weights = data["x"], data["weights"]
    grad_sum = 2.0 * weights.sum(0)
    assert [r["rows"] for r in results] == [
        (int(c[0]), int(c[-1]) + 1) for c in torch.tensor_split(torch.arange(N_ROWS), w)]
    for r in results:
        start, stop = r["rows"]
        torch.testing.assert_close(r["gathered"], 2.0 * x, rtol=0, atol=0)
        torch.testing.assert_close(r["grad"], grad_sum[start:stop])
        torch.testing.assert_close(r["gathered_t"], x.T, rtol=0, atol=0)
        torch.testing.assert_close(r["grad_t"], weights.sum(0).T[:, start:stop])


def test_all_reduce_sum_and_its_gradient(ranks):
    w, data, results = ranks
    x, weights = data["x"], data["weights"]
    for r in results:
        start, stop = r["rows"]
        torch.testing.assert_close(r["total"], x.sum(0))
        torch.testing.assert_close(
            r["sum_grad"], weights[:, 0].sum(0).expand(stop - start, C))


def test_cross_rank_batchnorm_matches_one_device(ranks):
    """Train-mode BN over the ranks' shares of a batch: the output rows,
    the input's and the affine parameters' gradients, and the new running
    statistics (unbiased variance over the global count) equal the
    one-device BN of the whole batch."""
    w, data, results = ranks
    ref = run_bn(make_bn(data["bn_params"]), data["bn_x"], data["bn_g"])
    sizes = mesh_lib.split_sizes(BN_SHAPE[0], w)
    torch.testing.assert_close(torch.cat([r["bn"]["out"] for r in results]),
                               ref["out"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r["bn"]["x_grad"] for r in results]),
                               ref["x_grad"], rtol=1e-5, atol=1e-5)
    assert [r["bn"]["out"].shape[0] for r in results] == sizes
    for r in results:
        for got, want in zip(r["bn"]["stats"], ref["stats"]):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        for k in ("weight_grad", "bias_grad"):
            torch.testing.assert_close(r["bn"][k], ref[k], rtol=1e-5, atol=1e-5)
        # every rank stores the same statistics and gradients
        for k in ("weight_grad", "bias_grad"):
            assert torch.equal(r["bn"][k], results[0]["bn"][k])
        assert all(torch.equal(a, b) for a, b in zip(r["bn"]["stats"],
                                                       results[0]["bn"]["stats"]))


def test_a_failing_rank_fails_spawn():
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_lib.spawn(_fail_on_rank_1, 2, "cpu", timeout=SPAWN_TIMEOUT)


def test_a_timeout_names_the_ranks_that_failed_before_it():
    with pytest.raises(TimeoutError, match="(?s)1 failed before.*rank 1 fails and hangs"):
        mesh_lib.spawn(_fail_on_rank_1_then_hang, 2, "cpu", timeout=10)


class _HangWhenUnpickled:
    """An argument whose unpickling in a spawned rank sleeps: the rank hangs
    before it joins the group."""

    def __reduce__(self):
        return time.sleep, (120,)


def test_a_rank_that_never_joins_times_out_on_the_rendezvous(monkeypatch):
    """Ranks that hang before they join the group: ``spawn`` raises once its
    rendezvous limit has passed, whatever ``timeout`` the run has."""
    monkeypatch.setattr(mesh_lib, "JOIN_TIMEOUT_S", 3.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 ranks did not all join the group in 3.0 s"):
        mesh_lib.spawn(_fail_on_rank_1, 2, "cpu", args=(_HangWhenUnpickled(),),
                       timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT


def test_a_rank_that_fails_before_joining_fails_spawn_at_once(monkeypatch):
    """Ranks whose group cannot form (gloo given a network interface that
    does not exist) fail before they join: ``spawn`` raises at once with
    their tracebacks, without waiting out the rendezvous limit."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "no_such_interface0")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)ranks failed.*rank 0:.*init_process_group"):
        mesh_lib.spawn(_fail_on_rank_1, 2, "cpu", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT


def test_fewer_cards_than_ranks_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA device"):
        mesh_lib.check_devices(2, "cuda")
    mesh_lib.check_devices(2, "cuda", share_device=True)
    mesh_lib.check_devices(3, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="need 1 CUDA device"):
        mesh_lib.check_devices(2, "cuda", share_device=True)
    with pytest.raises(ValueError):
        mesh_lib.check_devices(2, "mps")


@pytest.mark.parametrize("cli", [train_cli, inference_grid, inference_benchmark],
                         ids=["train", "inference_grid", "inference_benchmark"])
def test_cli_devices_with_one_card_raises(cli, tmp_path, monkeypatch):
    """``--devices 2`` on a machine with one card raises before any rank
    starts: nothing drops to one rank or to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = ["--data-path", str(tmp_path), "--devices", "2"]
    if cli is inference_benchmark:
        args += ["--benchmark-pickle-path", str(tmp_path / "b.pkl")]
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA device"):
        cli.main(args)
    with pytest.raises(ValueError, match="puts rank r on cuda:r"):
        cli.main(args + ["--device", "cuda:1"])


def test_pad_to_multiple_matches_jax():
    from dino_tracker_tpu.parallel.mesh import pad_to_multiple as jpad
    rng = np.random.default_rng(0)
    for shape, multiple, axis in [((5, 3), 4, 0), ((8, 3), 4, 0), ((2, 7, 3), 3, 1),
                                  ((1,), 5, 0), ((4, 2), 1, 1)]:
        x = rng.standard_normal(shape).astype(np.float32)
        got = mesh_lib.pad_to_multiple(x, multiple, axis)
        np.testing.assert_array_equal(got, jpad(x, multiple, axis))
        assert got.shape[axis] % multiple == 0


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_split_batches_shares_whole_batches(w):
    """Every rank's batches are a contiguous range in rank order, together
    every batch once; the longer shares start at ``first``; rows are each
    rank's sum of its batches' rows."""
    batch_rows = [8, 8, 8, 8, 3]
    for first in range(w):
        ranges, rows = [], None
        for rank in range(w):
            mesh = mesh_lib.Mesh(rank, w, torch.device("cpu")) if w > 1 else None
            mine, rows = mesh_lib.split_batches(batch_rows, mesh, first=first)
            ranges.append(mine)
        assert [i for r in ranges for i in r] == list(range(len(batch_rows)))
        assert rows == [sum(batch_rows[i] for i in r) for r in ranges]
        counts = [len(r) for r in ranges]
        longer = [(first + k) % w for k in range(len(batch_rows) % w)]
        assert counts == [len(batch_rows) // w + (r in longer) for r in range(w)]
