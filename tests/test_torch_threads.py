"""The port's CPU tests run torch at one intra-op thread.

The parity tests' torch work is tiny ops on tiny tensors: one thread runs
them about as fast as eight, and several test processes side by side at
torch's default (every core each) slow each other down many times over
(OpenMP oversubscription). ``one_thread`` is an autouse, module-scoped
fixture: every ``tests/test_torch_*.py`` module imports it by name, so it
runs before the module's other module-scoped fixtures and restores the
previous count after the module's last test. The CPU ranks that
``mesh.spawn`` starts share their parent's count
(``mesh.cpu_rank_threads``), so a test at one thread starts ranks at one
thread each. The spawned ranks import this module; it imports no JAX.
"""

import ast
import os

import pytest
import torch

from dino_tracker_tpu_torch.parallel import mesh as mesh_lib

TESTS = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's CPU work at one intra-op thread for the whole module, its
    module-scoped fixtures included."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imports_one_thread(tree) -> bool:
    return any(isinstance(node, ast.ImportFrom) and node.level == 0
               and node.module == "test_torch_threads"
               and any(a.name == "one_thread" and a.asname in (None, "one_thread")
                       for a in node.names)
               for node in tree.body)


def _rebinds_one_thread(tree) -> bool:
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == "one_thread":
            return True
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "one_thread" for t in node.targets):
            return True
    return False


def test_every_port_test_module_imports_the_one_thread_fixture():
    """An AST scan of every ``tests/test_torch_*.py``: each one imports
    ``one_thread`` from this module at its top level, under that name, and
    does not define another."""
    names = sorted(n for n in os.listdir(TESTS)
                   if n.startswith("test_torch_") and n.endswith(".py"))
    assert len(names) >= 30
    offenders = []
    for name in names:
        if name == "test_torch_threads.py":
            continue
        with open(os.path.join(TESTS, name)) as f:
            tree = ast.parse(f.read(), name)
        if not _imports_one_thread(tree) or _rebinds_one_thread(tree):
            offenders.append(name)
    assert offenders == []


def test_every_collected_port_test_requests_one_thread(request):
    """Every port test this session collected has ``one_thread`` in its
    fixture closure."""
    items = [i for i in request.session.items
             if os.path.basename(str(i.path)).startswith("test_torch_")]
    assert any(i.module.__name__ == __name__ for i in items)
    assert [i.nodeid for i in items if "one_thread" not in i.fixturenames] == []


@pytest.fixture(scope="module")
def threads_in_a_module_fixture():
    """A module-scoped fixture that does not name ``one_thread``."""
    return torch.get_num_threads()


def test_module_fixtures_run_under_one_thread(threads_in_a_module_fixture):
    """Autouse fixtures run first within their scope: a module's data
    fixtures compute at one thread, as its tests do."""
    assert threads_in_a_module_fixture == 1
    assert torch.get_num_threads() == 1


def _rank_threads(mesh):
    threads = torch.get_num_threads()
    # no rank leaves before every rank has connected: gloo's handshake fails
    # on a peer that already closed its group
    mesh_lib.barrier(mesh)
    return threads


@pytest.mark.parametrize("parent,want", [(1, 1), (4, 2)])
def test_cpu_ranks_share_their_parents_threads(parent, want):
    """Two gloo ranks spawned from a process at ``parent`` threads run at
    ``parent // 2`` each, at least one."""
    assert mesh_lib.cpu_rank_threads(2, parent) == want
    threads = torch.get_num_threads()
    torch.set_num_threads(parent)
    try:
        got = mesh_lib.spawn(_rank_threads, 2, "cpu", timeout=SPAWN_TIMEOUT)
    finally:
        torch.set_num_threads(threads)
    assert got == [want, want]
