"""The harness's CPU tests: the harness and the program import from the
checkout's root, torch runs one intra-op thread."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
for path in (ROOT, PORTBENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one. On the GPU machine: "
        "`python -m pytest portbench/tests -m cuda`")
