"""Weights carried across from the JAX package, and the port's import
boundary: dino_tracker_tpu_torch must import no JAX (and, at import time,
none of the optional file-format packages the GPU machine may lack)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from flax import serialization

from dino_tracker_tpu.config import TrainConfig
from dino_tracker_tpu.models import tracker as jtracker
from dino_tracker_tpu.training import checkpoint as jckpt
from dino_tracker_tpu.training import train as jtrain
from dino_tracker_tpu_torch import convert
from dino_tracker_tpu_torch.config import TrackerConfig
from dino_tracker_tpu_torch.models.tracker import Tracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (3, 4, 4, 4, 16)


def assert_trees_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def jax_state(seed=0):
    tcfg = jtracker.TrackerConfig(video_h=70, video_w=98, delta_channels=CHANNELS)
    return jtrain.init_train_state(jax.random.PRNGKey(seed), TrainConfig(), tcfg)


def test_state_round_trip_is_exact():
    state = jax_state()
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    sd = convert.state_from_jax(params, stats)
    model = Tracker(TrackerConfig(delta_channels=CHANNELS))
    model.load_state_dict(sd)  # strict: the key set is the module's own
    assert sd["delta_dino.layers.0.conv.weight"].shape == (4, 3, 5, 5)  # OIHW
    p2, s2 = convert.state_to_jax(model.state_dict())
    assert_trees_equal(p2, params)
    assert_trees_equal(s2, stats)
    sd2 = convert.state_from_jax(p2, s2)
    assert sd2.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd2[k].numpy(), sd[k].numpy(), err_msg=k)


@pytest.mark.parametrize("chunk_bytes", [None, 256])
def test_load_jax_checkpoint_matches_flax(tmp_path, monkeypatch, chunk_bytes):
    """A state written by the JAX trainer's save_state reads back equal to
    flax's own restore, including arrays flax splits into chunks."""
    if chunk_bytes is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
    path = jckpt.save_state(str(tmp_path), jax_state(1), 12)
    ours = convert.load_jax_checkpoint(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    assert_trees_equal(ours, ref)
    assert convert.checkpoint_path(str(tmp_path)) == path
    model = Tracker(TrackerConfig(delta_channels=CHANNELS))
    model.load_state_dict(convert.state_from_jax(ours["params"],
                                                 ours["batch_stats"]))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dino_tracker_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'yaml', 'PIL', 'msgpack')\n"
        "       if m in sys.modules]\n"
        "mods = ('runtime', 'cli.train', 'structures', 'training.train',\n"
        "        'training.losses', 'training.contrastive', 'training.cycle',\n"
        "        'training.sampler', 'training.checkpoint')\n"
        "print(sum(f'dino_tracker_tpu_torch.{m}' in sys.modules for m in mods),\n"
        "      bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["9", "[]"], out.stdout
