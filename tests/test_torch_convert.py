"""Weights carried across from the JAX package, and the port's import
boundary: dino_tracker_tpu_torch must import no JAX (and, at import time,
none of the optional file-format packages the GPU machine may lack)."""

import ast
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
from test_torch_threads import one_thread  # noqa: F401

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


PORT_MODULES = ('runtime', 'cli.train', 'structures', 'training.train',
                'training.losses', 'training.contrastive', 'training.cycle',
                'training.sampler', 'training.checkpoint', 'config',
                'ops.attention', 'ops.flash_attention', 'models.vit',
                'models.vit_convert', 'preprocessing.fg_mask',
                'preprocessing.split_fg_bg', 'preprocessing.pipeline',
                'utils.video_io', 'utils.native_io', 'evaluation.tapvid',
                'models.raft', 'ops.window_gather', 'preprocessing.flow',
                'preprocessing.trajectories', 'utils.native_traj',
                'preprocessing.best_buddies', 'ops.nms', 'cli.preprocess',
                'parallel.launcher', 'cli.run_benchmark', 'cli.eval_benchmark',
                'evaluation.metrics', 'utils.profiling', 'visualization.viz',
                'cli.visualize', 'cli.mp4_to_frames', 'parallel.mesh',
                'cli._ranks', 'ops._guard')


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dino_tracker_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'yaml', 'PIL', 'msgpack', 'imageio',\n"
        "                   'dino_tracker_tpu') if m in sys.modules]\n"
        f"mods = {PORT_MODULES!r}\n"
        "print(sum(f'dino_tracker_tpu_torch.{m}' in sys.modules for m in mods),\n"
        "      bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(PORT_MODULES)), "[]"], out.stdout


def test_port_sources_import_nothing_of_the_jax_package():
    """An AST scan of every source of the port, of chip_smoke.py and of the
    numpy maker of its full-width inputs (scripts/full_width_inputs.py): no
    import of jax, flax or dino_tracker_tpu (lazy ones included)."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "full_width_inputs.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dino_tracker_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), node.lineno, n)
                          for n in names if n.split(".")[0] in
                          ("jax", "flax", "dino_tracker_tpu")]
    assert offenders == []


def test_port_entry_points_run_with_the_jax_package_blocked(tmp_path):
    """With ``dino_tracker_tpu`` (and jax) unimportable, the port reads the
    repo's train config, maps the path contract, loads a frame folder and
    chains trajectories (RAFT, flow engine, chaining and the native
    occupancy update imported) and runs the best-buddy sweep and its
    ambiguity pass (the preprocess CLI imported), and imports every module
    of ``PORT_MODULES``."""
    from PIL import Image
    frames = tmp_path / "vid" / "video"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (14, 20, 3), np.uint8)).save(
            frames / f"{i:05d}.png")
    code = (
        "import sys\n"
        "for m in ('dino_tracker_tpu', 'jax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "from dino_tracker_tpu_torch.config import TrainConfig, add_config_paths\n"
        "from dino_tracker_tpu_torch.runtime import DINOTrackerRuntime\n"
        "from dino_tracker_tpu_torch.utils import video_io\n"
        "cfg = TrainConfig.from_yaml('config/train.yaml')\n"
        "assert cfg.total_iterations == 10000 and cfg.cyc_thresh == 4, cfg\n"
        f"root = {str(tmp_path / 'vid')!r}\n"
        "paths = add_config_paths(root)\n"
        "rt = DINOTrackerRuntime(root, cfg, device='cpu')\n"
        "assert rt.paths == paths and rt.tcfg.delta_channels[-1] == 1024\n"
        "v = video_io.load_video(paths['video_folder'])\n"
        "r = video_io.load_video(paths['video_folder'], resize=(7, 10))\n"
        "print(v.shape, r.shape, video_io.get_original_video_res("
        "paths['video_folder']))\n"
        "import numpy as np, torch\n"
        "from dino_tracker_tpu_torch.models import raft\n"
        "from dino_tracker_tpu_torch.preprocessing import flow, trajectories\n"
        "fwd = torch.zeros(2, 2, 6, 7)\n"
        "print(trajectories.extract_trajectories(fwd, fwd).shape)\n"
        "from dino_tracker_tpu_torch.cli import preprocess\n"
        "from dino_tracker_tpu_torch.preprocessing import best_buddies\n"
        "feats = torch.eye(35)[:, :16].T.reshape(1, 16, 5, 7).repeat(2, 1, 1, 1)\n"
        "bb = best_buddies.extract_best_buddies(feats, 42, 56)\n"
        "bb = best_buddies.compute_bb_ambiguity(bb, feats, 42, 56)\n"
        "print(int(bb.valid.sum()), bb.capacity)\n"
        "import importlib\n"
        f"mods = {PORT_MODULES!r}\n"
        "print(len([importlib.import_module(f'dino_tracker_tpu_torch.{m}') for m in mods]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:4] == ["(2, 3, 14, 20) (2, 3, 7, 10) (14, 20, 2)",
                                          "(42, 3, 2)", "32 35", str(len(PORT_MODULES))]


def test_mesh_test_modules_import_with_the_jax_package_blocked():
    """A spawned rank imports the test module that holds its function: every
    multi-rank test module imports with ``dino_tracker_tpu`` and jax
    unimportable, so no rank can load JAX (their JAX lives in fixtures)."""
    mods = sorted(n[:-3] for n in os.listdir(os.path.join(REPO, "tests"))
                  if n.startswith("test_torch_mesh") and n.endswith(".py"))
    assert "test_torch_mesh_preprocess" in mods and len(mods) >= 5
    code = (
        "import importlib, sys\n"
        "for m in ('dino_tracker_tpu', 'jax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        f"print(len([importlib.import_module(m) for m in {mods!r}]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(mods))]
