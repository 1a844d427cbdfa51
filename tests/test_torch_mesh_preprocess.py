"""The port's multi-device preprocessing on W gloo ranks on the CPU, held
against the port on one device and against the JAX package's
``make_mesh(2)`` paths.

Each rank runs its share of the one-device path's batches, each whole (ViT
frame batches, RAFT encoder and decode batches, best-buddy pair batches,
closest-grid frames, ambiguity slabs), so every call it makes is one the
one-device path makes. Held against one device (every process on one
thread): the ViT features of two layers, the flow engine's encodings,
adjacent flows and the direct flows of two starts within 1e-5 of max, the
cycle masks equal; both chaining passes, every best-buddy coordinate,
cosine and valid set in the three cap modes with and without the flow
filter, and the artifacts of ``run()`` (trajectories, f16 features, mask
jpgs, fg/bg banks, best buddies, their telemetry) equal element for
element; r within 1e-5. Every decode a rank runs has ``pair_batch`` pairs.
Only rank 0 writes: each rank preprocesses its own copy of the frame
folder, and only rank 0's gains files. On the masks-exist path only rank
0's copy holds masks, so a rank that looked for itself would sweep other
ViT layers than rank 0 and the collectives would hang (the spawn's timeout).

Against the JAX package on ``make_mesh(2)`` of the CPU devices
``tests/conftest.py`` forces: features, encodings and flows within 1e-5 of
max, cycle masks equal; the two packages' flows still differ by ~1e-6 px,
so the chained trajectories are held as ``test_torch_trajectories.py``
holds them (counts and NaN pattern equal: every threshold decision the
same; positions within 1e-4 px, 7.6e-6 here); best buddies of the same
f32 features equal, their cosines within 1e-5 of max (the bound of
``test_torch_best_buddies.py``: the packages' products round an ulp
apart), r within 1e-6. The ranks import this module, so JAX appears only in
the parent's fixtures; no JAX object reaches a rank.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.cli import preprocess as preprocess_cli
from dino_tracker_tpu_torch.config import PreprocessConfig, add_config_paths
from dino_tracker_tpu_torch.models import raft as praft
from dino_tracker_tpu_torch.models import vit as pvit
from dino_tracker_tpu_torch.models import vit_convert
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from dino_tracker_tpu_torch.preprocessing import best_buddies as bb_lib
from dino_tracker_tpu_torch.preprocessing import trajectories as ptraj
from dino_tracker_tpu_torch.preprocessing.flow import RaftFlowEngine
from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
from dino_tracker_tpu_torch.structures import BBData, load_bb_data
from dino_tracker_tpu_torch.utils import video_io
from test_torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
SPAWN_TIMEOUT = 300
T, H, W = 5, 42, 56
ITERS, THRESH, DIRECT_THRESH = 2, 0.5, 0.25
STARTS = (0, T - 2)
SETTINGS = dict(video_resh=H, video_resw=W, raft_iters=ITERS, threshold=THRESH,
                direct_flow_threshold=DIRECT_THRESH, dino_layer=1, mask_dino_layer=2,
                compute_dtype="float32", extract_frames_per_batch=2)
# run(): masks made by rank 0 with the direct filter; masks on disk (rank
# 0's copy only) with the filter off
MODES = {"fresh": dict(), "masks": dict(filter_using_direct_flow=False)}
# best-buddy scene: 6 frames of a 9×13 token grid (n = 117) at 70×98
BB_T, BB_H, BB_W = 6, 70, 98
CAPS = (None, 117, 32)  # adaptive, explicit >= n, fixed < n
AMB = dict(box_size=5.0, topk=8, rows_per_slab=16)
TOL = 1e-5  # features, flows, encodings and r; of the reference's max
ARTIFACTS = ("trajectories_file", "unfiltered_trajectories_file", "fg_trajectories_file",
             "bg_trajectories_file", "dino_embed_video_path", "mask_dino_embed_video_path")


def rank_root(base, w, mode, rank):
    return os.path.join(base, f"w{w}", mode, f"rank{rank}")


def run_pipelines(mesh, payload, vit, raft):
    """run() in both modes on this rank's copy of the frame folder."""
    rank, w = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    out = {}
    for mode, extra in MODES.items():
        pipe = PreprocessingPipeline(rank_root(payload["base"], w, mode, rank),
                                     PreprocessConfig(**SETTINGS, **extra), vit=vit,
                                     device=CPU, raft=raft, mesh=mesh)
        pipe.run()
        out[mode] = dict(timings=pipe.timings, telemetry=pipe.telemetry)
    return out


def run_all(mesh, payload):
    """Every sharded function on this rank (``mesh`` None: one device)."""
    vit = vit_convert.build_vit(payload["vit_state"], payload["vit_cfg"], CPU)
    raft = praft.load_raft_state_dict(payload["raft_state"], CPU)
    frames = torch.from_numpy(payload["frames"])
    out = dict(features=pvit.extract_feature_video(vit, frames, stride=7, layer=[1, 2],
                                                   frames_per_batch=3, mesh=mesh))

    sizes = []  # the pairs of every raft_decode call of this rank
    decode = praft.raft_decode

    def recording(model, fmap1, *args, **kw):
        sizes.append(fmap1.shape[0])
        return decode(model, fmap1, *args, **kw)

    praft.raft_decode = recording
    try:
        eng = RaftFlowEngine(raft, frames, num_iters=ITERS, device=CPU, mesh=mesh)
        out["encodings"] = eng.encodings()
        out["adjacent"] = eng.adjacent_flows()
        out["direct"] = {s: eng.direct_flows(s, THRESH) for s in STARTS}
        out["dual"] = ptraj.extract_trajectories_dual(
            *out["adjacent"], direct_flow_fn=lambda s: eng.direct_flows(s, THRESH),
            threshold=THRESH, min_trajectory_length=2, direct_flow_threshold=DIRECT_THRESH)
    finally:
        praft.raft_decode = decode
    out["decodes"] = dict(sizes=sizes, counter=dict(eng.decode_batch_sizes))

    feats = torch.from_numpy(payload["bb_feats"])
    out["sweep"] = {}
    for cap in CAPS:
        for filtered in (False, True):
            tel = {}
            bb = bb_lib.extract_best_buddies(
                feats, BB_H, BB_W, 7, cap=cap, telemetry=tel, mesh=mesh,
                unfiltered_trajectories=payload["bb_trajs"] if filtered else None)
            out["sweep"][cap, filtered] = (bb, tel)
    tel = {}
    out["ambiguity"] = (bb_lib.compute_bb_ambiguity(out["sweep"][32, False][0], feats, BB_H,
                                                    BB_W, 7, telemetry=tel, mesh=mesh,
                                                    **AMB), tel)
    out["runs"] = run_pipelines(mesh, payload, vit, raft)
    return out


def rank_main(mesh, payload):
    torch.set_num_threads(1)
    return run_all(mesh, payload)


def write_video_dirs(base, frames, masks):
    """A copy of the frame folder for every rank of every world and mode;
    in the masks-exist mode rank 0's copy alone holds the masks."""
    from test_torch_trajectories import write_frames
    for w in (1, 2, 3):
        for mode in MODES:
            for rank in range(w):
                root = rank_root(base, w, mode, rank)
                write_frames(os.path.join(root, "video"), frames)
                if mode == "masks" and rank == 0:
                    video_io.save_video_frames(masks, os.path.join(root, "masks"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(payload for the ranks: numpy and port objects only; the JAX
    package's RAFT and ViT parameters)."""
    import jax
    from dino_tracker_tpu.models import raft as jraft
    from test_torch_best_buddies import scene, trajectories
    from test_torch_trajectories import video
    from test_torch_vit import SMALL, models
    params = jax.tree.map(np.asarray, jraft.init_raft(jax.random.PRNGKey(5)))
    vit_params, _ = models(SMALL, seed=21)
    frames = video(2, T, H, W)
    base = str(tmp_path_factory.mktemp("mesh_preprocess"))
    masks = (np.random.default_rng(22).random((T, H, W)) < 0.5).astype(np.uint8) * 255
    write_video_dirs(base, frames, masks)
    payload = dict(frames=frames, raft_state=praft.raft_state_from_jax(params),
                   vit_state=vit_convert.vit_state_from_jax(vit_params), vit_cfg=SMALL,
                   bb_feats=scene(BB_T, 16, 9, 13, 0.3, seed=5),
                   bb_trajs=trajectories(60, BB_T, BB_H, BB_W, seed=6), base=base)
    return payload, params, vit_params


@pytest.fixture(scope="module")
def one_device(inputs):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' thread count
    try:
        return run_all(None, inputs[0])
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(inputs):
    """Each rank's results at W = 2 and W = 3 (both worlds at once)."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {w: pool.submit(mesh_lib.spawn, rank_main, w, "cpu", args=(inputs[0],),
                               timeout=SPAWN_TIMEOUT) for w in (2, 3)}
        return {w: job.result() for w, job in jobs.items()}


@pytest.fixture(scope="module")
def jax_mesh(inputs):
    """The JAX package's ViT sweep, flow engine, dual chaining, sweeps and
    ambiguity on ``make_mesh(2)``."""
    import jax.numpy as jnp
    from dino_tracker_tpu.models import vit as jvit
    from dino_tracker_tpu.parallel.mesh import make_mesh
    from dino_tracker_tpu.preprocessing import best_buddies as jbb
    from dino_tracker_tpu.preprocessing import flow as jflow
    from dino_tracker_tpu.preprocessing import trajectories as jtraj
    from test_torch_vit import SMALL, jax_cfg
    payload, params, vit_params = inputs
    mesh = make_mesh(2)
    frames = payload["frames"]
    out = dict(features=[np.asarray(f) for f in jvit.extract_feature_video(
        vit_params, jnp.asarray(frames), jax_cfg(SMALL), stride=7, layer=[1, 2],
        frames_per_batch=3, attn_impl="xla", mesh=mesh)])
    eng = jflow.RaftFlowEngine(params, frames, num_iters=ITERS, mesh=mesh)
    out["encodings"] = [np.asarray(x) for x in eng._encodings()]
    fwd, bwd = eng.adjacent_flows()
    out["adjacent"] = (np.asarray(fwd), np.asarray(bwd))
    out["direct"] = {s: tuple(np.asarray(x) for x in eng.direct_flows(s, THRESH))
                     for s in STARTS}
    out["dual"] = jtraj.extract_trajectories_dual(
        fwd, bwd, direct_flow_fn=lambda s: eng.direct_flows(s, THRESH), threshold=THRESH,
        min_trajectory_length=2, direct_flow_threshold=DIRECT_THRESH, mesh=mesh)
    feats = jnp.asarray(payload["bb_feats"])
    out["sweep"] = {}
    for cap in CAPS:
        for filtered in (False, True):
            tel = {}
            bb = jbb.extract_best_buddies(
                feats, BB_H, BB_W, 7, cap=cap, telemetry=tel, mesh=mesh,
                unfiltered_trajectories=payload["bb_trajs"] if filtered else None)
            out["sweep"][cap, filtered] = (BBData(*(np.asarray(x) for x in bb)), tel)
    out["ambiguity"] = np.asarray(jbb.compute_bb_ambiguity(
        jbb.extract_best_buddies(feats, BB_H, BB_W, 7, cap=32, mesh=mesh), feats, BB_H,
        BB_W, 7, box_size=AMB["box_size"], topk=AMB["topk"], mesh=mesh).r)
    return out


def numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close_to_max(got, want, tol=TOL):
    got, want = numpy(got), numpy(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def assert_trajectories_close(got, want, px=0.0):
    """Same count and NaN pattern; positions within ``px`` (0: equal)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=px)


def assert_bb_equal(got, want, r_tol=TOL, cos_tol=0.0):
    """Coordinates and validity equal; cosines within ``cos_tol`` of their
    max (0: equal); r within ``r_tol``."""
    for name, g, r in zip(BBData._fields, got, want):
        g, r = numpy(g), numpy(r)
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if name == "r":
            assert np.abs(g - r).max() <= r_tol
        elif name == "cos_sims":
            assert np.abs(g - r).max() <= cos_tol * np.abs(r).max()
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def assert_telemetry_equal(got, want):
    strip = lambda tel: {k: v for k, v in tel.items() if k != "phases"}
    assert strip(got) == strip(want)


def read_artifacts(root):
    """Every artifact of a preprocessed directory: the npz arrays, the mask
    jpgs' bytes, the best buddies and their telemetry (its seconds aside)."""
    paths = add_config_paths(root)
    art = {k: video_io.load_npz(paths[k]) for k in ARTIFACTS if os.path.exists(paths[k])}
    art["masks"] = {n: open(os.path.join(paths["masks_path"], n), "rb").read()
                    for n in sorted(os.listdir(paths["masks_path"]))}
    art["bb"] = load_bb_data(os.path.join(paths["dino_bb_dir"],
                                          "dino_best_buddies_filtered.npz"))
    with open(os.path.join(paths["dino_bb_dir"], "bb_truncation.json")) as f:
        art["bb_truncation"] = {k: v for k, v in json.load(f).items() if k != "phases"}
    return art


def assert_artifacts_equal(got, want):
    assert got.keys() == want.keys()
    for key in ARTIFACTS:
        if key not in want:
            continue
        for name, arr in want[key].items():
            if name == "features":
                assert_close_to_max(got[key][name], arr)
            else:
                np.testing.assert_array_equal(got[key][name], arr, err_msg=key)
    assert got["masks"] == want["masks"]
    assert_bb_equal(got["bb"], want["bb"])
    assert got["bb_truncation"] == want["bb_truncation"]


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ---------------------------------------------------------------------------
# the ranks against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 3])
def test_features_and_flows_match_one_device(spawned, one_device, w):
    ref = one_device
    for r in spawned[w]:
        for got, want in zip(r["features"], ref["features"]):
            assert_close_to_max(got, want)
        for got, want in zip(r["encodings"], ref["encodings"]):
            assert_close_to_max(got, want)
        for got, want in zip(r["adjacent"], ref["adjacent"]):
            assert_close_to_max(got, want)
        for s in STARTS:
            assert_close_to_max(r["direct"][s][0], ref["direct"][s][0])
            assert torch.equal(r["direct"][s][1], ref["direct"][s][1])
    assert len(ref["features"]) == 2 and ref["features"][0].shape == (T, 32, 5, 7)


@pytest.mark.parametrize("w", [2, 3])
def test_both_chaining_passes_match_one_device(spawned, one_device, w):
    want_f, want_u = one_device["dual"]
    assert len(want_f) and len(want_u) and len(want_f) != len(want_u)
    for r in spawned[w]:
        got_f, got_u = r["dual"]
        assert_trajectories_close(got_f, want_f)
        assert_trajectories_close(got_u, want_u)


@pytest.mark.parametrize("w", [2, 3])
def test_every_decode_has_pair_batch_pairs(spawned, one_device, w):
    """No rank decodes a batch of another size (cuDNN's f32 algorithms run
    4-7 pairs 8× slower than 8 on an H100). The ranks share the one-device
    decodes: 7 calls of 2 batches (the adjacent flows, two starts' direct
    flows, four chaining starts'), each call's batches on the ranks after
    the last call's, so their counts differ by one at most."""
    ref = one_device["decodes"]
    assert ref["sizes"] == [8] * 14
    per_rank = [len(r["decodes"]["sizes"]) for r in spawned[w]]
    assert per_rank == {2: [7, 7], 3: [5, 5, 4]}[w]
    for r, n in zip(spawned[w], per_rank):
        assert r["decodes"]["sizes"] == [8] * n
        assert r["decodes"]["counter"] == ({8: n} if n else {})


@pytest.mark.parametrize("w", [2, 3])
def test_sweep_and_ambiguity_match_one_device(spawned, one_device, w):
    for r in spawned[w]:
        for key, (bb, tel) in one_device["sweep"].items():
            got, got_tel = r["sweep"][key]
            assert_bb_equal(got, bb)
            assert_telemetry_equal(got_tel, tel)
        bb, tel = one_device["ambiguity"]
        got, got_tel = r["ambiguity"]
        assert_bb_equal(got, bb)
        assert_telemetry_equal(got_tel, tel)
    assert tel["rows_total"] > 16 * w  # more slabs than ranks
    assert one_device["sweep"][None, True][0].valid.any()


@pytest.mark.parametrize("w", [2, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_run_writes_what_one_device_writes(inputs, spawned, one_device, w, mode):
    base = inputs[0]["base"]
    assert_artifacts_equal(read_artifacts(rank_root(base, w, mode, 0)),
                           read_artifacts(rank_root(base, 1, mode, 0)))
    ref = one_device["runs"][mode]["telemetry"]
    for r in spawned[w]:
        tel = r["runs"][mode]["telemetry"]
        for key in ("best_buddies", "bb_ambiguity"):
            assert_telemetry_equal(tel[key], ref[key])


@pytest.mark.parametrize("w", [2, 3])
def test_only_rank_0_writes(inputs, spawned, w):
    """Rank 0's copy gains every artifact; the others' hold only their
    frames, so on the masks-exist path they followed rank 0's decision."""
    base = inputs[0]["base"]
    frames = [f"video/{i:05d}.png" for i in range(T)]
    for mode in MODES:
        written = files_under(rank_root(base, w, mode, 0))
        assert written == files_under(rank_root(base, 1, mode, 0))
        assert len(written) > len(frames) + T
        for rank in range(1, w):
            assert files_under(rank_root(base, w, mode, rank)) == frames
    for r in spawned[w]:
        assert "preprocess/fg_masks" not in r["runs"]["masks"]["timings"]
        assert "preprocess/fg_masks" in r["runs"]["fresh"]["timings"]
    assert "bb_save" in spawned[w][0]["runs"]["fresh"]["timings"]
    assert all("bb_save" not in r["runs"]["fresh"]["timings"] for r in spawned[w][1:])


# ---------------------------------------------------------------------------
# the ranks against the JAX package on make_mesh(2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 3])
def test_features_and_flows_match_the_jax_mesh(spawned, jax_mesh, w):
    for r in spawned[w]:
        for got, want in zip(r["features"], jax_mesh["features"]):
            assert_close_to_max(got, want)
        for got, want in zip(r["encodings"], jax_mesh["encodings"]):
            assert_close_to_max(got, want.transpose(0, 3, 1, 2))
        for got, want in zip(r["adjacent"], jax_mesh["adjacent"]):
            assert_close_to_max(got, want)
        for s in STARTS:
            assert_close_to_max(r["direct"][s][0], jax_mesh["direct"][s][0])
            np.testing.assert_array_equal(r["direct"][s][1].numpy(), jax_mesh["direct"][s][1])
        for got, want in zip(r["dual"], jax_mesh["dual"]):
            assert_trajectories_close(got, np.asarray(want), px=1e-4)


@pytest.mark.parametrize("w", [2, 3])
def test_sweep_and_ambiguity_match_the_jax_mesh(spawned, jax_mesh, w):
    for r in spawned[w]:
        for key, (bb, tel) in jax_mesh["sweep"].items():
            got, got_tel = r["sweep"][key]
            assert_bb_equal(got, bb, r_tol=1e-6, cos_tol=1e-5)
            assert_telemetry_equal(got_tel, tel)
        assert np.abs(r["ambiguity"][0].r.numpy() - jax_mesh["ambiguity"]).max() <= 1e-6


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_preprocess_cli_on_two_ranks_writes_what_one_device_writes(tmp_path, inputs):
    """``--devices 2 --device cpu`` (two gloo ranks) against ``--devices 1``
    on checkpoints written here; each rank reports its own timers and
    launches. ``--devices 2`` on a device index, or on more CUDA cards than
    are visible, raises before anything runs."""
    from test_torch_preprocess_run import write_checkpoints_and_config
    from test_torch_trajectories import write_frames
    payload, params, _ = inputs
    raft_path, vit_path, config = write_checkpoints_and_config(tmp_path, params)
    roots = {w: str(tmp_path / f"w{w}") for w in (2, 1)}
    reports = {}
    threads = torch.get_num_threads()
    # one device on a rank's thread count: the CPU's GEMMs sum in another
    # order on another count, and a feature then rounds to another f16
    torch.set_num_threads(mesh_lib.cpu_rank_threads(2, threads))
    try:
        for w, root in roots.items():
            write_frames(os.path.join(root, "video"), payload["frames"])
            args = ["--config", config, "--data-path", root, "--raft-checkpoint",
                    raft_path, "--dino-checkpoint", vit_path, "--device", "cpu"]
            reports[w] = preprocess_cli.main(args + ["--devices", str(w)])
    finally:
        torch.set_num_threads(threads)
    assert_artifacts_equal(read_artifacts(roots[2]), read_artifacts(roots[1]))
    assert len(reports[2]) == 2 and len(reports[1]) == 1
    for report in reports[2]:
        assert {"timings", "telemetry", "stages", "launches"} <= report.keys()
        assert report["stages"]["gather/vit_features"]["bytes"] == 2 * T * 384 * 5 * 7 * 4
        assert report["telemetry"]["raft"]["decode_batch_sizes"].keys() == {8}
    args = ["--config", config, "--data-path", roots[1], "--devices", "2"]
    with pytest.raises(ValueError, match="puts rank r on cuda:r"):
        preprocess_cli.main(args + ["--device", "cuda:1"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="nothing runs on fewer ranks"):
            preprocess_cli.main(args + ["--device", "cuda"])
