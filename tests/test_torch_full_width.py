"""The full-width goldens (tests/fixtures/full_width/) and the code around
them, on the CPU.

- The numpy maker (scripts/full_width_inputs.py) rebuilds every input of
  every golden: each array's sha256 equals the one the golden records (the
  ViT-L and RAFT-large weights included: each stage's inputs take under 10 s
  to make and digest). Its RAFT keys are the princeton-vl manifest of
  tests/fixtures/raft_realscale_golden.npz plus the two ``norm3`` BNs a
  published checkpoint holds.
- Each golden records its seed, widths, input digests, every record's shape
  and dtype, the JAX version and the tolerances ``chip_smoke.py`` phase 14
  holds the port to; together they stay under 4 MB.
- The generator's stage functions (scripts/gen_full_width_golden.py, the JAX
  package live) and phase 14's stage functions and compare helpers
  (chip_smoke.py, the port on the CPU) run end to end at ``TOY`` widths, which
  cross the same chunk and slab edges: every stage within its tolerance.
- Each compare helper fails on a perturbed output: one token, one flow pixel,
  one gradient element, one track, one buddy, one trajectory; stage 1's
  chaining helper also fails on the port with a planted change: the cycle
  threshold 1.5 → 1.49, the in-bounds test ``<=`` → ``<``, round-half-up in
  the look-behind occupancy.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import full_width_inputs as fw  # noqa: E402
import gen_full_width_golden as gen  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDENS = os.path.join(REPO, "tests", "fixtures", "full_width")
CPU = torch.device("cpu")


@pytest.mark.parametrize("stage", fw.STAGES)
def test_maker_reproduces_the_golden_digests(stage):
    meta, rec = chip_smoke.load_golden(stage)
    inp, wd = chip_smoke.golden_inputs(stage, meta)  # raises on any digest
    assert wd == fw.FULL
    assert fw.digests(inp) == meta["input_digests"]
    assert len(meta["input_digests"]) == len(fw.flatten(inp))


def test_goldens_record_their_provenance_under_4_mb():
    total = 0
    for stage in fw.STAGES:
        path = os.path.join(GOLDENS, f"{stage}.npz")
        total += os.path.getsize(path)
        with np.load(path) as f:
            meta = json.loads(str(f["meta"]))
            recs = {k[len("rec/"):]: f[k] for k in f.files if k.startswith("rec/")}
        assert meta["stage"] == stage and meta["seed"] == 0
        assert meta["widths"]["name"] == "full" and meta["tolerances"] == fw.TOLERANCES[stage]
        assert meta["jax"] and meta["numpy"] and meta["seconds_on_this_cpu"] > 0
        assert {k: [list(v.shape), v.dtype.str] for k, v in recs.items()} == meta["records"]
    assert total < 4 * 2 ** 20, total


def test_raft_keys_are_the_princeton_vl_manifest():
    with np.load(os.path.join(REPO, "tests", "fixtures", "raft_realscale_golden.npz")) as f:
        manifest = {k: tuple(int(x) for x in s.split(",")) for k, s in zip(f["keys"],
                                                                           f["shapes"])}
    sd = fw.raft_state_dict(np.random.default_rng(0))
    extra = {k for k in sd if ".norm3." in k}
    assert {k.split(".")[2] for k in extra} == {"layer2", "layer3"} and len(extra) == 8
    assert {k: v.shape for k, v in sd.items() if k not in extra} == manifest
    for k in extra:
        np.testing.assert_array_equal(sd[k], sd[k.replace(".norm3.", ".downsample.1.")])


def test_bb_features_give_exact_affinities():
    """±1 features: the f32 affinity of the unit rows equals the f64 one bit
    for bit, so no summation order can move a buddy, a top-k boundary or a
    ratio."""
    feats = fw.make("bb", fw.TOY, 0)["features"]
    flat = feats.reshape(feats.shape[0], feats.shape[1], -1).transpose(0, 2, 1)
    unit = flat / np.linalg.norm(flat, axis=-1, keepdims=True)
    a32 = unit[0].astype(np.float32) @ unit[1].astype(np.float32).T
    np.testing.assert_array_equal(a32, unit[0].astype(np.float64) @ unit[1].T)
    assert np.array_equal(np.rint(a32 * fw.TOY.bb_c), a32 * fw.TOY.bb_c)


@pytest.fixture(scope="module")
def toy():
    """{stage: (meta, golden records, port output)}: the generator's stage
    functions at TOY widths (the JAX package on the CPU), then phase 14's
    stage functions on the CPU, each run once for the module."""
    out = {}
    for stage in fw.STAGES:
        inp = fw.make(stage, fw.TOY, 0)
        rec = gen.STAGE_FNS[stage](inp, fw.TOY, 0)
        meta = gen.golden_meta(stage, fw.TOY, 0, inp, rec, 1.0)
        run, _ = chip_smoke.FULL_WIDTH_STAGES[stage]
        out[stage] = (meta, rec, run(inp, fw.TOY, CPU))
    return out


@pytest.mark.parametrize("stage", fw.STAGES)
def test_toy_stage_matches_jax(toy, stage):
    meta, rec, out = toy[stage]
    _, compare = chip_smoke.FULL_WIDTH_STAGES[stage]
    rows = compare(meta, rec, out)
    assert rows and all(err <= bound for _, err, bound in rows)


def _perturbed(stage, rec, out):
    """A copy of the port's output with one value moved far: one token of
    the f32 ViT, one flow pixel on the stride-4 grid, one sampled element of
    a gradient, one track, one buddy's target, one sampled trajectory's
    last position."""
    if stage == "vit":
        feats = {d: {k: v.copy() for k, v in layers.items()} for d, layers in out[0].items()}
        x = feats["float32"][fw.TOY.vit_layers[0]]
        x[0, :, 1, 2] *= 1.5
        return feats, out[1]
    if stage == "raft":
        flow = out.copy()
        flow[1, 0, 8, 4] += 1.0
        return flow
    if stage == "train":
        metrics, grads, stats = out["float32"][True]
        g = {k: v.copy() for k, v in fw.flatten(grads).items()}
        path = "delta_dino/layers/1/conv/w"
        i = rec[f"float32/gates_on/grad/{path}/idx"][3]
        g[path].ravel()[i] += np.abs(g[path]).max()
        return {**out, "float32": {**out["float32"], True: (metrics, g, stats)}}
    if stage == "refine":
        refined, trajs, occ, chunk = out["float32"]
        trajs = trajs.copy()
        trajs[5, 3, 0] += 0.5
        return {**out, "float32": (refined, trajs, occ, chunk)}
    if stage == "traj":
        trajs = out["trajs"]["f"].copy()
        row = next(i for i in rec["f/idx"] if np.isfinite(trajs[i, -1, 0]))
        trajs[row, -1, 0] += 0.5
        return {**out, "trajs": {**out["trajs"], "f": trajs}}
    fields, closest = out
    fields = [f.copy() for f in fields]
    s, u = 0, 1
    k = int(np.flatnonzero(fields[4][s, u])[7])
    fields[1][s, u, k] = fields[1][s, u, (k + 1) % fields[1].shape[2]]
    return fields, closest


@pytest.mark.parametrize("stage", fw.STAGES)
def test_compare_fails_on_a_perturbed_output(toy, stage):
    meta, rec, out = toy[stage]
    _, compare = chip_smoke.FULL_WIDTH_STAGES[stage]
    with pytest.raises(RuntimeError, match=f"full width {stage} differs"):
        compare(meta, rec, _perturbed(stage, rec, out))


def _step_at(threshold=None, strict=False):
    """``preprocessing/trajectories.py _step`` with a planted change: the
    cycle threshold replaced, or the in-bounds test strict."""
    from dino_tracker_tpu_torch.preprocessing import trajectories as traj

    def step(flows_fwd, flows_bwd, idx, coords, thresh):
        h, w = coords.shape[:2]
        coords1 = coords + traj._warp(flows_fwd[idx], coords)
        coords2 = coords1 + traj._warp(flows_bwd[idx], coords1)
        upper = torch.tensor([w - 1.0, h - 1.0], device=coords.device)
        below = coords1 < upper if strict else coords1 <= upper
        in_bounds = ((coords1 >= 0.0) & below).all(dim=-1)
        return coords1, (traj._norm(coords - coords2) < (threshold or thresh)) & in_bounds
    return step


def _occupancy_half_up(trajs, occupied, start, n_threads=0):
    """The look-behind occupancy rounding half-integers up."""
    t, h, w = occupied.shape
    valid = ~np.isnan(trajs).any(-1)
    cells = np.floor(np.nan_to_num(trajs) + 0.5).astype(np.int64)
    xi, yi = np.clip(cells[..., 0], 0, w - 1), np.clip(cells[..., 1], 0, h - 1)
    for f in range(start, t):
        occupied[f, yi[f, valid[f]], xi[f, valid[f]]] = True


@pytest.mark.parametrize("change", ["threshold 1.49", "strict in-bounds", "round half up"])
def test_traj_compare_fails_on_a_planted_change(toy, change, monkeypatch):
    """Phase 14's stage f on a port with one change planted: the cycle
    threshold 1.5 → 1.49 (keep masks differ off the threshold), the
    in-bounds test ``<=`` → ``<`` (rows ideal in both die a frame early
    where they land on the last row or column exactly), round-half-up in
    the occupancy (a later start spawns from other cells). The helper
    raises on each."""
    from dino_tracker_tpu_torch.preprocessing import trajectories as traj
    meta, rec, _ = toy["traj"]
    if change == "round half up":
        monkeypatch.setattr(traj, "occupancy_update", _occupancy_half_up)
    else:
        monkeypatch.setattr(traj, "_step", _step_at(1.49) if change == "threshold 1.49"
                            else _step_at(strict=True))
    out = chip_smoke.full_width_traj(fw.make("traj", fw.TOY, 0), fw.TOY, CPU)
    with pytest.raises(RuntimeError, match="full width traj differs"):
        chip_smoke.compare_traj(meta, rec, out)

