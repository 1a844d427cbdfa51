"""DINOv2 ViT-g/14 in the port: SwiGLU blocks (``models/vit.py``), their
DINOv2 keys (``models/vit_convert.py``), the layer defaults of a 40-block
model (``config.py``), and training at its 1,536-channel features.

The reference is the benchmark's plain PyTorch DINOv2 ViT
(``portbench/reference/vit_swiglu.py``), which imports nothing of the port
or of JAX, so this file runs where JAX is absent:
``python -m pytest tests/test_torch_vit_swiglu.py --noconftest``.

Tolerances on the CPU, seeded weights under the DINOv2 keys:

* f32: features within 1e-5 of the reference's largest magnitude: the same
  operations, through three blocks, where a library may sum in another
  order (0 measured on the CPU).
* bf16 compute against the reference at the same precision (bf16 operands
  for the linears and attention, f32 accumulation, residual, LayerNorm and
  gate): 1 − least per-token cosine ≤ 1e-5. Both round at the same points,
  so only a product summed in another order can land one bf16 ulp apart
  on an operand (measured 2.4e-7: the cosine's own f32 resolution). The
  f32 reference lies 5.9e-6 from the port's bf16 features and the float8
  control 1.6e-3 from the bf16 reference, so an FFN computed in another
  precision than the configuration states fails.

On the card (``cuda`` marker, skipped without one): ViT-g/14 at its
published widths, its seeded SwiGLU weights written as a DINOv2-keyed
``.pth`` and loaded by ``load_dinov2_state_dict``, sweeps a T=8 854×476
video through ``PreprocessingPipeline.run()``; its f16 feature (layer 25)
and mask (layer 39) stacks are held to the plain reference at the
configuration's precision (bf16 operands), computed frame batch by frame
batch and a few heads at a time, by 1 − least per-token cosine, as the
benchmark's ``feat``. The control, the reference with float8 (e4m3)
operands, must read above the tolerance (``G14_FEAT_TOL``). Then the whole
system, ``cli.run_benchmark``, on that video: preprocess, 40 training
iterations at C = 1,536 and inference.
"""

import json
import math
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.config import (PreprocessConfig, TrainConfig,
                                           tracker_config_from_train)
from dino_tracker_tpu_torch.models import vit as pvit
from dino_tracker_tpu_torch.models import vit_convert
from test_torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTBENCH = os.path.join(ROOT, "portbench")
if PORTBENCH not in sys.path:
    sys.path.insert(0, PORTBENCH)
from reference import preprocess as ref_pre  # noqa: E402
from reference import vit_swiglu as ref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32_TOL = 1e-5   # of the reference's largest magnitude
BF16_TOL = 1e-5  # 1 − least per-token cosine
# on the card at the published widths: the program's bf16 reading 1.9e-6 and
# the float8 control's 8.6e-3 in the run that set it (PERF.md), the limit
# preprocess-t8 holds its ViT-L features to
G14_FEAT_TOL = 2e-4

# a small SwiGLU ViT (hidden width by DINOv2's rule: 88 at D = 32) and its
# GELU twin, both at stride 7 on a 5×5 pretrain grid
SMALL = {"embed_dim": 32, "depth": 3, "heads": 4, "patch": 14, "stride": 7}
GRID = 5
G14 = {"model": "dinov2_vitg14", "embed_dim": 1536, "depth": 40, "heads": 24, "patch": 14,
       "stride": 7, "ffn": "swiglu", "hidden": 4096}


def port_cfg(vit: dict) -> pvit.ViTConfig:
    return pvit.ViTConfig(embed_dim=vit["embed_dim"], depth=vit["depth"],
                          num_heads=vit["heads"], patch_size=vit["patch"],
                          pretrain_grid=GRID, ffn=vit.get("ffn", "mlp"),
                          ffn_hidden=ref.hidden_dim(vit))


def small(ffn: str) -> dict:
    return {**SMALL, "ffn": ffn}


def cos_gap(a, b) -> float:
    """1 − the least per-token cosine of two T×D×h×w stacks."""
    x, y = (torch.as_tensor(v).cpu().float().flatten(2) for v in (a, b))
    return float(1.0 - torch.nn.functional.cosine_similarity(x, y, dim=1).min())


def dinov2_keys(vit: dict) -> dict:
    """DINOv2's own checkpoint keys and shapes for ``vit``, written out from
    facebookresearch/dinov2 (``DinoVisionTransformer``, no registers), the
    keys the extractor does not use (``mask_token``, the final ``norm``)
    included."""
    d, p, hid = vit["embed_dim"], vit["patch"], ref.hidden_dim(vit)
    keys = {"cls_token": (1, 1, d), "pos_embed": (1, 1 + 37 ** 2, d), "mask_token": (1, d),
            "patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,),
            "norm.weight": (d,), "norm.bias": (d,)}
    ffn = ({"mlp.w12.weight": (2 * hid, d), "mlp.w12.bias": (2 * hid,),
            "mlp.w3.weight": (d, hid), "mlp.w3.bias": (d,)} if vit.get("ffn") == "swiglu"
           else {"mlp.fc1.weight": (hid, d), "mlp.fc1.bias": (hid,),
                 "mlp.fc2.weight": (d, hid), "mlp.fc2.bias": (d,)})
    for i in range(vit["depth"]):
        for k, shape in {"norm1.weight": (d,), "norm1.bias": (d,),
                         "attn.qkv.weight": (3 * d, d), "attn.qkv.bias": (3 * d,),
                         "attn.proj.weight": (d, d), "attn.proj.bias": (d,),
                         "ls1.gamma": (d,), "norm2.weight": (d,), "norm2.bias": (d,),
                         **ffn, "ls2.gamma": (d,)}.items():
            keys[f"blocks.{i}.{k}"] = shape
    return keys


def small_model(vit: dict, seed: int):
    """(reference state, the port's ViT loaded from it by its DINOv2 keys)."""
    state = ref.vit_state_swiglu(vit, seed, "cpu", pretrain_grid=GRID)
    sd, cfg = vit_convert.load_dinov2_state_dict(state, cfg=port_cfg(vit))
    return state, vit_convert.build_vit(sd, cfg, "cpu")


# ---- the CPU: the block, the presets, the keys -------------------------------

@pytest.mark.parametrize("layers", [[2], [1, 2]], ids=["one-layer", "features-and-mask"])
@pytest.mark.parametrize("ffn", ["swiglu", "mlp"])
def test_vit_matches_reference_f32(ffn, layers):
    vit = small(ffn)
    state, model = small_model(vit, seed=3)
    video = torch.rand((3, 3, 42, 56), generator=torch.Generator().manual_seed(4))
    want = ref.vit_features(state, video, layers, vit, frames_per_batch=2, pretrain_grid=GRID)
    got = pvit.extract_feature_video(model, video, stride=7, layer=layers, frames_per_batch=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 32, 5, 7)
        err = float((g - w).abs().max())
        assert err <= F32_TOL * float(w.abs().max()), (err, float(w.abs().max()))


@pytest.mark.parametrize("layers", [[2], [1, 2]], ids=["one-layer", "features-and-mask"])
def test_swiglu_vit_matches_reference_bf16(layers):
    vit = small("swiglu")
    state, model = small_model(vit, seed=5)
    video = torch.rand((2, 3, 42, 56), generator=torch.Generator().manual_seed(6))
    want = ref.vit_features(state, video, layers, vit, ref_pre.Precision(),
                            frames_per_batch=2, pretrain_grid=GRID)
    got = pvit.extract_feature_video(model, video, stride=7, layer=layers, frames_per_batch=2,
                                     compute_dtype=torch.bfloat16)
    f32 = ref.vit_features(state, video, layers, vit, frames_per_batch=2, pretrain_grid=GRID)
    for g, w, x in zip(got, want, f32):
        assert cos_gap(g, w) <= BF16_TOL, cos_gap(g, w)
        # and bf16 is a real rounding: the f32 reference lies farther off
        assert cos_gap(g, x) > cos_gap(g, w)


def test_swiglu_block_gate():
    """One block's FFN is w3(silu(a)·b), [a | b] = w12(norm2(x)), not GELU."""
    vit = {**small("swiglu"), "depth": 1}
    state, model = small_model(vit, seed=7)
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        ours, _ = model.blocks[0](x, torch.float32)
    want = ref.block(x, state, 0, vit)
    assert torch.allclose(ours, want, rtol=0, atol=F32_TOL * float(want.abs().max()))
    gelu = dict(state)
    w12 = state["blocks.0.mlp.w12.weight"]
    hid = w12.shape[0] // 2  # a GELU MLP on the first half of w12 gives another block
    gelu.update({"blocks.0.mlp.fc1.weight": w12[:hid], "blocks.0.mlp.fc1.bias":
                 state["blocks.0.mlp.w12.bias"][:hid],
                 "blocks.0.mlp.fc2.weight": state["blocks.0.mlp.w3.weight"],
                 "blocks.0.mlp.fc2.bias": state["blocks.0.mlp.w3.bias"]})
    other = ref.block(x, gelu, 0, {**vit, "ffn": "mlp", "hidden": hid})
    assert float((other - ours).abs().max()) > 1e-2


def test_g14_preset_published_fields():
    g = pvit.ViTConfig.for_model("dinov2_vitg14")
    assert (g.embed_dim, g.depth, g.num_heads, g.patch_size, g.pretrain_grid, g.layerscale,
            g.ln_eps, g.ffn, g.hidden_dim) == (1536, 40, 24, 14, 37, True, 1e-6, "swiglu", 4096)
    assert g.embed_dim // g.num_heads == 64  # the head dim K2 takes
    assert ref.swiglu_hidden(1536) == (int(4 * 1536 * 2 / 3) + 7) // 8 * 8 == 4096
    n = sum(math.prod(s) for k, s in dinov2_keys(G14).items())
    assert 1.13e9 < n < 1.14e9, n  # "about 1.13 B parameters"
    for name in ("dinov2_vits14", "dinov2_vitb14", "dinov2_vitl14"):
        cfg = pvit.ViTConfig.for_model(name)
        assert (cfg.ffn, cfg.hidden_dim) == ("mlp", 4 * cfg.embed_dim), name


@pytest.mark.parametrize("name", ["dinov2_vitg14_reg", "dinov2_vitl14_reg", "dinov2_vits14_reg4"])
def test_register_models_are_refused(name):
    with pytest.raises(ValueError, match="register tokens"):
        pvit.ViTConfig.for_model(name)


@pytest.mark.parametrize("name", ["dinov2_vitg14", "dinov2_vitl14"])
def test_vit_state_keys_are_dinov2s(name):
    vit = G14 if name == "dinov2_vitg14" else {"embed_dim": 1024, "depth": 24, "heads": 16,
                                               "patch": 14, "ffn": "mlp"}
    cfg = pvit.ViTConfig.for_model(name)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in pvit.VisionTransformer(cfg).state_dict().items()}
    theirs = dinov2_keys(vit)
    assert set(vit_convert.vit_state_keys(cfg)) == set(shapes)
    assert set(theirs) - set(shapes) == {"mask_token", "norm.weight", "norm.bias"}
    assert all(shapes[k] == theirs[k] for k in shapes)
    assert shapes == ref.state_shapes(vit)


def test_g14_state_dict_loads_strictly_on_meta():
    """A DINOv2-keyed ViT-g/14 state dict (every key of the checkpoint, on the
    meta device) loads strictly; one with GELU MLP keys does not."""
    cfg = pvit.ViTConfig.for_model("dinov2_vitg14")
    sd = {k: torch.empty(s, device="meta") for k, s in dinov2_keys(G14).items()}
    model = vit_convert.build_vit({k: sd[k] for k in vit_convert.vit_state_keys(cfg)}, cfg,
                                  "meta")
    assert tuple(model.blocks[39].mlp.w12.weight.shape) == (8192, 1536)
    assert tuple(model.blocks[0].mlp.w3.weight.shape) == (1536, 4096)
    assert not hasattr(model.blocks[0].mlp, "fc1")
    gelu = {k: torch.empty(s, device="meta")
            for k, s in dinov2_keys({**G14, "ffn": "mlp", "hidden": 6144}).items()}
    with pytest.raises(KeyError):
        {k: gelu[k] for k in vit_convert.vit_state_keys(cfg)}
    with pytest.raises(RuntimeError):
        vit_convert.build_vit({k: gelu.get(k, sd[k]) for k in vit_convert.vit_state_keys(cfg)},
                              pvit.ViTConfig.for_model("dinov2_vitl14"), "meta")


def test_load_dinov2_checkpoint_file(tmp_path):
    """A small SwiGLU checkpoint on disk, with DINOv2's unused keys, loads by
    its DINOv2 keys to the same numbers; one without ``mlp.w12`` raises."""
    vit = small("swiglu")
    cfg = port_cfg(vit)
    state = ref.vit_state_swiglu(vit, 9, "cpu", pretrain_grid=GRID)
    path = str(tmp_path / "vit.pth")
    torch.save({**state, "mask_token": torch.zeros(1, 32), "norm.weight": torch.ones(32),
                "norm.bias": torch.zeros(32)}, path)
    sd, got = vit_convert.load_dinov2_state_dict(path, cfg=cfg)
    assert got == cfg and set(sd) == set(vit_convert.vit_state_keys(cfg))
    assert all(torch.equal(sd[k], state[k]) for k in sd)
    del state["blocks.1.mlp.w12.weight"]
    with pytest.raises(KeyError):
        vit_convert.load_dinov2_state_dict(state, cfg=cfg)


def test_g14_layers_are_set_by_its_config():
    """The layer defaults stay ViT-L/14's; a ViT-g/14 config names 25 and 39,
    inside its 40 blocks, and its DeltaDINO ends at 1,536 channels."""
    g14 = PreprocessConfig(dino_model_name="dinov2_vitg14", mask_dino_model_name="dinov2_vitg14")
    assert (g14.dino_layer, g14.mask_dino_layer) == (15, 23)
    g14 = PreprocessConfig(dino_model_name="dinov2_vitg14", mask_dino_model_name="dinov2_vitg14",
                           dino_layer=25, mask_dino_layer=39)
    assert g14.mask_dino_layer == pvit.ViTConfig.for_model("dinov2_vitg14").depth - 1
    tcfg = tracker_config_from_train(TrainConfig(dino_model_name="dinov2_vitg14"))
    assert tcfg.delta_channels == (3, 64, 128, 256, 1536)


# ---- the CPU: training and inference at 1,536 channels -------------------------

def test_train_step_and_inference_at_1536_channels():
    """TrainConfig's ViT-g/14 sets DeltaDINO's last width to 1,536; a tiny
    video's train steps (both gates on) run on 1,536-channel features, and
    inference takes them and refuses 1,024."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.models.tracker import Tracker
    from dino_tracker_tpu_torch.structures import BBData
    from dino_tracker_tpu_torch.training import train
    from dino_tracker_tpu_torch.training.sampler import TrajectoryBank
    from yardstick import train_data

    cfg = TrainConfig(video_resh=42, video_resw=56, train_batch_size=16, batch_n_frames=2,
                      cyc_n_frames=2, cyc_batch_size_per_frame=8, cl_n_frames=2,
                      cl_points_per_pair=8, compute_dtype="float32",
                      dino_model_name="dinov2_vitg14", apply_cyc_after=0,
                      apply_cl_ref_after=0)
    tcfg = tracker_config_from_train(cfg)
    c = tcfg.delta_channels[-1]
    assert c == 1536
    t, (fh, fw) = 4, tcfg.feat_hw
    raw = train_data.make_train_data({"frames": t, "height": 42, "width": 56, "channels": c,
                                      "feat_hw": (fh, fw), "trajectories": 200,
                                      "fg_share": 0.3, "bb_capacity": 12}, 11, "cpu")
    bb = BBData(raw["bb_source_coords"], raw["bb_target_coords"], raw["bb_cos_sims"],
                raw["bb_r"], raw["bb_valid"])
    banks = [TrajectoryBank(raw[f"{s}_coords"], raw[f"{s}_valid"], raw[f"{s}_coords"].shape[0])
             for s in ("fg", "bg")]
    data = train.VideoData(raw["video"], raw["dino"], raw["masks"], bb, *banks)
    model = Tracker(tcfg)
    model.load_state_dict(train_data.make_weights(tcfg.delta_channels, 11, "cpu"))
    model.train()
    opt, sched = train.make_optimizer(model, cfg)
    runner = train.StepRunner(model, opt, sched, torch.Generator().manual_seed(12), cfg, tcfg,
                              None)
    before = model.delta_dino.layers[3].conv.weight.detach().clone()
    runner.run(data, True, True, 2)
    metrics = {k: float(v) for k, v in train.reduce_metrics(runner.take_metrics(), None).items()}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert metrics["loss_cyc"] != 0 and metrics["loss_cl_refiner"] != 0, metrics
    assert tuple(before.shape) == (1536, 256, 5, 5)
    assert not torch.equal(before, model.delta_dino.layers[3].conv.weight)

    dino = raw["dino"].float()
    inf = runtime.make_model_inference(model, raw["video"], dino, tcfg, 0.7, 0.6)
    assert inf.refined_features.shape == (t, fh, fw, 1536)  # channels last
    with pytest.raises(ValueError, match="1024 channels but the refiner emits 1536"):
        runtime.make_model_inference(model, raw["video"], dino[:, :1024], tcfg, 0.7, 0.6)


# ---- the card -------------------------------------------------------------------

SEED = 2300000101
T_CARD, H_CARD, W_CARD = 8, 476, 854


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K2 has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def g14_checkpoints(cuda, tmp_path_factory):
    """The seeded ViT-g/14 as a DINOv2-keyed f32 ``.pth`` (its unused keys
    too) and RAFT-large as a princeton-vl ``.pth``, written once."""
    from yardstick import preprocess_data
    root = tmp_path_factory.mktemp("g14")
    state = ref.vit_state_swiglu(G14, SEED, cuda)
    vit_path, raft_path = str(root / "dinov2_vitg14.pth"), str(root / "raft.pth")
    torch.save({**{k: v.cpu() for k, v in state.items()}, "mask_token": torch.zeros(1, 1536),
                "norm.weight": torch.ones(1536), "norm.bias": torch.zeros(1536)}, vit_path)
    del state
    torch.save({k: v.cpu() for k, v in preprocess_data.raft_state(SEED, cuda).items()},
               raft_path)
    return vit_path, raft_path


def _card_line(**fields):
    print("g14 " + json.dumps(fields), flush=True)


@pytest.mark.cuda
def test_g14_sweep_matches_reference_on_card(cuda, g14_checkpoints, tmp_path):
    from dino_tracker_tpu_torch.models.raft import load_raft_state_dict
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    from yardstick import compare, preprocess_data
    vit_path, raft_path = g14_checkpoints
    state, vcfg = vit_convert.load_dinov2_state_dict(vit_path, "dinov2_vitg14")
    assert vcfg.ffn == "swiglu" and len(state) == len(vit_convert.vit_state_keys(vcfg))
    vit = vit_convert.build_vit(state, vcfg, cuda)
    del state
    raft = load_raft_state_dict(raft_path, cuda)
    cfg = PreprocessConfig(dino_model_name="dinov2_vitg14", mask_dino_model_name="dinov2_vitg14",
                           dino_layer=25, mask_dino_layer=39)
    video = preprocess_data.video(SEED, 0, T_CARD, H_CARD, W_CARD, cuda)
    path = str(tmp_path / "video")
    torch.cuda.reset_peak_memory_stats(cuda)
    t0 = time.perf_counter()
    pipe = PreprocessingPipeline(path, cfg, vit=vit, device=cuda, frames=video, raft=raft)
    pipe.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(cuda)
    stage_s = pipe.timings.get("preprocess/dino_features")
    t0 = time.perf_counter()  # the sweep again, its kernels built
    pvit.extract_feature_video(vit, video, stride=7, layer=[cfg.dino_layer, cfg.mask_dino_layer],
                               compute_dtype=torch.bfloat16)
    torch.cuda.synchronize(cuda)
    sweep_s = time.perf_counter() - t0
    del pipe, vit, raft
    torch.cuda.empty_cache()
    prog = compare.read_preprocess_artifacts(path)
    assert prog["features"].shape == (T_CARD, 1536, 67, 121)

    ref_state = ref.vit_state_swiglu(G14, SEED, cuda)
    layers = [cfg.dino_layer, cfg.mask_dino_layer]
    readings, t_ref = {}, time.perf_counter()
    bf16 = ref.vit_features(ref_state, video, layers, G14, ref_pre.Precision())
    ref_s = time.perf_counter() - t_ref
    for name, prec in (("control", ref_pre.Precision("float8_e4m3")), ("f32", ref.FLOAT32)):
        other = ref.vit_features(ref_state, video, layers, G14, prec)
        for k, o, b in zip(("features", "mask_features"), other, bf16):
            readings[f"{name}_{k}"] = cos_gap(o.half(), b.half())
        del other
    for k, b, in zip(("features", "mask_features"), bf16):
        readings[f"program_{k}"] = cos_gap(prog[k], b.half())
    f32 = ref.vit_features(ref_state, video, layers, G14, ref.FLOAT32)
    for k, x in zip(("features", "mask_features"), f32):
        readings[f"program_vs_f32_{k}"] = cos_gap(prog[k], x.half())
    _card_line(readings=readings, run_s=run_s, stage_s=stage_s, sweep_s=sweep_s,
               reference_bf16_s=ref_s,
               peak_bytes=peak, card=torch.cuda.get_device_name(cuda))
    program = max(readings["program_features"], readings["program_mask_features"])
    control = min(readings["control_features"], readings["control_mask_features"])
    assert program <= G14_FEAT_TOL < control, readings
    assert control >= 3 * program, readings


def _write_e2e_inputs(root, vit_path, raft_path, iterations):
    """A dataset root with one T=8 video of PNG frames, the two yaml files
    for ViT-g/14 and a benchmark pickle of 16 queries on frame 0."""
    from PIL import Image
    from yardstick import preprocess_data
    shift = preprocess_data.SHIFTS[0]
    frames = preprocess_data.textured_video(T_CARD, H_CARD, W_CARD, shift, (0.3, 1.1, 2.0), "cpu")
    folder = os.path.join(root, "videos", "0", "video")
    os.makedirs(folder)
    for i, f in enumerate((frames * 255).round().byte().permute(0, 2, 3, 1).numpy()):
        Image.fromarray(f).save(os.path.join(folder, f"{i:05d}.png"))
    q = np.random.default_rng(8).random((16, 2)) * [W_CARD - 1, H_CARD - 1]
    tracks = q[:, None] + np.arange(T_CARD)[None, :, None] * np.asarray(shift)
    bench = {"videos": [{"video_idx": 0, "h": H_CARD, "w": W_CARD, "query_points": {0: q.tolist()},
                         "target_points": {0: tracks.astype(np.float32)},
                         "occluded": {0: ((tracks < 0) | (tracks > [W_CARD - 1, H_CARD - 1])
                                          ).any(-1)}}]}
    pkl = os.path.join(root, "benchmark.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(bench, f)
    pre, train_yaml = os.path.join(root, "preprocessing.yaml"), os.path.join(root, "train.yaml")
    with open(pre, "w") as f:
        f.write(f"max_frames: {T_CARD}\ndino_model_name: dinov2_vitg14\n"
                "mask_dino_model_name: dinov2_vitg14\ndino_layer: 25\nmask_dino_layer: 39\n")
    with open(train_yaml, "w") as f:
        f.write(f"total_iterations: {iterations}\napply_cyc_after: {iterations // 2}\n"
                f"apply_cl_ref_after: {iterations // 2}\ncheckpoint_interval: {iterations // 2}\n"
                "dino_model_name: dinov2_vitg14\n")
    return ["--dataset-root-dir", os.path.join(root, "videos"), "--benchmark-pickle-path", pkl,
            "--train-config", train_yaml, "--preprocess-config", pre,
            "--raft-checkpoint", raft_path, "--dino-checkpoint", vit_path, "--device", "cuda"]


@pytest.mark.cuda
def test_g14_whole_system_on_card(cuda, g14_checkpoints, tmp_path):
    """cli.run_benchmark with ViT-g/14: preprocess, 40 iterations at
    C = 1,536 (both gates on for the last 20), inference."""
    from dino_tracker_tpu_torch.cli import run_benchmark
    from dino_tracker_tpu_torch.utils import video_io
    iterations = 40
    args = _write_e2e_inputs(str(tmp_path), *g14_checkpoints, iterations)
    torch.cuda.reset_peak_memory_stats(cuda)
    t0 = time.perf_counter()
    launcher = run_benchmark.main(args + ["--claim-dir", str(tmp_path / "claims")])
    run_s = time.perf_counter() - t0
    vid = os.path.join(str(tmp_path), "videos", "0")
    assert os.path.exists(str(tmp_path / "claims" / "0.done"))
    feats = video_io.load_npz(os.path.join(vid, "dino_embeddings", "dino_embed_video.npz"))
    assert feats["features"].shape[:2] == (T_CARD, 1536)
    assert os.path.exists(os.path.join(vid, "models", "dino_tracker", f"state_{iterations}.pt"))
    state = torch.load(os.path.join(vid, "models", "dino_tracker", f"state_{iterations}.pt"),
                       map_location="cpu", weights_only=False)
    assert tuple(state["model"]["delta_dino.layers.3.conv.weight"].shape) == (1536, 256, 5, 5)
    trajs = np.load(os.path.join(vid, "trajectories", "trajectories_0.npy"))
    occ = np.load(os.path.join(vid, "occlusions", "occlusion_preds_0.npy"))
    assert trajs.shape == (16, T_CARD, 2) and np.isfinite(trajs).all() and occ.shape == (16, T_CARD)
    report = launcher.reports["0"]
    _card_line(whole_system_s=run_s, peak_bytes=torch.cuda.max_memory_allocated(cuda),
               stages={k: v for k, v in report.get("stages", report).items()
                       if k.startswith(("video/", "train/steps"))}
               if isinstance(report, dict) else str(report))
