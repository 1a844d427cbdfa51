"""The ViT-g/14 configuration and what this benchmark reads of the ViT: the
``dt-g14-davis`` file against the program's preset and against
``dt-l14-davis``, the plain SwiGLU reference's widths, and the
``vit_ffn_s.preprocess`` reader on synthetic traces (and on a program
without the span). On the card, the control and the half-batch fault fail
each new training cell's limits at the cell's own size."""

import json
import math
import os

import pytest
import torch

import calibrate
import run

from conftest import PORTBENCH, ROOT
from test_portbench_spans import kernel, launch, reader, record_of, span

from reference import vit_swiglu


def config(name):
    with open(os.path.join(PORTBENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_g14_config_is_l14_with_the_backbone_changed():
    """Every value of dt-g14-davis is dt-l14-davis's but the backbone's and
    what follows from it (DeltaDINO's last width, the layers, the names)."""
    g, l = config("dt-g14-davis"), config("dt-l14-davis")
    assert g["reduced"] == [] and g["frames"] == 50
    assert g["vit"] == {"model": "dinov2_vitg14", "embed_dim": 1536, "depth": 40, "heads": 24,
                        "patch": 14, "stride": 7, "layers": [25, 39], "ffn": "swiglu",
                        "hidden": 4096}
    assert g["delta_channels"] == l["delta_channels"][:-1] + [1536]
    changed = {"train": {"dino_model_name"},
               "preprocess": {"dino_model_name", "mask_dino_model_name", "dino_layer",
                              "mask_dino_layer"}}
    for group in ("train", "preprocess"):
        same = {k for k in l[group] if g[group][k] == l[group][k]}
        assert set(l[group]) - same == changed[group], group
    for k in set(l) - {"name", "source", "reduced", "delta_channels", "vit", "train",
                       "preprocess", "assumed"}:
        assert g[k] == l[k], k
    assert g["train"]["dino_model_name"] == g["preprocess"]["dino_model_name"] == "dinov2_vitg14"
    assert [g["preprocess"]["dino_layer"], g["preprocess"]["mask_dino_layer"]] == g["vit"]["layers"]


def test_g14_config_is_the_programs_preset():
    from dino_tracker_tpu_torch.config import PreprocessConfig, TrainConfig
    from dino_tracker_tpu_torch.models.vit import ViTConfig
    g = config("dt-g14-davis")
    v = ViTConfig.for_model(g["vit"]["model"])
    assert (v.embed_dim, v.depth, v.num_heads, v.patch_size, v.ffn, v.hidden_dim) == tuple(
        g["vit"][k] for k in ("embed_dim", "depth", "heads", "patch", "ffn", "hidden"))
    pre = PreprocessConfig(**g["preprocess"])
    assert [pre.dino_layer, pre.mask_dino_layer] == g["vit"]["layers"]
    assert g["vit"]["layers"][-1] == v.depth - 1
    assert TrainConfig(**g["train"]).dino_embed_dim == g["delta_channels"][-1]
    assert vit_swiglu.hidden_dim(g["vit"]) == vit_swiglu.swiglu_hidden(1536) == 4096


def test_the_vit_ffn_reader():
    """Device time of the kernels launched inside ``vit/ffn`` spans (one
    per block), per traced video; a program without the span reads None."""
    host = [span("preprocess/dino_features", 0, 1000),
            span("vit/attention", 0, 300), span("vit/ffn", 300, 200),
            span("vit/attention", 500, 300), span("vit/ffn", 800, 200),
            launch(10, 1), launch(310, 2), launch(320, 3), launch(510, 4), launch(810, 5)]
    device = [kernel(20, 250, 1), kernel(330, 40, 2), kernel(380, 60, 3),
              kernel(600, 150, 4), kernel(900, 90, 5)]
    read = reader("vit_ffn_s.preprocess").read
    assert read(record_of([(host, device)])) == pytest.approx(190e-6)
    assert read(record_of([(host, device), (host, device)])) == pytest.approx(190e-6)
    parent = [e for e in host if e["name"] not in ("vit/attention", "vit/ffn")]
    assert read(record_of([(parent, device)])) is None
    assert read(record_of([(host, device)], card=False)) is None
    assert read({}) is None


def test_the_new_cells_are_listed_where_they_report():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    listed = {m["name"]: m.get("workloads") for m in b["end_to_end"] + b["per_layer"]}
    for cell in ("dt-g14-davis.train-on", "dt-l14-davis.train-off"):
        assert cell in listed["train_ms_per_iter"] and cell not in listed["preprocess_s_per_video"]
    assert "dt-l14-davis.train-off" not in listed["step_cycle_ms.train"]
    assert listed["vit_ffn_s.preprocess"] == ["dt-l14-davis.preprocess-t8"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dt-g14-davis.train-on", "dt-l14-davis.train-off"])
def test_the_new_cells_control_fails_their_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the card")
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    limits = run.load_json(run.resolve(bench, cell)["limits_path"])
    for seed in (101, 102, 103):
        r = calibrate.readings(bench, cell, seed, "cuda:0")
        assert all(math.isfinite(r["program"][k]) and r["program"][k] <= v
                   for k, v in limits.items()), r
        assert not all(r["control"][k] <= v for k, v in limits.items()), r
        assert not all(r["half_batch"][k] <= v for k, v in limits.items()), r
