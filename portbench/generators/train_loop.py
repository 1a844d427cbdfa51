"""Traffic generator for test-time training: a closed loop of train steps, back
to back, through the program's own loop (``training.train.StepRunner``), as
``Trainer.train`` runs them.

Set-up builds one runner (model, Adam and its schedule, the step's
generator) from the seed's weights and data, and drives it through the
cell's first ``checked_steps`` steps with ``StepRunner.run``, one step a
call: the first is the warm-up step of the capture, the rest are replays.
It keeps each step's total loss, the first gradient as Adam holds it
(exp_avg / (1 − β1) after one step) and the parameters after the last. The
window then runs chunks of ``next_chunk`` steps from ``start_iteration``
with the metrics read every ``log_interval`` steps, until ``--seconds`` have
passed; the last chunk runs to its end, and every step and second of the
window counts. A traced run then profiles a few short stretches of steps.
Once the program's state is freed, the plain reference follows the checked
steps from the same weights, data and seed.

The traffic file holds: ``gates`` (cycle, refined_bb), ``start_iteration``,
``log_interval``, ``checked_steps``, ``trace_stretches`` and
``trace_steps``.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from reference import train_step as reference  # noqa: E402
from yardstick import compare, counts, trace as trace_lib, train_data  # noqa: E402

def _sizes(cfg: dict) -> dict:
    fh = 1 + (cfg["height"] - cfg["vit"]["patch"]) // cfg["vit"]["stride"]
    fw = 1 + (cfg["width"] - cfg["vit"]["patch"]) // cfg["vit"]["stride"]
    return {"frames": cfg["frames"], "height": cfg["height"], "width": cfg["width"],
            "channels": cfg["delta_channels"][-1], "feat_hw": (fh, fw), **cfg["data"]}


def k1_shapes(cfg: dict):
    """The N×H×W×C inputs of the step's three blurpools."""
    frames = 2 * cfg["train"]["batch_n_frames"]
    h, w, out = cfg["height"], cfg["width"], []
    for c in cfg["delta_channels"][1:4]:
        out.append([frames, h, w, c])
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def _program_data(raw: dict):
    from dino_tracker_tpu_torch.structures import BBData
    from dino_tracker_tpu_torch.training.sampler import TrajectoryBank
    from dino_tracker_tpu_torch.training.train import VideoData
    bb = BBData(raw["bb_source_coords"], raw["bb_target_coords"], raw["bb_cos_sims"],
                raw["bb_r"], raw["bb_valid"])
    banks = [TrajectoryBank(raw[f"{s}_coords"], raw[f"{s}_valid"], raw[f"{s}_coords"].shape[0])
             for s in ("fg", "bg")]
    return VideoData(raw["video"], raw["dino"], raw["masks"], bb, *banks)


def setup(ctx, mesh=None) -> SimpleNamespace:
    """The cell's set-up: data and weights from the seed, one runner (on
    this rank of ``mesh``), and the checked steps through ``StepRunner.run``
    with what they left (on a mesh the losses summed over the ranks)."""
    import torch
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.models.tracker import Tracker
    from dino_tracker_tpu_torch.training import train

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    s = SimpleNamespace(train=train, traffic=traffic, dev=dev, train_json=cfg["train"],
                        mesh=mesh)
    s.cfg = TrainConfig(**cfg["train"])
    s.tcfg = TrackerConfig(video_h=cfg["height"], video_w=cfg["width"],
                           dino_patch_size=cfg["vit"]["patch"], stride=cfg["vit"]["stride"],
                           delta_channels=tuple(cfg["delta_channels"]),
                           compute_dtype=s.cfg.compute_dtype)
    s.gates = (traffic["gates"]["cycle"], traffic["gates"]["refined_bb"])
    s.raw = train_data.make_train_data(_sizes(cfg), ctx.seed, dev)
    s.weights = train_data.make_weights(cfg["delta_channels"], ctx.seed, dev)
    s.data = _program_data(s.raw)
    model = Tracker(s.tcfg).to(dev)
    model.load_state_dict(s.weights)
    model.train()
    opt, sched = train.make_optimizer(model, s.cfg)
    sched.load_state_dict({"last_epoch": traffic["start_iteration"]})
    s.step_seed = train_data.derived_seed(ctx.seed, 3)
    gen = torch.Generator(device=dev).manual_seed(s.step_seed)
    s.runner = train.StepRunner(model, opt, sched, gen, s.cfg, s.tcfg, mesh)
    names = {p: n for n, p in model.named_parameters()}
    beta1 = opt.param_groups[0]["betas"][0]
    metrics, first_grads = [], None
    for k in range(traffic["checked_steps"]):
        s.runner.run(s.data, *s.gates, 1)
        metrics.append({n: v.clone() for n, v in
                        train.reduce_metrics(s.runner.take_metrics(), mesh).items()})
        if k == 0:
            first_grads = {names[p]: st["exp_avg"] / (1 - beta1) for p, st in opt.state.items()}
    s.program = {"losses": [float(m["loss_total"]) for m in metrics],
                 "terms": [{n: float(v) for n, v in m.items() if n != "loss_total"}
                           for m in metrics],
                 "first_grads": first_grads,
                 "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    _fence(dev)
    return s


def window(ctx, s):
    """Chunks of steps back to back until ``ctx.seconds`` have passed ->
    (steps, seconds, steps in a metrics read that was not finite). On a
    mesh rank 0 decides after each chunk whether another follows, so every
    rank takes the same steps; each rank times its own window."""
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    train, traffic = s.train, s.traffic
    i = traffic["start_iteration"] + traffic["checked_steps"]
    steps = failed = since_log = 0
    mesh_lib.barrier(s.mesh)
    _fence(s.dev)
    t0 = time.perf_counter()
    prev = None
    while True:
        n = train.next_chunk(s.cfg, i, traffic["log_interval"])
        s.runner.run(s.data, *s.gates, n)
        i, steps, since_log = i + n, steps + n, since_log + n
        if i % traffic["log_interval"] == 0:
            failed += _unfinite(s, since_log)
            since_log = 0
        done = _event(s.dev)
        if prev is not None:
            prev.synchronize()
        stop = time.perf_counter() - t0 >= ctx.seconds or i >= s.cfg.total_iterations
        if mesh_lib.broadcast_object(stop, s.mesh):
            break
        prev = done
    _fence(s.dev)
    seconds = time.perf_counter() - t0
    return steps, seconds, failed + _unfinite(s, since_log)


def free_program(s):
    """Drop the runner, its graph, model and optimizer (the data stays)."""
    import torch
    s.runner.release()
    del s.runner, s.data
    gc.collect()
    if s.dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_run(s, precision="bfloat16", half_batch=False) -> dict:
    """The plain reference through the checked steps from the same weights,
    data and seed, on one device (``precision``, ``half_batch``: the
    control and a planted fault)."""
    import torch
    return reference.train_steps(
        s.weights, s.raw, _counts(s.raw), s.train_json,
        torch.Generator(device=s.dev).manual_seed(s.step_seed), *s.gates,
        n_steps=s.traffic["checked_steps"], start=s.traffic["start_iteration"],
        precision=precision, half_batch=half_batch)


def measure(ctx, mesh=None) -> dict:
    """Set-up, the window, a traced run's stretches, then (on rank 0) the
    reference's check, on this rank of ``mesh``."""
    import torch
    if getattr(ctx, "plant", None) is not None:  # a test's fault, planted in this process
        ctx.plant()
    s = setup(ctx, mesh)
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.barrier(mesh)
    setup_s = time.time() - ctx.t_start_wall
    steps, seconds, failed = window(ctx, s)
    cfg = ctx.config
    record = {"card": s.dev.type == "cuda", "step_s": seconds / steps,
              "k1_shapes": k1_shapes(cfg),
              "flops_per_step": counts.train_step_flops(
                  cfg["train"], (cfg["height"], cfg["width"]), _sizes(cfg)["feat_hw"],
                  cfg["delta_channels"], *s.gates)}
    summary = None
    if ctx.trace:
        summary = trace_lib.TraceSummary()
        n = s.traffic["trace_steps"]
        for _ in range(s.traffic["trace_stretches"]):
            mesh_lib.barrier(mesh)
            trace_lib.profile(lambda: s.runner.run(s.data, *s.gates, n), ctx.tmpdir, summary)
        record.update(trace=summary, traced_steps=s.traffic["trace_stretches"] * n)
    peak = _peak(s.dev)
    free_program(s)
    readings = None
    if mesh_lib.is_main(mesh):
        t_ref = time.perf_counter()
        readings = compare.train_readings(s.program, reference_run(s), s.weights)
        readings["where"]["reference_s"] = time.perf_counter() - t_ref
    mesh_lib.barrier(mesh)
    return {"setup_s": setup_s, "steps": steps, "seconds": seconds, "failed": failed,
            "readings": readings, "memory_peak_bytes": peak, "record": record,
            "modules": sorted({n.split(".")[0] for n in list(sys.modules)})}


def _rank(mesh, ctx):
    ctx.device = mesh.device
    return measure(ctx, mesh)


def run(ctx) -> dict:
    """The cell's run; on a mesh, each rank's loaded top-level module names
    under ``modules``, for the harness's check."""
    ranks = ctx.ranks
    if ranks == 1:
        outs = [measure(ctx)]
    else:
        from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
        outs = mesh_lib.spawn(_rank, ranks, ctx.device.type, args=(ctx,))
    main = outs[0]
    steps, seconds = main["steps"], max(o["seconds"] for o in outs)  # the slowest rank
    record = dict(main["record"], step_s=seconds / steps)
    if ranks > 1:
        record["ranks"] = [o["record"] for o in outs]
        record["world"] = ranks
    trace = None
    if ctx.trace:
        summaries = [o["record"]["trace"] for o in outs]
        trace = SimpleNamespace(busy_s=sum(t.busy_s for t in summaries) / ranks,
                                window_s=sum(t.window_s for t in summaries) / ranks,
                                breakdown=summaries[0].breakdown)
    return {"metrics": {"train_ms_per_iter": 1e3 * seconds / steps},
            "setup_s": main["setup_s"], "attempted": steps,
            "failed": max(o["failed"] for o in outs), "readings": main["readings"],
            "memory_peak_bytes": max(o["memory_peak_bytes"] for o in outs), "record": record,
            "trace": trace,
            "modules": {f"rank {r}": o["modules"] for r, o in enumerate(outs)} if ranks > 1 else {}}


def _unfinite(s, steps):
    """``steps`` if the metrics summed since the last read (over the mesh's
    ranks) are not all finite, else 0 (reads them back: a host sync)."""
    sums = s.train.reduce_metrics(s.runner.take_metrics(), s.mesh)
    return 0 if all(math.isfinite(float(v)) for v in sums.values()) else steps


def _peak(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _counts(raw):
    return raw["fg_coords"].shape[0], raw["bg_coords"].shape[0]


def _fence(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Done:
    def synchronize(self):
        pass


def _event(dev):
    """An event after the work queued so far (the CPU's work is done)."""
    import torch
    if dev.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def calibrate(ctx, mesh=None, faults=None, program_faults=()) -> dict:
    """One seed's readings against the reference (on rank 0 of ``mesh``):
    the program's checked steps, the control, each fault planted in the
    reference put in the program's place (``faults``, default the half
    batch) and each of ``faults.PROGRAM_FAULTS`` named in
    ``program_faults``, planted in the program (and mended) after the
    sound readings."""
    import faults as faults_lib
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    main = mesh_lib.is_main(mesh)
    s = setup(ctx, mesh)
    free_program(s)
    out = {"seed": ctx.seed}
    if main:
        ref = reference_run(s)
        out["program"] = compare.train_readings(s.program, ref, s.weights)
        out["control"] = compare.train_readings(reference_run(s, "float8_e4m3"), ref, s.weights)
        for fault in ("half_batch",) if faults is None else faults:
            out[fault] = compare.train_readings(reference_run(s, **{fault: True}), ref, s.weights)
    for fault in program_faults:
        mend = faults_lib.PROGRAM_FAULTS[fault]()
        try:
            broken = setup(ctx, mesh)
            free_program(broken)
        finally:
            mend()
        if main:
            out[f"program_{fault}"] = compare.train_readings(broken.program, ref, s.weights)
    mesh_lib.barrier(mesh)
    return out
