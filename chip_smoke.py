#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dino_tracker_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --raft-frames 50   # phases 1, 2 (K3) and 8 only, at T=50
    python3 chip_smoke.py --preprocess-frames 50   # phases 1, 2 (K2, K3) and 9 only
    python3 chip_smoke.py --e2e-frames 50 [--e2e-iterations K]   # phases 1, 2 and 11 only
    python3 chip_smoke.py --train-only [--resume-faults]   # phases 1, 2 (K1, K4, K5), 3's
                                             # K4 and K5 checks, 4 and 5 only
    python3 chip_smoke.py --mesh-devices 4   # N >= 2 cards: phases 1, 2, the launches on
                                             # cuda:1, phases 13 and 12 over NCCL
    python3 chip_smoke.py --mesh-devices 4 --preprocess-frames 50   # phases 1, 2 (K2,
                                             # K3) and 13 at T=50 over NCCL
    python3 chip_smoke.py --full-width   # phases 1, 2 and 14 only

Phases, one line or more each (any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles kernels K1 (csrc/blurpool.cu: K1-fwd blurpool_down_nhwc
     and K1-bwd blurpool_up_nhwc), K2 (csrc/flash_attention.cu), K3
     (csrc/corr_lookup.cu), K4 (csrc/tracker_head.cu: K4-fwd head_conv_fwd
     and K4-bwd head_conv_bwd) and K5 (csrc/batchnorm.cu: the refiner's
     BatchNorm + ReLU, K5-fwd and K5-bwd) with nvcc into build/kernels/, one nvcc per
     source, all started together; prints each kernel's registers, shared
     memory and spills as ptxas reports them.
  3. kernel check: K1-fwd against its plain PyTorch version at the three
     DeltaDINO blurpool shapes of a 16-frame refine chunk, and K1-bwd against
     autograd of the plain version at the three shapes of an 8-frame training
     step, bf16 and f32, each shape's time beside its own bound; K2 against
     attention_reference at the ViT stage's shape [4 frames, 16 heads,
     S=8108, 64] in bf16 on contiguous inputs and on the ViT's layout
     (permuted views of one qkv buffer, which it reads without copies), at
     one frame in f32 and at ragged S = 100 and 1000 in both, timed on both
     bf16 layouts, with TFLOP/s and the fraction of its bound; K3 against
     corr_lookup_reference on a pyramid of random 256-channel f32 fmaps for a decode batch of 8
     pairs at 60×107 with coordinates inside, at the edge and far outside
     the maps, timed beside its byte bound and the floor that 32-byte sectors
     put under it; with the error bounds and kernel vs plain (and, for K2,
     F.scaled_dot_product_attention, for K3 four F.grid_sample calls) times
     from CUDA events, and the share of the bound each kernel reaches; K1-fwd
     also alone at the three bf16 shapes of an 8-frame training step; K4-fwd
     and K4-bwd against the plain f32 chain (TF32 off) at the train step's
     head shapes (512, 1024 and 2048 maps of 67×121), each error within 1e-5
     of its terms' summed magnitudes, timed beside its bound, the plain
     version and the head's cuDNN chain (library_ms), and summed over one
     gates-on step's head calls; K5-fwd and K5-bwd at the refiner's four
     layer shapes of an 8-frame train step in bf16, on a cotangent whose
     statistics term is of the size of its direct term: the output bit for
     bit the plain BatchNorm + ReLU chain's (nn.batchnorm_plain), the input
     gradient within 2^-6 of its terms' magnitudes of float64 and summing to
     about 0 over the rows, the parameter gradients within 1e-5; each timed
     beside its byte bound (4 and 10 bytes an element), the chain and
     PyTorch's train-mode F.batch_norm, and summed over a step.
  4. the inference slice at full width: T=50 frames of 854×476, a
     dinov2_vitl14-width (C=1024) feature stack on the 67×121 grid, bf16
     compute, seeded random weights in the JAX package's layout carried over
     by convert.state_from_jax. runtime.make_model_inference refines every
     frame (DeltaDINO through K1-fwd and K5-fwd), then ModelInference.infer serves three
     requests of 256 query points on frames 0, 24 and 49 (every head through
     K4-fwd).
  5. the training slice at full width: the same video and feature stack,
     synthetic fg masks, 100k fg + 100k bg trajectories and padded best
     buddies, all made on the card from a seed; TrainConfig's defaults
     (batch 512 × 4 frames, bf16, cycle 4×256, contrastive 4×256); the port's
     own initialization. The main path: train.train_step runs warm-up steps,
     then 20 timed steps with both phase gates off and 10 with both on (all
     six losses), and one step of each under set_sync_debug_mode("warn"),
     which must make no host sync; then train.Trainer trains 50 iterations
     from its init in chunks of up to 25 (TrainConfig.steps_per_call), each
     chunk replays of the step captured into a CUDA graph
     (training/step_graph.py), with the gates at 20 and a checkpoint at 30,
     so that replays cross a gate, a checkpoint and the schedule's count 40.
     K1-fwd and K1-bwd: the wrappers count 3 launches an eager step
     (a capture's warm-up step included), and torch.profiler traces every
     replay, 5 a trace, and counts the kernels the card ran, 3 each a
     replay; K4-fwd and K4-bwd likewise, 1 and 1 a step with the gates off,
     4 and 2 with them on (HEAD_LAUNCHES); K5-fwd and K5-bwd 4 and 4 a step
     (one a refiner layer), each of K5's four kernels 4 a replay.
     Then, for each set of gates, from one state (30 eager steps from the
     init, restored as a checkpoint is), a chunk of 25 replays against 25
     eager train_steps three times: equal batches and learning rates every
     step (the rate steps down at count 40), each loss term's and each
     parameter's and BN statistic's change at a median L2 distance from the
     eager runs within 4x their own largest distance (index_add's atomics)
     plus 0.1% of the change (0.01% of a loss term; the head's null-gradient
     bias within Adam's 2·lr a step), no host sync in a replayed chunk under
     set_sync_debug_mode("error"), graphed vs eager ms/iter timed in turns
     with their peak memory and 5 steps each under torch.profiler (the
     card's busy share); every run's discrete choices recorded step by step
     (the cycle filter's kept points, the head's hard argmax of every point,
     StepRecorder), and where the graph took one no eager run took, each
     at its threshold within the runs' noise, the parameters and BN
     statistics held to a fourth eager run that takes the graph's choices;
     then a step with an .item() injected must fail capture and
     raise. The Trainer's run R is recorded from before its first capture,
     and its state in memory where it writes state_30.pt (parameters,
     buffers, Adam's state, the schedule, the generator, the banks) must
     equal the file bit for bit. Then state_30.pt resumed
     to 50 three times eagerly (E1-E3) and once in chunks of replays (S),
     each recorded: the final generator state, schedule count and Adam
     steps equal the uninterrupted run's, batches equal at every step, the
     steps where R or S took a choice no eager run took printed, and R's and
     S's parameters and BN statistics within the eager spread of E1-E3, or
     of E_R / E_S (an eager run from the file taking R's or S's recorded
     choices) where they took one. With --resume-faults the check then runs
     from three planted faulty files (Adam's moments zeroed, BN statistics
     reset, the generator of step 29) and must miss each. Then
     runtime.load_model + make_model_inference serve one 256-point request
     from state_50.pt.
  6. the ViT feature stage at full width: seeded random dinov2_vitl14 weights
     (D=1024, 24 blocks, 16 heads) in the DINOv2 layout, made on the card,
     and a synthetic T=50 video at 854×476. PreprocessingPipeline.
     extract_dino_features sweeps layers 15 and 23 once (stride 7, a 67×121
     grid, S=8108 tokens, 4 frames a batch, bf16, every attention through
     K2) and writes the f16 artifacts under build/chip_smoke/vit/; then
     create_fg_masks on the layer-23 features (mask jpgs written) and
     split_trajectories on synthetic trajectories (masks read back, fg/bg
     banks written); then the per-token cosine of bf16 against f32 features
     on one frame (gate: median >= 0.995).
  7. reference: the inference entry points on a small f32 input, one f32
     training step (losses and gradients) on a small input from the same
     init and the same injected batch, a small f32 ViT through
     extract_feature_video and compute_fg_masks, and pipeline stage 1 on 6
     f32 frames of 224×128 plus a RAFT forward with degenerate pyramid
     levels (48×64), each on the GPU and on the CPU (the CPU path is held
     against the JAX package by the tests).
  8. pipeline stage 1 at full width: seeded random RAFT-large weights in the
     princeton-vl layout (the flow head's last conv scaled by 0.1, so flows
     stay sub-pixel and trajectories survive), made on the card and loaded
     by load_raft_state_dict; a synthetic textured T=12 video at 854×476 that
     moves by (1.5, 0.5) px a frame. PreprocessingPipeline.
     extract_trajectories_both (encoders once per frame, adjacent flows,
     both chaining passes over every start frame with its direct flows:
     24 GRU iterations, f32, 8 pairs a decode batch, every lookup through
     K3), with its phase times, the trajectory counts, peak memory and one
     decode batch's time.
  9. the preprocess CLI at full width: T=12 PNG frames of phase 8's video at
     854×476, phase 8's RAFT-large and phase 6's ViT-L/14 weights saved as
     .pth checkpoints, a yaml that sets max_frames; cli.preprocess.main runs
     in this process (stage 1 through K3, the ViT stage through K2, masks,
     split, stage 5), every artifact is checked (the best-buddy one for its
     mirror invariants), and 2 training steps run on the directory through
     DINOTrackerRuntime.load_video_data. Printed: each stage's and phase's
     seconds, the sweep's and the ambiguity pass's TFLOP/s, rows_total, peak
     memory, the ambiguity pass again on every mutual pair (no flow filter,
     the most rows the video can give), one ambiguity slab's product and NMS
     timed apart with its kernel profile, and the artifact's size.
  10. reference: stage 5 on T=6 frames of 224×126 (n=527, C=1024), GPU
     against CPU: the adaptive sweep with the fused filter, a fixed cap of 64,
     of_filter_best_buddies and compute_bb_ambiguity, each disagreement
     allowed only inside a 1e-5 margin of the CPU's products and distances.
  11. the whole system at full width: a dataset root with two videos, 0 and
     1, of T=8 PNG frames at 854×476 (textured_video moving (1.5, 0.5) and
     (-1.0, 0.75) px a frame), phase 9's checkpoints, a train yaml cutting
     training to 40 iterations (both gates and an async checkpoint at 20,
     TrainConfig's full width otherwise) and a benchmark pickle (query
     frames 0 and 5, 64 points each, targets from the known shift, occluded
     where they leave the frame). cli.run_benchmark.main runs preprocess,
     train and inference for both videos in this process (K3 in stage 1, K2
     in the ViT stage, K1-fwd and K1-bwd in every train step, K1-fwd in the
     refine), then cli.eval_benchmark.main writes the CSV. Checked: both
     .done markers, state_40.pt, every prediction's shape and finiteness,
     the CSV against the port's metric functions run again on the saved
     predictions (every metric NaN or in [0, 1]), the exact launch counts,
     and that nothing of a video stays on the card: against the memory
     allocated before video 0 (cuBLAS workspaces cleared), each video leaves
     at most cuBLAS's workspaces and 16 MiB more, and once they are cleared
     after the last video at most 16 MiB more. Reuses phase 9's RAFT and ViT
     checkpoints. Printed per video from the stage timers of utils/profiling
     (fenced): preprocess, train (ms/iter of the steps alone with the gates
     off and on; loading the artifacts, the log, the checkpoints and bank
     rotations apart), the refine and each request, eval, peak memory. With
     --e2e-frames N alone: one video of N frames, K iterations (default
     TrainConfig's 10,000, gates at K/2, checkpoints every K/4), a query
     frame every 5 frames with 256 points each.
  12. multi-device (parallel/mesh.py): first, on the one card and with no
     mesh, phase 5's comparison of 25 replays against 25 eager steps under
     its rule (train_chunks) on phase 11's video 0 directory, with the bf16
     config of its train.yaml and the Trainer's init: the data, config and
     state every NCCL rank below runs its chunks on, printed as phase 5's.
     Then, with two or more cards, K1-fwd,
     K1-bwd, K2 and K3 launched on cuda:1 from this process (cuda:0 current),
     each against its plain version (one card: a line says it did not run).
     Then cli.train and cli.inference_benchmark with --devices 2
     --share-device (two ranks on the one card over gloo) and with --devices
     1, on copies of phase 11's video 0 (T=8 at 854x476, TrainConfig's full
     width, 40 iterations, gates at 20), both inference runs serving the
     2-rank checkpoint; checked: the checkpoints, every rank's exact K1
     launches and its captures and replays (one device: 2 captures, one a
     set of gates, and 38 replays; gloo ranks: every step eager), trajectories
     within 1e-3 px and equal occlusion flags. Then
     both again on a copy of that folder with a truncated state_41.pt beside
     state_40.pt (a kill mid-save): checked that every rank served
     state_40.pt and that the .npy files equal those of the folder without
     the bad file, bit for bit. Then
     the train step on 2 ranks against one device (run twice, for the card's
     own spread): f32 from the Trainer's init (losses 1e-5 relative plus
     1e-7, gradients 1e-4 of each tensor's max, BN statistics 1e-6), bf16
     from seeded non-zero weights (sign and scale: losses 2e-2 of their
     scale, gradients 0.35 of max), replicas bitwise equal after 3 bf16
     steps; the refine's 265.7 MB gather and its backward's all-reduce timed.
     Printed: each rank's ms/iter with the gates off and on, the slowest
     rank's, captures, replays, launches and peak memory, with the card's
     name and power limit. With two or more cards the same again with 2
     ranks over NCCL, one card each (one card: a line says the NCCL capture
     did not run). Over NCCL each rank of cli.train captures its whole
     data-parallel step (collectives included) once a set of gates and
     replays it (2 captures, 38 replays a rank); then on every rank, from one
     state at count 30, phase 5's comparison of 25 replays against 25 eager
     mesh steps three times under its rule (train_chunks: the whole step's
     discrete choices judged from every rank's share, and where the graph
     took one no eager run took, every rank held to its eager G), the
     replicas' parameters and BN statistics bitwise equal after the replays
     and after G (a hash each), K1-fwd and K1-bwd 3 each a replay in a
     5-step trace, and, in turns, replayed and eager ms/iter, the busy share,
     NCCL's share of the device time and the busy share without NCCL under
     the profiler,
     the capture's time and peak memory, for every rank and the slowest;
     then, in processes of their own, a capture that fails on rank 1 alone
     after the forward's collectives (an .item() injected there) must raise
     on every rank before any replay, and every rank's process must end. With --mesh-devices N alone: N ranks, one card each, over NCCL,
     on the directory phase 13 preprocessed with N ranks.
  13. multi-device preprocessing: cli.preprocess with --devices 2
     --share-device and with --devices 1 on two copies of phase 11's video
     0's frames (T=8 at 854x476, ViT-L/14 at stride 7, RAFT-large with 24
     iterations in f32, phase 9's checkpoints): each rank runs its share of
     the ViT's frame batches (K2), of the decode batches (K3), of the
     closest grids' frames, of the best-buddy pair batches and of the
     ambiguity slabs, every batch whole; rank 0 writes. Checked: every
     artifact of the two runs (trajectories of both passes, fg/bg banks,
     mask jpgs' bytes, best-buddy coordinates, cosines, validity and
     telemetry equal; f16 features within 1e-5 of max, r within 1e-5), each
     rank's K2 and K3 launches against its share, every decode at 8 pairs.
     Printed: each rank's stage seconds, launches, decode batch sizes, peak
     memory and gathers (bytes and seconds), each stage at W=2 (rank 0 and
     slowest rank) beside W=1, with the card's name and power limit. Over
     gloo on one card the gathers go through host memory: an equality
     check, not a speed path. With --mesh-devices N: N ranks over NCCL, one
     card each (T=8, or --preprocess-frames T).
  14. full width against the JAX package: for each stage of the goldens in
     tests/fixtures/full_width/ (made by scripts/gen_full_width_golden.py
     from the JAX package on a CPU), its inputs are rebuilt from the
     golden's seed by scripts/full_width_inputs.py (numpy alone) and their
     sha256 digests checked against the golden's, then run through the
     port's entry points: a. load_dinov2_state_dict, build_vit and
     extract_feature_video (dinov2_vitl14, 2 frames of 854×476, layers 15
     and 23, f32 and bf16: K2's f32 and bf16 kernels); b. load_raft_state_dict
     and the RaftFlowEngine's decode of 2 pairs in its 8-pair batch (24
     iterations, f32: K3); c. convert.state_from_jax, train.step_losses and
     backward at TrainConfig's widths on the golden's injected batch, both
     sets of gates, f32 and bf16 (K1-fwd, K1-bwd); d. runtime.
     make_model_inference (T=20, refine chunks of 16: K1-fwd) and one
     256-point ModelInference.infer, f32 and bf16; e. extract_best_buddies
     with the fused flow filter, closest_trajectory_grids and
     compute_bb_ambiguity (T=4, C=1024, 12,000 trajectories); f.
     extract_trajectories_dual on T=8 synthetic flows at 854×476 with their
     direct flows (both passes, the native look-behind occupancy), each
     start's keep masks, and the port's float64 recomputation of every
     chain (the pixels within 1e-3 px of a threshold, counted). Each stage is
     held to the golden under the tolerances it records (full_width_inputs.
     TOLERANCES); the largest error of each kind is printed beside its
     bound, with the stage's seconds; any miss raises.
Each main path (phases 4, 5, 6, 8, 9, 11, 12, 13, 14) runs with every kernel's
launch count set to 0 just before it and read just after (the ranks of
phases 12 and 13 start from 0 in their own processes and report their
counts). ops/_guard.py counts each launch a wrapper makes (K5 its wrapper
calls); the replays of a captured train step run no wrapper, and phase 5
(and phase 12's train chunks on each NCCL rank) counts the K1 (and, on one
card, K4) kernels they run from a trace of the card (phases 11 and 12 leave
the CLIs' replays untraced, so their timers are not the profiler's). Then
one JSON line with the kernels (K2 and K3 counted over phases 6 + 9 + 11 +
13 + 14 and 8 + 9 + 11 + 13 + 14, K1 over 4 + 5 + 11 + 12 + 14, K4 over
4 + 5), and last {"ok": true, "device": ...}.

The feature stack is a static scene plus per-frame noise, so a query's own
cell is the correlation peak in every frame and tracks stay near the query.
Imports no JAX, none of the JAX package's modules, and none of PyYAML,
imageio or msgpack; Pillow for the PNG frames of phases 9 and 11 and the
pipeline's mask jpgs; PyYAML only through the CLIs' configs.
"""

import argparse
import contextlib
import copy
import dataclasses
import faulthandler
import gc
import importlib
import json
import math
import os
import pickle
import shutil
import subprocess
import time
import traceback
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

T, H, W = 50, 476, 854
CHANNELS = (3, 64, 128, 256, 1024)
QUERY_FRAMES = (0, 24, 49)
N_QUERIES = 256
# the head's argmax radius (35 px) plus one feature cell (7 px) rounded up
SELF_TRACK_PX = 50.0
REAL_SHAPES = [(16, 476, 854, 64), (16, 238, 427, 128), (16, 119, 214, 256)]
# the three DeltaDINO blurpool inputs of a training step (8-frame set)
TRAIN_SHAPES = [(8, 476, 854, 64), (8, 238, 427, 128), (8, 119, 214, 256)]
# the refiner's four BN inputs in an 8-frame train step (K5), and the bytes an
# element K5 moves at least, bf16: K5-fwd reads x and writes y, K5-bwd reads
# g and x twice each and writes gx
BN_SHAPES = TRAIN_SHAPES + [(8, 60, 107, 1024)]
BN_FWD_BYTES, BN_BWD_BYTES = 4, 10
# TrainConfig defaults for the occlusion rule
ANCHOR_COS, COS = 0.7, 0.6
N_FG_TRAJ = N_BG_TRAJ = 100_000
BB_CAP = 512
WARMUP_STEPS, OFF_STEPS, ON_STEPS = 3, 20, 10
# phase 5's chunks: TrainConfig.steps_per_call steps; each loss term,
# parameter and BN statistic of the graph may lie from three eager runs (the
# median of its L2 distances) by this factor times their own largest distance
# between two of them, plus a floor
CHUNK_STEPS, CHUNK_TOL_FACTOR = 25, 4.0
# the floors, shares of a loss term's values and of a tensor's change: bf16
# rounding that differs between runs grows over the steps, and three eager
# runs can happen to agree on a loss term or a tensor far closer than a
# fourth run does (to 1e-7 of a loss term; the head's normalised convs, whose
# kernels' scale is a null direction); a step too many or too few moves every
# change by ~4%
CHUNK_LOSS_FLOOR, CHUNK_CHANGE_FLOOR = 1e-4, 1e-3
# the loss terms the cycle filter's kept points enter: a point at the filter's
# 4 px threshold lands on either side in two valid runs and moves them at that
# step by about 1/n of the cycle term (n points kept); ``cycle_flips``
CYCLE_TERMS = ("loss_cyc", "loss_total")
# the head's calls in a train step, in order (StepRecorder), each with the
# share of its points whose query is one of the step's draws (the rest are
# predictions of the same step): the flow term's batch, the cycle filter's
# source -> target and target -> source, the cycle loss's sources then
# targets; the head's tensors whose gradient norms a recorder keeps
HEAD_CALLS = (("flow", 1.0), ("cycle filter forward", 1.0), ("cycle filter backward", 0.0),
              ("cycle loss", 0.5))
HEAD_TENSORS = ("tracker_head.conv1.weight", "tracker_head.conv1.bias",
                "tracker_head.conv2.weight", "tracker_head.conv2.bias")
RECORDED = ("frames", "src", "tgt", "losses", "lrs", "drawn", "kept", "dists", "argmax",
            "top", "drawn_query", "head_grads")
# the compared chunks start at this schedule count, so they cross
# apply_scheduler_every = 40
CHUNK_START = 30
# phase 5's Trainer run: iterations, gates, a checkpoint and logs, so that its
# chunks of replays cross a gate, a checkpoint and the schedule's count 40
TRAINER_ITERATIONS, TRAINER_GATES, TRAINER_CHECKPOINT, TRAINER_LOG = 50, 20, 30, 25
# K1-fwd and K1-bwd as a trace of the card names them (csrc/blurpool.cu);
# train steps a torch.profiler trace holds (a 25-step trace of the step with
# the gates on lost kernels: the counts are checked)
K1_KERNELS = ("blurpool_down_kernel", "blurpool_up_kernel")
TRACE_STEPS = 5
# K4-fwd and K4-bwd as a trace of the card names them (csrc/tracker_head.cu),
# and their launches a train step with the gates off / on: the flow term's
# head; then also the cycle filter's two (no gradient) and the cycle loss's
# one, which takes a backward as the flow term's does
K4_KERNELS = ("head_conv_fwd_kernel", "head_conv_bwd_kernel")
# K5's kernels as a trace of the card names them (csrc/batchnorm.cu): K5-fwd,
# then K5-bwd's sums, their block-ordered reduction and the input gradient;
# each runs once a refiner layer a train step
K5_KERNELS = ("bn_apply_kernel", "bn_grad_sums_kernel", "bn_reduce_kernel",
              "bn_grad_apply_kernel")
BN_LAYERS = len(BN_SHAPES)
HEAD_LAUNCHES = {False: (1, 1), True: (len(HEAD_CALLS), 2)}
# the head's maps in a train step with the gates on, on the 67×121 grid:
# (maps a call, forward calls, backward calls) for the flow term's batch, a
# cycle-filter prediction and the cycle loss's sources and targets
HEAD_MAPS = ((512, 1, 1), (1024, 2, 0), (2048, 1, 1))
# FLOP a pixel: conv1 and conv2, 144 FMAs each, forward; backward conv1
# again, conv2's transpose, conv1's transpose and both weight gradients
HEAD_FWD_FLOP, HEAD_BWD_FLOP = 2 * 2 * 144, 5 * 2 * 144
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO_DIR, "build", "chip_smoke")
# phase 14's goldens, made by scripts/gen_full_width_golden.py
GOLDEN_DIR = os.path.join(REPO_DIR, "tests", "fixtures", "full_width")
# K2 on the ViT feature stage's main path: 4 frames a batch × 16 heads,
# 67·121 tokens + cls, head dim 64, bf16
ATTN_SHAPE = (4, 16, 8108, 64)
ATTN_SCALE = 1.0 / math.sqrt(ATTN_SHAPE[-1])
# K2's bf16 bound, in units of the reference output's largest magnitude
BF16_ATTN_TOL = 2.0 ** -6
N_SPLIT_TRAJ = 100_000
# published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12
# K3 on stage 1's main path: a decode batch of 8 pairs on the 60×107 grid of
# 854×476 frames padded to 856×480; bound of K3 against its plain version,
# in units of the plain output's largest magnitude
RAFT_T = 12
LOOKUP_SHAPE = (8, 60, 107)
LOOKUP_TOL = 1e-5
# RAFT flows, GPU against CPU, in units of max|flow|; trajectories chained
# from the same flows on both, in px
FLOW_TOL, TRAJ_TOL = 1e-4, 1e-4
# the preprocess CLI's frames at full width; the best-buddy GPU-vs-CPU margin
PREPROCESS_T = 12
BB_MARGIN = 1e-5
# the whole system (phase 11): two videos of T frames moving by different
# shifts, training cut to 40 iterations (gates and a checkpoint at 20), 64
# points on each query frame; the device memory left allocated after a video
# may exceed what was allocated before the first (cuBLAS workspaces aside) by
# at most E2E_MEMORY_MARGIN bytes (a trained DeltaDINO with its Adam moments
# is ~80 MB)
E2E_T, E2E_ITERATIONS, E2E_POINTS = 8, 40, 64
E2E_QUERY_FRAMES = (0, 5)
E2E_SHIFTS = ((1.5, 0.5), (-1.0, 0.75))
E2E_MEMORY_MARGIN = 16 * 2**20
# steps timed for each bank size by probe_train_banks
PROBE_STEPS = 20
# phase 12: ranks of the default run (sharing the one card), the step's
# equality gates against one device (loss rtol, gradient share of each
# tensor's max; bf16: the sign-and-scale rule), the null gradient, the
# inference bound and the bf16 steps after which ranks must be equal
MESH_RANKS = 2
MESH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 0.35)}
MESH_NULL_GRADS = {"tracker_head.conv2.bias"}
MESH_PX_TOL = 1e-3
MESH_REPLICA_STEPS = 3
MESH_TIMED_STEPS = 5  # warm bf16 steps timed under each set of gates
# seconds after which a rank in phase 12's train chunks prints its Python
# stack, and every as many seconds again, until the chunks end
MESH_STACK_DUMP_S = 180
# the capture that fails on rank 1: the ranks' time limit (under a minute
# needed); a rank still running at half of it prints its stack
MESH_FAILURE_TIMEOUT_S = 150
# phase 13: f16 features and r of --devices N against --devices 1, in units
# of the features' largest magnitude and absolute
MESH_PRE_TOL = 1e-5


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound(flops, nbytes, peak_flops):
    """(least ms for the work, "operations" or "bytes", whichever bounds)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def reset_counts():
    """Set every kernel's launch count, and the train step's captures and
    replays, to 0."""
    from dino_tracker_tpu_torch.ops import _guard
    from dino_tracker_tpu_torch.training.step_graph import StepGraph
    _guard.reset_counts()
    StepGraph.captures = StepGraph.replays = 0


def counted(*kernels):
    """The launch counts of the named kernels since the last reset."""
    from dino_tracker_tpu_torch.ops import _guard
    counts = _guard.launch_counts()
    return tuple(counts[k] for k in kernels)


def fence(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(y: torch.Tensor) -> float:
    return float(2.0 ** (np.floor(np.log2(y.abs().max().item())) - 7))


def make_inputs(t, h, w, c, feat_hw, device, seed):
    """Video T×3×H×W in [0,1] and an f16 T×C×h'×w' feature stack: a static
    per-position pattern plus per-frame noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    video = torch.rand((t, 3, h, w), generator=g, device=device)
    pos = torch.randn((1, c, *feat_hw), generator=g, device=device) * 3
    noise = torch.randn((t, c, *feat_hw), generator=g, device=device) * 0.6
    return video, (pos + noise).half()


def queries(rng, n, frame, h, w):
    return np.stack([rng.random(n) * (w - 1), rng.random(n) * (h - 1),
                     np.full(n, frame)], -1).astype(np.float32)


def build_model(params, stats, tcfg, device):
    from dino_tracker_tpu_torch import convert
    from dino_tracker_tpu_torch.models.tracker import Tracker
    model = Tracker(tcfg)
    model.load_state_dict(convert.state_from_jax(params, stats))
    return model.to(device)


def blurpool_bound(shapes, itemsize=2):
    """Summed bound of one blurpool (either direction) per N×H×W×C input
    shape: the full-size and the half-size tensor each moved once; 16 f32
    FMAs per half-size value."""
    flops = nbytes = 0.0
    for n, h, w, c in shapes:
        small = n * ((h + 1) // 2) * ((w + 1) // 2) * c
        flops += 32.0 * small
        nbytes += (n * h * w * c + small) * itemsize
    ms, by = bound(flops, nbytes, F32_FLOPS)
    return {"bound_ms": ms, "bound_by": by, "library_ms": None}


def phase_kernel_check(bp, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for shape in REAL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            y = bp.blurpool_cuda(x)
            ref = bp.blurpool_reference(x)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            bound = bf16_ulp(ref.float()) if dtype == torch.bfloat16 else 1e-5
            check(y.shape == ref.shape and err <= bound,
                  f"K1 {shape} {dtype}: max abs err {err} > bound {bound}")
            k = cuda_ms(lambda: bp.blurpool_cuda(x))
            p = cuda_ms(lambda: bp.blurpool_reference(x))
            print(f"kernel check: K1 {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3g} (bound {bound:.3g}), kernel {k:.3f} ms, "
                  f"plain {p:.3f} ms", flush=True)
            if dtype == torch.bfloat16:  # the main path's dtype
                worst = max(worst, err)
                ms += k
                plain_ms += p
            del x, y, ref
    for shape in TRAIN_SHAPES:  # the training step's three inputs, bf16
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        y = bp.blurpool_cuda(x)
        ref = bp.blurpool_reference(x)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        bound = bf16_ulp(ref.float())
        check(y.shape == ref.shape and err <= bound,
              f"K1 {shape} bf16: max abs err {err} > bound {bound}")
        k = cuda_ms(lambda: bp.blurpool_cuda(x))
        least = blurpool_bound([shape])["bound_ms"]
        print(f"kernel check: K1 {shape} bf16 (training step): max_abs_err {err:.3g} "
              f"(bound {bound:.3g}), kernel {k:.4f} ms, its bound {least:.4f} ms (bytes; "
              f"{least / k:.3f} of it), (ms - bound) x 10,000 launches = "
              f"{(k - least) * 10:.3f} s", flush=True)
        del x, y, ref
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **blurpool_bound(REAL_SHAPES)}


def phase_kernel_bwd_check(bp, dev):
    """K1-bwd against the plain backward (autograd of blurpool_reference) on
    the same cotangent; plain ms times that backward alone."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for shape in TRAIN_SHAPES:
        n, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device=dev).to(dtype).requires_grad_(True)
            y = bp.blurpool_reference(x)
            gy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
            ref = torch.autograd.grad(y, x, gy, retain_graph=True)[0]
            gx = bp.blurpool_cuda_bwd(gy, h, w)
            torch.cuda.synchronize()
            err = (gx.float() - ref.float()).abs().max().item()
            bound = bf16_ulp(ref.float()) if dtype == torch.bfloat16 else 1e-5
            check(gx.shape == ref.shape and err <= bound,
                  f"K1-bwd {shape} {dtype}: max abs err {err} > bound {bound}")
            k = cuda_ms(lambda: bp.blurpool_cuda_bwd(gy, h, w))
            p = cuda_ms(lambda: torch.autograd.grad(y, x, gy, retain_graph=True))
            least = blurpool_bound([shape], gy.element_size())["bound_ms"]
            print(f"kernel check: K1-bwd {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3g} (bound {bound:.3g}), kernel {k:.4f} ms, its bound "
                  f"{least:.4f} ms (bytes; {least / k:.3f} of it), plain {p:.3f} ms",
                  flush=True)
            if dtype == torch.bfloat16:  # the training step's dtype
                worst = max(worst, err)
                ms += k
                plain_ms += p
            del x, y, gy, ref, gx
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **blurpool_bound(TRAIN_SHAPES)}


def phase_head_check(dev):
    """K4-fwd and K4-bwd against the plain chain in float64 (autograd for the
    backward) at the train step's head shapes, on dyadic data: maps on a 1/32
    grid, a third of them 0 as after a ReLU, a cotangent on a 1/64 grid that
    sums to zero on each map as a softmax's does, kernels on a 1/8 grid whose
    taps sum to 1 as normalised ones do. Every pre-activation is then exact
    in f32, so both sides take the same ReLU branches (at real-valued inputs
    a pre-activation within a rounding of zero takes either, and moves g_x by
    a whole term). Each error is held to 1e-5 of the summed magnitudes of the
    terms it adds (the plain version on |x|, |weights|, |g_y|; for g_b2 an
    absolute bound against the cotangent's scale). Timed beside its bound (HEAD_*_FLOP
    over the f32 peak against 8 or 12 bytes a pixel over the bandwidth, the
    larger), the plain version (``head_conv_reference``: NCHW cuDNN convs)
    and, as ``library_ms``, the chain the train step ran before K4 (the
    head's NHWC ``normalized_conv2d`` calls). Returns K4-fwd's and K4-bwd's
    rows for the kernels' line, summed over one gates-on step's calls."""
    from dino_tracker_tpu_torch.models import tracker_head as th
    from dino_tracker_tpu_torch.ops import head_conv as hc
    from dino_tracker_tpu_torch.config import TrackerConfig
    hp, wp = TrackerConfig(video_h=H, video_w=W).feat_hw
    g = torch.Generator(device=dev).manual_seed(4)

    def eighths(*shape, lo=-2, hi=3):
        return torch.randint(lo, hi, shape, generator=g, device=dev) / 8

    head = th.TrackerHead().to(dev)
    with torch.no_grad():
        for conv in (head.conv1, head.conv2):
            k = eighths(hc.HIDDEN, 9)
            k[:, 4] += 1 - k.sum(1)  # the taps sum to 1: the normalisation divides by 1
            conv.weight.copy_(k.reshape(conv.weight.shape))
            conv.bias.copy_(eighths(*conv.bias.shape, lo=-4, hi=5))
    ws = [t.detach().contiguous() for t in (th.normalized_weight(head.conv1), head.conv1.bias,
                                            th.normalized_weight(head.conv2), head.conv2.bias)]
    step = {d: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "flop": 0.0, "bytes": 0.0} for d in ("fwd", "bwd")}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b, n_fwd, n_bwd in HEAD_MAPS:
            x = torch.randint(-10, 32, (b, hp, wp), generator=g, device=dev).clamp_min(0) / 32
            a = torch.randint(0, 16, (b, hp * wp), generator=g, device=dev)
            gy = ((a - a.roll(1, 1)) / 64).reshape(b, hp, wp)
            got = (hc.head_conv_cuda(x, *ws), *hc.head_conv_cuda_bwd(x, gy, *ws[:3]))

            def plain_grads(xx, gg, wws):
                xx = xx.detach().requires_grad_(True)
                wws = [w.detach().requires_grad_(True) for w in wws]
                y = hc.head_conv_reference(xx, *wws)
                return (y.detach(), *torch.autograd.grad(y, [xx, *wws], gg))

            ref = plain_grads(x.double(), gy.double(), [w.double() for w in ws])
            mag = plain_grads(x.double().abs(), gy.double().abs(),
                              [w.double().abs() for w in ws])
            torch.cuda.synchronize()
            errs = [((a.double() - r).abs() / m.clamp_min(1e-300)).max().item()
                    for a, r, m in zip(got, ref, mag)]
            check(max(errs) <= 1e-5, f"K4 {b}x{hp}x{wp}: errors over the terms' magnitudes "
                  f"(logits, g_x, g_w1n, g_b1, g_w2n, g_b2) {errs} > 1e-5")

            xr = x.clone().requires_grad_(True)
            wr = [w.clone().requires_grad_(True) for w in ws]
            y_plain = hc.head_conv_reference(xr, *wr)
            cost = x[:, None].clone().requires_grad_(True)
            feats = torch.relu(th.normalized_conv2d(cost.permute(0, 2, 3, 1), head.conv1))
            y_lib = th.normalized_conv2d(feats, head.conv2)
            gy_lib = gy[..., None]
            pixels = b * hp * wp
            for d, n, kernel, plain, library, flop, nbytes in (
                    ("fwd", n_fwd, lambda: hc.head_conv_cuda(x, *ws),
                     lambda: hc.head_conv_reference(x, *ws),
                     lambda: th.normalized_conv2d(torch.relu(th.normalized_conv2d(
                         x[..., None], head.conv1)), head.conv2),
                     HEAD_FWD_FLOP, 8),
                    ("bwd", n_bwd, lambda: hc.head_conv_cuda_bwd(x, gy, *ws[:3]),
                     lambda: torch.autograd.grad(y_plain, [xr, *wr], gy, retain_graph=True),
                     lambda: torch.autograd.grad(y_lib, [cost, *head.parameters()], gy_lib,
                                                 retain_graph=True),
                     HEAD_BWD_FLOP, 12)):
                with torch.no_grad() if d == "fwd" else contextlib.nullcontext():
                    k, p, lib = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
                least, by = bound(flop * pixels, nbytes * pixels, F32_FLOPS)
                err = max(errs) if d == "fwd" else max(errs[1:])
                print(f"kernel check: K4-{d} {b}x{hp}x{wp} f32: error {err:.3g} of the terms' "
                      f"magnitudes (bound 1e-5), kernel {k:.4f} ms, its bound {least:.4f} ms "
                      f"({by}; {least / k:.3f} of it), plain {p:.3f} ms, the cuDNN chain "
                      f"{lib:.3f} ms; {n} a train step", flush=True)
                row = step[d]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                               ("flop", flop * pixels), ("bytes", nbytes * pixels)):
                    row[key] += n * v
            del x, gy, got, ref, mag, xr, wr, y_plain, cost, feats, y_lib
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rows = []
    for d in ("fwd", "bwd"):
        row = step.pop(d)
        row["bound_ms"], row["bound_by"] = bound(row.pop("flop"), row.pop("bytes"), F32_FLOPS)
        print(f"kernel check: K4-{d} in a train step with the gates on: kernel "
              f"{row['ms']:.3f} ms, its bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / row['ms']:.3f} of it), the cuDNN chain "
              f"{row['library_ms']:.3f} ms", flush=True)
        rows.append(row)
    return rows


def bn_grad_float64(x, gy, weight, mean, var, mask, relu, eps=1e-5):
    """K5-bwd's train-mode quantities in float64 from bf16 x and gy: the
    input gradient inv·w·(g′ − Σg′/n − x̂·Σg′x̂/n), the sums [Σg′, Σg′x̂], the
    magnitudes m = |inv·w|·(|g′| + Σ|g′|/n + |x̂|·Σ|g′x̂|/n) of its terms and
    [Σ|g′|, Σ|g′x̂|]; g′ is gy where ``mask`` (the chain's output above 0)."""
    c = x.shape[-1]
    inv = torch.rsqrt(var.double() + eps)
    xh = (x.double() - mean.double()) * inv
    gp = torch.where(mask, gy.double(), 0.0) if relu else gy.double()
    rows = x.numel() // c
    gpx = gp * xh
    sums = torch.cat([gp.reshape(-1, c).sum(0), gpx.reshape(-1, c).sum(0)])
    abs_sums = torch.cat([gp.abs().reshape(-1, c).sum(0), gpx.abs().reshape(-1, c).sum(0)])
    del gpx
    iw = inv * weight.double()
    gx = iw * (gp - sums[:c] / rows - xh * (sums[c:] / rows))
    m = iw.abs() * (gp.abs() + abs_sums[:c] / rows + xh.abs() * (abs_sums[c:] / rows))
    return gx, sums, m, abs_sums


def phase_bn_check(dev):
    """K5-fwd and K5-bwd at the refiner's four BN inputs of an 8-frame train
    step, bf16, train mode, on conv-output-like data (normal, a per-channel
    offset) and a cotangent with a per-channel offset and a per-channel
    multiple of x's normal part besides its noise, so that the input
    gradient's statistics term inv·w·(Σg′/n + x̂·Σg′x̂/n) is of the size of its
    direct term. The forward takes the chain's own statistics
    (``nn.batch_moments``), so its output must equal the plain chain's
    (``nn.batchnorm_plain``, then the ReLU on layers 0-2) bit for bit. The
    backward against float64 (``bn_grad_float64``, the ReLU's mask from the
    chain's output): the input gradient within 2^-6·m entry by entry (three
    roundings to bf16 of at most 2^-8 of a term each; the chain's own is held
    to the same), its per-channel sum over the rows, 0 in exact arithmetic,
    within 2^-6 of the summed m, and the parameter gradients within 1e-5 of
    the summed magnitudes of their terms. Timed beside the byte bound (K5-fwd
    4 bytes an element, K5-bwd 10): K5-fwd against the chain's apply alone
    (its eval mode with the batch's statistics), and with the statistics
    against the chain in train mode and, as ``library_ms``, PyTorch's
    train-mode ``F.batch_norm`` on the channels-last view (then
    ``torch.relu`` on layers 0-2); K5-bwd against autograd of the chain and,
    as ``library_ms``, of ``F.batch_norm``. Returns K5-fwd's and K5-bwd's rows
    for the kernels' line, summed over a step's four layers."""
    from dino_tracker_tpu_torch.models import nn as pnn
    from dino_tracker_tpu_torch.ops import batchnorm as bn_ops
    g = torch.Generator(device=dev).manual_seed(5)
    keys = {"fwd": ("ms", "plain_ms", "library_ms", "with_statistics_ms",
                    "plain_with_statistics_ms"),
            "bwd": ("ms", "plain_ms", "library_ms")}
    step = {d: {"max_abs_err": 0.0, **dict.fromkeys(k, 0.0), "bytes": 0.0}
            for d, k in keys.items()}
    for shape in BN_SHAPES:
        n, h, w, c = shape
        relu = c <= 256
        offset = torch.randn(c, generator=g, device=dev)
        z = torch.randn(shape, generator=g, device=dev)
        x = (z * 0.5 + offset).bfloat16()
        g_offset, g_slope = (torch.randn(c, generator=g, device=dev) for _ in range(2))
        gy = (g_offset + g_slope * z + torch.randn(shape, generator=g, device=dev)).bfloat16()
        del z
        bn = pnn.BatchNorm(c).to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(c, generator=g, device=dev) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g, device=dev) * 0.3)
        outs = {}
        for name, fn in (("k5", pnn.batchnorm), ("plain", pnn.batchnorm_plain)):
            xr = x.clone().requires_grad_(True)
            bn.weight.grad = bn.bias.grad = None
            y, _ = fn(xr, bn, True, relu=relu)
            y.backward(gy)
            outs[name] = (y.detach(), xr.grad, bn.weight.grad.clone(), bn.bias.grad.clone())
            del xr, y
        check(torch.equal(outs["k5"][0], outs["plain"][0]),
              f"K5 {shape}: the output differs from the plain chain's")
        with torch.no_grad():
            mean, var, _ = pnn.batch_moments(x)
            inv = torch.rsqrt(var + 1e-5)
            stat = torch.cat([mean, var, inv])
            ref_gx, ref_sums, m, abs_sums = bn_grad_float64(x, gy, bn.weight, mean, var,
                                                            outs["plain"][0] > 0, relu)
        errs = {}
        for name, (_, gx, gw, gb) in outs.items():
            errs[name] = (((gx.double() - ref_gx).abs() / m).max().item(),
                          (gx.double().reshape(-1, c).sum(0).abs()
                           / m.reshape(-1, c).sum(0)).max().item(),
                          ((torch.cat([gb, gw]).double() - ref_sums).abs() / abs_sums)
                          .max().item())
        del ref_gx, m
        check(all(e[0] <= 2 ** -6 and e[1] <= 2 ** -6 and e[2] <= 1e-5 for e in errs.values()),
              f"K5 {shape}: backward errors against float64 (g_x over its terms' "
              f"magnitudes, bound 2^-6; the rows' sum of g_x over theirs, bound 2^-6; g_b "
              f"and g_w over theirs, bound 1e-5): K5 {errs['k5']}, the chain {errs['plain']}")
        xr = x.clone().requires_grad_(True)
        y_plain, _ = pnn.batchnorm_plain(xr, bn, True, relu=relu)
        # the library: train-mode batch_norm on the channels-last view
        lib_w, lib_b = (t.detach().clone().requires_grad_(True) for t in (bn.weight, bn.bias))
        x_lib = x.clone().requires_grad_(True)
        running = [bn.running_mean.clone(), bn.running_var.clone()]

        def library(xx, ww=bn.weight, bb=bn.bias):
            y = F.batch_norm(xx.permute(0, 3, 1, 2), *running, ww, bb, True, 0.1, 1e-5)
            return torch.relu(y) if relu else y

        y_lib = library(x_lib, lib_w, lib_b)
        gy_lib = gy.permute(0, 3, 1, 2)
        applied = pnn.BatchNorm(c).to(dev)  # the chain's apply alone: eval mode
        with torch.no_grad():
            for dst, src in ((applied.weight, bn.weight), (applied.bias, bn.bias),
                             (applied.running_mean, mean), (applied.running_var, var)):
                dst.copy_(src)
        elems = n * h * w * c
        for d, kernel, plain, lib, with_stats, nbytes, err in (
                ("fwd", lambda: bn_ops.apply_cuda(x, bn.weight, bn.bias, mean, inv, relu),
                 lambda: pnn.batchnorm_plain(x, applied, False, relu=relu),
                 lambda: library(x),
                 (lambda: pnn.batchnorm(x, bn, True, relu=relu),
                  lambda: pnn.batchnorm_plain(x, bn, True, relu=relu)), BN_FWD_BYTES, 0.0),
                ("bwd", lambda: bn_ops.batchnorm_cuda_bwd(gy, x, stat, bn.weight, bn.bias, True,
                                                          relu),
                 lambda: torch.autograd.grad(y_plain, [xr, bn.weight, bn.bias], gy,
                                             retain_graph=True),
                 lambda: torch.autograd.grad(y_lib, [x_lib, lib_w, lib_b], gy_lib,
                                             retain_graph=True),
                 None, BN_BWD_BYTES, errs["k5"][0])):
            with torch.no_grad() if d == "fwd" else contextlib.nullcontext():
                times = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                         "library_ms": cuda_ms(lib)}
                if with_stats is not None:
                    times["with_statistics_ms"] = cuda_ms(with_stats[0])
                    times["plain_with_statistics_ms"] = cuda_ms(with_stats[1])
            least = nbytes * elems / HBM_BYTES * 1e3
            what = ("the chain's apply alone" if d == "fwd" else "autograd of the chain")
            extra = (f"; with the statistics {times['with_statistics_ms']:.4f} ms, the chain "
                     f"{times['plain_with_statistics_ms']:.3f} ms" if d == "fwd" else "")
            print(f"kernel check: K5-{d} {n}x{h}x{w}x{c} bf16{' +ReLU' if relu else ''}: "
                  + (f"error {err:.3g} of its terms' magnitudes (bound 2^-6), "
                     if d == "bwd" else "output equal to the chain's, ")
                  + f"kernel {times['ms']:.4f} ms, its bound {least:.4f} ms (bytes; "
                  f"{least / times['ms']:.3f} of it), {what} {times['plain_ms']:.3f} ms, "
                  f"F.batch_norm{' + relu' if relu else ''} {times['library_ms']:.3f} ms"
                  f"{extra}; 1 a train step", flush=True)
            row = step[d]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            for k, v in times.items():
                row[k] += v
            row["bytes"] += nbytes * elems
        del x, gy, outs, xr, y_plain, stat, x_lib, y_lib, gy_lib
    rows_out = []
    for d in ("fwd", "bwd"):
        row = step.pop(d)
        row["bound_ms"], row["bound_by"] = row.pop("bytes") / HBM_BYTES * 1e3, "bytes"
        extra = (f"; with the statistics {row['with_statistics_ms']:.3f} ms, the chain "
                 f"{row['plain_with_statistics_ms']:.3f} ms" if d == "fwd" else "")
        print(f"kernel check: K5-{d} in a train step (four layers): kernel {row['ms']:.3f} ms, "
              f"its bound {row['bound_ms']:.4f} ms ({row['bound_ms'] / row['ms']:.3f} of it), "
              f"the plain chain {row['plain_ms']:.3f} ms, F.batch_norm "
              f"{row['library_ms']:.3f} ms{extra}", flush=True)
        rows_out.append(row)
    return rows_out


def qkv_views(shape, g, dev):
    """q, k, v [B, H, S, 64] as the ViT makes them: permuted views of one bf16
    [B, S, 3·H·64] qkv buffer (models/vit.py)."""
    b, h, s, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=dev).bfloat16()
    return qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)


def phase_attention_check(dev):
    """K2 against attention_reference: at the main path's shape in bf16 (the
    plain version frame by frame: one frame's f32 scores take 4.2 GB), both
    on contiguous q, k, v and on the main path's layout (the permuted views
    of one [4, 8108, 3·1024] qkv buffer, through multi_head_attention), at
    one frame in f32, and at ragged S in both dtypes and both bf16 layouts.
    Bounds: bf16 2^-6·max|out|, two to four bf16 ulps at the top of the
    output's range (the kernel rounds the unnormalised probabilities to bf16,
    the plain version the normalised ones; both round the output), f32 2e-5.
    Times at the main path's shape: K2 on the qkv views (the main path) and
    on contiguous inputs, the plain version and F.scaled_dot_product_attention
    (timed only: the port never calls it)."""
    from dino_tracker_tpu_torch.ops import attention as attn
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(3)

    def plain(q, k, v):
        return torch.cat([attn.attention_reference(q[i:i + 1], k[i:i + 1],
                                                   v[i:i + 1], ATTN_SCALE)
                          for i in range(q.shape[0])])

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(ATTN_SHAPE, bf16, "qkv views"), (ATTN_SHAPE, bf16, "contiguous"),
             ((1,) + ATTN_SHAPE[1:], f32, "contiguous")] + [
        ((2, 3, s, 64), dt, lay) for s in (100, 1000)
        for dt, lay in ((bf16, "qkv views"), (bf16, "contiguous"), (f32, "contiguous"))]
    inputs = {}
    for shape, dtype, layout in cases:
        if layout == "qkv views":
            q, k, v = qkv_views(shape, g, dev)
        else:
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for _ in range(3))
        out = attn.multi_head_attention(q, k, v, ATTN_SCALE)
        ref = plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_ATTN_TOL * ref.float().abs().max().item() if dtype == bf16 else 2e-5
        check(out.shape == ref.shape and out.dtype == dtype and err <= tol,
              f"K2 {shape} {dtype} {layout}: max abs err {err} > bound {tol}")
        if dtype == bf16:  # a [B, S, H, 64] buffer, so the ViT's transpose is a view
            b, h, s, d = shape
            check(out.stride() == (s * h * d, d, h * d, 1),
                  f"K2 {shape} bf16 output strides {out.stride()}")
        print(f"kernel check: K2 {shape} {str(dtype)[6:]} {layout}: max_abs_err "
              f"{err:.3g} (bound {tol:.3g})", flush=True)
        if shape == ATTN_SHAPE and dtype == bf16:
            inputs[layout] = (q, k, v, err)
        del out, ref
    q, k, v, err = inputs["qkv views"]
    qc, kc, vc, err_c = inputs["contiguous"]
    # the main path copies nothing: the call allocates its output and no more
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = attn.multi_head_attention(q, k, v, ATTN_SCALE)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    check(extra <= out.numel() * out.element_size(),
          f"K2 on the qkv views allocated {extra} bytes beyond its inputs")
    print(f"kernel check: K2 {ATTN_SHAPE} bf16 qkv views: {extra / 2**20:.1f} MiB "
          f"allocated by the call (its output), no copies", flush=True)
    del out
    b, h, s, d = ATTN_SHAPE
    flops = 4.0 * b * h * s * s * d
    bound_ms, bound_by = bound(flops, 4.0 * b * h * s * d * 2, BF16_FLOPS)
    contiguous_ms = cuda_ms(lambda: fa.flash_attention_cuda(qc, kc, vc, ATTN_SCALE))
    ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v, ATTN_SCALE))  # the main path
    plain_ms = cuda_ms(lambda: plain(q, k, v), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, scale=ATTN_SCALE))
    print(f"kernel check: K2 {ATTN_SHAPE} bf16 contiguous: {contiguous_ms:.3f} ms "
          f"({flops / contiguous_ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / contiguous_ms:.3f} of the bound)", flush=True)
    print(f"kernel check: K2 {ATTN_SHAPE} bf16 through multi_head_attention on the "
          f"qkv views: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the bound {bound_ms:.3f} ms ({bound_by})), "
          f"scaled_dot_product_attention {library_ms:.3f} ms "
          f"({flops / library_ms / 1e9:.1f} TFLOP/s, contiguous), plain "
          f"{plain_ms:.3f} ms (frame by frame)", flush=True)
    return {"max_abs_err": max(err, err_c), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_slice(bp, dev):
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrackerConfig
    tcfg = TrackerConfig(video_h=H, video_w=W, delta_channels=CHANNELS,
                         compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    params, stats = full_width_inputs().jax_layout_weights(rng, CHANNELS)
    model = build_model(params, stats, tcfg, dev)
    video, dino = make_inputs(T, H, W, CHANNELS[-1], tcfg.feat_hw, dev, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    mi = runtime.make_model_inference(model, video, dino, tcfg, ANCHOR_COS, COS)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    request_s, self_px, track_px, occluded = [], [], [], []
    for frame in QUERY_FRAMES:
        qp = queries(rng, N_QUERIES, frame, H, W)
        t0 = time.perf_counter()
        trajs, occ = mi.infer(qp)
        request_s.append(time.perf_counter() - t0)
        check(trajs.shape == (N_QUERIES, T, 2) and occ.shape == (N_QUERIES, T)
              and occ.dtype == bool, f"shapes {trajs.shape} {occ.shape} {occ.dtype}")
        check(np.isfinite(trajs).all(), "non-finite trajectory coordinates")
        check((trajs >= 0).all() and (trajs[..., 0] <= W - 1).all()
              and (trajs[..., 1] <= H - 1).all(), "a coordinate left the frame")
        d = np.linalg.norm(trajs - qp[:, None, :2], axis=-1)
        self_px.append(d[:, frame].max())
        track_px.append(np.median(d))
        occluded.append(occ.mean())
        check(self_px[-1] <= SELF_TRACK_PX,
              f"frame {frame}: a query came back {self_px[-1]:.1f} px from "
              f"itself on its own frame (> {SELF_TRACK_PX})")
    launches, k1_bwd = counted("blurpool_down_nhwc", "blurpool_up_nhwc")
    expected = 3 * -(-T // 16)  # 3 blurpools per 16-frame refine chunk
    check(launches == expected and k1_bwd == 0,
          f"K1 launched {launches} times (K1-bwd {k1_bwd}) in the inference path, expected "
          f"{expected} (and 0)")
    head_calls = counted("head_conv_fwd", "head_conv_bwd")
    check(head_calls[0] >= len(QUERY_FRAMES) and head_calls[1] == 0,
          f"K4-fwd / K4-bwd launched {head_calls} times in the inference path: every "
          f"request's head through K4-fwd, no backward")
    bn_calls = counted("batchnorm_fwd", "batchnorm_bwd")
    check(bn_calls == (BN_LAYERS * -(-T // 16), 0), f"K5-fwd / K5-bwd launched {bn_calls} "
          f"times in the inference path, expected {BN_LAYERS} a 16-frame refine chunk "
          f"(eval mode) and no backward")
    print(f"slice: T={T} {W}x{H} C={CHANNELS[-1]} grid {tcfg.feat_hw} bf16: "
          f"refine {refine_s:.3f} s, requests "
          f"{', '.join(f'{s:.3f}' for s in request_s)} s for {N_QUERIES} "
          f"points each, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, own-frame error max {max(self_px):.2f} px, median track "
          f"distance {np.median(track_px):.2f} px, occluded share "
          f"{np.mean(occluded):.3f}, K1 launches {launches}, K4-fwd launches "
          f"{head_calls[0]}", flush=True)
    return launches, video, dino


def make_train_data(video, dino, dev, seed, bb_cap=BB_CAP,
                    n_traj=(N_FG_TRAJ, N_BG_TRAJ)):
    """Training data on the card from a seed: an fg ellipse drifting across
    the frames (0/255 masks, as the artifact), fg/bg trajectory banks whose
    rows are visible in ~80% of the frames (at least 2, as build_bank
    guarantees), and padded best buddies for every ordered frame pair."""
    from dino_tracker_tpu_torch.structures import BBData
    from dino_tracker_tpu_torch.training.sampler import TrajectoryBank
    from dino_tracker_tpu_torch.training.train import VideoData
    g = torch.Generator(device=dev).manual_seed(seed)
    t, _, h, w = video.shape
    scale = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    cx = w * (0.3 + 0.4 * torch.arange(t, device=dev) / max(t - 1, 1))[:, None, None]
    masks = ((((xs - cx) / (0.15 * w)) ** 2 + ((ys - h / 2) / (0.25 * h)) ** 2)
             < 1).float() * 255

    def bank(n):
        valid = torch.rand((n, t), generator=g, device=dev) < 0.8
        valid[:, :2] = True
        coords = torch.rand((n, t, 2), generator=g, device=dev) * scale
        return TrajectoryBank(coords * valid[..., None], valid, n)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    nvalid = torch.randint(bb_cap // 5, bb_cap, (t, t), generator=g, device=dev)
    bb = BBData(rand(t, t, bb_cap, 2) * scale, rand(t, t, bb_cap, 2) * scale,
                0.2 + 0.8 * rand(t, t, bb_cap), rand(t, t, bb_cap),
                torch.arange(bb_cap, device=dev) < nvalid[..., None])
    return VideoData(video, dino, masks, bb, bank(n_traj[0]), bank(n_traj[1]))


class StepRecorder:
    """Test-only wrappers of ``train.sample_batch``, ``train.step_losses``,
    ``cycle.cycle_data_from_points``, ``tracker_head.hard_argmax`` and
    ``mesh.all_reduce_grads`` (patched in while the recorder is entered):
    each step's batch (``frames_set_t``, source and target frame indices),
    loss terms, DeltaDINO learning rate (read from ``lr``, the schedule's
    device tensor; with no ``lr`` given, ``train.make_optimizer`` is wrapped
    too and the Trainer's own schedule found), cycle filter (each drawn
    point's validity before the filter, its cycle distance and whether it
    was kept), the head's hard argmax of every point of every head call in
    the step (``argmax``: the flat index; ``top``: the raw map's two
    largest values; ``drawn_query``: whether the point's query is one of
    the step's draws, not an earlier prediction of the same step) and the
    L2 norm of each head tensor's gradient (``head_grads``, HEAD_TENSORS)
    go to row i of device buffers, i counted on the device, so a captured
    step records every replay (a graph replayed past n steps overwrites the
    first rows)."""

    def __init__(self, n, cfg, dev, lr=None):
        from dino_tracker_tpu_torch.models import tracker_head
        from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
        from dino_tracker_tpu_torch.training import train
        self.train, self.head, self.mesh_lib, self.lr = train, tracker_head, mesh_lib, lr
        self.i = torch.zeros(1, dtype=torch.long, device=dev)
        long = lambda k: torch.full((n, k), -1, dtype=torch.long, device=dev)
        self.frames = long(2 * cfg.batch_n_frames)
        self.src, self.tgt = long(cfg.train_batch_size), long(cfg.train_batch_size)
        self.losses = torch.zeros((n, len(train.METRICS)), device=dev)
        self.lrs = torch.zeros(n, device=dev)
        p = cfg.cyc_n_frames * cfg.cyc_batch_size_per_frame
        self.drawn = torch.zeros((n, p), dtype=torch.bool, device=dev)
        self.kept = torch.zeros((n, p), dtype=torch.bool, device=dev)
        self.dists = torch.zeros((n, p), device=dev)
        # the head's calls a step: the flow term's batch, the cycle filter's
        # two ways and the cycle loss's both ways (HEAD_CALLS)
        width = cfg.train_batch_size + 4 * p
        self.argmax = long(width)
        self.top = torch.zeros((n, width, 2), device=dev)
        self.drawn_query = torch.zeros((n, width), dtype=torch.bool, device=dev)
        self.head_grads = torch.zeros((n, len(HEAD_TENSORS)), device=dev)
        self._call = self._off = 0

    def make_optimizer(self, *args, **kwargs):
        opt, sched = self._make_optimizer(*args, **kwargs)
        self.lr = sched.lr
        return opt, sched

    def sample_batch(self, *args, **kwargs):
        self._call = self._off = 0  # a step starts
        s = self._sample(*args, **kwargs)
        for buf, x in ((self.frames, s.frames_set_t), (self.src, s.source_frame_indices),
                       (self.tgt, s.target_frame_indices)):
            buf.index_copy_(0, self.i, x[None])
        return s

    def cycle_data_from_points(self, model, emb, frames, cfg, src_sel, tgt_sel, coords,
                               valid, *args, **kwargs):
        out = self._cycle(model, emb, frames, cfg, src_sel, tgt_sel, coords, valid,
                          *args, **kwargs)
        for buf, x in ((self.drawn, valid.reshape(-1)), (self.kept, out.valid),
                       (self.dists, out.dists)):
            buf.index_copy_(0, self.i, x[None])
        return out

    def hard_argmax(self, cost):
        idx = self._argmax(cost)
        b, off = idx.shape[0], self._off
        if off + b <= self.argmax.shape[1]:
            top = torch.topk(cost.detach().flatten(1).float(), 2, dim=1).values
            share = HEAD_CALLS[self._call][1] if self._call < len(HEAD_CALLS) else 0.0
            drawn = torch.arange(b, device=idx.device) < share * b
            for buf, x in ((self.argmax, idx), (self.top, top), (self.drawn_query, drawn)):
                buf.narrow(1, off, b).index_copy_(0, self.i, x[None])
        self._call, self._off = self._call + 1, off + b
        return idx

    def step_losses(self, *args, **kwargs):
        total, metrics = self._losses(*args, **kwargs)
        self.losses.index_copy_(0, self.i, torch.stack(
            [metrics[k] for k in self.train.METRICS])[None])
        self.lrs.index_copy_(0, self.i, self.lr.reshape(1))
        return total, metrics

    def all_reduce_grads(self, model, mesh):
        self._reduce(model, mesh)
        grads = dict(model.named_parameters())
        self.head_grads.index_copy_(0, self.i, torch.stack(
            [grads[k].grad.float().norm() if grads[k].grad is not None
             else torch.zeros((), device=self.i.device) for k in HEAD_TENSORS])[None])
        self.i.add_(1).remainder_(len(self.losses))  # later replays wrap around
        return None

    def __enter__(self):
        train, cycle = self.train, self.train.cycle
        self._sample, self._losses = train.sample_batch, train.step_losses
        self._cycle, self._argmax = cycle.cycle_data_from_points, self.head.hard_argmax
        self._reduce, self._make_optimizer = self.mesh_lib.all_reduce_grads, train.make_optimizer
        train.sample_batch, train.step_losses = self.sample_batch, self.step_losses
        cycle.cycle_data_from_points = self.cycle_data_from_points
        self.head.hard_argmax = self.hard_argmax
        self.mesh_lib.all_reduce_grads = self.all_reduce_grads
        if self.lr is None:
            train.make_optimizer = self.make_optimizer
        return self

    def __exit__(self, *exc):
        self.train.sample_batch, self.train.step_losses = self._sample, self._losses
        self.train.cycle.cycle_data_from_points = self._cycle
        self.head.hard_argmax = self._argmax
        self.mesh_lib.all_reduce_grads = self._reduce
        self.train.make_optimizer = self._make_optimizer

    def rows(self, first, n):
        """Rows first .. first + n - 1 of every buffer, as a namespace."""
        return types.SimpleNamespace(**{k: getattr(self, k)[first:first + n]
                                        for k in RECORDED})


class FollowChoices:
    """Test-only: while entered, an eager run takes, step by step, the cycle
    filter's kept points and the head's hard argmax of every head call that
    ``rec`` (``StepRecorder.rows`` of another run, one row a step) recorded,
    in place of its own. Entered after the run's own ``StepRecorder``, which
    then keeps the run's own choices."""

    def __init__(self, rec):
        from dino_tracker_tpu_torch.models import tracker_head
        from dino_tracker_tpu_torch.training import train
        self.train, self.head, self.rec = train, tracker_head, rec
        self.k, self._off = -1, 0

    def sample_batch(self, *args, **kwargs):
        self.k, self._off = self.k + 1, 0
        return self._sample(*args, **kwargs)

    def hard_argmax(self, cost):
        own = self._argmax(cost)
        b = own.shape[0]
        take = self.rec.argmax[self.k, self._off:self._off + b].to(own.device)
        self._off += b
        return take

    def cycle_data_from_points(self, *args, **kwargs):
        out = self._cycle(*args, **kwargs)
        return out._replace(valid=self.rec.kept[self.k].to(out.valid.device))

    def __enter__(self):
        cycle = self.train.cycle
        self._sample, self._cycle = self.train.sample_batch, cycle.cycle_data_from_points
        self._argmax = self.head.hard_argmax
        self.train.sample_batch, cycle.cycle_data_from_points = (
            self.sample_batch, self.cycle_data_from_points)
        self.head.hard_argmax = self.hard_argmax
        return self

    def __exit__(self, *exc):
        self.train.sample_batch = self._sample
        self.train.cycle.cycle_data_from_points = self._cycle
        self.head.hard_argmax = self._argmax


def traced(fn):
    """``fn()`` under torch.profiler tracing the card -> (wall ms, the
    traced kernels' device ms, [runs of K1-fwd, K1-bwd, K4-fwd, K4-bwd and
    K5's four kernels] as the card ran them, a CUDA graph's replays
    included, NCCL's kernels' device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3
    return (wall, busy, [sum(e.count for e in events if k in e.key)
                         for k in K1_KERNELS + K4_KERNELS + K5_KERNELS], nccl)


class TracedReplays:
    """Test-only wrapper of ``step_graph.StepGraph.replay`` (patched in
    while entered): every replay call runs under ``traced``, TRACE_STEPS
    replays a trace, and ``ran`` sums the K1-fwd, K1-bwd, K4-fwd, K4-bwd
    and K5 kernels the card ran in replays, which no wrapper counts. (The captures and the steps
    replayed are ``StepGraph``'s own counters, which ``reset_counts``
    resets.)"""

    def __init__(self):
        from dino_tracker_tpu_torch.training import step_graph
        self.cls = step_graph.StepGraph
        self.ran = [0] * (len(K1_KERNELS) + len(K4_KERNELS) + len(K5_KERNELS))

    def __enter__(self):
        self._replay = self.cls.replay
        watch = self

        def replay(graph, n):
            for k in range(0, n, TRACE_STEPS):
                ran = traced(lambda: watch._replay(graph, min(TRACE_STEPS, n - k)))[2]
                watch.ran = [a + b for a, b in zip(watch.ran, ran)]

        self.cls.replay = replay
        return self

    def __exit__(self, *exc):
        self.cls.replay = self._replay


@contextlib.contextmanager
def eager_trainer(on=True):
    """Test-only: while entered, the Trainer's ``StepRunner`` runs every step
    eagerly on the card, as it does on the CPU."""
    from dino_tracker_tpu_torch.training import train
    runner = train.StepRunner

    class Eager(runner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.graphed = False

    if on:
        train.StepRunner = Eager
    try:
        yield
    finally:
        train.StepRunner = runner


def count_syncs(fn):
    """The host syncs ``fn`` makes, as torch.cuda.set_sync_debug_mode("warn")
    reports them (the autograd thread's included), each as the innermost
    frames of the Python stack that made it."""
    import traceback
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            found.append(" < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                    for f in stack[:-5:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return found


def spread_rows(names, got, eager, base=None, floor=CHUNK_CHANGE_FLOOR, ref=None):
    """Per tensor: (name, e, s, bound, scale) with distances in the L2 norm
    (a few elements whose gradient is float noise, which Adam turns into
    full steps, would decide a largest-element distance): e the median over
    the ``eager`` runs of |got - run| (with a ``ref`` run, |got - ref|
    alone), s the eager runs' own spread (the
    largest |run - run'| over pairs of them: index_add's atomics make every
    run differ from the first step on), scale = |eager[0] - base| (the
    change from ``base``; |eager[0]| without one) and bound =
    CHUNK_TOL_FACTOR * s + floor * scale. A tensor passes where
    e <= bound."""
    rows = []
    for j, name in enumerate(names):
        runs = [r[j].double() for r in eager]
        dist = lambda x, y: float((x - y).norm())
        g = got[j].double()
        scale = dist(runs[0], 0.0 if base is None else base[j].double())
        s_j = max(dist(x, y) for k, x in enumerate(runs) for y in runs[k + 1:])
        e_j = (float(np.median([dist(g, x) for x in runs])) if ref is None
               else dist(g, ref[j].double()))
        rows.append((name, e_j, s_j,
                     CHUNK_TOL_FACTOR * s_j + floor * scale, scale))
    return rows


def cycle_flips(got, eager, thresh, head_offset=None, judge_until=None):
    """The steps at which the graph's cycle filter kept another set of points
    than every eager run did (``StepRecorder``'s cycle buffers of the graph
    run ``got`` and the ``eager`` runs) -> (those steps, every such step
    explained, a line). A step is explained where each point kept otherwise
    lies at the ``thresh`` px threshold within the runs' noise: its cycle
    distance in the graph within CHUNK_TOL_FACTOR times the eager runs'
    spread of it (the largest distance between two of them, or the median
    of that over the step's drawn points where larger: three runs can agree
    on one point far closer than the step's noise) plus CHUNK_LOSS_FLOOR of
    the threshold, of their median; kept on one side, dropped on the other,
    it lies at the threshold in both. With ``head_offset`` (the flow term's
    batch: the cycle filter's two head calls follow it in the recorder's
    argmax rows, one point each, as with no mesh) a point is also explained
    where the graph's hard argmax of it in the filter's forward or backward
    call differs from that of each eager run that kept it otherwise: its
    distance then moved with that choice (``argmax_flips`` judges it).
    Steps after ``judge_until`` are listed, not judged. The points drawn
    and valid before the filter must be equal in every run at every
    step."""
    runs = [got, *eager]
    drawn = [r.drawn.cpu() for r in runs]
    kept = [r.kept.cpu() for r in runs]
    dists = [r.dists.double().cpu() for r in runs]
    p_n = kept[0].shape[1]
    if head_offset is not None:
        am = [r.argmax.cpu()[:, head_offset:head_offset + 2 * p_n] for r in runs]
        # per step and point: the argmax of either filter call differs from the graph's
        head_moved = [((a[:, :p_n] != am[0][:, :p_n]) | (a[:, p_n:] != am[0][:, p_n:]))
                      for a in am[1:]]
    same_drawn = all(torch.equal(d, drawn[0]) for d in drawn[1:])
    if not bool(drawn[0].any()):
        return [], same_drawn, "cycle filter: not run"
    steps, shown, ok, worst = [], [], same_drawn, 0.0
    for k in range(len(kept[0])):
        if any(torch.equal(kept[0][k], e[k]) for e in kept[1:]):
            continue
        steps.append(k)
        moved = torch.zeros_like(kept[0][k])
        for e in kept[1:]:
            moved |= kept[0][k] != e[k]
        every = torch.stack([x[k] for x in dists[1:]])
        sel = drawn[0][k]
        step_noise = float((every.amax(0) - every.amin(0))[sel].median()) if sel.any() else 0.0
        d = every[:, moved]
        spread = (d[:, None] - d[None]).abs().amax((0, 1)).clamp(min=step_noise)
        err = (dists[0][k][moved] - d.median(0).values).abs()
        bound = CHUNK_TOL_FACTOR * spread + CHUNK_LOSS_FLOOR * thresh
        ratio = err / bound
        if head_offset is not None:  # moved with a choice of the head
            with_head = torch.ones_like(ratio, dtype=torch.bool)
            for e, h in zip(kept[1:], head_moved):
                with_head &= ~(kept[0][k] != e[k])[moved] | h[k][moved]
            ratio = torch.where(with_head, 0.0, ratio)
        if judge_until is not None and k > judge_until:
            ratio = torch.zeros_like(ratio)
        ok &= bool((ratio <= 1).all())
        worst = max(worst, float(ratio.max()))
        shown += [f"step {k} point {int(p)}: graph {float(dists[0][k][p]):.9g}, eager "
                  + " ".join(f"{float(x[k][p]):.9g}" for x in dists[1:])
                  for p in moved.nonzero().flatten()[:4]]
    among = sum(not all(torch.equal(kept[1][k], e[k]) for e in kept[2:])
                for k in range(len(kept[0])))
    line = (f"cycle filter: points drawn {'equal' if same_drawn else 'NOT equal'} in every "
            f"run; kept sets of the graph other than every eager run's at steps {steps}")
    if steps:
        line += (f", each point kept otherwise at {thresh:g} px within {worst:.3g} of its "
                 f"bound ({'; '.join(shown)})")
    return steps, ok, line + f"; the eager runs' kept sets differ at {among} steps"


def argmax_flips(got, eager, judge_until=None):
    """The head's hard argmax of the run ``got`` against the ``eager`` runs
    (``StepRecorder`` rows of each) -> (the steps at which some point's
    argmax in ``got`` differs from every eager run's, every such point
    explained, a line). A point whose query is one of the step's draws is
    explained where the raw map's two largest values lie within the runs'
    noise, in ``got`` and in the eager runs' median: their gap within
    CHUNK_TOL_FACTOR times the eager runs' spread of the largest value (the
    largest, over the step's drawn queries, of the largest distance between
    two of them) plus CHUNK_LOSS_FLOOR of that value; two cells that tie
    within the noise go either way in valid runs. A point whose query is a
    prediction of the same step (the cycle filter's backward, the cycle
    loss's targets) is counted and not judged: its query moves with the
    choice made before it. Steps after ``judge_until`` are listed, not
    judged."""
    am = [r.argmax.cpu() for r in (got, *eager)]
    top = [r.top.double().cpu() for r in (got, *eager)]
    drawn = got.drawn_query.cpu()
    steps, ok, worst, judged_n, derived_n, shown = [], True, 0.0, 0, 0, []
    gap = lambda t, k: t[k, :, 0] - t[k, :, 1]
    for k in range(len(am[0])):
        used = am[0][k] >= 0
        moved = used.clone()
        for e in am[1:]:
            moved &= am[0][k] != e[k]
        if not bool(moved.any()):
            continue
        steps.append(k)
        judged = moved & drawn[k] & (judge_until is None or k <= judge_until)
        derived_n += int((moved & ~judged).sum())
        if not bool(judged.any()):
            continue
        judged_n += int(judged.sum())
        firsts = torch.stack([t[k, :, 0] for t in top[1:]])
        noise = float((firsts[:, None] - firsts[None]).abs().amax((0, 1))[drawn[k] & used].max())
        gaps = torch.stack([gap(top[0], k),
                            torch.stack([gap(t, k) for t in top[1:]]).median(0).values]).amax(0)
        bound = CHUNK_TOL_FACTOR * noise + CHUNK_LOSS_FLOOR * top[0][k, :, 0].abs()
        ratio = torch.where(bound > 0, gaps / bound.clamp(min=1e-300),
                            torch.where(gaps > 0, math.inf, 0.0))[judged]
        ok &= bool((ratio <= 1).all())
        worst = max(worst, float(ratio.max()))
        shown += [f"step {k} point {int(p)}: top two {float(top[0][k, p, 0]):.7g} / "
                  f"{float(top[0][k, p, 1]):.7g}, eager noise {noise:.3g}"
                  for p in judged.nonzero().flatten()[:2]]
    line = (f"head argmax: points other than every eager run's at steps {steps}"
            + (f" ({judged_n} with drawn queries, within {worst:.3g} of their bound"
               + (f": {'; '.join(shown[:4])}" if shown else "")
               + f"; {derived_n} with queries the step predicted or after the first "
               f"step with such a choice, not judged)" if steps else ""))
    return steps, ok, line


def choice_flips(got, eager, thresh, head_offset):
    """The discrete choices of ``got`` that no ``eager`` run took: the cycle
    filter's kept points (``cycle_flips``, with ``head_offset``) and the
    head's hard argmax (``argmax_flips``) -> (the steps with such a choice,
    every one at the first such step explained, a line). After the first,
    ``got`` no longer shares the eager runs' choices: its later points
    drift from theirs beyond their own spread (a chunk on an H100: a cycle
    distance 1.7e-3 px from three eager runs within 1.9e-4 of each other,
    9 steps after such a choice), so later choices are listed, not judged;
    the run that takes ``got``'s choices carries the check on."""
    steps = sorted(set(cycle_flips(got, eager, thresh, head_offset)[0])
                   | set(argmax_flips(got, eager)[0]))
    first = steps[0] if steps else None
    c_ok, c_line = cycle_flips(got, eager, thresh, head_offset, first)[1:]
    a_ok, a_line = argmax_flips(got, eager, first)[1:]
    return steps, c_ok and a_ok, f"{c_line}; {a_line}"


def head_columns(cfg, world):
    """For each of ``world`` ranks, the columns of one device's
    ``StepRecorder`` head rows (argmax, top, drawn_query: HEAD_CALLS in
    order) that the rank's own row fills, in the order it fills them: its
    rows of the flow term's batch (``mesh.split_rows``), its share of every
    pair's points in the cycle filter's forward and backward calls (the
    point axis split as ``mesh.split_sizes`` splits it, ``cycle.py``), then
    its share of every block of the cycle loss's sources and targets."""
    from dino_tracker_tpu_torch.parallel.mesh import split_sizes
    b, g, k = cfg.train_batch_size, cfg.cyc_n_frames, cfg.cyc_batch_size_per_frame
    p = g * k
    rb, rk = (np.cumsum([0] + split_sizes(n, world)) for n in (b, k))
    cols = []
    for r in range(world):
        blocks = lambda first, n: [first + j * k + i for j in range(n)
                                   for i in range(rk[r], rk[r + 1])]
        cols.append(torch.tensor([*range(rb[r], rb[r + 1]), *blocks(b, g),
                                  *blocks(b + p, g), *blocks(b + 2 * p, 2 * g)]))
    return cols


def whole_record(rows, cfg):
    """Every rank's ``StepRecorder.rows`` of one run, in rank order -> the
    run's record in one device's layout, every buffer of RECORDED: the head
    calls' columns put back where one device has them (``head_columns``),
    the loss terms the sum of the ranks' shares (as ``reduce_metrics``
    sums them), the rest rank 0's (the batches, the rates, the cycle
    filter's points, which every rank computes after its gather, and the
    gradients' norms after their all-reduce)."""
    out = {k: getattr(rows[0], k) for k in RECORDED}
    out["losses"] = torch.stack([r.losses for r in rows]).sum(0)
    cols = head_columns(cfg, len(rows))
    for k in ("argmax", "top", "drawn_query"):
        out[k] = getattr(rows[0], k).clone()
        for c, r in zip(cols, rows):
            out[k][:, c] = getattr(r, k)[:, :len(c)]
    return types.SimpleNamespace(**out)


def chunk_choices(got, eager, cfg, mesh=None):
    """The discrete choices of the run ``got`` that no ``eager`` run took,
    judged by ``choice_flips`` on the records in one device's layout
    (``StepRecorder.rows``, one row a step; the flow term's batch the head
    offset). On a ``mesh`` every rank's rows of every run are gathered over
    its host group (gloo, never the NCCL communicator) and rebuilt
    (``whole_record``): every rank reaches the same verdict from the same
    data, and ``mesh.agree`` holds the ranks to it, so that every rank runs
    eager G or none does. -> namespace of ``steps`` (with such a choice),
    ``ok`` (each at the first such step explained), ``line``, ``whole``
    ((got, [eager]) in one device's layout), ``first`` and ``took`` (the
    ranks whose own share held such a choice at the first such step, at
    any), ``misses`` (a run whose cycle filter, drawn, kept or dists,
    differs between ranks: named by run and rank)."""
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    runs = [got, *eager]
    world = mesh_lib.world_size(mesh)
    every = [[types.SimpleNamespace(**{k: getattr(r, k).cpu() for k in RECORDED})]
             for r in runs]
    if world > 1:
        import torch.distributed as dist
        gathered = [None] * world
        host = mesh.host_group if mesh.host_group is not None else mesh.group
        dist.all_gather_object(gathered, [vars(r[0]) for r in every], group=host)
        every = [[types.SimpleNamespace(**rank[j]) for rank in gathered]
                 for j in range(len(runs))]
    error = out = None
    try:
        names = ["graph"] + [f"eager {chr(65 + j)}" for j in range(len(eager))]
        misses = []
        for name, ranks in zip(names, every):
            for r, x in enumerate(ranks[1:], 1):
                for k in ("drawn", "kept", "dists"):
                    at = (getattr(x, k) != getattr(ranks[0], k)).flatten(1).any(1)
                    if at.any():
                        misses.append(f"{name}: rank {r}'s {k} differs from rank 0's at "
                                      f"steps {at.nonzero().flatten().tolist()}")
        whole = [whole_record(ranks, cfg) for ranks in every]
        w, e = whole[0], whole[1:]
        steps, ok, line = choice_flips(w, e, cfg.cyc_thresh, cfg.train_batch_size)
        owner = torch.empty(w.argmax.shape[1], dtype=torch.long)
        for r, c in enumerate(head_columns(cfg, world)):
            owner[c] = r
        kept_owner = owner[cfg.train_batch_size:][:w.kept.shape[1]]  # the filter's forward

        def ranks_at(k):  # whose share held a choice that no eager run took at step k
            moved = w.argmax[k] >= 0
            for x in e:
                moved &= w.argmax[k] != x.argmax[k]
            kept = torch.zeros_like(w.kept[k])
            if not any(torch.equal(w.kept[k], x.kept[k]) for x in e):
                for x in e:
                    kept |= w.kept[k] != x.kept[k]
            return set(owner[moved].tolist()) | set(kept_owner[kept].tolist())

        out = types.SimpleNamespace(
            steps=steps, ok=ok, line=line, whole=(w, e), misses=misses,
            first=sorted(ranks_at(steps[0])) if steps else [],
            took=sorted(set().union(*(ranks_at(k) for k in steps))))
    except Exception:  # a fault of this rank's verdict, raised on every rank
        error = traceback.format_exc()
    mesh_lib.agree(error, None if out is None else (out.steps, out.ok, out.first, out.took),
                   mesh, "train chunks, the discrete choices' verdict")
    return out


def follow_run(model, lr, step, n, cfg, dev, rec):
    """Eager G: ``n`` calls of ``step`` (one eager train step of ``model``
    each; on a mesh this rank's) taking the discrete choices that ``rec``
    (this rank's own ``StepRecorder.rows`` of another run, one row a step)
    recorded (``FollowChoices``) -> (G's own recorder, its parameters, its
    BN statistics)."""
    with StepRecorder(n, cfg, dev, lr) as own, FollowChoices(rec):
        for _ in range(n):
            step()
    return (own, *model_state(model)[1::2])


def digest(tensors):
    """A sha256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def loss_rules(got, eager, thresh, head_offset=None, whole=None):
    """The loss terms' rule on ``StepRecorder``s of the graph run and the
    eager runs: every term's series of step values under ``spread_rows``
    (floor CHUNK_LOSS_FLOOR of the term), those of CYCLE_TERMS without the
    steps at which the graph's cycle filter kept other points than every
    eager run, each such step explained by ``cycle_flips`` (with
    ``head_offset``; on the records ``whole``, (graph, [eager runs]) in one
    device's layout, where given: on a mesh ``got`` and ``eager`` hold this
    rank's shares) -> (the cycle filter's (ok, line), the losses'
    ``spread_summary``, the rows over every step, the rows as held)."""
    from dino_tracker_tpu_torch.training.train import METRICS
    flips, flips_ok, flips_line = cycle_flips(*(whole or (got, eager)), thresh, head_offset)
    steady = [k for k in range(len(got.losses)) if k not in flips]
    series = lambda rec, cut: [x[steady] if cut and name in CYCLE_TERMS else x
                               for name, x in zip(METRICS, rec.losses.T)]
    rows = [spread_rows(METRICS, series(got, cut), [series(r, cut) for r in eager],
                        floor=CHUNK_LOSS_FLOOR) for cut in (False, True)]
    return (flips_ok, flips_line), spread_summary("losses", rows[1]), *rows


def spread_summary(kind, rows):
    """(every tensor passed, a line on the worst one: its error, its spread
    and its bound, each over the scale of its change; where one missed, the
    line then lists every row, absolute, so that a miss names its
    tensors)."""
    ratio = lambda r: r[1] / r[3] if r[3] > 0 else (0.0 if r[1] == 0 else math.inf)
    worst = max(rows, key=ratio)
    rel = lambda v: f"{v / worst[4]:.3g}" if worst[4] > 0 else f"{v:.3g} (abs)"
    ok = all(r[1] <= r[3] for r in rows)
    line = (f"{kind}: {sum(r[1] <= r[3] for r in rows)}/{len(rows)} within, worst "
            f"{worst[0]} at {ratio(worst):.3g} of its bound (error {rel(worst[1])}, spread "
            f"{rel(worst[2])}, bound {rel(worst[3])} of its scale {worst[4]:.3g})")
    if not ok:
        line += f" [every row: {rows_line(rows)}]"
    return ok, line


def rows_line(rows):
    """Every row of ``spread_rows``: name, error, spread, bound and scale,
    absolute, a miss marked."""
    return "name error spread bound scale: " + ", ".join(
        f"{r[0]}{'' if r[1] <= r[3] else ' MISSED'} {r[1]:.4g} {r[2]:.4g} {r[3]:.4g} "
        f"{r[4]:.4g}" for r in rows)


def params_summary(names, got, eager, base, steps, lr, ref=None):
    """``spread_summary`` of the parameters' change (``spread_rows``, with
    its ``ref``), but for the tensors whose gradient is zero in exact math
    (MESH_NULL_GRADS: its float noise sets the sign of each Adam step, so
    runs differ at random): those are held to Adam's own limit instead, a
    change of at most 2·lr a step."""
    keep = [j for j, n in enumerate(names) if n not in MESH_NULL_GRADS]
    pick = lambda xs: None if xs is None else [xs[j] for j in keep]
    ok, line = spread_summary("parameters' change", spread_rows(
        pick(names), pick(got), [pick(r) for r in eager], pick(base), ref=pick(ref)))
    for j, n in enumerate(names):
        if n in MESH_NULL_GRADS:
            moved = float((got[j].double() - base[j].double()).abs().max())
            ok &= moved <= 2 * lr * steps  # each element's change
            line += f"; {n} (noise) moved {moved:.3g}, limit {2 * lr * steps:.3g}"
    return ok, line


def model_state(model):
    """(parameter names, parameters, BN-statistic names, BN statistics),
    cloned."""
    params = [(n, p.detach().clone()) for n, p in model.named_parameters()]
    stats = [(n, b.clone()) for n, b in model.named_buffers() if "running" in n]
    return ([n for n, _ in params], [p for _, p in params],
            [n for n, _ in stats], [b for _, b in stats])


def from_state(state, names):
    return [state["model"][n] for n in names]


def memory_line(dev):
    """This process's view of the card: free and total memory (all
    processes), reserved and allocated by this process, in GiB."""
    free, total = torch.cuda.mem_get_info(dev)
    return (f"card free {free / 2**30:.2f} of {total / 2**30:.2f} GiB, this process "
            f"reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f}, allocated "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f}")


def loss_series(names, rows, got, eager):
    """Each missed loss term's values step by step: the graph's, then eager
    A's, B's and C's."""
    fmt = lambda x: " ".join(f"{float(v):.6g}" for v in x)
    return "; ".join(
        f"{name} per step: graph [{fmt(got[j])}], " + ", ".join(
            f"eager {k} [{fmt(r[j])}]" for k, r in zip("ABC", eager))
        for j, (name, row) in enumerate(zip(names, rows)) if row[1] > row[3])


def train_chunks(dev, trainer, cfg, tcfg, data, mesh=None):
    """The train step as the Trainer runs it on the card (or on this rank of
    an NCCL ``mesh``): a chunk of CHUNK_STEPS (TrainConfig.steps_per_call)
    replays of one captured CUDA graph (training/step_graph.py), against
    CHUNK_STEPS eager train_steps, for each set of gates, each run from one
    state: CHUNK_START eager steps from the Trainer's init (the schedule's
    count CHUNK_START, so the chunk crosses apply_scheduler_every = 40),
    restored as a checkpoint is.

    Checked (raises where a check fails): every step's batch (frames_set_t,
    source and target indices) and DeltaDINO learning rate of the graph
    equal the eager run's, the rate steps down by gamma where the count
    reaches 40 and equals lr·gamma^(count // 40), consecutive batches
    differ; per loss term (this rank's share on a mesh), per parameter and
    per BN statistic, the graph's median L2 distance to eager runs A, B and
    C is within CHUNK_TOL_FACTOR times their largest distance between two of
    them, plus a floor: CHUNK_CHANGE_FLOOR of the parameters' and
    statistics' change over the chunk, CHUNK_LOSS_FLOOR of a loss term
    (``spread_rows``, ``params_summary``; CYCLE_TERMS without the steps at
    which the graph's cycle filter kept other points than every eager run,
    each explained by ``cycle_flips``, ``loss_rules``). Where the graph took
    a discrete choice that no eager run took (``chunk_choices``, the whole
    step's choices: on a mesh every rank's share gathered and judged in one
    device's layout; ``choice_flips``: the cycle filter's kept points, the
    head's hard argmax, each of which must lie at its threshold within the
    runs' noise), a fourth eager run G from the same state takes the
    graph's recorded choices at every step (``follow_run``; on a mesh every
    rank runs G, each taking its own share of the argmax and the whole kept
    set), and the loss terms (this rank's shares), parameters and BN
    statistics are held to G alone (within the same factor of A-C's spread
    and the same floor): a choice taken otherwise moves the head's
    small-gradient weights through Adam far beyond what three runs that
    agreed on it spread. On a mesh a run whose cycle filter differs between
    ranks is a miss of its own. No host sync under
    torch.cuda.set_sync_debug_mode("error") over a replayed chunk; the card
    ran K1-fwd and K1-bwd 3 times each a replay in a trace. A miss names
    every row of the summary that missed and, for a loss term, its values
    step by step in the graph and in eager A-C; on a mesh each rank prints
    its free and reserved memory before each capture and at each verdict,
    and every rank raises with every rank's misses (``mesh.agree``).
    Measured: in turns (graph, eager, eager, graph chunks; host clock, synchronised)
    ms/iter and peak memory of each; then TRACE_STEPS steps of each under
    torch.profiler: the card's busy share and NCCL's share of the device
    time. -> {gates: {"rule": the verdicts' line, "lr_step", "capture_ms",
    "peak_capture", "peak_eager_a", "times": {graphed: [ms/iter]}, "peaks":
    {graphed: bytes}, "busy": {graphed: (ms/iter, busy, nccl share)},
    "digest": a hash of the graph run's parameters and BN statistics,
    "digest_g": eager G's (None where G did not run), "took": the ranks
    whose share took a choice no eager run took}}."""
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    from dino_tracker_tpu_torch.training import train
    every, gamma = cfg.apply_scheduler_every, cfg.scheduler_gamma

    def fresh(state):
        model = trainer.init_model().train()
        opt, sched = train.make_optimizer(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(2)
        if state is not None:  # a copy: the optimizer would keep state's tensors
            state = copy.deepcopy(state)
            model.load_state_dict(state["model"])
            train.load_optimizer_state(opt, state["optimizer"])
            sched.load_state_dict(state["scheduler"])
            gen.set_state(state["generator"])
        return model, train.StepRunner(model, opt, sched, gen, cfg, tcfg, mesh)

    def chunk(runner, gates, graphed, n=CHUNK_STEPS):
        t0 = time.perf_counter()
        if graphed:
            runner.run(data, gates, gates, n)
        else:
            for _ in range(n):
                runner.step(data, gates, gates)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def note(what):  # on a mesh, where each rank got to (a hang names its place)
        if mesh is not None:
            print(f"[rank {mesh.rank}] train chunks, gates {gates}: {what}", flush=True)

    if mesh is not None:  # a rank that hangs prints its Python stack
        faulthandler.dump_traceback_later(MESH_STACK_DUMP_S, repeat=True)
    results = {}
    for gates in (False, True):
        model, runner = fresh(None)
        check(runner.graphed, f"the step on {dev} is not captured: {runner.eager_because}")
        for _ in range(CHUNK_START):
            runner.step(data, gates, gates)
        start = copy.deepcopy(train.train_state(model, runner.opt, runner.sched,
                                                runner.generator, CHUNK_START))
        p_names, _, b_names, _ = model_state(model)
        del model, runner
        runs, kept = {}, {}
        for name in ("eager A", "eager B", "graph", "eager C"):
            model, runner = fresh(start)
            torch.cuda.reset_peak_memory_stats()
            with StepRecorder(CHUNK_STEPS, cfg, dev, runner.sched.lr) as rec:
                if name == "graph":  # the warm-up step and the capture, then replays
                    note(f"before the capture: {memory_line(dev)}")
                    ms = chunk(runner, gates, True, 1)
                    chunk(runner, gates, True, CHUNK_STEPS - 1)
                else:
                    ms = chunk(runner, gates, False)
            runs[name] = (rec, *model_state(model)[1::2], ms,
                          torch.cuda.max_memory_allocated(), int(runner.sched.count))
            note(f"{name} done")
            if name in ("graph", "eager C"):
                kept[name] = runner
            del model, runner
        a, g = runs["eager A"], runs["graph"]
        eager_recs = [runs[k][0] for k in ("eager A", "eager B", "eager C")]
        choices = chunk_choices(g[0], eager_recs, cfg, mesh)
        held_to = None  # eager G: (its recorder, parameters, BN statistics)
        if choices.steps:  # from the state, the graph's choices (this rank's)
            model, runner = fresh(start)
            held_to = follow_run(model, runner.sched.lr,
                                 lambda: runner.step(data, gates, gates), CHUNK_STEPS, cfg,
                                 dev, g[0])
            del model, runner
        reserved = torch.cuda.memory_reserved(dev)
        note(f"the verdict: {memory_line(dev)}")
        # every rank learns of any rank's miss or fault before the next collective
        misses = []
        try:
            if not all(torch.equal(getattr(g[0], k), getattr(a[0], k))
                       for k in ("frames", "src", "tgt", "lrs")):
                misses.append("the graph's batches or learning rates differ from the eager "
                              "steps'")
            same = [torch.equal(g[0].src[k], g[0].src[k + 1]) and torch.equal(
                g[0].tgt[k], g[0].tgt[k + 1]) for k in range(CHUNK_STEPS - 1)]
            if any(same):
                misses.append(f"replays drew the same batch: {same}")
            lrs = g[0].lrs.double().cpu().numpy()
            want = cfg.lr_delta_dino * gamma ** ((CHUNK_START + np.arange(CHUNK_STEPS)) // every)
            cross = every - CHUNK_START
            if not (np.abs(lrs / want - 1).max() <= 1e-6 and lrs[cross] < lrs[cross - 1]
                    and g[5] == CHUNK_START + CHUNK_STEPS):
                misses.append(f"the schedule inside the graph: rates {lrs}, expected {want}, "
                              f"count {g[5]}")
            eager = [runs[k] for k in ("eager A", "eager B", "eager C")]
            misses += choices.misses
            if held_to is None:  # loss_rules: CYCLE_TERMS without the cycle flips
                losses_held, every_step, loss_rows = loss_rules(
                    g[0], eager_recs, cfg.cyc_thresh, cfg.train_batch_size,
                    choices.whole)[1:]
            else:  # every term's series held to eager G's
                every_step = loss_rows = spread_rows(
                    train.METRICS, list(g[0].losses.T), [list(r.losses.T) for r in eager_recs],
                    floor=CHUNK_LOSS_FLOOR, ref=list(held_to[0].losses.T))
                losses_held = spread_summary("losses", loss_rows)
            ref = (lambda j: None) if held_to is None else (lambda j: held_to[j])
            bn_rows = spread_rows(b_names, g[2], [r[2] for r in eager],
                                  from_state(start, b_names), ref=ref(2))
            first = f" (the first in rank {', '.join(map(str, choices.first))}'s share)"
            verdicts = [(choices.ok, choices.line + "; held to " + (
                            f"eager G, which took the graph's choices at steps "
                            f"{choices.steps}{first if mesh_lib.is_parallel(mesh) else ''}"
                            if held_to is not None else "eager A-C")),
                        losses_held,
                        params_summary(p_names, g[1], [r[1] for r in eager],
                                       from_state(start, p_names), CHUNK_STEPS,
                                       cfg.lr_cnn_refiner, ref=ref(1)),
                        spread_summary("BN statistics' change", bn_rows)]
            if not all(v[0] for v in verdicts):
                misses.append("the graph disagrees with the eager steps: "
                              + "; ".join(v[1] for v in verdicts if not v[0]))
                if not losses_held[0]:
                    misses.append(loss_series(train.METRICS, loss_rows, list(g[0].losses.T),
                                              [list(r[0].losses.T) for r in eager]))
        except Exception:  # a fault of this rank's checks, reported on every rank
            misses.append(traceback.format_exc())
        mesh_lib.agree("; ".join(misses) or None, None, mesh,
                       f"train chunks, gates {gates}")
        note(f"compared: {'; '.join(v[1] for v in verdicts)}")
        graph, eager = kept["graph"], kept["eager C"]
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chunk(graph, gates, True)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        times, peaks = {True: [], False: []}, {True: 0, False: 0}
        for graphed in (True, False, False, True):
            torch.cuda.reset_peak_memory_stats()
            times[graphed].append(chunk(graph if graphed else eager, gates, graphed))
            peaks[graphed] = max(peaks[graphed], torch.cuda.max_memory_allocated())
        note(f"in turns: replayed {times[True]}, eager {times[False]} ms/iter, peak "
             f"{peaks[True]} / {peaks[False]} B, capture {g[3]:.1f} ms")
        results[gates] = dict(
            rule=("; ".join(v[1] for v in verdicts)), lr_step=lrs[cross] / lrs[cross - 1],
            loss_rows=(rows_line(every_step), rows_line(loss_rows)),
            capture_ms=g[3], peak_capture=g[4], peak_eager_a=a[4], reserved=reserved,
            times=times, peaks=peaks, digest=digest(g[1] + g[2]),
            digest_g=None if held_to is None else digest(held_to[1] + held_to[2]),
            took=choices.took,
            # the graph writes into its recorder's buffers: they live as long
            runners=(graph, eager, runs["graph"][0]))
        del kept, runs
    for gates, r in results.items():  # traces last: every number above is kept
        graph, eager, _ = r.pop("runners")
        r["busy"] = {}
        for graphed in (True, False):
            wall, device_ms, ran, nccl_ms = traced(
                lambda: chunk(graph if graphed else eager, gates, graphed, TRACE_STEPS))
            r["busy"][graphed] = (wall / TRACE_STEPS, device_ms / wall, nccl_ms / device_ms)
            if graphed:
                check(ran[:2] == [3 * TRACE_STEPS] * 2, f"gates {gates}: the card ran K1-fwd / "
                      f"K1-bwd {ran[:2]} times in {TRACE_STEPS} replays")
                # a mesh rank's share of the head's maps may be empty
                head = [n * TRACE_STEPS for n in HEAD_LAUNCHES[gates]]
                check(mesh is not None or ran[2:4] == head, f"gates {gates}: the card ran "
                      f"K4-fwd / K4-bwd {ran[2:4]} times in {TRACE_STEPS} replays, expected "
                      f"{head}")
                check(ran[4:] == [BN_LAYERS * TRACE_STEPS] * len(K5_KERNELS),
                      f"gates {gates}: the card ran K5's kernels {K5_KERNELS} {ran[4:]} "
                      f"times in {TRACE_STEPS} replays, {BN_LAYERS} each a step expected")
        note(f"traced: {r['busy']}")
        graph.release()
        eager.release()
        del graph, eager
    if mesh is not None:
        faulthandler.cancel_dump_traceback_later()
    return results


def print_chunks(results, cfg, smi, what="train chunks"):
    """``train_chunks``'s results on one card, two lines for each set of
    gates, each line starting with ``what``."""
    for gates, r in results.items():
        on = "on" if gates else "off"
        print(f"{what}, gates {on}: {CHUNK_STEPS} replays vs "
              f"{CHUNK_STEPS} eager steps from one state at count {CHUNK_START}: batches "
              f"and learning rates equal (the rate x{r['lr_step']:.6f} at count "
              f"{cfg.apply_scheduler_every}), consecutive batches differ; each tensor's "
              f"median L2 distance to eager A, B, C against {CHUNK_TOL_FACTOR:g}x their "
              f"spread + {CHUNK_LOSS_FLOOR:g} of a loss term, {CHUNK_CHANGE_FLOOR:g} of a "
              f"change: {r['rule']}; the warm-up step and the capture {r['capture_ms']:.1f} "
              f"ms, peak allocated {r['peak_capture'] / 2**30:.2f} GiB (eager A "
              f"{r['peak_eager_a'] / 2**30:.2f})", flush=True)
        times, peaks, busy = r["times"], r["peaks"], r["busy"]
        print(f"{what}, gates {on}: a replayed chunk under "
              f"set_sync_debug_mode('error'): no sync; in turns (graph, eager, eager, graph; "
              f"{CHUNK_STEPS} steps each): graphed {', '.join(f'{t:.2f}' for t in times[True])} "
              f"ms/iter, eager {', '.join(f'{t:.2f}' for t in times[False])} ms/iter; peak "
              f"allocated while replaying {peaks[True] / 2**30:.2f} GiB (the graph's pool, "
              f"reserved at capture, not counted), eager {peaks[False] / 2**30:.2f} GiB; "
              f"under torch.profiler ({TRACE_STEPS} steps): graphed {busy[True][0]:.2f} "
              f"ms/iter, the card busy {busy[True][1]:.4f} of it (K1-fwd and K1-bwd ran "
              f"{3 * TRACE_STEPS} times each in the replays), eager {busy[False][0]:.2f} "
              f"ms/iter, busy {busy[False][1]:.4f} [{smi}]", flush=True)
        every_step, steady = r["loss_rows"]
        print(f"{what}, gates {on}: loss rows over every step (the rule before "
              f"{', '.join(CYCLE_TERMS)} left out the steps where the graph's cycle filter "
              f"kept other points) {every_step}; as held {steady}", flush=True)


def phase_train_chunks(dev, trainer, cfg, tcfg, data, smi):
    """``train_chunks`` on the one card, printed; then a step with an
    .item() injected must fail capture and raise, naming the line."""
    from dino_tracker_tpu_torch.training import train
    print_chunks(train_chunks(dev, trainer, cfg, tcfg, data), cfg, smi)

    # a step that syncs: the capture raises and names the line
    model = trainer.init_model().train()
    opt, sched = train.make_optimizer(model, cfg)
    runner = train.StepRunner(model, opt, sched,
                              torch.Generator(device=dev).manual_seed(2), cfg, tcfg)
    losses = train.step_losses

    def syncing(*args, **kwargs):
        total, metrics = losses(*args, **kwargs)
        total.item()
        return total, metrics

    train.step_losses = syncing
    try:
        runner.run(data, False, False, 2)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        train.step_losses = losses
    check(raised is not None and "total.item()" in raised,
          f"a step with an .item() was captured: {raised}")
    print(f"train chunks: a step with .item() injected fails capture: {raised[:300]}",
          flush=True)
    del model, runner


def bank_tensors(data):
    """The tensors of ``data``'s two trajectory banks."""
    return [x for bank in (data.fg_bank, data.bg_bank) for x in bank
            if isinstance(x, torch.Tensor)]


class SavedAt:
    """Test-only wrapper of ``train.train_state`` (patched in while
    entered): where a Trainer makes its checkpoint's state at step ``at``,
    ``snap`` keeps the Trainer's own state in memory beside it: every
    parameter and buffer by name (non-persistent ones included), Adam's
    state by parameter name, the schedule's device rate and count, the
    generator state and copies of ``data``'s trajectory banks."""

    def __init__(self, at, data):
        from dino_tracker_tpu_torch.training import train
        self.train, self.at, self.data, self.snap = train, at, data, None

    def train_state(self, model, opt, sched, generator, step):
        state = self._state(model, opt, sched, generator, step)
        if step == self.at:
            name = {id(p): n for n, p in model.named_parameters()}
            order = [name[id(p)] for g in opt.param_groups for p in g["params"]]
            self.snap = dict(
                tensors={n: t.detach().clone() for n, t in
                         [*model.named_parameters(), *model.named_buffers()]},
                # .get: indexing the optimizer's defaultdict would add state
                adam={name[id(p)]: {k: v.clone() if torch.is_tensor(v) else v
                                    for k, v in opt.state.get(p, {}).items()}
                      for g in opt.param_groups for p in g["params"]},
                order=order, lr=sched.lr.clone(), count=sched.count.clone(),
                generator=generator.get_state(),
                banks=[x.clone() for x in bank_tensors(self.data)])
        return state

    def __enter__(self):
        self._state, self.train.train_state = self.train.train_state, self.train_state
        return self

    def __exit__(self, *exc):
        self.train.train_state = self._state


def compare_saved(snap, state, fresh, data, cfg):
    """``SavedAt``'s snapshot against the checkpoint ``state`` it was saved
    as, bit for bit: every parameter and buffer (one the file lacks must
    equal ``fresh``'s, a newly initialised model's: the resumed run rebuilds
    it), Adam's moments and step counts, the rate and count (and the rate a
    resumed ``LRSchedule`` computes from the count), the generator state,
    and ``data``'s banks as a resumed run finds them -> (all equal, a
    line)."""
    from dino_tracker_tpu_torch.training import train
    same = lambda a, b: (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                         and torch.equal(a, b.to(a.device)))
    saved = state["model"]
    missing = [n for n in snap["tensors"] if n not in saved]
    fresh_t = dict([*fresh.named_parameters(), *fresh.named_buffers()])
    differ = [n for n, t in snap["tensors"].items()
              if not same(t, saved[n] if n in saved else fresh_t[n])]
    adam, n_adam = state["optimizer"]["state"], 0
    for i, n in enumerate(snap["order"]):
        for k, v in snap["adam"][n].items():
            n_adam += 1
            if i not in adam or not (same(v, adam[i][k]) if torch.is_tensor(v)
                                     else v == adam[i][k]):
                differ.append(f"Adam {n}.{k}")
    again = train.LRSchedule(torch.zeros_like(snap["lr"]), cfg.lr_delta_dino,
                             cfg.scheduler_gamma, cfg.apply_scheduler_every)
    again.load_state_dict(state["scheduler"])
    if not (int(snap["count"]) == state["scheduler"]["last_epoch"]
            and float(snap["lr"]) == state["optimizer"]["param_groups"][0]["lr"]
            and same(snap["lr"], again.lr)):
        differ.append(f"the schedule: rate {float(snap['lr'])!r}, count {int(snap['count'])} "
                      f"in memory; {state['optimizer']['param_groups'][0]['lr']!r}, "
                      f"{state['scheduler']['last_epoch']} saved")
    if not same(snap["generator"], state["generator"]):
        differ.append("the generator state")
    banks = bank_tensors(data)
    if len(banks) != len(snap["banks"]) or not all(map(same, snap["banks"], banks)):
        differ.append("the trajectory banks")
    line = (f"{len(snap['tensors'])} parameters and buffers ({len(missing)} not in the file"
            + (f": {', '.join(missing)}, each equal to a fresh init's" if missing else "")
            + f"), Adam's {n_adam} moments and step counts, the rate "
            f"{float(snap['lr']):.9g} and count {int(snap['count'])}, the generator, "
            f"{len(banks)} bank tensors: " + (f"DIFFER: {', '.join(differ)}" if differ
                                             else "all equal bit for bit"))
    return not differ, line


def resumed_run(long, tcfg, data, folder, source, dev, log_interval, graphed,
                follow=None):
    """The Trainer from ``source`` (a checkpoint file to copy, or a state to
    save, as state_<long.checkpoint_interval>.pt in a fresh ``folder``) to
    ``long.total_iterations``: eagerly, or in chunks of replays where
    ``graphed``; with ``follow`` (recorder rows) taking those choices
    (``FollowChoices``) -> (the final checkpoint, the run's own
    ``StepRecorder`` rows)."""
    from dino_tracker_tpu_torch.training import checkpoint, train
    end, at = long.total_iterations, long.checkpoint_interval
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    if isinstance(source, str):
        shutil.copy(source, folder)
    else:
        checkpoint.save_state(folder, source, at)
    with contextlib.ExitStack() as stack:
        stack.enter_context(eager_trainer(not graphed))
        rec = stack.enter_context(StepRecorder(end - at, long, dev))
        if follow is not None:
            stack.enter_context(FollowChoices(follow))
        train.Trainer(long, tcfg, data, folder, seed=2, device=dev).train(
            log_interval=log_interval)
    return checkpoint.load_state(folder, end, map_location=dev), rec.rows(0, end - at)


def resume_check(dev, long, tcfg, data, ckpt_folder, log_interval, names, r_rows, work,
                 start=None):
    """The rule a run resumed from a checkpoint that replays wrote is held
    to. R is the Trainer's own run through ``ckpt_folder``'s
    state_<long.checkpoint_interval>.pt to ``long.total_iterations``
    (``r_rows``: its ``StepRecorder`` rows from that step on). From that
    file (or from ``start``, a state put in its place) the Trainer runs to
    the end three times eagerly (E1, E2, E3) and once in chunks of replays
    (S), each recorded. Checked: every final generator state equals R's bit
    for bit, and so do the schedule's count and Adam's step counts; R's and
    S's batches and rates equal E1-E3's at every step. Each of R and S: its
    discrete choices that no eager run took (``choice_flips``: the cycle
    filter's kept points, the head's argmax), those of the first such step
    each at its threshold within the runs' noise; where it took any, a
    fourth eager run
    from the file that takes its recorded choices at every step (E_R, E_S;
    ``FollowChoices``) is the run it is held to, else E1-E3: its
    parameters and BN statistics, as changes from the file's, lie from the
    eager runs (the median distance; from E_R or E_S alone) within
    CHUNK_TOL_FACTOR times E1-E3's own spread plus CHUNK_CHANGE_FLOOR of the
    change's scale. ``names``: the parameter and BN-statistic names
    (``model_state``). -> (every check met, [(met, line)], {"R": steps with
    a choice no eager run took, "S": ...}), steps counted from the file's."""
    from dino_tracker_tpu_torch.training import checkpoint
    end, at = long.total_iterations, long.checkpoint_interval
    source = checkpoint.checkpoint_file(ckpt_folder, at) if start is None else start
    if start is None:
        start = checkpoint.load_state(ckpt_folder, at, map_location=dev)
    finals = {"R": checkpoint.load_state(ckpt_folder, end, map_location=dev)}
    recs = {"R": r_rows}
    for name in ("E1", "E2", "S", "E3"):
        finals[name], recs[name] = resumed_run(long, tcfg, data, os.path.join(work, name),
                                               source, dev, log_interval, name == "S")
    gen = {k: torch.equal(s["generator"], finals["R"]["generator"]) for k, s in finals.items()}
    counts = {k: (s["scheduler"]["last_epoch"],
                  sorted({int(v["step"]) for v in s["optimizer"]["state"].values()}))
              for k, s in finals.items()}
    results = [(all(gen.values()) and all(c == (end, [end]) for c in counts.values()),
                f"final generator equal to R's {gen}, (schedule count, Adam steps) {counts}, "
                f"expected {end}")]
    eager_recs = [recs[k] for k in ("E1", "E2", "E3")]
    eager = [finals[k] for k in ("E1", "E2", "E3")]
    p_names, b_names = names
    only = {}
    for name in ("R", "S"):
        x = recs[name]
        same = all(torch.equal(getattr(x, k), getattr(e, k)) for e in eager_recs
                   for k in ("frames", "src", "tgt", "lrs"))
        steps, explained, line = choice_flips(x, eager_recs, long.cyc_thresh,
                                              long.train_batch_size)
        only[name] = steps
        ref = None
        if steps:
            finals["E_" + name] = resumed_run(long, tcfg, data, os.path.join(work, "E_" + name),
                                              source, dev, log_interval, False, follow=x)[0]
            ref = lambda names, k=name: from_state(finals["E_" + k], names)
            grads = torch.stack([e.head_grads for e in eager_recs]).median(0).values
            j = HEAD_TENSORS.index("tracker_head.conv2.weight")
            line += "; conv2.weight's gradient norm at those steps, run / eager median: " + (
                ", ".join(f"{k} {float(x.head_grads[k, j]):.4g} / {float(grads[k, j]):.4g}"
                          for k in steps[:6]))
        results.append((same and explained,
                        f"{name}: batches and rates equal to E1-E3's at every step: {same}; "
                        f"{line}; held to " + (f"E_{name}, which took its choices"
                                               if steps else "E1-E3")))
        at_ = lambda names: (from_state(finals[name], names),
                             [from_state(e, names) for e in eager], from_state(start, names))
        held = lambda names: None if ref is None else ref(names)
        results += [(good, f"{name} {text}") for good, text in (
            params_summary(p_names, *at_(p_names), end - at, long.lr_cnn_refiner,
                           ref=held(p_names)),
            spread_summary("BN statistics' change",
                           spread_rows(b_names, *at_(b_names), ref=held(b_names))))]
    return all(r[0] for r in results), results, only


# the faults planted in a checkpoint that the resume check must catch
RESUME_FAULTS = ("Adam moments zeroed", "BN running statistics reset",
                 "generator state from the step before")


def planted(state, kind, generator):
    """A copy of checkpoint ``state`` with fault ``kind`` (RESUME_FAULTS)
    planted; ``generator``: the generator state of the step before."""
    s = copy.deepcopy(state)
    if kind == RESUME_FAULTS[0]:
        for v in s["optimizer"]["state"].values():
            v["exp_avg"].zero_()
            v["exp_avg_sq"].zero_()
    elif kind == RESUME_FAULTS[1]:
        for k, v in s["model"].items():
            if k.endswith("running_mean") or k.endswith("num_batches_tracked"):
                v.zero_()
            elif k.endswith("running_var"):
                v.fill_(1.0)
    else:
        s["generator"] = generator.clone()
    return s


def resume_faults(dev, long, tcfg, data, ckpt_folder, log_interval, names, r_rows, work):
    """``resume_check`` with each of RESUME_FAULTS planted in the file E1-E3,
    S and E_R resume from (the generator of the step before from a Trainer
    run to that step) -> [(fault, the check met, its [(met, line)])]."""
    from dino_tracker_tpu_torch.training import checkpoint, train
    at = long.checkpoint_interval
    start = checkpoint.load_state(ckpt_folder, at, map_location=dev)
    folder = os.path.join(work, "before")
    shutil.rmtree(folder, ignore_errors=True)
    train.Trainer(dataclasses.replace(long, total_iterations=at - 1), tcfg, data, folder,
                  seed=2, device=dev).train(log_interval=log_interval)
    before = checkpoint.load_state(folder, at - 1, map_location=dev)["generator"]
    out = []
    for k, kind in enumerate(RESUME_FAULTS):
        ok, results, _ = resume_check(dev, long, tcfg, data, ckpt_folder, log_interval, names,
                                      r_rows, os.path.join(work, f"fault_{k}"),
                                      planted(start, kind, before))
        out.append((kind, ok, results))
    return out


def phase_train_resume(dev, long, tcfg, data, ckpt_folder, log_interval, names, r_rows,
                       faults=False):
    """``resume_check`` on phase 5's Trainer run R, printed; raises where a
    check missed. With ``faults``, then ``resume_faults``: the check must
    miss each planted fault."""
    at = long.checkpoint_interval
    ok, results, only = resume_check(dev, long, tcfg, data, ckpt_folder, log_interval, names,
                                     r_rows, os.path.join(WORK_DIR, "resume"))
    print(f"train resume: from R's state_{at}.pt (written after replays) to "
          f"{long.total_iterations}, eagerly three times (E1-E3) and in chunks of replays (S); "
          f"steps with a choice no eager run took: R {[at + k for k in only['R']]}, S "
          f"{[at + k for k in only['S']]}; each tensor's L2 distance against "
          f"{CHUNK_TOL_FACTOR:g}x E1-E3's spread + {CHUNK_CHANGE_FLOOR:g} of its change: "
          + "; ".join(line for _, line in results), flush=True)
    check(ok, "a run resumed from a checkpoint written after replays left the eager runs: "
          + "; ".join(line for good, line in results if not good))
    if not faults:
        return
    for kind, met, results in resume_faults(dev, long, tcfg, data, ckpt_folder, log_interval,
                                            names, r_rows,
                                            os.path.join(WORK_DIR, "resume_faults")):
        missed = [line for good, line in results if not good]
        print(f"train resume, planted fault ({kind}): the check "
              f"{'MET' if met else 'missed'}: " + "; ".join(missed), flush=True)
        check(not met, f"the resume check did not miss a checkpoint with {kind}")


def phase_train(bp, dev, video, dino, smi, faults=False):
    """The training slice at full width; returns the K1-fwd, K1-bwd, K4-fwd,
    K4-bwd, K5-fwd and K5-bwd launches of its main path (K5-bwd's in the
    replays counted by its input gradient's kernel): the timed train_step
    loop (the wrappers' counts) and the Trainer's run in chunks (the
    wrappers' counts of its eager warm-up steps, and the kernels the card ran
    in its replays, traced by torch.profiler). The Trainer's run is R of the resume check: every
    step recorded (``StepRecorder``, in place before its captures) and its
    state in memory at its checkpoint held to the file bit for bit
    (``SavedAt``, ``compare_saved``). ``faults``: ``phase_train_resume``'s."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.training import checkpoint, train
    from dino_tracker_tpu_torch.training.step_graph import StepGraph
    cfg = TrainConfig()  # the reference's config/train.yaml defaults
    tcfg = TrackerConfig(video_h=H, video_w=W, delta_channels=CHANNELS,
                         compute_dtype=cfg.compute_dtype)
    data = make_train_data(video, dino, dev, 5)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt_folder = os.path.join(WORK_DIR, "models", "dino_tracker")
    trainer = train.Trainer(cfg, tcfg, data, ckpt_folder, seed=2, device=dev)
    model = trainer.init_model().train()
    init = [p.detach().clone() for p in model.parameters()]
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []

    def run(n, gates):
        t0 = time.perf_counter()
        for _ in range(n):
            history.append(train.train_step(model, opt, sched, data, gen, gates,
                                            gates, cfg, tcfg))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    # the main path: the train step, then the Trainer in chunks from its init
    long = dataclasses.replace(cfg, total_iterations=TRAINER_ITERATIONS,
                               checkpoint_interval=TRAINER_CHECKPOINT,
                               apply_cyc_after=TRAINER_GATES,
                               apply_cl_ref_after=TRAINER_GATES)
    reset_counts()
    first_ms = run(1, False)
    run(WARMUP_STEPS - 1, False)
    off_ms = run(OFF_STEPS, False)
    m_off = history[-1]
    run(WARMUP_STEPS - 1, True)
    on_ms = run(ON_STEPS, True)
    m_on = history[-1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = [count_syncs(lambda: train.train_step(model, opt, sched, data, gen, g, g, cfg,
                                                   tcfg)) for g in (False, True)]
    t0 = time.perf_counter()
    with TracedReplays() as watch, StepRecorder(TRAINER_ITERATIONS, long, dev) as r_rec, \
            SavedAt(TRAINER_CHECKPOINT, data) as saved:
        train.Trainer(long, tcfg, data, ckpt_folder, seed=2, device=dev).train(
            log_interval=TRAINER_LOG)
    trainer_s = time.perf_counter() - t0
    captures, replays = StepGraph.captures, StepGraph.replays
    calls = counted("blurpool_down_nhwc", "blurpool_up_nhwc")
    launches = (calls[0] + watch.ran[0], calls[1] + watch.ran[1])
    eager_steps = len(history) + 2 + captures
    check(calls == (3 * eager_steps,) * 2 and watch.ran[:2] == [3 * replays] * 2
          and captures == 2 and captures + replays == TRAINER_ITERATIONS,
          f"K1-fwd / K1-bwd: the wrappers launched {calls} times in {eager_steps} eager "
          f"steps, the card ran {watch.ran[:2]} in {replays} replays of "
          f"{captures} captures; expected 3 a step, 2 captures (one a set of gates) "
          f"and {TRAINER_ITERATIONS} steps of the Trainer")
    # K4 by gates: eager steps (the loop's, count_syncs' one and a capture's
    # warm-up step of each set) and replays (the Trainer's, the gates on from
    # TRAINER_GATES), each HEAD_LAUNCHES a step
    eager = {False: WARMUP_STEPS + OFF_STEPS + 2, True: WARMUP_STEPS - 1 + ON_STEPS + 2}
    replayed = {False: TRAINER_GATES - 1, True: replays - TRAINER_GATES + 1}
    head_calls = counted("head_conv_fwd", "head_conv_bwd")
    want = [tuple(sum(n[g] * HEAD_LAUNCHES[g][i] for g in (False, True)) for i in (0, 1))
            for n in (eager, replayed)]
    check(head_calls == want[0] and tuple(watch.ran[2:4]) == want[1],
          f"K4-fwd / K4-bwd: the wrappers launched {head_calls} times in the eager steps, "
          f"the card ran {watch.ran[2:4]} in the replays; expected {want[0]} and {want[1]}")
    # K5: a wrapper call a refiner layer a direction in each eager step, and
    # each of its kernels once a layer in each replay
    bn_calls = counted("batchnorm_fwd", "batchnorm_bwd")
    check(bn_calls == (BN_LAYERS * eager_steps,) * 2
          and watch.ran[4:] == [BN_LAYERS * replays] * len(K5_KERNELS),
          f"K5-fwd / K5-bwd: the wrappers launched {bn_calls} times in {eager_steps} eager "
          f"steps, the card ran {K5_KERNELS} {watch.ran[4:]} times in {replays} replays; "
          f"expected {BN_LAYERS} a step each")
    bn_launches = (bn_calls[0] + watch.ran[4], bn_calls[1] + watch.ran[7])
    values = torch.stack([torch.stack(list(m.values())) for m in history])
    check(bool(values.isfinite().all()), "a non-finite loss term")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    check(len(grads) > 0 and all(bool(gr.isfinite().all()) for gr in grads),
          "a non-finite gradient")
    moved = sum(not torch.equal(a, p) for a, p in zip(init, model.parameters()))
    check(moved == len(grads), f"{moved} parameter tensors moved, "
          f"{len(grads)} have gradients")
    steps_saved = checkpoint.checkpoint_steps(ckpt_folder)
    check(steps_saved == [TRAINER_ITERATIONS, TRAINER_CHECKPOINT],
          f"Trainer wrote checkpoints {steps_saved}")
    same, line = compare_saved(saved.snap, checkpoint.load_state(
        ckpt_folder, TRAINER_CHECKPOINT, map_location=dev), trainer.init_model(), data, long)
    print(f"train resume: the Trainer's state in memory at {TRAINER_CHECKPOINT} against its "
          f"state_{TRAINER_CHECKPOINT}.pt: {line}", flush=True)
    check(same, f"the Trainer's state_{TRAINER_CHECKPOINT}.pt lacks state it carries: {line}")
    names = model_state(model)[::2]
    del model, opt, sched, history
    fmt = lambda m: ", ".join(f"{k} {float(v):.6g}" for k, v in m.items())
    print(f"train: T={T} {W}x{H} C={CHANNELS[-1]} bf16, batch "
          f"{cfg.train_batch_size}x{cfg.batch_n_frames} frames, "
          f"{N_FG_TRAJ}+{N_BG_TRAJ} trajectories: first step {first_ms:.1f} ms, "
          f"gates off {off_ms:.2f} ms/iter ({OFF_STEPS} steps), gates on "
          f"{on_ms:.2f} ms/iter ({ON_STEPS} steps), peak memory {peak:.2f} GiB; host "
          f"syncs in a train_step with the gates off / on: {len(syncs[0])} / "
          f"{len(syncs[1])}; the Trainer {TRAINER_ITERATIONS} iterations in chunks (gates "
          f"at {TRAINER_GATES}, checkpoints {steps_saved}, replays traced) {trainer_s:.2f} s: "
          f"{captures} captures, {replays} replays; K1-fwd/K1-bwd launches "
          f"{launches} (wrappers {calls}, traced in replays {tuple(watch.ran[:2])}); "
          f"K4-fwd/K4-bwd launches {tuple(a + b for a, b in zip(head_calls, watch.ran[2:4]))} "
          f"(wrappers {head_calls}, traced in replays {tuple(watch.ran[2:4])}); K5-fwd/K5-bwd "
          f"launches {bn_launches} (wrappers {bn_calls}, traced in replays "
          f"{tuple(watch.ran[4:])} of {K5_KERNELS})", flush=True)
    check(syncs == [[], []], f"the train step makes host syncs (gates off / on): {syncs}")
    print(f"train: losses, gates off: {fmt(m_off)}", flush=True)
    print(f"train: losses, gates on: {fmt(m_on)}", flush=True)

    phase_train_chunks(dev, trainer, cfg, tcfg, data, smi)
    phase_train_resume(dev, long, tcfg, data, ckpt_folder, TRAINER_LOG, names,
                       r_rec.rows(TRAINER_CHECKPOINT, TRAINER_ITERATIONS - TRAINER_CHECKPOINT),
                       faults)
    del r_rec
    head_launches = tuple(a + b for a, b in zip(head_calls, watch.ran[2:4]))

    # serve the Trainer's last checkpoint
    t0 = time.perf_counter()
    served = runtime.load_model(ckpt_folder, tcfg, dev)
    mi = runtime.make_model_inference(served, video, dino, tcfg, ANCHOR_COS, COS)
    qp = queries(np.random.default_rng(7), N_QUERIES, T // 5, H, W)
    trajs, occ = mi.infer(qp)
    check(trajs.shape == (N_QUERIES, T, 2) and occ.shape == (N_QUERIES, T)
          and np.isfinite(trajs).all(), "serving the trained checkpoint failed")
    print(f"train: serve {N_QUERIES} points from state_{TRAINER_ITERATIONS}.pt: "
          f"{time.perf_counter() - t0:.2f} s, tracks finite, occluded share "
          f"{occ.mean():.3f}", flush=True)
    return (*launches, *head_launches, *bn_launches)


def phase_train_reference(dev):
    """One f32 training step on a small input, GPU against CPU: the same
    init (drawn on the CPU), the same injected batch, cycle data and
    contrastive pairs, all six losses. Losses within 1e-4 relative plus
    1e-6 absolute: the two regularisers average |‖r‖/‖d‖ − 1| and
    |cos − 1| over ratios and cosines within ~1e-3 of 1, which f32 resolves
    only to ~1e-7 absolute. Gradients within 1e-3 of each tensor's largest
    magnitude: the row gathers' backward accumulates with atomics on the
    card, so sums land in another order than on the CPU (and from run to
    run)."""
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.models import nn as pnn
    from dino_tracker_tpu_torch.models.tracker import Tracker
    from dino_tracker_tpu_torch.training import cycle, sampler, train
    t, h, w, channels = 6, 70, 98, (3, 8, 8, 8, 32)
    tcfg = TrackerConfig(video_h=h, video_w=w, delta_channels=channels)
    n_feat = tcfg.feat_hw[0] * tcfg.feat_hw[1]
    cfg = TrainConfig(video_resh=h, video_resw=w, train_batch_size=32,
                      batch_n_frames=3, cyc_n_frames=2, cyc_batch_size_per_frame=16,
                      cl_n_frames=2, cl_points_per_pair=2 * n_feat,
                      cl_fg_points_ratio=0.5, compute_dtype="float32")
    cpu = torch.device("cpu")
    video, dino = make_inputs(t, h, w, channels[-1], tcfg.feat_hw, cpu, 4)
    data = make_train_data(video, dino, cpu, 4, bb_cap=24, n_traj=(200, 200))
    gen = torch.Generator().manual_seed(4)
    sample = sampler.sample_batch(gen, data.fg_bank, data.bg_bank, 32, 3, 0.5,
                                  t, w, h)
    p, k = cfg.cyc_n_frames, cfg.cyc_batch_size_per_frame
    sel = torch.randint(0, len(sample.frames_set_t), (2, p), generator=gen)
    pts = [torch.cat([torch.rand((p, k, 2), generator=gen) * torch.tensor([w - 1, h - 1]),
                      sample.frames_set_t[s].float()[:, None, None].expand(p, k, 1)],
                     2).reshape(-1, 3) for s in sel]
    cyc = cycle.CycleData(pts[0], pts[1], sel[0].repeat_interleave(k),
                          sel[1].repeat_interleave(k), torch.rand(p * k, generator=gen) * 4,
                          torch.rand(p * k, generator=gen) < 0.7)
    pairs = (np.array([0, 2]), np.array([1, 0]))
    model = Tracker(tcfg)
    model.reset_parameters(gen)
    pnn.init_conv_(model.delta_dino.layers[-1].conv, gen)  # every layer gets gradient
    with torch.no_grad():  # keep the head's normalized convs well conditioned
        for conv in (model.tracker_head.conv1, model.tracker_head.conv2):
            conv.weight += 0.3
    out = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        md = Tracker(tcfg)
        md.load_state_dict(model.state_dict())
        md = md.to(d).train()
        move = lambda x: x.to(d) if isinstance(x, torch.Tensor) else x
        dd = type(data)(*(type(v)(*map(move, v)) if isinstance(v, tuple) else move(v)
                          for v in data))
        total, metrics = train.step_losses(
            md, dd, type(sample)(*map(move, sample)), None, cfg, tcfg, True,
            True, cyc_data=type(cyc)(*map(move, cyc)), dino_pair_sel=pairs,
            ref_pair_sel=pairs)
        total.backward()
        out[name] = ({k2: float(v) for k2, v in metrics.items()},
                       {n: q.grad.cpu() for n, q in md.named_parameters()
                        if q.grad is not None})
    loss_err, worst = max((abs(out["card"][0][k2] - v) / (1e-4 * abs(v) + 1e-6), k2)
                          for k2, v in out["cpu"][0].items())
    grad_err = max(float((out["card"][1][n] - gr).abs().max() / gr.abs().max())
                   for n, gr in out["cpu"][1].items()
                   if n != "tracker_head.conv2.bias")  # float noise (trap)
    print(f"reference: one f32 train step, T={t} {w}x{h}, all six losses: GPU "
          f"vs CPU losses {json.dumps(out['card'][0])} vs "
          f"{json.dumps(out['cpu'][0])}: worst {worst} at {loss_err:.3g} of its "
          f"bound (1e-4 relative + 1e-6), gradients max diff {grad_err:.3g} of "
          f"each tensor's max (bound 1e-3)", flush=True)
    check(out["card"][1].keys() == out["cpu"][1].keys() and loss_err <= 1.0
          and grad_err <= 1e-3, "GPU and CPU training steps disagree")


def phase_reference(dev):
    """The same entry points on a small f32 input, GPU against CPU."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrackerConfig
    t, h, w, channels = 6, 70, 98, (3, 8, 8, 8, 32)
    tcfg = TrackerConfig(video_h=h, video_w=w, delta_channels=channels)
    rng = np.random.default_rng(2)
    # shift the head taps so each 3×3 kernel's sum (the normalized conv's
    # divisor) stays far from 0: a near-zero sum amplifies the two devices'
    # f32 summation-order differences without bound
    params, stats = full_width_inputs().jax_layout_weights(rng, channels, head_shift=0.3)
    video, dino = make_inputs(t, h, w, channels[-1], tcfg.feat_hw, dev, 3)
    qp = np.concatenate([queries(rng, 8, f, h, w) for f in (0, 3, 5)])
    out = {}
    for d in (dev, torch.device("cpu")):
        mi = runtime.make_model_inference(
            build_model(params, stats, tcfg, d), video.to(d), dino.to(d),
            tcfg, ANCHOR_COS, COS)
        out[d.type] = mi.infer(qp)
    err = np.abs(out["cuda"][0] - out["cpu"][0]).max()
    same_occ = (out["cuda"][1] == out["cpu"][1]).mean()
    print(f"reference: {len(qp)} queries, T={t} {w}x{h}, f32: GPU vs CPU "
          f"trajectories max diff {err:.3g} px (bound 1e-2), occlusion "
          f"agreement {same_occ:.3f} (bound 1.0)", flush=True)
    check(err <= 1e-2 and same_occ == 1.0, "GPU and CPU paths disagree")


def vit_state(cfg, dev, seed):
    """Random ViT weights under the DINOv2 state-dict keys, made on ``dev``:
    linears ~U(±1/√din), non-zero pos-embed (so the bicubic resize does
    work) and layerscale ~U(±0.2)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, scale):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale

    d, hid, p = cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim, cfg.patch_size
    sd = {"patch_embed.proj.weight": u((d, 3, p, p), 1 / math.sqrt(3 * p * p)),
          "patch_embed.proj.bias": u((d,), 0.1), "cls_token": u((1, 1, d), 1.0),
          "pos_embed": u((1, 1 + cfg.pretrain_grid ** 2, d), 1.0)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                                  "mlp.fc1": (hid, d), "mlp.fc2": (d, hid)}.items():
            sd[f"{b}{name}.weight"] = u((dout, din), 1 / math.sqrt(din))
            sd[f"{b}{name}.bias"] = u((dout,), 0.1)
        for name in ("norm1", "norm2"):
            sd[f"{b}{name}.weight"] = 1 + u((d,), 0.2)
            sd[f"{b}{name}.bias"] = u((d,), 0.1)
        if cfg.layerscale:
            sd[f"{b}ls1.gamma"] = u((d,), 0.2)
            sd[f"{b}ls2.gamma"] = u((d,), 0.2)
    return sd


def scene_video(t, h, w, dev, seed):
    """T×3×H×W in [0, 1]: a smooth static background and a bright disk that
    crosses it, plus noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ys = torch.linspace(0, 1, h, device=dev)[:, None]
    xs = torch.linspace(0, 1, w, device=dev)[None, :]
    bg = torch.stack([0.4 + 0.2 * torch.sin(6 * xs + 2 * ys),
                      0.4 + 0.2 * torch.cos(5 * ys - 3 * xs),
                      0.3 + 0.1 * xs + 0.1 * ys])  # 3×H×W
    cx = 0.25 + 0.5 * torch.arange(t, device=dev)[:, None, None] / max(t - 1, 1)
    disk = (((xs - cx) * w / h) ** 2 + (ys - 0.5) ** 2) < 0.2 ** 2  # T×H×W
    fg = torch.tensor([0.9, 0.8, 0.2], device=dev)[None, :, None, None]
    video = torch.where(disk[:, None], fg, bg[None])
    noise = torch.randn(video.shape, generator=g, device=dev) * 0.03
    return (video + noise).clamp(0, 1)


def token_cosines(a, b):
    """Per-token cosine of two T×D×h×w feature videos, flattened."""
    return F.cosine_similarity(a.flatten(2), b.flatten(2), dim=1).flatten()


def phase_vit(dev):
    """The ViT feature stage at full width through the port's entry points;
    returns K2's launch count in it and the features' seconds."""
    from dino_tracker_tpu_torch.config import PreprocessConfig, feature_grid_size
    from dino_tracker_tpu_torch.models import vit, vit_convert
    from dino_tracker_tpu_torch.preprocessing import fg_mask, split_fg_bg
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    from dino_tracker_tpu_torch.utils import video_io
    cfg = PreprocessConfig()  # dinov2_vitl14, layers 15 and 23, stride 7, bf16
    vcfg = vit.ViTConfig.for_model(cfg.dino_model_name)
    model = vit_convert.build_vit(vit_state(vcfg, dev, 6), vcfg, dev)
    h, w = cfg.video_resh, cfg.video_resw
    grid = feature_grid_size(h, w, vcfg.patch_size, cfg.dino_stride)
    video = scene_video(T, h, w, dev, 7)
    root = os.path.join(WORK_DIR, "vit")
    shutil.rmtree(root, ignore_errors=True)
    pipe = PreprocessingPipeline(root, cfg, vit=model, device=dev, frames=video)
    paths = [pipe.paths["dino_embed_video_path"],
             pipe.paths["mask_dino_embed_video_path"]]
    layers = [cfg.dino_layer, cfg.mask_dino_layer]
    rng = np.random.default_rng(8)
    trajs = np.stack([rng.uniform(0, w - 1, (N_SPLIT_TRAJ, T)),
                      rng.uniform(0, h - 1, (N_SPLIT_TRAJ, T))], -1).astype(np.float32)
    trajs[rng.random((N_SPLIT_TRAJ, T)) < 0.3] = np.nan  # late starts and gaps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    feats, mask_feats = pipe.extract_dino_features(layers, paths)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    masks_np = pipe.create_fg_masks(mask_feats)  # and the mask jpgs
    t2 = time.perf_counter()
    fg, bg = pipe.split_trajectories(trajs)  # masks read back, two .npz banks
    t3 = time.perf_counter()
    (launches,) = counted("flash_attention")
    peak = torch.cuda.max_memory_allocated() / 2**30
    pipe.join_saves()
    t4 = time.perf_counter()
    # stages 3-4 again, with the first call's library loads done and the
    # feature artifacts landed: the computation alone, then each entry point
    again = fg_mask.compute_fg_masks(mask_feats, (h, w), cfg.fg_mask_threshold)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    masks_again = pipe.create_fg_masks(mask_feats)
    t6 = time.perf_counter()
    fg_again, _ = pipe.split_trajectories(trajs)
    t7 = time.perf_counter()
    check(np.array_equal(again.cpu().numpy(), masks_np)
          and np.array_equal(masks_again, masks_np)
          and np.array_equal(fg_again, fg, equal_nan=True),
          "stages 3-4 are not deterministic")
    # the mask jpgs read back are the masks in memory (at the midpoint: the
    # jpg rings a few levels around an edge, and the split, as in the
    # reference, takes any value > 0 as fg); the banks written are the split
    # of what was read back
    on_disk = video_io.load_masks(pipe.paths["masks_path"], h, w)
    check(np.array_equal((on_disk > 127).astype(np.float32), masks_np),
          "the mask jpgs do not read back as the masks")
    ref_fg, ref_bg = split_fg_bg.split_fg_bg(trajs, on_disk)
    for name, got, ref in (("fg_trajectories_file", fg, ref_fg),
                           ("bg_trajectories_file", bg, ref_bg)):
        check(np.array_equal(got, ref, equal_nan=True) and np.array_equal(
            video_io.load_npz(pipe.paths[name])["trajectories"], ref, equal_nan=True),
              f"{name} is not the split of the masks on disk")

    depth = max(layers) + 1  # the sweep stops after the deepest layer
    expected = depth * -(-T // cfg.extract_frames_per_batch)
    check(launches == expected, f"K2 launched {launches} times in the ViT "
          f"stage, expected {expected}")
    for f in (feats, mask_feats):
        check(f.shape == (T, vcfg.embed_dim, *grid) and f.dtype == torch.float32
              and bool(f.isfinite().all()), f"features {f.shape} {f.dtype}")
    for path, f in zip(paths, (feats, mask_feats)):
        art = video_io.load_npz(path)["features"]
        check(art.dtype == np.float16 and art.shape == tuple(f.shape)
              and np.array_equal(art[[0, -1]], f[[0, -1]].half().cpu().numpy()),
              f"artifact {path}: {art.dtype} {art.shape}")
    check(masks_np.shape == (T, h, w) and set(np.unique(masks_np)) <= {0.0, 1.0},
          "masks are not T×H×W {0, 1}")
    check(len(fg) + len(bg) == N_SPLIT_TRAJ, "the split lost trajectories")
    fg_share = float(masks_np.mean())
    print(f"vit: {cfg.dino_model_name} T={T} {w}x{h} stride {cfg.dino_stride} "
          f"grid {grid} S={grid[0] * grid[1] + 1} bf16, {cfg.extract_frames_per_batch} "
          f"frames a batch, layers {layers} in one sweep: features {t1 - t0:.3f} s "
          f"({T / (t1 - t0):.2f} frames/s), fg masks with their jpgs "
          f"{t2 - t1:.3f} s, split of {N_SPLIT_TRAJ} trajectories with the "
          f"masks read back and both banks written {t3 - t2:.3f} s ({len(fg)} "
          f"fg / {len(bg)} bg), f16 artifacts joined {t4 - t3:.3f} s later; "
          f"peak memory {peak:.2f} GiB, fg share {fg_share:.4f}, K2 launches "
          f"{launches}", flush=True)
    print(f"vit: again, after the artifacts landed: compute_fg_masks "
          f"{t5 - t4:.3f} s, create_fg_masks {t6 - t5:.3f} s, "
          f"split_trajectories {t7 - t6:.3f} s", flush=True)

    ref = vit.extract_feature_video(model, video[:1], stride=cfg.dino_stride,
                                    layer=layers, compute_dtype=torch.float32)
    cos = torch.cat([token_cosines(f[:1], r) for f, r in zip((feats, mask_feats), ref)])
    cmin, cmed = cos.min().item(), cos.median().item()
    print(f"vit: bf16 vs f32 features on frame 0, layers {layers}: per-token "
          f"cosine min {cmin:.6f}, median {cmed:.6f} (gate: median >= 0.995)",
          flush=True)
    check(cmed >= 0.995, f"bf16 features drift from f32: median cosine {cmed}")
    return launches, t1 - t0


def phase_vit_reference(dev):
    """A small f32 ViT (head dim 64, the dim K2 takes) through
    extract_feature_video and compute_fg_masks, GPU against CPU: features
    within 1e-4 of their max, masks equal."""
    from dino_tracker_tpu_torch.models import vit, vit_convert
    from dino_tracker_tpu_torch.preprocessing import fg_mask
    cpu = torch.device("cpu")
    cfg = vit.ViTConfig(embed_dim=128, depth=3, num_heads=2, mlp_ratio=2,
                        patch_size=14, pretrain_grid=5)
    state = vit_state(cfg, cpu, 9)
    t, h, w = 3, 70, 98
    video = scene_video(t, h, w, cpu, 10)
    out = []  # (features, masks) on the GPU, then on the CPU
    for d in (dev, cpu):
        model = vit_convert.build_vit(state, cfg, d)
        f = vit.extract_feature_video(model, video.to(d), stride=7, layer=[1, 2])
        out.append(([x.cpu() for x in f],
                    fg_mask.compute_fg_masks(f[1], (h, w)).cpu()))
    (gpu_f, gpu_m), (cpu_f, cpu_m) = out
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(gpu_f, cpu_f))
    same = bool(torch.equal(gpu_m, cpu_m))
    print(f"reference: f32 ViT (D=128, 3 blocks, 2 heads) T={t} {w}x{h}: GPU vs "
          f"CPU features max diff {err:.3g} of their max (bound 1e-4), fg masks "
          f"equal {same} (fg share {cpu_m.mean().item():.3f})", flush=True)
    check(err <= 1e-4 and same, "GPU and CPU ViT feature stages disagree")


def corr_lookup_bound(pyramid, coords, radius=4):
    """K3's least time on these inputs: the in-map cells of each pixel's
    10×10 window at every level read once (4 B each), its coordinates (8 B)
    read and its 324 outputs (4 B each) written once; 7 f32 FLOP an output.
    Returns (bound numbers, the all-inside bytes, the sector floor's bytes:
    the same with each in-map window row read as the whole 32-byte sectors
    it spans, which is what device memory moves)."""
    b, _, h, w = coords.shape
    n = b * h * w
    side = 2 * radius + 2
    cells = sectors = 0.0
    pixel = torch.arange(n, device=coords.device, dtype=torch.int64)[:, None]
    for lvl, vol in enumerate(pyramid):
        spans = []  # [lo, hi) of the in-map window, x then y
        for c, size in ((coords[:, 0], vol.shape[2]), (coords[:, 1], vol.shape[1])):
            c = c.reshape(-1)
            if size == 1:  # every tap reads the one cell
                spans.append((torch.zeros_like(c), torch.ones_like(c)))
                continue
            c = torch.clamp(c / 2 ** lvl, -(radius + 1.0), size + radius)
            lo = torch.floor(c) - radius
            spans.append((torch.clamp(lo, min=0),
                          torch.clamp(torch.clamp(lo + side, max=float(size)), min=0)))
        (x0, x1), (y0, y1) = [(a.long(), torch.maximum(a, z).long()) for a, z in spans]
        cells += float(((x1 - x0) * (y1 - y0)).sum())
        hl, wl = vol.shape[1:]
        rows = y0[:, None] + torch.arange(side, device=coords.device)
        live = (rows < y1[:, None]) & (x1 > x0)[:, None]
        start = ((pixel * hl + rows) * wl + x0[:, None]) * 4
        end = ((pixel * hl + rows) * wl + x1[:, None]) * 4
        sectors += float(torch.where(live, (end - 1) // 32 - start // 32 + 1, 0).sum())
    n_out = len(pyramid) * (2 * radius + 1) ** 2
    other = 8 * n + 4 * n_out * n
    ms, by = bound(7.0 * n_out * n, 4 * cells + other, F32_FLOPS)
    return ({"bound_ms": ms, "bound_by": by},
            n * (4 * len(pyramid) * side * side + 8 + 4 * n_out), 32 * sectors + other)


def corr_lookup_grid_sample(pyramid, coords, radius=4):
    """The lookup as four F.grid_sample calls, one per level, each sampling
    its maps at the 9×9 tap grid (torchvision RAFT's CorrBlock form), then a
    cat: timed as K3's library yardstick only; the port never calls it."""
    b, _, h, w = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (dx, dy)
    centre = coords.permute(0, 2, 3, 1).reshape(-1, 1, 1, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        hl, wl = vol.shape[1:]
        pts = centre / 2 ** lvl + delta
        grid = torch.stack([2 * pts[..., 0] / max(wl - 1, 1) - 1,
                            2 * pts[..., 1] / max(hl - 1, 1) - 1], dim=-1)
        out.append(F.grid_sample(vol[:, None], grid, align_corners=True).reshape(b, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def lookup_inputs(dev, b, h, w, seed):
    """A real pyramid (random 256-channel f32 fmaps) and coordinates: the grid
    moved by N(0, 2) px, a tenth of the pixels within 6 px of an edge of the
    map, and one in fifty 50-300 px outside it."""
    from dino_tracker_tpu_torch.models import raft
    g = torch.Generator(device=dev).manual_seed(seed)
    f1, f2 = (torch.randn((b, 256, h, w), generator=g, device=dev) for _ in range(2))
    pyramid = raft.build_corr_pyramid(f1, f2)
    del f1, f2
    coords = raft.coords_grid(b, h, w, dev)
    coords += torch.randn(coords.shape, generator=g, device=dev) * 2

    def rand(scale, shift=0.0):
        return torch.rand((b, h, w), generator=g, device=dev) * scale + shift

    for axis, size in ((0, w), (1, h)):
        edge = rand(1.0) < 0.1
        side = torch.where(rand(1.0) < 0.5, 0.0, size - 1.0)
        coords[:, axis] = torch.where(edge, side + rand(12.0, -6.0), coords[:, axis])
        far = rand(1.0) < 0.02
        sign = torch.where(rand(1.0) < 0.5, -1.0, 1.0)
        coords[:, axis] = torch.where(far, side + sign * rand(250.0, 50.0), coords[:, axis])
    return pyramid, coords.contiguous()


def phase_corr_lookup_check(dev):
    """K3 against corr_lookup_reference at the main path's shape, with the
    bound, kernel, plain and 4× F.grid_sample times from CUDA events."""
    from dino_tracker_tpu_torch.ops import window_gather as wg
    pyramid, coords = lookup_inputs(dev, *LOOKUP_SHAPE, seed=12)
    out = wg.corr_lookup_cuda(pyramid, coords)
    ref = wg.corr_lookup_reference(pyramid, coords)
    lib_out = corr_lookup_grid_sample(pyramid, coords)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    lib_err = (lib_out - ref).abs().max().item()
    check(out.shape == ref.shape == (LOOKUP_SHAPE[0], 324) + LOOKUP_SHAPE[1:]
          and err <= LOOKUP_TOL * scale,
          f"K3 {LOOKUP_SHAPE}: max abs err {err} > bound {LOOKUP_TOL * scale}")
    zero_share = float((ref == 0).float().mean())
    del ref, lib_out
    ms = cuda_ms(lambda: wg.corr_lookup_cuda(pyramid, coords))
    plain_ms = cuda_ms(lambda: wg.corr_lookup_reference(pyramid, coords), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: corr_lookup_grid_sample(pyramid, coords))
    numbers, inside_bytes, sector_bytes = corr_lookup_bound(pyramid, coords)
    least = numbers["bound_ms"]
    floor_ms = sector_bytes / HBM_BYTES * 1e3
    print(f"kernel check: K3 {LOOKUP_SHAPE[0]} pairs x {LOOKUP_SHAPE[1]}x"
          f"{LOOKUP_SHAPE[2]}, levels {[tuple(v.shape[1:]) for v in pyramid]} f32: "
          f"max_abs_err {err:.3g} (bound {LOOKUP_TOL * scale:.3g}; zero outputs "
          f"{zero_share:.3f}), 4x grid_sample max diff {lib_err:.3g}; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms, 4x grid_sample {library_ms:.3f} ms, bound "
          f"{least:.4f} ms ({numbers['bound_by']}; {least / ms:.3f} of it; all "
          f"windows inside: {inside_bytes / HBM_BYTES * 1e3:.4f} ms), sector floor "
          f"{floor_ms:.4f} ms ({floor_ms / ms:.3f} of the kernel's time)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **numbers,
            "library_ms": library_ms}


def raft_state(dev, seed):
    """Random RAFT-large weights under the princeton-vl keys (``module.``
    prefixed), made on ``dev``: convs ~U(±1/√fan_in) (torch's default
    bounds), BN affine and statistics near identity. The flow head's last
    conv is scaled by 0.1: unscaled, the random flows run to a few px with
    forward and backward flows unrelated, so the cycle check kills every
    trajectory; scaled, they stay near 0.3 px, most pixels survive, and the
    harvest works at the load of a real video."""
    from torch import nn
    from dino_tracker_tpu_torch.models import raft
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, scale, shift=0.0):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale + shift

    sd = {}
    for name, m in raft.RAFT().named_modules():
        if isinstance(m, nn.Conv2d):
            bound_ = 1 / math.sqrt(m.weight[0].numel())
            sd[f"{name}.weight"] = u(m.weight.shape, bound_)
            sd[f"{name}.bias"] = u(m.bias.shape, bound_)
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            sd.update({f"{name}.weight": u((c,), 0.2, 1.0), f"{name}.bias": u((c,), 0.1),
                       f"{name}.running_mean": u((c,), 0.1),
                       f"{name}.running_var": u((c,), 0.5, 1.0)})
    for k in ("weight", "bias"):
        sd[f"update_block.flow_head.conv2.{k}"] *= 0.1
    return {f"module.{k}": v for k, v in sd.items()}


def textured_video(t, h, w, dev, shift=(1.5, 0.5)):
    """T×3×H×W in [0, 1]: a smooth colour texture moving by ``shift`` (x, y)
    px a frame."""
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    frames = []
    for i in range(t):
        x, y = xs - shift[0] * i, ys - shift[1] * i
        frames.append(torch.stack([
            0.5 + 0.25 * torch.sin(0.11 * x + 0.05 * y) * torch.cos(0.07 * y),
            0.5 + 0.25 * torch.sin(0.05 * x - 0.13 * y + 1.0),
            0.5 + 0.2 * torch.cos(0.03 * x + 0.02 * y) * torch.sin(0.09 * x)]))
    return torch.stack(frames).clamp(0, 1)


def decode_batches(t, pair_batch=8, min_len=2):
    """Decode batches of stage 1 at T frames: adjacent flows both ways, then
    each start frame's direct flows both ways."""
    per = lambda n: -(-n // pair_batch)
    return 2 * per(t - 1) + 2 * sum(per(t - 1 - s) for s in range(t - (min_len - 1)))


def check_trajectories(trajs, t, h, w, what):
    finite = ~np.isnan(trajs).any(-1)
    check(trajs.ndim == 3 and trajs.shape[1:] == (t, 2) and trajs.dtype == np.float32,
          f"{what}: {trajs.shape} {trajs.dtype}")
    pts = trajs[finite]
    check(np.isfinite(pts).all() and (pts >= 0).all() and (pts[:, 0] <= w - 1).all()
          and (pts[:, 1] <= h - 1).all(), f"{what}: a point outside the frame")
    check((finite.sum(1) >= 2).all(), f"{what}: a trajectory shorter than 2 frames")


def phase_raft(dev, t=RAFT_T):
    """Pipeline stage 1 at full width; returns K3's launch count in it."""
    from dino_tracker_tpu_torch.config import PreprocessConfig
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    from dino_tracker_tpu_torch.utils import video_io
    cfg = PreprocessConfig()  # RAFT 24 iterations f32, thresholds 1.5 / 2.5
    h, w = cfg.video_resh, cfg.video_resw
    model = raft.load_raft_state_dict(raft_state(dev, 11), dev)
    root = os.path.join(WORK_DIR, "raft")
    shutil.rmtree(root, ignore_errors=True)
    pipe = PreprocessingPipeline(root, cfg, device=dev, frames=textured_video(t, h, w, dev),
                                 raft=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    trajs, unfiltered = pipe.extract_trajectories_both()
    total = time.perf_counter() - t0
    (launches,) = counted("corr_lookup")
    peak = torch.cuda.max_memory_allocated() / 2**30
    batches = decode_batches(t)
    check(launches == cfg.raft_iters * batches,
          f"K3 launched {launches} times in stage 1, expected {cfg.raft_iters} x "
          f"{batches} decode batches")
    for arr, what in ((trajs, "filtered"), (unfiltered, "unfiltered")):
        check_trajectories(arr, t, h, w, what)
    check(np.array_equal(video_io.load_npz(pipe.paths["trajectories_file"])["trajectories"],
                         trajs, equal_nan=True), "trajectories.npz is not the result")
    fwd, bwd = pipe.flow_engine.adjacent_flows()
    check(fwd.shape == bwd.shape == (t - 1, 2, h, w) and bool(fwd.isfinite().all())
          and bool(bwd.isfinite().all()), "adjacent flows: shape or non-finite")

    # one full decode batch (8 pairs) and its correlation pyramid, warm
    eng = pipe.flow_engine
    ia, ib = np.zeros(8, np.int64), np.arange(1, 9) % t
    decode_ms = cuda_ms(lambda: eng.decode(ia, ib), iters=3, warmup=1)
    fmaps = eng.encodings()[0]
    pyramid_ms = cuda_ms(lambda: raft.build_corr_pyramid(fmaps[ia], fmaps[ib]), iters=3)
    tm = pipe.timings
    direct = batches - 2 * -(-(t - 1) // 8)
    print(f"raft: stage 1, T={t} {w}x{h}, RAFT-large {cfg.raft_iters} iterations "
          f"{cfg.raft_compute_dtype}, 8 pairs a decode batch: encode {tm['encode']:.3f} s, "
          f"adjacent flows {tm['adjacent_flows']:.3f} s, direct sweep and chaining "
          f"{tm['direct_sweep_and_chaining']:.3f} s, harvest {tm['harvest']:.3f} s, "
          f"total {total:.3f} s; {len(trajs)} filtered / {len(unfiltered)} unfiltered "
          f"trajectories; peak memory {peak:.2f} GiB; one decode batch (8 pairs) "
          f"{decode_ms:.2f} ms, its pyramid {pyramid_ms:.2f} ms; {batches} decode "
          f"batches ({direct} direct), K3 launches {launches}", flush=True)
    return launches, decode_ms, pyramid_ms, eng


def profile_decode(eng, ia, ib):
    """Device time of one decode batch by kernel (torch.profiler, CUDA
    activity only): the top kernels and the sums by kind. Kinds by kernel
    name: K3; cuDNN convolutions (implicit GEMM and FFT kernels); GEMMs (the
    pyramid); everything else (elementwise, concatenation, copies)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decode(ia, ib)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, evt.count, evt.key))
    kinds = {"K3 corr_lookup": 0.0, "convolutions": 0.0, "GEMM": 0.0, "other": 0.0}
    for ms, _, name in rows:
        low = name.lower()
        if "corr_lookup" in low:
            kinds["K3 corr_lookup"] += ms
        elif any(k in low for k in ("conv", "fprop", "cudnn", "winograd", "xmma", "fft",
                                    "complex", "region_transform")):
            kinds["convolutions"] += ms
        elif "gemm" in low:
            kinds["GEMM"] += ms
        else:
            kinds["other"] += ms
    total = sum(kinds.values())
    if total == 0:
        print("raft: profile of one decode batch: no device time recorded", flush=True)
        return
    print(f"raft: profile of one decode batch (8 pairs, device time {total:.1f} ms): "
          + ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})" for k, v in kinds.items()),
          flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"raft:   {ms:9.2f} ms {count:5d}x {name[:110]}", flush=True)


def conv_table(model, dev, n=8, hw=(60, 107)):
    """Each conv of the update block alone at a decode batch's shape (n pairs
    on the 60×107 grid, f32, TF32 off), NCHW and channels-last input: ms
    from CUDA events and the achieved f32 TFLOP/s."""
    from torch import nn
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.models.nn import exact_f32
    g = torch.Generator(device=dev).manual_seed(0)
    for name, m in model.update_block.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        x = torch.randn((n, m.in_channels, *hw), generator=g, device=dev)
        flops = 2.0 * m.weight.numel() * n * hw[0] * hw[1]
        times = []
        for layout in (torch.contiguous_format, torch.channels_last):
            xl = x.contiguous(memory_format=layout)
            with torch.no_grad(), exact_f32(xl):
                times.append(cuda_ms(lambda: m(xl), iters=5, warmup=2))
        print(f"raft: conv {name} {m.in_channels}->{m.out_channels} "
              f"{tuple(m.kernel_size)} x{n}: NCHW {times[0]:.2f} ms "
              f"({flops / times[0] / 1e9:.1f} TFLOP/s), channels-last {times[1]:.2f} ms "
              f"({flops / times[1] / 1e9:.1f} TFLOP/s)", flush=True)
        if name == "encoder.conv":  # as the motion encoder runs it
            with torch.no_grad(), exact_f32(x):
                ms = cuda_ms(lambda: raft._conv_out_padded(m, x, 128), iters=5, warmup=2)
            print(f"raft: conv {name} with 128 outputs, cut to {m.out_channels}: "
                  f"{ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)


def phase_raft_reference(dev):
    """Stage 1 on 6 f32 frames of 224×128 (12 iterations), and one RAFT
    forward at 48×64 (degenerate levels), GPU against CPU from the same
    weights. Flows within FLOW_TOL of max|flow|. Trajectories: the CPU
    chains the GPU's flows (adjacent and direct) and must give the GPU's
    trajectories, counts equal and positions within TRAJ_TOL px; the CPU
    pipeline's own trajectories, from its own flows, are printed beside
    them (a point within float noise of a threshold may flip)."""
    from dino_tracker_tpu_torch.config import PreprocessConfig
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.preprocessing import trajectories as traj
    from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
    cpu = torch.device("cpu")
    state = raft_state(cpu, 13)
    t, h, w = 6, 128, 224
    cfg = PreprocessConfig(video_resh=h, video_resw=w, raft_iters=12)
    video = textured_video(t, h, w, cpu)
    out = []  # (trajectories, flows, engine) on the GPU, then on the CPU
    for i, d in enumerate((dev, cpu)):
        root = os.path.join(WORK_DIR, f"raft_ref_{i}")
        shutil.rmtree(root, ignore_errors=True)
        pipe = PreprocessingPipeline(root, cfg, device=d, frames=video.clone(),
                                     raft=raft.load_raft_state_dict(state, d))
        res = pipe.extract_trajectories_both()
        eng = pipe.flow_engine
        out.append((res, [f.cpu() for f in eng.adjacent_flows()]
                    + [eng.direct_flows(0, cfg.threshold)[0].cpu()], eng))
    (gpu_res, gpu_flows, gpu_eng), (cpu_res, cpu_flows, _) = out
    flow_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(gpu_flows, cpu_flows))
    chained = traj.extract_trajectories_dual(
        gpu_flows[0], gpu_flows[1],
        direct_flow_fn=lambda s: [x.cpu() for x in gpu_eng.direct_flows(s, cfg.threshold)],
        threshold=cfg.threshold, min_trajectory_length=cfg.min_trajectory_length,
        direct_flow_threshold=cfg.direct_flow_threshold)
    same = all(a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
               for a, b in zip(gpu_res, chained))
    traj_err = max((float(np.nanmax(np.abs(a - b))) if len(a) else 0.0)
                   for a, b in zip(gpu_res, chained)) if same else float("inf")

    rng = np.random.default_rng(14)
    img1, img2 = (torch.from_numpy(rng.random((2, 3, 48, 64), dtype=np.float32))
                  for _ in range(2))
    small = [raft.raft_forward(raft.load_raft_state_dict(state, d), img1.to(d),
                               img2.to(d), 12).cpu() for d in (dev, cpu)]
    small_err = float((small[0] - small[1]).abs().max() / small[1].abs().max())
    print(f"reference: stage 1 T={t} {w}x{h} f32 ({cfg.raft_iters} iterations): GPU vs "
          f"CPU flows max diff {flow_err:.3g} of max|flow| (bound {FLOW_TOL}); "
          f"trajectories {[len(a) for a in gpu_res]} on the GPU, "
          f"{[len(a) for a in chained]} chained on the CPU from the GPU's flows "
          f"(max diff {traj_err:.3g} px, bound {TRAJ_TOL}), "
          f"{[len(a) for a in cpu_res]} from the CPU's own flows; RAFT forward 48x64 "
          f"(degenerate levels) GPU vs CPU {small_err:.3g} of max|flow|", flush=True)
    check(flow_err <= FLOW_TOL and small_err <= FLOW_TOL,
          "GPU and CPU RAFT flows disagree")
    check(same and traj_err <= TRAJ_TOL and len(gpu_res[1]) > 0,
          "GPU and CPU chaining disagree")


def write_frames(folder, t, h, w, dev, shift=(1.5, 0.5)):
    """T PNG frames of textured_video (moving by ``shift`` px a frame)."""
    from PIL import Image
    os.makedirs(folder)
    frames = (textured_video(t, h, w, dev, shift) * 255).round().byte().permute(0, 2, 3, 1)
    for i, frame in enumerate(frames.cpu().numpy()):
        Image.fromarray(frame).save(os.path.join(folder, f"{i:05d}.png"))


def write_weights(root, cfg, dev):
    """The random RAFT-large and ViT weights (phases 8 and 6, the flow head
    scaled as in phase 8) as .pth checkpoints; returns their two paths."""
    from dino_tracker_tpu_torch.models import vit
    os.makedirs(root, exist_ok=True)
    raft_path, vit_path = os.path.join(root, "raft.pth"), os.path.join(root, "vit.pth")
    torch.save({k: v.cpu() for k, v in raft_state(dev, 11).items()}, raft_path)
    vcfg = vit.ViTConfig.for_model(cfg.dino_model_name)
    torch.save({k: v.cpu() for k, v in vit_state(vcfg, dev, 6).items()}, vit_path)
    return raft_path, vit_path


def write_preprocess_yaml(root, cfg):
    """A preprocessing yaml that sets max_frames; returns its path."""
    config = os.path.join(root, "preprocessing.yaml")
    with open(config, "w") as f:
        f.write(f"max_frames: {cfg.max_frames}\n")
    return config


def write_preprocess_inputs(root, cfg, t, dev):
    """A frame folder of T PNGs (textured_video at the config's size),
    write_weights' checkpoints and the yaml; returns the CLI's arguments."""
    write_frames(os.path.join(root, "vid", "video"), t, cfg.video_resh, cfg.video_resw, dev)
    raft_path, vit_path = write_weights(root, cfg, dev)
    return ["--config", write_preprocess_yaml(root, cfg), "--data-path",
            os.path.join(root, "vid"), "--raft-checkpoint", raft_path,
            "--dino-checkpoint", vit_path, "--device", str(dev)]


def check_bb_artifact(bb, t):
    """The BB artifact's invariants: the diagonal empty; validity, cos and r
    mirror-symmetric; (u, s)'s coordinates (s, u)'s swapped; |cos| <= 1 (up
    to 1e-6, the rounding of a unit dot product); r = 1 on empty slots and
    finite on valid ones."""
    valid, cos, r = bb.valid, bb.cos_sims, bb.r
    mirror = lambda x: x.transpose(0, 1)
    check(bb.source_coords.shape[:3] == valid.shape == cos.shape == r.shape
          and valid.shape[:2] == (t, t), f"BB shapes {valid.shape}")
    check(not bool(valid.diagonal().any()), "a diagonal pair has buddies")
    check(torch.equal(valid, mirror(valid)) and torch.equal(cos, mirror(cos))
          and torch.equal(r, mirror(r)), "BB validity, cos or r is not mirror-symmetric")
    check(torch.equal(bb.source_coords, mirror(bb.target_coords)),
          "the reverse direction is not the forward one swapped")
    check(bool((cos.abs() <= 1 + 1e-6).all()), f"|cos| up to {cos.abs().max().item()}")
    check(bool((r[~valid] == 1).all()) and bool(r[valid].isfinite().all()),
          "r is not 1 on empty slots or not finite on valid ones")


def phase_preprocess(dev, t=PREPROCESS_T):
    """The preprocess CLI in this process on PNG frames and .pth checkpoints
    at full width (dinov2_vitl14, RAFT-large, 854×476, T frames), every
    artifact checked, then 2 training steps on the directory through the
    port's training data path. Returns the CLI's K2 and K3 launches and its
    RAFT and ViT checkpoints' paths."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.cli import preprocess
    from dino_tracker_tpu_torch.config import (PreprocessConfig, TrainConfig, add_config_paths,
                                               feature_grid_size)
    from dino_tracker_tpu_torch.models import vit
    from dino_tracker_tpu_torch.preprocessing import best_buddies as bb_lib
    from dino_tracker_tpu_torch.structures import load_bb_data
    from dino_tracker_tpu_torch.training import train
    from dino_tracker_tpu_torch.utils import video_io
    cfg = PreprocessConfig(max_frames=t)
    h, w = cfg.video_resh, cfg.video_resw
    c = vit.ViTConfig.for_model(cfg.dino_model_name).embed_dim
    root = os.path.join(WORK_DIR, "preprocess")
    shutil.rmtree(root, ignore_errors=True)
    args = write_preprocess_inputs(root, cfg, t, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    (report,) = preprocess.main(args)
    total = time.perf_counter() - t0
    launches = counted("flash_attention", "corr_lookup")
    peak = torch.cuda.max_memory_allocated() / 2**30
    expected = ((max(cfg.dino_layer, cfg.mask_dino_layer) + 1)
                * -(-t // cfg.extract_frames_per_batch), cfg.raft_iters * decode_batches(t))
    check(launches == expected, f"K2 / K3 launched {launches} times in the preprocess "
          f"CLI, expected {expected}")

    data_path = args[args.index("--data-path") + 1]
    paths = add_config_paths(data_path)
    trajs = video_io.load_npz(paths["trajectories_file"])["trajectories"]
    unfiltered = video_io.load_npz(paths["unfiltered_trajectories_file"])["trajectories"]
    check_trajectories(trajs, t, h, w, "filtered")
    check_trajectories(unfiltered, t, h, w, "unfiltered")
    fg, bg = (video_io.load_npz(paths[k])["trajectories"]
              for k in ("fg_trajectories_file", "bg_trajectories_file"))
    check(len(fg) + len(bg) == len(trajs), "the split lost trajectories")
    grid = feature_grid_size(h, w, 14, cfg.dino_stride)
    for key in ("dino_embed_video_path", "mask_dino_embed_video_path"):
        art = video_io.load_npz(paths[key])["features"]
        check(art.dtype == np.float16 and art.shape == (t, c, *grid)
              and np.isfinite(art).all(), f"{key}: {art.dtype} {art.shape}")
    masks = video_io.load_masks(paths["masks_path"], h, w)
    check(masks.shape == (t, h, w), f"masks {masks.shape}")
    with open(os.path.join(paths["dino_bb_dir"], "bb_truncation.json")) as f:
        sweep = json.load(f)
    check(sweep["truncated_pairs"] == 0 and sweep["total_pairs"] == t * (t - 1) // 2,
          f"bb_truncation.json: {sweep}")
    bb = load_bb_data(os.path.join(paths["dino_bb_dir"], "dino_best_buddies_filtered.npz"), dev)
    check_bb_artifact(bb, t)
    rows = report["telemetry"]["bb_ambiguity"]["rows_total"]
    check(rows == int(bb.valid.sum()), f"{rows} ambiguity rows for {int(bb.valid.sum())} buddies")

    # training on the directory, through the port's training data path
    tcfg = TrainConfig()
    rt = runtime.DINOTrackerRuntime(data_path, tcfg, dev)
    data = rt.load_video_data()
    trainer = train.Trainer(tcfg, rt.tcfg, data, paths["ckpt_folder"], seed=2, device=dev)
    model = trainer.init_model().train()
    opt, sched = train.make_optimizer(model, tcfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    losses = [train.train_step(model, opt, sched, data, gen, False, False, tcfg, rt.tcfg)
              for _ in range(2)]
    check(all(bool(torch.stack(list(m.values())).isfinite().all()) for m in losses),
          "a non-finite loss training on the preprocessed directory")

    # the ambiguity pass again with every mutual pair (the sweep without the
    # flow filter) on the f16 artifact upcast: the most rows this video can
    # give it, since the random RAFT's trajectories leave few flow gaps
    feats = torch.from_numpy(video_io.load_npz(paths["dino_embed_video_path"])["features"]
                             ).to(dev).float()
    every = bb_lib.extract_best_buddies(feats, h, w, cfg.dino_stride)
    amb_all = {}
    t0 = time.perf_counter()
    bb_lib.compute_bb_ambiguity(every, feats, h, w, cfg.dino_stride, telemetry=amb_all)
    torch.cuda.synchronize()
    amb_all_s = time.perf_counter() - t0
    profile_ambiguity_slab(feats, bb_lib, h, w, cfg.dino_stride)
    del feats, every

    tm = report["timings"]
    n = grid[0] * grid[1]
    pairs = t * (t - 1) // 2
    bb_s = tm["preprocess/best_buddies"]
    sweep_tflops = pairs * 2.0 * n * n * c / tm["bb_sweep"] / 1e12
    amb_tflops = rows * 2.0 * n * c / tm["bb_ambiguity"] / 1e12
    print(f"preprocess: cli.preprocess T={t} {w}x{h} {cfg.dino_model_name} + RAFT-large: "
          f"{total:.3f} s in all; " + ", ".join(
              f"{k.split('/')[1]} {v:.3f} s" for k, v in tm.items() if k.startswith("preprocess/"))
          + f"; peak memory {peak:.2f} GiB; K2 / K3 launches {launches}", flush=True)
    print(f"preprocess: best buddies {bb_s:.3f} s: " + ", ".join(
        f"{k} {tm[k]:.3f} s" for k in ("bb_closest_grids", "bb_sweep", "bb_compaction",
                                        "bb_ambiguity", "bb_save"))
          + f"; sweep {pairs} pairs at n={n} ({sweep_tflops:.1f} TFLOP/s f32), ambiguity "
          f"rows_total {rows} ({amb_tflops:.1f} TFLOP/s), m_max "
          f"{report['telemetry']['bb_ambiguity']['m_max']}, ambiguity phases "
          f"{json.dumps(report['telemetry']['bb_ambiguity']['phases'])}", flush=True)
    rows_all = amb_all["rows_total"]
    print(f"preprocess: ambiguity with every mutual pair (no flow filter): rows_total "
          f"{rows_all} in {amb_all_s:.3f} s ({rows_all * 2.0 * n * c / amb_all_s / 1e12:.1f} "
          f"TFLOP/s, {amb_all_s / max(rows_all, 1) * 1e6:.3f} us a row), m_max "
          f"{amb_all['m_max']}, phases {json.dumps(amb_all['phases'])}", flush=True)
    art = os.path.join(paths["dino_bb_dir"], "dino_best_buddies_filtered.npz")
    raw_mb = sum(x.numel() * x.element_size() for x in bb) / 1e6
    print(f"preprocess: dino_best_buddies_filtered.npz {os.path.getsize(art) / 1e6:.1f} MB "
          f"compressed from {raw_mb:.1f} MB in {tm['bb_save']:.3f} s", flush=True)
    print(f"preprocess: {len(trajs)} filtered / {len(unfiltered)} unfiltered trajectories, "
          f"{len(fg)} fg / {len(bg)} bg; fg share {float((masks > 127).mean()):.4f}; "
          f"best-buddy cap {sweep['cap']} (adaptive {sweep['adaptive']}), max count "
          f"{sweep['max_count']}, mean count {sweep['mean_count']:.1f}, truncated pairs "
          f"{sweep['truncated_pairs']} of {sweep['total_pairs']}; 2 train steps on the "
          f"directory: losses {', '.join(f'{float(v):.4g}' for v in losses[-1].values())}",
          flush=True)
    return launches, (args[args.index("--raft-checkpoint") + 1],
                      args[args.index("--dino-checkpoint") + 1])


def profile_ambiguity_slab(feats, bb_lib, h, w, stride, rows=8192):
    """One ambiguity slab at the main path's shape (8,192 unit rows of frame
    1 against frame 0's n tokens): the f32 product and nms_top2_peaks timed
    apart with CUDA events, then the slab's device time by kernel
    (torch.profiler, CUDA activity). Returns (product ms, NMS ms)."""
    from torch.profiler import ProfilerActivity, profile
    from dino_tracker_tpu_torch.models.nn import exact_f32
    from dino_tracker_tpu_torch.ops import nms
    from dino_tracker_tpu_torch.utils.coords import bb_meshgrid
    fn = bb_lib._normalized_tokens(feats[:2])
    grid = bb_meshgrid(h, w, stride, device=feats.device)
    src = fn[1][torch.arange(rows, device=feats.device) % fn.shape[1]]

    def product():
        with exact_f32(src):
            return src @ fn[0].T

    sim = product()
    gemm_ms = cuda_ms(product, iters=5)
    nms_ms = cuda_ms(lambda: nms.nms_top2_peaks(sim, grid), iters=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nms.nms_top2_peaks(product(), grid)
        torch.cuda.synchronize()
    rows_by = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
                      for e in prof.key_averages()), reverse=True)
    total = sum(r[0] for r in rows_by)
    print(f"preprocess: one ambiguity slab ({rows} rows x n={fn.shape[1]}): f32 product "
          f"{gemm_ms:.3f} ms ({2.0 * rows * fn.shape[1] * fn.shape[2] / gemm_ms / 1e9:.1f} "
          f"TFLOP/s), nms_top2_peaks {nms_ms:.3f} ms; profile {total:.3f} ms of device time:",
          flush=True)
    for ms, count, name in rows_by[:8]:
        print(f"preprocess:   {ms:8.3f} ms {count:4d}x {name[:100]}", flush=True)
    return gemm_ms, nms_ms


def bb_reference_inputs(t, c, gh, gw, h, w, seed):
    """Features (a per-position code plus per-frame noise, so mutual matches
    exist) and N×T×2 trajectories at random positions, each missing from a
    random 40% of the frames."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn((1, c, gh, gw), generator=g)
    feats = pos + 2.5 * torch.randn((t, c, gh, gw), generator=g)
    n_traj = 3000
    trajs = torch.rand((n_traj, t, 2), generator=g) * torch.tensor([w - 1.0, h - 1.0])
    trajs[torch.rand((n_traj, t), generator=g) < 0.4] = float("nan")
    return feats, trajs.numpy()


def top2_gap(x, dim):
    top = x.topk(2, dim=dim).values
    return top.select(dim, 0) - top.select(dim, 1)


def phase_bb_reference(dev):
    """Stage 5 on T=6 frames of 224×126 (n = 17×31 = 527 tokens, C=1024),
    GPU against CPU: the adaptive sweep with the fused filter, a fixed cap
    of 64 (< n), of_filter_best_buddies on the CPU's capped result and
    compute_bb_ambiguity on each device's adaptive result. Margins come from
    the CPU's f32 products: a token whose best and second-best cosine, along
    either axis, lie within BB_MARGIN, or (fixed cap) whose cosine lies
    within it of its pair's 64th, or whose nearest trajectory at either frame
    is within BB_MARGIN (relative) of the second nearest, may flip; every
    disagreement must lie among them. Cos within BB_MARGIN of max|cos|; r
    within BB_MARGIN on rows whose peak1 and 400th/401st similarities, in
    both directions, are separated by more than BB_MARGIN."""
    from dino_tracker_tpu_torch.preprocessing import best_buddies as bbl
    from dino_tracker_tpu_torch.utils.coords import bb_meshgrid
    cpu = torch.device("cpu")
    t, h, w, c, cap = 6, 126, 224, 1024, 64
    gh, gw = 17, 31
    n = gh * gw
    feats, trajs = bb_reference_inputs(t, c, gh, gw, h, w, 16)
    out = []  # on the GPU, then on the CPU
    for d in (dev, cpu):
        f = feats.to(d)
        adaptive = bbl.extract_best_buddies(f, h, w, unfiltered_trajectories=trajs)
        fixed = bbl.extract_best_buddies(f, h, w, cap=cap)
        out.append([adaptive, fixed, bbl.compute_bb_ambiguity(adaptive, f, h, w),
                    bbl.closest_trajectory_grids(trajs, bb_meshgrid(h, w, device=d))])
    to = lambda bb, d: type(bb)(*(x.to(d) for x in bb))
    gpu = [to(r, cpu) if isinstance(r, tuple) else r.cpu() for r in out[0]]
    ref = out[1]
    check(gpu[0].valid.shape == ref[0].valid.shape,
          f"adaptive capacities differ: {gpu[0].capacity} vs {ref[0].capacity}")
    filt = [bbl.of_filter_best_buddies(to(ref[1], d), trajs, h, w).valid.cpu()
            for d in (dev, cpu)]

    # margins on the CPU's own products
    grid = bb_meshgrid(h, w)
    fn = bbl._normalized_tokens(feats)  # T×n×C
    dist = torch.stack([torch.cdist(grid[None].double(), torch.from_numpy(
        np.nan_to_num(trajs[:, f], nan=1e12)).double()[None])[0] for f in range(t)])
    near2 = dist.topk(2, dim=2, largest=False).values
    close_near = (near2[..., 1] - near2[..., 0]) <= BB_MARGIN * near2[..., 0]  # T×n
    tok = lambda xy: ((xy[..., 1] - 7) / 7 * gw + (xy[..., 0] - 7) / 7).round().long()
    near_tokens = disagree = 0
    cos_err, max_cos = 0.0, 0.0
    for s in range(t):
        for u in range(s + 1, t):
            aff = fn[s] @ fn[u].T
            src_max = aff.argmax(1)
            near = (top2_gap(aff, 1) <= BB_MARGIN) | (top2_gap(aff, 0)[src_max] <= BB_MARGIN)
            cos = aff.max(1).values
            mutual = aff.argmax(0)[src_max] == torch.arange(n)
            if mutual.sum() > cap:  # the fixed cap's boundary
                kth_cos = cos[mutual].topk(cap).values[-1]
                near_cap = near | ((cos - kth_cos).abs() <= BB_MARGIN)
            else:
                near_cap = near
            near_f = near | close_near[s] | close_near[u][src_max]
            for (g_bb, r_bb), allowed in (((gpu[0], ref[0]), near_f), ((gpu[1], ref[1]), near_cap)):
                sets = []
                for bb in (g_bb, r_bb):
                    v = bb.valid[s, u]
                    sets.append({(int(i), int(j)): float(x) for i, j, x in zip(
                        tok(bb.source_coords[s, u][v]), tok(bb.target_coords[s, u][v]),
                        bb.cos_sims[s, u][v])})
                for key in sets[0].keys() ^ sets[1].keys():
                    disagree += 1
                    check(bool(allowed[key[0]]), f"pair ({s}, {u}): buddy {key} on one "
                          "device only, outside the margin")
                for key in sets[0].keys() & sets[1].keys():
                    cos_err = max(cos_err, abs(sets[0][key] - sets[1][key]))
                    max_cos = max(max_cos, abs(sets[1][key]))
            near_tokens += int(near_f.sum()) + int(near_cap.sum())
    check(cos_err <= BB_MARGIN * max_cos, f"cos differs by {cos_err} (max |cos| {max_cos})")
    close_ok = (gpu[3] == ref[3]) | close_near
    check(bool(close_ok.all()), "closest-trajectory indices differ outside the margin")

    # the OF filter of one input on both devices: only nearest-trajectory ties may flip
    src_tok, tgt_tok = tok(ref[1].source_coords), tok(ref[1].target_coords)
    fr = torch.arange(t)
    filt_near = (close_near[fr[:, None, None], src_tok.clamp(0, n - 1)]
                 | close_near[fr[None, :, None], tgt_tok.clamp(0, n - 1)])
    check(bool(((filt[0] == filt[1]) | filt_near).all()), "OF filter differs outside the margin")

    # r on rows stable in both directions, where both devices hold the same buddy
    same = (gpu[0].valid == ref[0].valid) & (gpu[0].source_coords == ref[0].source_coords).all(-1)
    stable = torch.zeros_like(ref[0].valid)
    for s in range(t):
        for u in range(t):
            v = ref[0].valid[s, u]
            if s == u or not v.any():
                continue
            sims = fn[s][tok(ref[0].source_coords[s, u][v])] @ fn[u].T
            top = sims.topk(401, dim=1).values
            ok = ((top[:, 0] - top[:, 1]) > BB_MARGIN) & ((top[:, 399] - top[:, 400]) > BB_MARGIN)
            stable[s, u, v] = ok
    stable &= stable.transpose(0, 1).clone() & same
    r_err = float((gpu[2].r - ref[2].r).abs()[stable].max()) if stable.any() else 0.0
    check(r_err <= BB_MARGIN and int(stable.sum()) > 0, f"r differs by {r_err} on stable rows")
    print(f"reference: best buddies T={t} {w}x{h} n={n} C={c}, GPU vs CPU: adaptive with the "
          f"fused filter {int(ref[0].valid.sum())} buddies (cap {ref[0].capacity}), cap {cap} "
          f"{int(ref[1].valid.sum())}; {near_tokens} token checks inside the {BB_MARGIN} "
          f"margin, {disagree} buddies on one device only (all inside it); cos max diff "
          f"{cos_err:.3g} (bound {BB_MARGIN * max_cos:.3g}); closest trajectories "
          f"{int((gpu[3] != ref[3]).sum())} of {gpu[3].numel()} differ ({int(close_near.sum())} "
          f"inside the margin); OF filter {int((filt[0] != filt[1]).sum())} slots differ; r max "
          f"diff {r_err:.3g} on {int(stable.sum())} of {int(ref[0].valid.sum())} rows "
          f"(bound {BB_MARGIN})", flush=True)


def write_e2e_inputs(root, t, iterations, checkpoint_interval, query_frames, n_points, dev,
                     shifts, weights=None):
    """Phase 11's inputs under ``root``: a dataset root ``videos/`` with one
    video directory per shift (T PNG frames of textured_video), the RAFT and
    ViT checkpoints ``weights`` (written by write_weights where None), a
    preprocessing yaml that sets max_frames, ``train.yaml``
    (``iterations``, both gates at half of them, ``checkpoint_interval``,
    TrainConfig's full width otherwise) and ``benchmark.pkl`` (``n_points``
    queries on each query frame, targets from the known shift, occluded
    where they leave the frame). Returns run_benchmark's arguments, less
    the claim directory, and the benchmark."""
    from dino_tracker_tpu_torch.config import PreprocessConfig
    cfg = PreprocessConfig(max_frames=t)
    h, w = cfg.video_resh, cfg.video_resw
    os.makedirs(root)
    raft_path, vit_path = weights or write_weights(root, cfg, dev)
    pre_yaml = write_preprocess_yaml(root, cfg)
    data = os.path.join(root, "videos")
    rng = np.random.default_rng(8)
    videos = []
    for idx, shift in enumerate(shifts):
        write_frames(os.path.join(data, str(idx), "video"), t, h, w, dev, shift)
        entry = {"video_idx": idx, "h": h, "w": w, "query_points": {},
                 "target_points": {}, "occluded": {}}
        for f in query_frames:
            q = rng.random((n_points, 2)) * [w - 1, h - 1]
            tracks = q[:, None] + (np.arange(t) - f)[None, :, None] * np.asarray(shift)
            entry["query_points"][f] = q.tolist()
            entry["target_points"][f] = tracks.astype(np.float32)
            entry["occluded"][f] = ((tracks < 0) | (tracks > [w - 1, h - 1])).any(-1)
        videos.append(entry)
    bench = {"videos": videos}
    pkl = os.path.join(root, "benchmark.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(bench, f)
    train_yaml = os.path.join(root, "train.yaml")
    with open(train_yaml, "w") as f:
        f.write(f"total_iterations: {iterations}\napply_cyc_after: {iterations // 2}\n"
                f"apply_cl_ref_after: {iterations // 2}\n"
                f"checkpoint_interval: {checkpoint_interval}\n")
    return ["--dataset-root-dir", data, "--benchmark-pickle-path", pkl,
            "--train-config", train_yaml, "--preprocess-config", pre_yaml,
            "--raft-checkpoint", raft_path, "--dino-checkpoint", vit_path,
            "--device", str(dev)], bench


def check_metrics_csv(path, rows, data, bench, w, h):
    """The eval CSV: rows 0.., average; each video's numbers the port's metric
    function run again on the saved predictions, the average their nanmean,
    empty fields where NaN; every metric NaN or in [0, 1]."""
    import csv
    from dino_tracker_tpu_torch.cli import eval_benchmark
    from dino_tracker_tpu_torch.evaluation import metrics
    with open(path, newline="") as f:
        table = list(csv.reader(f))
    ids = [str(v["video_idx"]) for v in bench["videos"]]
    check([r[0] for r in table] == ["video_idx", *sorted(ids), "average"],
          f"CSV rows {[r[0] for r in table]}")
    again = {vid: metrics.compute_tapvid_metrics_for_video(
        os.path.join(data, vid, "trajectories"), os.path.join(data, vid, "occlusions"),
        bench, int(vid), pred_video_sizes=[w, h]) for vid in ids}
    cols = table[0][1:]
    check(cols == list(again[ids[0]]), f"CSV columns {cols}")
    want = {vid: again[vid] for vid in sorted(ids)}
    want["average"] = {c: eval_benchmark.nanmean([m[c] for m in again.values()]) for c in cols}
    for row in table[1:]:
        expect = [eval_benchmark.csv_field(want[row[0]][c]) for c in cols]
        check(row[1:] == expect, f"CSV row {row[0]}: {row[1:]} != {expect}")
    check(len(rows) == len(table) - 1, f"eval_benchmark returned {len(rows)} rows")
    vals = np.asarray([[float(x) if x else np.nan for x in r[1:]] for r in table[1:]])
    check(bool(np.all(np.isnan(vals) | ((vals >= 0) & (vals <= 1)))),
          f"a metric outside [0, 1]: {vals}")
    return want


def live_cuda_tensors():
    """(count, bytes) of the CUDA tensors the garbage collector can reach."""
    found = [o for o in gc.get_objects() if torch.is_tensor(o) and o.is_cuda]
    return len(found), sum(o.untyped_storage().nbytes() for o in found)


def phase_e2e(dev, t=E2E_T, iterations=E2E_ITERATIONS, checkpoint_interval=E2E_ITERATIONS // 2,
              query_frames=E2E_QUERY_FRAMES, n_points=E2E_POINTS, shifts=E2E_SHIFTS,
              weights=None):
    """The whole system on the card: cli.run_benchmark (preprocess, train,
    inference for every video, one process) then cli.eval_benchmark, every
    output checked; ``weights`` are the RAFT and ViT checkpoints to reuse
    (written anew where None). Returns the launches of K1-fwd, K1-bwd, K2,
    K3, K5-fwd and K5-bwd."""
    from dino_tracker_tpu_torch.cli import eval_benchmark, run_benchmark
    from dino_tracker_tpu_torch.config import PreprocessConfig, TrainConfig
    from dino_tracker_tpu_torch.training.step_graph import StepGraph
    from dino_tracker_tpu_torch.utils import profiling
    pcfg, tcfg = PreprocessConfig(max_frames=t), TrainConfig()
    h, w = pcfg.video_resh, pcfg.video_resw
    root = os.path.join(WORK_DIR, "e2e")
    shutil.rmtree(root, ignore_errors=True)
    args, bench = write_e2e_inputs(root, t, iterations, checkpoint_interval, query_frames,
                                   n_points, dev, shifts, weights)
    data, claims = os.path.join(root, "videos"), os.path.join(root, "claims")
    csv_path = os.path.join(root, "metrics.csv")
    # the baseline: what earlier phases left, without cuBLAS's per-handle
    # workspaces (the caching allocator counts them as allocated)
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()

    reset_counts()
    t0 = time.perf_counter()
    launcher = run_benchmark.main(args + ["--claim-dir", claims])  # replays untraced
    run_s = time.perf_counter() - t0
    captures, replays = StepGraph.captures, StepGraph.replays
    launches = counted("blurpool_down_nhwc", "blurpool_up_nhwc", "flash_attention",
                       "corr_lookup", "batchnorm_fwd", "batchnorm_bwd")
    profiling.reset_stage_timers()
    t0 = time.perf_counter()
    rows = eval_benchmark.main(args[:4] + ["--out-file", csv_path, "--pred-w", str(w),
                                           "--pred-h", str(h)])
    eval_s = time.perf_counter() - t0
    eval_report = profiling.stage_report()

    ids = [str(i) for i in range(len(shifts))]
    n = len(ids)
    # K1 in the refine (3 launches a 16-frame chunk) and in the train steps
    # the wrappers launch: each capture's warm-up step; the replays' are not
    # traced here (phase 5 traces them); K5 likewise, one a refiner layer
    expected = (n * 3 * -(-t // 16) + 3 * captures, 3 * captures,
                n * (max(pcfg.dino_layer, pcfg.mask_dino_layer) + 1)
                * -(-t // pcfg.extract_frames_per_batch),
                n * pcfg.raft_iters * decode_batches(t),
                n * BN_LAYERS * -(-t // 16) + BN_LAYERS * captures, BN_LAYERS * captures)
    check(launches == expected and captures + replays == n * iterations,
          f"K1-fwd / K1-bwd / K2 / K3 / K5-fwd / K5-bwd launched {launches} times in the "
          f"whole system, "
          f"expected {expected}; {captures} captured and {replays} replayed "
          f"train steps, expected {n * iterations}")
    for vid in ids:
        check(os.path.exists(os.path.join(claims, f"{vid}.done")), f"video {vid} not done")
        check(vid in launcher.reports, f"no report for video {vid}")
        check(os.path.exists(os.path.join(data, vid, "models", "dino_tracker",
                                          f"state_{iterations}.pt")),
              f"video {vid}: no state_{iterations}.pt")
        for f in query_frames:
            trajs = np.load(os.path.join(data, vid, "trajectories", f"trajectories_{f}.npy"))
            occ = np.load(os.path.join(data, vid, "occlusions", f"occlusion_preds_{f}.npy"))
            check(trajs.shape == (n_points, t, 2) and np.isfinite(trajs).all()
                  and occ.shape == (n_points, t),
                  f"video {vid} frame {f}: {trajs.shape} {occ.shape}")
    want = check_metrics_csv(csv_path, rows, data, bench, w, h)

    # what stays allocated: after each video, and after the last one without
    # the cuBLAS workspaces; nothing of a video may stay into the next
    gc.collect()
    left = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    cleared = torch.cuda.memory_allocated()
    workspaces = left - cleared
    before = [launcher.reports[vid]["allocated_before_bytes"] for vid in ids]
    after = [launcher.reports[vid]["allocated_after_bytes"] for vid in ids]
    mib = lambda b: f"{b / 2**20:.1f}"
    check(before[0] == base, f"{mib(before[0] - base)} MiB allocated between the "
          f"baseline and video 0")
    check(cleared - base <= E2E_MEMORY_MARGIN and all(
        a - base <= workspaces + E2E_MEMORY_MARGIN for a in after),
          f"device memory carried past a video: baseline {mib(base)} MiB, after each "
          f"video {[mib(a) for a in after]} MiB, cuBLAS workspaces {mib(workspaces)} MiB, "
          f"left without them {mib(cleared)} MiB (margin "
          f"{E2E_MEMORY_MARGIN / 2**20:.0f}); live CUDA tensors (count, bytes) "
          f"{live_cuda_tensors()}")

    gates_at = iterations // 2
    for vid in ids:
        rep = launcher.reports[vid]
        st = {k: v["total_s"] for k, v in rep["stages"].items()}
        requests = [st[f"inference/query_frame_{f}"] for f in query_frames]
        host = {k: st.get(f"train/{k}", 0.0)
                for k in ("load_data", "init", "log", "checkpoint", "bank_rotation")}
        steps_s = st["train/steps_gates_off"] + st["train/steps_gates_on"]
        print(f"e2e: video {vid} (T={t} {w}x{h}, shift {shifts[int(vid)]}): preprocess "
              f"{st['video/preprocess']:.3f} s (trajectories {st['preprocess/trajectories']:.3f},"
              f" dino_features {st['preprocess/dino_features']:.3f}, best_buddies "
              f"{st['preprocess/best_buddies']:.3f}); train {st['video/train']:.3f} s for "
              f"{iterations} iterations: steps {steps_s:.3f} s "
              f"({st['train/steps_gates_off'] / gates_at * 1e3:.2f} ms/iter gates off, "
              f"{st['train/steps_gates_on'] / (iterations - gates_at) * 1e3:.2f} ms/iter "
              f"gates on), " + ", ".join(f"{k} {v:.3f} s" for k, v in host.items())
              + f", other {st['video/train'] - steps_s - sum(host.values()):.3f} s; "
              f"inference {st['video/inference']:.3f} s (load and refine "
              f"{st['inference/refine']:.3f} s, {len(requests)} requests of {n_points} "
              f"points: {', '.join(f'{s:.3f}' for s in requests)} s); eval "
              f"{eval_report[f'eval/{vid}']['total_s']:.3f} s; peak memory "
              f"{rep['peak_bytes'] / 2**30:.2f} GiB, allocated before "
              f"{mib(rep['allocated_before_bytes'])} MiB, after "
              f"{mib(rep['allocated_after_bytes'])} MiB; average_jaccard "
              f"{want[vid]['average_jaccard']:.4f}, occlusion_accuracy "
              f"{want[vid]['occlusion_accuracy']:.4f}", flush=True)
    print(f"e2e: {n} videos, run_benchmark {run_s:.3f} s, eval_benchmark {eval_s:.3f} s; "
          f"memory allocated: baseline {mib(base)} MiB, after each video "
          f"{[mib(a) for a in after]} MiB, of which cuBLAS workspaces {mib(workspaces)} MiB; "
          f"after the last video without them {mib(cleared)} MiB (carried "
          f"{mib(cleared - base)}, bound {E2E_MEMORY_MARGIN / 2**20:.0f}); live CUDA "
          f"tensors (count, bytes) {live_cuda_tensors()}; "
          f"launches K1-fwd {launches[0]}, K1-bwd {launches[1]}, K2 {launches[2]}, "
          f"K3 {launches[3]}, K5-fwd {launches[4]}, K5-bwd {launches[5]}; train steps "
          f"{captures} captured (each a warm-up step), "
          f"{replays} replayed; TrainConfig batch {tcfg.train_batch_size} x "
          f"{tcfg.batch_n_frames} frames, {tcfg.compute_dtype}", flush=True)
    return launches


def probe_train_banks(dev, data_path):
    """The train step on a video's own artifacts (TrainConfig's full width),
    with its trajectory banks whole and with each cut to phase 5's 100,000
    rows, gates off and on (CUDA events): how much of the steps' time beyond
    phase 5's the bank size accounts for."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrainConfig
    from dino_tracker_tpu_torch.training import train
    from dino_tracker_tpu_torch.training.sampler import TrajectoryBank
    cfg = TrainConfig()
    rt = runtime.DINOTrackerRuntime(data_path, cfg, dev)
    data = rt.load_video_data()
    cut = lambda b, n: TrajectoryBank(b.coords[:n], b.valid[:n], min(b.count, n))
    small = data._replace(fg_bank=cut(data.fg_bank, N_FG_TRAJ),
                          bg_bank=cut(data.bg_bank, N_BG_TRAJ))
    model = train.Trainer(cfg, rt.tcfg, data, "", seed=2, device=dev).init_model().train()
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    ms = {(name, gates): cuda_ms(lambda: train.train_step(
        model, opt, sched, d, gen, gates, gates, cfg, rt.tcfg), iters=PROBE_STEPS, warmup=3)
        for gates in (False, True) for name, d in (("whole", data), ("cut", small))}
    print(f"e2e: train step on video 0's artifacts ({PROBE_STEPS} steps, CUDA events), banks "
          f"whole ({data.fg_bank.count} fg + {data.bg_bank.count} bg): "
          f"{ms['whole', False]:.2f} / {ms['whole', True]:.2f} ms gates off / on; cut to "
          f"{N_FG_TRAJ} + {N_BG_TRAJ}: {ms['cut', False]:.2f} / {ms['cut', True]:.2f} ms; "
          f"best-buddy slots {data.bb.valid.shape[-1]} (phase 5: {BB_CAP}), features "
          f"{data.dino_embed.dtype}", flush=True)


def phase_other_card(bp, other):
    """K1-fwd, K1-bwd, K2 and K3 launched on ``other`` (cuda:1) from this
    process, whose current device stays cuda:0, each against its plain
    version on that card: every wrapper launches under its tensor's device
    guard (ops/_guard.py)."""
    from dino_tracker_tpu_torch.ops import attention
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    from dino_tracker_tpu_torch.ops import window_gather as wg
    check(torch.cuda.current_device() == 0, "cuda:0 is not the current device")
    g = torch.Generator(device=other).manual_seed(21)
    errs = {}
    x = torch.randn(TRAIN_SHAPES[0], generator=g, device=other).bfloat16().requires_grad_()
    y = bp.blurpool_cuda(x)
    gy = torch.randn(y.shape, generator=g, device=other).bfloat16()
    (gx,) = torch.autograd.grad(y, x, gy)
    xr = x.detach().clone().requires_grad_()
    yr = bp.blurpool_reference(xr)
    (gxr,) = torch.autograd.grad(yr, xr, gy)
    errs["K1-fwd"] = ((y.float() - yr.float()).abs().max().item(), bf16_ulp(yr.float()))
    errs["K1-bwd"] = ((gx.float() - gxr.float()).abs().max().item(), bf16_ulp(gxr.float()))
    del x, y, gy, gx, xr, yr, gxr
    q, k, v = qkv_views((1, 16, 2048, 64), g, other)
    out = fa.flash_attention_cuda(q, k, v, ATTN_SCALE).float()
    ref = attention.attention_reference(q.float(), k.float(), v.float(), ATTN_SCALE)
    errs["K2"] = ((out - ref).abs().max().item(), BF16_ATTN_TOL * ref.abs().max().item())
    del q, k, v, out, ref
    pyramid, coords = lookup_inputs(other, *LOOKUP_SHAPE, seed=22)
    out = wg.corr_lookup_cuda(pyramid, coords)
    ref = wg.corr_lookup_reference(pyramid, coords)
    errs["K3"] = ((out - ref).abs().max().item(), LOOKUP_TOL * ref.abs().max().item())
    torch.cuda.synchronize(other)
    del pyramid, coords, out, ref
    check(torch.cuda.current_device() == 0, "a launch changed the current device")
    print(f"other card: K1-fwd, K1-bwd, K2, K3 launched on {other} while cuda:0 is "
          f"current: " + ", ".join(f"{name} max_abs_err {e:.3g} (bound {b:.3g})"
                                   for name, (e, b) in errs.items()), flush=True)
    check(all(e <= b for e, b in errs.values()), f"a kernel on {other} disagrees "
          f"with its plain version: {errs}")


def mesh_equality(mesh, data_path, train_yaml, device_type="cuda"):
    """On every rank (``mesh`` None: one device): the train step on the
    directory's artifacts at ``train_yaml``'s widths (TrainConfig's full
    width in phase 12), gates on, in f32 and in bf16 -> the losses and
    gradients summed over the ranks and the new BN statistics; then
    MESH_REPLICA_STEPS steps of the bf16 default across the phase boundary
    -> the model state and the generator state; with a mesh, the times of
    the refine's gather and of its backward's all-reduce at the training
    shape. f32 starts from the Trainer's own initialisation (seed 2), whose
    zero last DeltaDINO layer keeps the earlier layers' gradients exactly
    zero: at full width some pre-activation lies within f32 rounding of a
    ReLU's kink, lands on either side in two valid orders of summation and
    moves a gradient by its whole cotangent, so a 1e-4 bound on those layers
    would not hold even between two orders on one device. bf16 and the
    replica steps start from non-zero seeded weights, so every layer's
    gradient and BN's backward over the ranks are held (bf16: to sign and
    scale)."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrainConfig
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    from dino_tracker_tpu_torch.training import train
    from dino_tracker_tpu_torch.training.sampler import sample_batch
    dev = mesh.device if mesh is not None else torch.device(device_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    data = None
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(TrainConfig.from_yaml(train_yaml), compute_dtype=dtype)
        rt = runtime.DINOTrackerRuntime(data_path, cfg, dev, mesh=mesh)
        data = data if data is not None else rt.load_video_data()
        channels = rt.tcfg.delta_channels
        if dtype == "float32":
            model = train.Trainer(cfg, rt.tcfg, data, "", seed=2, device=dev
                                  ).init_model().train()
        else:
            model = build_model(*full_width_inputs().jax_layout_weights(
                np.random.default_rng(9), channels, 0.1), rt.tcfg, dev).train()
        gen = torch.Generator(device=dev).manual_seed(2)
        sample = sample_batch(gen, data.fg_bank, data.bg_bank, cfg.train_batch_size,
                              cfg.batch_n_frames, cfg.fg_traj_ratio, data.video.shape[0],
                              cfg.video_resw, cfg.video_resh)
        total, metrics = train.step_losses(model, data, sample, gen, cfg, rt.tcfg, True,
                                           True, mesh=mesh)
        total.backward()
        mesh_lib.all_reduce_grads(model, mesh)
        metrics = train.reduce_metrics(metrics, mesh)
        out[dtype] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          grads={n: p.grad.cpu() for n, p in model.named_parameters()
                                 if p.grad is not None},
                          buffers={n: b.cpu() for n, b in model.named_buffers()})
        del model, total
    model = build_model(*full_width_inputs().jax_layout_weights(
        np.random.default_rng(9), channels, 0.1), rt.tcfg, dev).train()
    opt, sched = train.make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(MESH_REPLICA_STEPS):
        train.train_step(model, opt, sched, data, gen, i >= 1, i >= 1, cfg, rt.tcfg, mesh)
    out["replica"] = dict(state={k: v.cpu() for k, v in model.state_dict().items()},
                          generator=gen.get_state())
    # warm steps (the CLI's timers include each segment's first steps: the
    # collectives' set-up, the first allocations)
    for gates in (False, True):
        fence(dev)
        t0 = time.perf_counter()
        for _ in range(MESH_TIMED_STEPS):
            train.train_step(model, opt, sched, data, gen, gates, gates, cfg, rt.tcfg, mesh)
        fence(dev)
        out[f"warm_ms_{'on' if gates else 'off'}"] = (
            (time.perf_counter() - t0) * 1e3 / MESH_TIMED_STEPS)
    del model, opt
    if mesh is not None:  # the refine's gather (forward) and all-reduce (backward)
        import torch.distributed as dist
        n = 2 * cfg.batch_n_frames
        x = torch.randn((mesh_lib.split_sizes(n, mesh.world_size)[mesh.rank],
                         *rt.tcfg.feat_hw, channels[-1]), device=dev)
        full = torch.randn((n, *rt.tcfg.feat_hw, channels[-1]), device=dev)

        def timed(fn, iters=5):
            fn()
            fence(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            fence(dev)
            return (time.perf_counter() - t0) * 1e3 / iters

        out["gather_ms"] = timed(lambda: mesh_lib.all_gather_rows(x, mesh, n))
        out["all_reduce_ms"] = timed(lambda: dist.all_reduce(full, group=mesh.group))
        out["gather_bytes"] = full.numel() * full.element_size()
        del x, full
    if mesh is not None and mesh_lib.capture_blocker(mesh) is None:
        trainer = train.Trainer(cfg, rt.tcfg, data, "", seed=2, device=dev, mesh=mesh)
        out["chunks"] = train_chunks(dev, trainer, cfg, rt.tcfg, data, mesh)
    return out


def capture_failure_on_rank_1(mesh, data_path, train_yaml):
    """``sync_on_rank_1`` on a preprocessed directory's data."""
    return sync_on_rank_1(mesh, *dir_trainer(mesh.device, data_path, train_yaml, mesh))


def dir_trainer(dev, data_path, train_yaml, mesh=None):
    """A Trainer (seed 2) on a preprocessed directory's artifacts at
    ``train_yaml``'s config (its bf16 default), on ``dev`` or this rank of
    ``mesh`` -> (trainer, cfg, tcfg, data)."""
    from dino_tracker_tpu_torch import runtime
    from dino_tracker_tpu_torch.config import TrainConfig
    from dino_tracker_tpu_torch.training import train
    cfg = TrainConfig.from_yaml(train_yaml)
    rt = runtime.DINOTrackerRuntime(data_path, cfg, dev, mesh=mesh)
    data = rt.load_video_data()
    trainer = train.Trainer(cfg, rt.tcfg, data, "", seed=2, device=dev, mesh=mesh)
    return trainer, cfg, rt.tcfg, data


def phase_dir_chunks(dev, data_path, train_yaml, smi):
    """Phase 12's one-card train chunks: ``train_chunks`` with no mesh on a
    preprocessed directory (phase 11's video 0), the data, config and init
    every NCCL rank of phase 12 runs its chunks on, printed as phase 5's."""
    t0 = time.perf_counter()
    trainer, cfg, tcfg, data = dir_trainer(dev, data_path, train_yaml)
    print_chunks(train_chunks(dev, trainer, cfg, tcfg, data), cfg, smi,
                 f"train chunks on one card, {os.path.relpath(data_path, REPO_DIR)}'s artifacts")
    del trainer, data
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train chunks on one card: {time.perf_counter() - t0:.2f} s", flush=True)


def report_capture_failure(raised):
    """Checks and prints each rank's ``sync_on_rank_1`` message."""
    check(all(e is not None and "rank 1:" in e and ".item()" in e for e in raised),
          f"a capture failed on rank 1 alone; the ranks raised {raised}")
    print(f"mesh: a step that syncs on rank 1 alone after the forward's collectives (an "
          f".item() injected) failed its capture there, after the other ranks had "
          f"captured the whole step, and raised on all {len(raised)} ranks before any "
          f"replay; every rank's process then ended: {raised[0][:300]}", flush=True)


def sync_on_rank_1(mesh, trainer, cfg, tcfg, data):
    """A step that syncs on rank 1 alone (an .item() injected there after
    the forward, so after the refine's gather, BN's all-reduces and the
    cycle gathers were captured), whose capture therefore fails there part
    way while the other ranks capture the whole step: every rank must raise
    before any replay, naming rank 1 and the line. Nothing after it uses
    the NCCL communicator (a host barrier), and the spawn's time limit
    holds the processes' end. -> this rank's error message."""
    import torch.distributed as dist
    from dino_tracker_tpu_torch.training import train
    model = trainer.init_model().train()
    opt, sched = train.make_optimizer(model, cfg)
    runner = train.StepRunner(model, opt, sched,
                              torch.Generator(device=mesh.device).manual_seed(2), cfg,
                              tcfg, mesh)
    losses = train.step_losses

    def syncing(*args, **kwargs):
        out = losses(*args, **kwargs)
        if mesh.rank == 1:
            torch.zeros((), device=mesh.device).item()  # after the forward's collectives
        return out

    faulthandler.dump_traceback_later(MESH_FAILURE_TIMEOUT_S // 2, repeat=True)
    train.step_losses = syncing
    try:
        runner.run(data, False, False, 2)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        train.step_losses = losses
    dist.barrier(group=mesh.host_group)
    torch.cuda.synchronize(mesh.device)
    return raised  # the stack dumps stay armed until the process ends


def rank_line(reports, gates_at, iterations):
    """ms/iter with the gates off and on, captures and replays, launches and
    peak memory of each rank's report."""
    parts = []
    for r, rep in enumerate(reports):
        st = rep["stages"]
        ms = lambda k, n: st[k]["total_s"] / n * 1e3 if k in st else float("nan")
        slowest = (f", slowest rank {ms('train/steps_gates_off/slowest_rank', gates_at):.2f}"
                   f" / {ms('train/steps_gates_on/slowest_rank', iterations - gates_at):.2f}"
                   if "train/steps_gates_off/slowest_rank" in st else "")
        parts.append(f"rank {r}: {ms('train/steps_gates_off', gates_at):.2f} / "
                     f"{ms('train/steps_gates_on', iterations - gates_at):.2f} ms/iter "
                     f"gates off / on{slowest}, captures {rep['graphs']['captures']}, "
                     f"replays {rep['graphs']['replays']}, launches {rep['launches']}, peak "
                     f"{rep.get('peak_bytes', 0) / 2**30:.2f} GiB")
    return "; ".join(parts)


def phase_mesh(dev, video_dir, train_yaml, bench_pkl, n_ranks, share, smi,
               iterations=E2E_ITERATIONS, t=E2E_T):
    """cli.train then cli.inference_benchmark with --devices n_ranks and
    --devices 1 on copies of a preprocessed video directory (TrainConfig's
    full width, ``iterations`` with both gates at half of them), inference
    again past a truncated newest checkpoint, then the step's equality across
    ranks (``mesh_equality``). ``share``: every rank
    on cuda:0 over gloo; else rank r on cuda:r over NCCL. Returns the
    launches of K1-fwd, K1-bwd, K5-fwd and K5-bwd over every rank of every
    run (the wrappers' counts)."""
    from dino_tracker_tpu_torch.cli import inference_benchmark
    from dino_tracker_tpu_torch.cli import train as train_cli
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    from dino_tracker_tpu_torch.training import checkpoint
    from dino_tracker_tpu_torch.utils import profiling
    root = os.path.join(WORK_DIR, "mesh")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {w: os.path.join(root, f"w{w}") for w in (n_ranks, 1)}
    for d in dirs.values():
        shutil.copytree(video_dir, d, ignore=shutil.ignore_patterns(
            "models", "trajectories", "occlusions", "grid_*"))
    mode = ["--share-device"] if share else []
    how = (f"{n_ranks} ranks on {dev} over gloo (shared card)" if share
           else f"{n_ranks} ranks on cuda:0..{n_ranks - 1} over NCCL")
    gates_at = iterations // 2
    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    def run(cli, argv, w):
        reset_counts()
        profiling.reset_stage_timers()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reports = cli.main(argv + ["--devices", str(w)] + (mode if w > 1 else []))
        return reports, time.perf_counter() - t0

    train_args = lambda d: ["--config", train_yaml, "--data-path", d, "--device", dev.type]
    # one device, and ranks over NCCL, train in chunks of replays; ranks over
    # gloo (a shared card) eagerly
    trained = {w: run(train_cli, train_args(dirs[w]), w) for w in (n_ranks, 1)}
    for w, d in dirs.items():
        steps = checkpoint.checkpoint_steps(os.path.join(d, "models", "dino_tracker"))
        check(steps == [iterations, gates_at], f"--devices {w} wrote checkpoints {steps}")
    infer_args = train_args(dirs[n_ranks]) + ["--benchmark-pickle-path", bench_pkl,
                                              "--video-id", "0"]
    served = {}
    with open(bench_pkl, "rb") as f:
        frames = sorted(pickle.load(f)["videos"][0]["query_points"])
    for w in (n_ranks, 1):  # both serve the W-rank run's checkpoint
        served[w] = run(inference_benchmark, infer_args, w)
        served[w] += ({f: (np.load(os.path.join(dirs[n_ranks], "trajectories",
                                                f"trajectories_{f}.npy")),
                           np.load(os.path.join(dirs[n_ranks], "occlusions",
                                                f"occlusion_preds_{f}.npy")))
                       for f in frames},)
        for sub in ("trajectories", "occlusions"):
            shutil.rmtree(os.path.join(dirs[n_ranks], sub))
    # a checkpoint cut by a kill mid-save, newer than any: both runs serve the
    # step before it (rank 0 picks it for every rank) and write what the
    # folder without it gave
    cut = os.path.join(root, "cut")
    shutil.copytree(dirs[n_ranks], cut, ignore=shutil.ignore_patterns(
        "trajectories", "occlusions", "grid_*"))
    folder = os.path.join(cut, "models", "dino_tracker")
    good = checkpoint.checkpoint_file(folder, iterations)
    with open(good, "rb") as f:
        blob = f.read()
    with open(checkpoint.checkpoint_file(folder, iterations + 1), "wb") as f:
        f.write(blob[: len(blob) // 2])
    fallback = {}
    for w in (n_ranks, 1):
        fallback[w] = run(inference_benchmark, ["--config", train_yaml, "--data-path", cut,
                                                "--device", dev.type, "--benchmark-pickle-path",
                                                bench_pkl, "--video-id", "0"], w)
        got = [r["checkpoint"] for r in fallback[w][0]]
        check(got == [good] * w, f"--devices {w} with a truncated state_{iterations + 1}.pt "
              f"served {got}, expected {good} on every rank")
        same = all(np.array_equal(np.load(os.path.join(cut, sub, f"{name}_{f}.npy")),
                                  served[w][2][f][i])
                   for f in frames for i, (sub, name) in enumerate(
                       (("trajectories", "trajectories"), ("occlusions", "occlusion_preds"))))
        check(same, f"--devices {w} with a truncated newest checkpoint wrote other "
              "predictions than the folder without it")
        for sub in ("trajectories", "occlusions"):
            shutil.rmtree(os.path.join(cut, sub))
    print(f"mesh: a truncated state_{iterations + 1}.pt beside state_{iterations}.pt: "
          f"cli.inference_benchmark --devices {n_ranks} ({fallback[n_ranks][1]:.2f} s) and "
          f"--devices 1 ({fallback[1][1]:.2f} s) served state_{iterations}.pt on every "
          f"rank, .npy files equal to those without the bad file [{smi}]", flush=True)
    px = max(float(np.abs(served[n_ranks][2][f][0] - served[1][2][f][0]).max())
             for f in frames)
    flips = sum(int((served[n_ranks][2][f][1] != served[1][2][f][1]).sum()) for f in frames)
    finite = all(np.isfinite(served[w][2][f][0]).all() for w in served for f in frames)

    # launches: each rank's DeltaDINO runs 3 blurpools an eager train step
    # (its share of the frame set) and 3 a 16-frame refine chunk of its
    # frames; a captured step's wrapper calls count only in its warm-up step,
    # one a capture (the replays run no wrapper): 2 captures, one a set of
    # gates, and the other steps replayed, on one device and on each NCCL rank
    refine = lambda w: [3 * -(-s // 16) for s in mesh_lib.split_sizes(t, w)]
    for w in (n_ranks, 1):
        graphed = w == 1 or not share
        captures = 2 if graphed else 0
        got = [(r["launches"]["blurpool_down_nhwc"], r["launches"]["blurpool_up_nhwc"],
                r["launches"]["batchnorm_fwd"], r["launches"]["batchnorm_bwd"],
                r["graphs"]["captures"], r["graphs"]["replays"]) for r in trained[w][0]]
        eager = captures if graphed else iterations
        want = (3 * eager, 3 * eager, BN_LAYERS * eager, BN_LAYERS * eager, captures,
                iterations - eager)
        check(got == [want] * w, f"--devices {w} training launched K1-fwd / K1-bwd / "
              f"K5-fwd / K5-bwd and made captures / replays {got} per rank, expected {want}")
        for what, runs in (("inference", served), ("inference past the truncated file",
                                                   fallback)):
            got = [(r["launches"]["blurpool_down_nhwc"], r["launches"]["batchnorm_fwd"])
                   for r in runs[w][0]]
            want = [(k, k // 3 * BN_LAYERS) for k in refine(w)]
            check(got == want, f"--devices {w} {what} launched K1-fwd / K5-fwd {got} "
                  f"times per rank, expected {want}")
    if share:
        print(f"mesh: cli.train --devices {n_ranks} --share-device: every rank stepped "
              f"eagerly (0 captures, 3 K1-fwd and K1-bwd a step; gloo collectives go "
              f"through host memory)", flush=True)
    launches = [0, 0, 0, 0]
    for w in (n_ranks, 1):
        for r in trained[w][0] + served[w][0] + fallback[w][0]:
            for i, k in enumerate(("blurpool_down_nhwc", "blurpool_up_nhwc", "batchnorm_fwd",
                                   "batchnorm_bwd")):
                launches[i] += r["launches"][k]
    for w in (n_ranks, 1):
        print(f"mesh: cli.train --devices {w} ({how if w > 1 else f'one process on {dev}'}"
              f"), T={t} 854x476, TrainConfig's full width, {iterations} iterations, "
              f"gates at {gates_at}: {trained[w][1]:.2f} s; {rank_line(trained[w][0], gates_at, iterations)}"
              f" [{smi}]", flush=True)
        reqs = ", ".join(f"{k.split('_')[-1]} {v['total_s']:.3f} s"
                         for k, v in served[w][0][0]["stages"].items()
                         if k.startswith("inference/query_frame_"))
        print(f"mesh: cli.inference_benchmark --devices {w} on the {n_ranks}-rank "
              f"checkpoint: {served[w][1]:.2f} s, rank 0 refine "
              f"{served[w][0][0]['stages']['inference/refine']['total_s']:.3f} s, "
              f"requests (query frame, s) {reqs}; K1-fwd per rank "
              f"{[r['launches']['blurpool_down_nhwc'] for r in served[w][0]]} [{smi}]",
              flush=True)
    ok = px <= MESH_PX_TOL and flips == 0 and finite
    print(f"mesh: inference --devices {n_ranks} against --devices 1 on one checkpoint: "
          f"trajectories max diff {px:.3g} px (bound {MESH_PX_TOL}), occlusion flags "
          f"differing {flips}: {'met' if ok else 'NOT MET'}", flush=True)
    check(ok, "multi-rank inference disagrees with one device")

    # the step itself: W ranks against one device (twice, for the card's own
    # run-to-run spread: the row gathers' backward accumulates with atomics)
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(mesh_equality, n_ranks, dev.type,
                           args=(dirs[1], train_yaml), share_device=share,
                           timeout=900)
    eq_s = time.perf_counter() - t0
    one = [mesh_equality(None, dirs[1], train_yaml, dev.type) for _ in range(2)]
    if cuda:
        torch.cuda.empty_cache()
    lines, met = [], True
    for dtype, (loss_rtol, grad_tol) in MESH_TOL.items():
        ref = one[0][dtype]
        # f32: each loss term relative to itself, beside an absolute 1e-7 for
        # terms near 0 (as tests/test_torch_train_step.py compares them);
        # bf16 (sign and scale): a term smaller than the total loss relative
        # to the total, the scale the step trains on
        total = abs(ref["metrics"]["loss_total"])
        scale = lambda v: abs(v) + 1e-7 / loss_rtol if dtype == "float32" else max(
            abs(v), total, 1e-30)
        loss_err, worst = max((abs(r[dtype]["metrics"][k] - v) / scale(v), k)
                              for r in ranks for k, v in ref["metrics"].items())

        def grad_err(a):
            """Largest difference over each tensor's largest magnitude; a
            tensor that is zero on one device must be zero."""
            errs = []
            for n, g in ref["grads"].items():
                if n in MESH_NULL_GRADS:
                    continue
                d, s = float((a["grads"][n] - g).abs().max()), float(g.abs().max())
                errs.append(d / s if s else (0.0 if d == 0 else float("inf")))
            return max(errs)

        g_err = max(grad_err(r[dtype]) for r in ranks)
        floor = grad_err(one[1][dtype])
        bn_err = max(float((r[dtype]["buffers"][n] - b).abs().max()) for r in ranks
                     for n, b in ref["buffers"].items())
        # on the card, equality holds to the card's own run-to-run spread
        bound = max(grad_tol, 2 * floor)
        bn_bound = 1e-6 if dtype == "float32" else loss_rtol
        ok = loss_err <= loss_rtol and g_err <= bound and bn_err <= bn_bound
        met &= ok
        lines.append(f"{dtype}: losses max rel diff {loss_err:.3g} ({worst}; bound "
                     f"{loss_rtol}), "
                     f"gradients max diff {g_err:.3g} of each tensor's max (bound "
                     f"{grad_tol}, or twice one device's own run-to-run "
                     f"{floor:.3g}: {bound:.3g}; {'within' if g_err <= grad_tol else 'NOT within'}"
                     f" {grad_tol} itself), BN statistics max diff {bn_err:.3g} (bound "
                     f"{bn_bound}): {'met' if ok else 'NOT MET'}")
    first = ranks[0]["replica"]
    same = all(torch.equal(r["replica"]["state"][k], v) for r in ranks[1:]
               for k, v in first["state"].items()) and all(
        torch.equal(r["replica"]["generator"], first["generator"]) for r in ranks[1:])
    print(f"mesh: train step, {how}, against one device (TrainConfig's full width, "
          f"gates on; f32 from the Trainer's init, bf16 from seeded non-zero weights; "
          f"{eq_s:.1f} s): " + "; ".join(lines)
          + f"; after {MESH_REPLICA_STEPS} bf16 steps every rank's parameters, BN "
          f"statistics and generator state bitwise equal: {same}; then {MESH_TIMED_STEPS} "
          f"warm steps under each set of gates, ms/iter gates off / on: one device "
          f"{one[0]['warm_ms_off']:.2f} / {one[0]['warm_ms_on']:.2f}, each rank "
          f"{[(round(r['warm_ms_off'], 2), round(r['warm_ms_on'], 2)) for r in ranks]}"
          f"; the refine's gather "
          f"of {ranks[0]['gather_bytes'] / 1e6:.1f} MB: rank times "
          f"{[round(r['gather_ms'], 2) for r in ranks]} ms, its backward's all-reduce "
          f"{[round(r['all_reduce_ms'], 2) for r in ranks]} ms [{smi}]", flush=True)
    check(met and same, "the multi-rank train step disagrees with one device")
    if not share:
        mesh_chunks_report(ranks, how, smi)
        report_capture_failure(mesh_lib.spawn(capture_failure_on_rank_1, n_ranks,
                                              dev.type, args=(dirs[1], train_yaml),
                                              timeout=MESH_FAILURE_TIMEOUT_S))
    return launches


def mesh_chunks_report(ranks, how, smi):
    """Each rank's ``train_chunks`` (run by ``mesh_equality``): checked that
    every rank's graph run, and eager G where the ranks ran it, left bitwise
    the same parameters and BN statistics; printed, in turns, for every rank
    and the slowest (the largest time, the least busy share), gates off and
    on, with the ranks whose own share took a choice no eager run took."""
    for gates in (False, True):
        rows = [r["chunks"][gates] for r in ranks]
        for key, run in (("digest", "the replays"), ("digest_g", "eager G")):
            got = [r[key] for r in rows]
            check(len(set(got)) == 1, f"gates {gates}: the ranks' replicas differ after "
                  f"{run}: {[d and d[:12] for d in got]}")
        took = rows[0]["took"]
        fmt = lambda xs: ", ".join(f"{x:.2f}" for x in xs)
        # NCCL's kernels spin while they wait for a slower peer: the card's
        # own work is the busy share less NCCL's part of it
        own = lambda b: b[1] * (1 - b[2])
        lines = [f"rank {k}: replayed {fmt(r['times'][True])}, eager "
                 f"{fmt(r['times'][False])} ms/iter, under the profiler replayed "
                 f"{r['busy'][True][0]:.2f} (busy {r['busy'][True][1]:.4f}, NCCL "
                 f"{r['busy'][True][2]:.4f} of the device time, busy without NCCL "
                 f"{own(r['busy'][True]):.4f}), eager "
                 f"{r['busy'][False][0]:.2f} (busy {r['busy'][False][1]:.4f}, NCCL "
                 f"{r['busy'][False][2]:.4f}, busy without NCCL "
                 f"{own(r['busy'][False]):.4f}), warm-up step and capture "
                 f"{r['capture_ms']:.1f} ms, peak allocated replaying "
                 f"{r['peaks'][True] / 2**30:.2f} GiB, eager {r['peaks'][False] / 2**30:.2f}"
                 f" GiB, reserved at the verdict {r['reserved'] / 2**30:.2f} GiB; {r['rule']}"
                 for k, r in enumerate(rows)]
        slow = lambda f: max(f(r) for r in rows)
        lines.append(
            f"slowest rank: replayed {slow(lambda r: np.mean(r['times'][True])):.2f}, "
            f"eager {slow(lambda r: np.mean(r['times'][False])):.2f} ms/iter (means in "
            f"turns), busy replayed {min(r['busy'][True][1] for r in rows):.4f}, eager "
            f"{min(r['busy'][False][1] for r in rows):.4f}, without NCCL replayed "
            f"{min(own(r['busy'][True]) for r in rows):.4f}, eager "
            f"{min(own(r['busy'][False]) for r in rows):.4f}, capture "
            f"{slow(lambda r: r['capture_ms']):.1f} ms")
        print(f"mesh: train chunks, {how}, gates {'on' if gates else 'off'}: on every rank "
              f"{CHUNK_STEPS} replays vs {CHUNK_STEPS} eager steps from one state at count "
              f"{CHUNK_START}, batches and rates equal, every tensor within phase 5's rule; "
              f"the replicas bitwise equal after the replays"
              + ("" if rows[0]["digest_g"] is None else " and after eager G")
              + f"; ranks whose own share took a choice no eager run took: {len(took)} of "
              f"{len(rows)} {took}; "
              f"K1-fwd and K1-bwd {3 * TRACE_STEPS} each in {TRACE_STEPS} traced replays on "
              f"every rank; in turns (graph, eager, eager, graph; {CHUNK_STEPS} steps each): "
              + "; ".join(lines) + f" [{smi}]", flush=True)


def compare_preprocessed(got_dir, want_dir):
    """Every artifact of two preprocessed directories, under the bounds of
    phase 13: trajectories (both passes) and the fg/bg banks, the mask jpgs'
    bytes and the best buddies' coordinates, cosines, validity and
    telemetry (its seconds aside) equal; each f16 feature artifact within
    MESH_PRE_TOL of its max; r within MESH_PRE_TOL. -> [(what, value,
    bound or None for equality, ok)]."""
    from dino_tracker_tpu_torch.config import add_config_paths
    from dino_tracker_tpu_torch.structures import load_bb_data
    from dino_tracker_tpu_torch.utils import video_io
    got, want = add_config_paths(got_dir), add_config_paths(want_dir)
    rows = []
    for key in ("trajectories_file", "unfiltered_trajectories_file", "fg_trajectories_file",
                "bg_trajectories_file"):
        a, b = (video_io.load_npz(p[key])["trajectories"] for p in (got, want))
        rows.append((key, f"{a.shape} vs {b.shape}", None,
                     a.shape == b.shape and np.array_equal(a, b, equal_nan=True)))
    for key in ("dino_embed_video_path", "mask_dino_embed_video_path"):
        a, b = (video_io.load_npz(p[key])["features"].astype(np.float32) for p in (got, want))
        err = float(np.abs(a - b).max() / np.abs(b).max()) if a.shape == b.shape else np.inf
        rows.append((key, err, MESH_PRE_TOL, err <= MESH_PRE_TOL))
    names = sorted(os.listdir(want["masks_path"]))
    same = names == sorted(os.listdir(got["masks_path"])) and all(
        open(os.path.join(got["masks_path"], n), "rb").read()
        == open(os.path.join(want["masks_path"], n), "rb").read() for n in names)
    rows.append((f"{len(names)} mask jpgs", same, None, same))
    bb = [load_bb_data(os.path.join(p["dino_bb_dir"], "dino_best_buddies_filtered.npz"))
          for p in (got, want)]
    for name, a, b in zip(bb[0]._fields, *bb):
        if name == "r":
            err = float((a - b).abs().max()) if a.shape == b.shape else np.inf
            rows.append(("bb r", err, MESH_PRE_TOL, err <= MESH_PRE_TOL))
        else:
            ok = a.shape == b.shape and torch.equal(a, b)
            rows.append((f"bb {name}", ok, None, ok))
    tel = []
    for p in (got, want):
        with open(os.path.join(p["dino_bb_dir"], "bb_truncation.json")) as f:
            tel.append({k: v for k, v in json.load(f).items() if k != "phases"})
    rows.append(("bb_truncation.json", tel[0] == tel[1], None, tel[0] == tel[1]))
    return rows


def rank_shares(n_batches_per_call, w):
    """Each rank's batches over successive calls of split_batches (whole
    batches, the count split as split_sizes splits it, each call's longer
    shares starting at the rank after the last call's, as the flow engine
    moves them on)."""
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    shares, first = [0] * w, 0
    for n in n_batches_per_call:
        sizes = mesh_lib.split_sizes(n, w)
        shares = [c + sizes[(r - first) % w] for r, c in enumerate(shares)]
        first = (first + n) % w
    return shares


def phase_mesh_preprocess(dev, frames_dir, cli_args, n_ranks, share, smi, t):
    """cli.preprocess with --devices n_ranks and with --devices 1 on two
    copies of ``frames_dir`` (a frame folder), ``cli_args`` giving the
    config and checkpoints; every artifact compared (compare_preprocessed).
    Every rank's K2 and K3 launches are held to its share of the ViT's
    frame batches and of the decode batches (whole batches: where a call has
    fewer batches than ranks, some ranks get none of it), every decode to 8
    pairs.
    Printed: each rank's stage seconds, launches, decode batch sizes, peak
    memory and gathers (bytes, seconds), each stage at W=n_ranks (rank 0
    and the slowest rank) beside W=1. Returns the directories (n_ranks, 1)
    and the K2 and K3 launches of both runs over every rank."""
    from dino_tracker_tpu_torch.cli import preprocess
    from dino_tracker_tpu_torch.config import PreprocessConfig
    from dino_tracker_tpu_torch.utils import native_io, native_traj, profiling
    cfg = PreprocessConfig.from_yaml(cli_args[cli_args.index("--config") + 1])
    # the frame loader and the occupancy update are built at first use with
    # g++: built here, so that no rank times the build inside its stage 1
    native_io.get_lib()
    native_traj.get_lib()
    root = os.path.join(WORK_DIR, "mesh_preprocess")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {w: os.path.join(root, f"w{w}") for w in (n_ranks, 1)}
    for d in dirs.values():
        shutil.copytree(frames_dir, os.path.join(d, "video"))
    mode = ["--share-device"] if share else []
    how = (f"{n_ranks} ranks on {dev} over gloo (shared card)" if share
           else f"{n_ranks} ranks on cuda:0..{n_ranks - 1} over NCCL")
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for w, d in dirs.items():
        reset_counts()
        profiling.reset_stage_timers()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reports = preprocess.main(cli_args + ["--data-path", d, "--device", dev.type,
                                              "--devices", str(w)] + (mode if w > 1 else []))
        runs[w] = (reports, time.perf_counter() - t0)
    torch.cuda.empty_cache()

    rows = compare_preprocessed(dirs[n_ranks], dirs[1])
    vit_batches = -(-t // cfg.extract_frames_per_batch)
    blocks = max(cfg.dino_layer, cfg.mask_dino_layer) + 1
    per = lambda n: -(-n // 8)
    calls = [2 * per(t - 1)] + [2 * per(t - 1 - s) for s in range(t - 1)]
    launches = [0, 0]
    for w in (n_ranks, 1):
        reports = runs[w][0]
        want = list(zip((blocks * n for n in rank_shares([vit_batches], w)),
                        (cfg.raft_iters * n for n in rank_shares(calls, w))))
        got = [(r["launches"]["flash_attention"], r["launches"]["corr_lookup"])
               for r in reports]
        sizes = [r["telemetry"]["raft"]["decode_batch_sizes"] for r in reports]
        check(got == want and sum(g[0] for g in got) > 0 and sum(g[1] for g in got) > 0,
              f"--devices {w}: K2 / K3 launched {got} times per rank, expected {want}")
        check(all(set(z) <= {8} for z in sizes), f"--devices {w}: decode batches {sizes}")
        launches[0] += sum(g[0] for g in got)
        launches[1] += sum(g[1] for g in got)
        for r, rep in enumerate(reports):
            stages = ", ".join(f"{k.split('/')[1]} {v:.3f}" for k, v in rep["timings"].items()
                               if k.startswith("preprocess/"))
            stages += " (stage 1: " + ", ".join(
                f"{k} {rep['timings'][k]:.3f}" for k in ("encode", "adjacent_flows",
                                                         "direct_sweep_and_chaining", "harvest")
                if k in rep["timings"]) + "; best buddies: " + ", ".join(
                f"{k[3:]} {rep['timings'][k]:.3f}" for k in (
                    "bb_closest_grids", "bb_sweep", "bb_compaction", "bb_ambiguity", "bb_save")
                if k in rep["timings"]) + ")"
            gathers = ", ".join(f"{k.split('/')[1]} {v['bytes'] / 1e6:.1f} MB in "
                                f"{v['total_s']:.3f} s ({v['calls']} calls)"
                                for k, v in rep["stages"].items() if k.startswith("gather/"))
            print(f"mesh preprocess: --devices {w} rank {r}: stage s {stages}; K2 {got[r][0]}, "
                  f"K3 {got[r][1]} launches; decode batches (pairs: count) {sizes[r]}; "
                  f"peak {rep.get('peak_bytes', 0) / 2**30:.2f} GiB; gathers: "
                  f"{gathers or 'none'} [{smi}]", flush=True)
    stage_names = [k for k in runs[1][0][0]["timings"] if k.startswith("preprocess/")]
    table = []
    for k in stage_names:
        per_rank = [r["timings"].get(k, 0.0) for r in runs[n_ranks][0]]
        table.append(f"{k.split('/')[1]} {per_rank[0]:.3f} / {max(per_rank):.3f} / "
                     f"{runs[1][0][0]['timings'][k]:.3f}")
    print(f"mesh preprocess: cli.preprocess T={t} 854x476 {cfg.dino_model_name} + RAFT-large, "
          f"{how} against one process on {dev}: {runs[n_ranks][1]:.2f} s against "
          f"{runs[1][1]:.2f} s; stage s at W={n_ranks} (rank 0 / slowest rank) and W=1: "
          + "; ".join(table) + f" [{smi}]", flush=True)
    ok = all(r[3] for r in rows)
    print(f"mesh preprocess: --devices {n_ranks} against --devices 1, every artifact: "
          + ", ".join(f"{what} {value if bound is None else f'{value:.3g} (bound {bound})'}"
                      for what, value, bound, _ in rows)
          + f": {'met' if ok else 'NOT MET'}", flush=True)
    check(ok, "multi-rank preprocessing wrote other artifacts than one device")
    return dirs, launches


# ---------------------------------------------------------------------------
# phase 14: full width against the JAX package's goldens
# ---------------------------------------------------------------------------

def full_width_inputs():
    """scripts/full_width_inputs.py, the numpy maker the golden generator
    imports under the same name."""
    import sys
    scripts = os.path.join(REPO_DIR, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import full_width_inputs
    return full_width_inputs


def load_golden(stage, golden_dir=GOLDEN_DIR):
    """(meta, records) of tests/fixtures/full_width/<stage>.npz."""
    with np.load(os.path.join(golden_dir, f"{stage}.npz")) as f:
        return (json.loads(str(f["meta"])),
                {k[len("rec/"):]: f[k] for k in f.files if k.startswith("rec/")})


def golden_inputs(stage, meta):
    """The stage's inputs rebuilt from the golden's seed and widths, their
    digests checked against the golden's: (inputs, widths)."""
    fw = full_width_inputs()
    wd = {w.name: w for w in (fw.FULL, fw.TOY)}[meta["widths"]["name"]]
    # a field added to Widths after a golden was made is not in its record
    now = json.loads(json.dumps(dataclasses.asdict(wd)))
    check({k: now.get(k) for k in meta["widths"]} == meta["widths"],
          f"full width {stage}: the golden was made at other widths than {wd.name}")
    inp = fw.make(stage, wd, meta["seed"])
    got = fw.digests(inp)
    bad = sorted(k for k in meta["input_digests"].keys() | got.keys()
                 if meta["input_digests"].get(k) != got.get(k))
    check(not bad, f"full width {stage}: {len(bad)} input digests differ from the "
          f"golden's (first {bad[:3]}; numpy {np.__version__}, golden's "
          f"{meta['numpy']})")
    check(meta["tolerances"] == fw.TOLERANCES[stage],
          f"full width {stage}: the golden records other tolerances")
    return inp, wd


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def full_width_vit(inp, wd, dev):
    """Stage a: the DINOv2 state dict through load_dinov2_state_dict and
    build_vit, then extract_feature_video on the frames (4 a batch), layers
    ``wd.vit_layers``, f32 and bf16 -> ({dtype: {layer: T×D×h×w numpy}},
    {dtype: K2 launches})."""
    from dino_tracker_tpu_torch.models import vit, vit_convert
    d, depth, heads, mlp, grid = wd.vit
    cfg = vit.ViTConfig(embed_dim=d, depth=depth, num_heads=heads, mlp_ratio=mlp,
                        patch_size=14, pretrain_grid=grid)
    state, cfg = vit_convert.load_dinov2_state_dict(inp["weights"], cfg=cfg)
    model = vit_convert.build_vit(state, cfg, dev)
    video = torch.from_numpy(inp["frames"]).to(dev)
    out, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        (before,) = counted("flash_attention")
        feats = vit.extract_feature_video(model, video, stride=7, layer=list(wd.vit_layers),
                                          compute_dtype=_torch_dtype(dtype))
        launches[dtype] = counted("flash_attention")[0] - before
        out[dtype] = {layer: f.cpu().numpy() for layer, f in zip(wd.vit_layers, feats)}
    return out, launches


def full_width_raft(inp, wd, dev):
    """Stage b: the princeton-vl state dict through load_raft_state_dict, then
    the flow engine's decode of the pairs (one batch padded to its 8 pairs),
    f32 -> N×2×H×W numpy."""
    from dino_tracker_tpu_torch.models import raft
    from dino_tracker_tpu_torch.preprocessing.flow import RaftFlowEngine
    model = raft.load_raft_state_dict(inp["weights"], dev)
    eng = RaftFlowEngine(model, torch.from_numpy(inp["frames"]).to(dev),
                         num_iters=wd.raft_iters, device=dev)
    return eng.decode(inp["source"], inp["target"]).cpu().numpy()


def full_width_train(inp, wd, dev):
    """Stage c: one train step (train.step_losses and backward) from the
    JAX-layout weights (convert.state_from_jax) on the injected batch, each
    set of gates, f32 and bf16 -> {dtype: {gates: (losses, gradients and new
    BN statistics as JAX-layout trees (convert.state_to_jax))}}. The
    TrainConfig is the golden generator's: TrainConfig's widths, the
    contrastive terms taking every candidate."""
    from dino_tracker_tpu_torch import convert
    from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from dino_tracker_tpu_torch.models.tracker import Tracker
    from dino_tracker_tpu_torch.structures import BBData
    from dino_tracker_tpu_torch.training import cycle, sampler, train
    tdev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data = train.VideoData(tdev(inp["video"]), tdev(inp["dino"]), tdev(inp["masks"]),
                           BBData(**{k: tdev(v) for k, v in inp["bb"].items()}),
                           sampler.build_bank(inp["fg_trajectories"], device=dev),
                           sampler.build_bank(inp["bg_trajectories"], device=dev))
    sample = sampler.TrainSample(**{k: tdev(v) for k, v in inp["sample"].items()})
    cyc = cycle.CycleData(**{k: tdev(v) for k, v in inp["cyc"].items()})
    pairs = lambda p: (p["source"], p["target"])
    state = convert.state_from_jax(inp["params"], inp["stats"])
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(video_resh=wd.h, video_resw=wd.w, train_batch_size=wd.batch,
                          batch_n_frames=wd.batch_n_frames, cyc_n_frames=wd.cyc[0],
                          cyc_batch_size_per_frame=wd.cyc[1], cl_n_frames=wd.cl_pairs,
                          cl_points_per_pair=2 * wd.n_feat, cl_fg_points_ratio=0.5,
                          compute_dtype=dtype)
        tcfg = TrackerConfig(video_h=wd.h, video_w=wd.w, delta_channels=wd.channels,
                             compute_dtype=dtype)
        out[dtype] = {}
        for gates in (False, True):
            model = Tracker(tcfg)
            model.load_state_dict(state)
            model = model.to(dev).train()
            total, metrics = train.step_losses(
                model, data, sample, torch.Generator(device=dev).manual_seed(0), cfg, tcfg,
                gates, gates, cyc_data=cyc, dino_pair_sel=pairs(inp["dino_pairs"]),
                ref_pair_sel=pairs(inp["ref_pairs"]))
            total.backward()
            sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                  for n, p in model.named_parameters()}
            sd.update((n, b) for n, b in model.named_buffers() if "running" in n)
            grads, stats = convert.state_to_jax(sd)
            out[dtype][gates] = ({k: float(v) for k, v in metrics.items()}, grads, stats)
    return out


def full_width_refine(inp, wd, dev):
    """Stage d: runtime.make_model_inference (the refine, in chunks of 16
    frames) and ModelInference.infer on the query points, f32 and bf16 ->
    {dtype: (T×h×w×C refined, tracks N×T×2, occluded N×T, the request's
    chunk)}."""
    from dino_tracker_tpu_torch import convert, runtime
    from dino_tracker_tpu_torch.config import TrackerConfig
    from dino_tracker_tpu_torch.models.tracker import Tracker
    video = torch.from_numpy(inp["video"]).to(dev)
    dino = torch.from_numpy(inp["dino"]).to(dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        tcfg = TrackerConfig(video_h=wd.h, video_w=wd.w, delta_channels=wd.channels,
                             compute_dtype=dtype)
        model = Tracker(tcfg)
        model.load_state_dict(convert.state_from_jax(inp["params"], inp["stats"]))
        mi = runtime.make_model_inference(model.to(dev), video, dino, tcfg, ANCHOR_COS, COS,
                                          chunk=wd.infer_chunk)
        trajs, occ = mi.infer(inp["queries"])
        out[dtype] = (mi.refined_features.cpu().numpy(), trajs, occ, mi.chunk)
        del mi, model
    return out


def full_width_bb(inp, wd, dev):
    """Stage e: extract_best_buddies with the fused flow filter,
    closest_trajectory_grids (chunks of ``wd.bb_chunk``) and
    compute_bb_ambiguity (slabs of ``wd.bb_slab`` rows) -> (BBData fields
    numpy, closest T×n)."""
    from dino_tracker_tpu_torch.preprocessing import best_buddies as bbl
    from dino_tracker_tpu_torch.utils.coords import bb_meshgrid
    feats, trajs = torch.from_numpy(inp["features"]).to(dev), inp["trajectories"]
    bb = bbl.extract_best_buddies(feats, wd.h, wd.w, 7, unfiltered_trajectories=trajs)
    closest = bbl.closest_trajectory_grids(trajs, bb_meshgrid(wd.h, wd.w, device=dev),
                                           chunk=wd.bb_chunk)
    bb = bbl.compute_bb_ambiguity(bb, feats, wd.h, wd.w, 7, rows_per_slab=wd.bb_slab)
    return [x.cpu().numpy() for x in bb], closest.cpu().numpy()


def _err(name, got, want, bound):
    """(name, largest |got − want|, bound)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{name}: shape {got.shape}, golden {want.shape}")
    return name, float(np.abs(got - want).max()) if got.size else 0.0, float(bound)


def _judge(stage, rows):
    """Raises on any row above its bound; returns the rows."""
    bad = [r for r in rows if not r[1] <= r[2]]
    check(not bad, f"full width {stage} differs from the JAX package: " + "; ".join(
        f"{n} {e:.4g} > {b:.4g}" for n, e, b in bad[:8]))
    return rows


def compare_vit(meta, rec, out):
    """f32: the sampled tokens' vectors, every token's norm and every
    channel's mean within tolerances["float32"] of the layer's largest
    |feature|. bf16: each sampled token's cosine with the golden's at least
    tolerances["bfloat16_cosine"] (the JAX "bf16" computes in f32 at this
    grid; the port keeps bf16 operands)."""
    fw = full_width_inputs()
    tol = meta["tolerances"]
    rows = []
    for dtype, layers in out[0].items():
        for layer, x in layers.items():
            key = f"{dtype}/layer{layer}/"
            got = fw.record_features(x, rec[key + "tokens"])
            if dtype == "float32":
                bound = tol["float32"] * rec[key + "absmax"]
                rows += [_err(f"{key}{k}", got[k], rec[key + k], bound)
                         for k in ("token_vals", "token_norm", "chan_mean")]
            else:
                a, b = got["token_vals"], rec[key + "token_vals"]
                cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
                rows.append((f"{key}1-cosine", float(1 - cos.min()),
                             1 - tol["bfloat16_cosine"]))
    return _judge("vit", rows)


def compare_raft(meta, rec, out):
    """The flow at a stride of 4 and every row's mean within
    tolerances["flow"] of max|flow|."""
    fw = full_width_inputs()
    got = fw.record_flow(out)
    bound = meta["tolerances"]["flow"] * rec["absmax"]
    return _judge("raft", [_err(k, got[k], rec[k], bound) for k in ("flow_s4", "row_mean")])


# gradients that are float noise in both packages (test_torch_train_step.py)
NULL_GRAD_PATHS = {"tracker_head/conv2/b"}


def cancelling_grad(path, n_layers):
    """The BN shift of a DeltaDINO layer (of ``n_layers``) that feeds another
    train-mode BN: its gradient sums cotangents that cancel
    (full_width_inputs.TOLERANCES)."""
    parts = path.split("/")
    return (parts[0] == "delta_dino" and parts[-2:] == ["bn", "bias"]
            and int(parts[2]) < n_layers - 1)


def compare_train(meta, rec, out):
    """Each phase and dtype: every loss term within the loss rtol (atol
    1e-7), BN's new statistics within the stats rtol (atol 1e-5), and each
    gradient's sampled elements within the grad share of its largest
    magnitude, its norm and sum within that share of its norm and of its
    sum of magnitudes, under the "grad_cancelling" share for the BN shifts
    that feed another train-mode BN; a gradient the JAX package gives
    exactly 0 (the detached conv biases) must be 0."""
    fw = full_width_inputs()
    rows = []
    for dtype, phases in out.items():
        tol = meta["tolerances"][dtype]
        for gates, (metrics, grads, stats) in phases.items():
            key = f"{dtype}/gates_{'on' if gates else 'off'}/"
            for k, v in metrics.items():
                want = rec[f"{key}loss/{k}"]
                rows.append((f"{key}loss/{k}", abs(v - float(want)),
                             tol["loss"] * abs(float(want)) + 1e-7))
            for path, v in fw.flatten(stats).items():
                want = rec[f"{key}stats/{path}"]
                rows.append((f"{key}stats/{path}", float(np.abs(v - want).max()),
                             float(tol["stats"] * np.abs(want).max() + 1e-5)))
            for path, g in fw.flatten(grads).items():
                if path in NULL_GRAD_PATHS:
                    continue
                gk = f"{key}grad/{path}/"
                got = fw.record_tensor(g, rec[gk + "idx"])
                share = tol["grad_cancelling" if cancelling_grad(
                    path, len(meta["widths"]["channels"]) - 1) else "grad"]
                rows.append(_err(gk + "vals", got["vals"], rec[gk + "vals"],
                                 share * float(rec[gk + "absmax"])))
                rows.append(_err(gk + "norm", got["norm"], rec[gk + "norm"],
                                 share * float(rec[gk + "norm"])))
                rows.append(_err(gk + "sum", got["sum"], rec[gk + "sum"],
                                 share * float(rec[gk + "l1"])))
    return _judge("train", rows)


def compare_refine(meta, rec, out):
    """f32: the refined stack's sampled elements and per-frame channel means
    within the refined share of its largest magnitude, every track within
    track_px, every occlusion flag equal. bf16: the same, each bound at least
    as wide as bf16 moves the JAX package's own output (its bf16 record
    against its f32 one)."""
    fw = full_width_inputs()
    rows = []
    for dtype, (refined, trajs, occ, chunk) in out.items():
        tol = meta["tolerances"][dtype]
        key = f"{dtype}/"
        got = fw.record_refined(refined, rec[key + "refined/idx"])
        spread = lambda k: (float(np.abs(rec[f"bfloat16/{k}"].astype(np.float64)
                                         - rec[f"float32/{k}"]).max())
                            if dtype == "bfloat16" else 0.0)
        bound = max(tol["refined"] * float(rec[key + "refined/absmax"]),
                    spread("refined/vals"))
        rows.append(_err(key + "refined/vals", got["vals"], rec[key + "refined/vals"], bound))
        rows.append(_err(key + "refined/chan_mean", got["chan_mean"],
                         rec[key + "refined/chan_mean"],
                         max(bound, spread("refined/chan_mean"))))
        rows.append(_err(key + "tracks", trajs, rec[key + "tracks"],
                         max(tol["track_px"], spread("tracks"))))
        rows.append((key + "occlusion flags differing", float((occ != rec[key + "occluded"]).sum()),
                     float((rec["bfloat16/occluded"] != rec["float32/occluded"]).sum())
                     if dtype == "bfloat16" else 0.0))
        rows.append((key + "chunk", float(abs(chunk - int(rec[key + "chunk"]))), 0.0))
    return _judge("refine", rows)


def compare_bb(meta, rec, out):
    """Every per-pair count, buddy token, cosine, ratio r, the capacity and
    every closest trajectory equal (exact products, see full_width_inputs.
    bb_inputs)."""
    fw = full_width_inputs()
    wd_h, wd_w = meta["widths"]["h"], meta["widths"]["w"]
    fields, closest = out
    got = fw.record_bb(*fields, wd_h, wd_w)
    got["capacity"] = np.int64(fields[4].shape[-1])
    got["closest"] = closest.astype(np.int32)
    rows = []
    for k in ("counts", "capacity", "source_tok", "target_tok", "cos_1024", "r", "closest"):
        g, want = np.asarray(got[k]), rec[k]
        same = g.shape == want.shape and np.array_equal(g, want)
        rows.append((k, 0.0 if same else float(np.inf if g.shape != want.shape else
                                                (g != want).sum()), 0.0))
    return _judge("bb", rows)


def traj_margins(fwd, bwd, direct, wd, eps):
    """The port's float64 recomputation of stage 1's chaining on the same
    flows (every step of ``preprocessing/trajectories.py``, the sampling
    and the norms in float64), for each start frame s -> {"first": {pass:
    S×H×W int64, the first frame at which the pixel's chain, while alive in
    float64, put its cycle error, (pass f) its direct-flow error, or a
    coordinate within ``eps`` px of the threshold or of the frame's bound (T
    where it never did)}, "coords": S×T×H×W×2 float64 positions (the chain
    advances whether alive or not; the grid before s), "mask_near": T×H×W
    bool, the flow masks' cycle error within ``eps`` of the threshold}: the
    pixels where a last-bit difference between two implementations can
    flip a decision."""
    from dino_tracker_tpu_torch.preprocessing import trajectories as traj
    from dino_tracker_tpu_torch.utils.sampling import bilinear_sampler_pixel
    fw = full_width_inputs()
    th, dth = fw.TRAJ_ARGS["threshold"], fw.TRAJ_ARGS["direct_flow_threshold"]
    t, h, w = wd.traj_t, wd.h, wd.w
    f64, b64 = fwd.double(), bwd.double()
    grid = traj._grid(h, w, fwd.device).double()
    norm = lambda d: torch.sqrt((d * d).sum(-1))
    warp = lambda flow, c: bilinear_sampler_pixel(flow[None], c[None])[0].permute(1, 2, 0)
    upper = torch.tensor([w - 1.0, h - 1.0], dtype=torch.float64, device=fwd.device)
    n_starts = t - (fw.TRAJ_ARGS["min_trajectory_length"] - 1)
    first = {k: torch.full((n_starts, h, w), t, dtype=torch.int64, device=fwd.device)
             for k in "fu"}
    coords_all = grid.expand(n_starts, t, h, w, 2).clone()
    for s in range(n_starts):
        dflows, dmasks = traj._padded_direct(direct, s, t - 1, h, w, fwd.device)
        dflows = dflows.double()
        coords = grid
        alive = {k: torch.ones((h, w), dtype=torch.bool, device=fwd.device) for k in "fu"}
        for idx in range(s, t - 1):
            c1 = coords + warp(f64[idx], coords)
            err = norm(coords - (c1 + warp(b64[idx], c1)))
            edge = torch.cat([c1, upper - c1], -1).abs().amin(-1)
            near = ((err - th).abs() < eps) | (edge < eps)
            err_d = norm(c1 - (grid + dflows[idx - s])) * (dmasks[idx - s] > 0.2)
            ok = (err < th) & ((c1 >= 0) & (c1 <= upper)).all(-1)
            for k, hit, also in (("u", near, ok), ("f", near | ((err_d - dth).abs() < eps),
                                                  ok & (err_d < dth))):
                first[k][s] = torch.where(alive[k] & hit & (first[k][s] == t), idx + 1,
                                          first[k][s])
                alive[k] = alive[k] & also
            coords = c1
            coords_all[s, idx + 1] = c1
    c1 = grid[None] + b64.permute(0, 2, 3, 1)
    err = norm(grid[None] - (c1 + bilinear_sampler_pixel(f64, c1).permute(0, 2, 3, 1)))
    mask_near = torch.cat([torch.zeros((1, h, w), dtype=torch.bool, device=fwd.device),
                           (err - th).abs() < eps])
    return {"first": {k: v.cpu().numpy() for k, v in first.items()},
            "coords": coords_all.cpu().numpy(), "mask_near": mask_near.cpu().numpy()}


def full_width_traj(inp, wd, dev):
    """Stage 1's chaining: the port's extract_trajectories_dual on ``dev``
    with the golden's direct flows through direct_flow_fn (the occupancy
    through utils/native_traj.py), each start's keep masks of _chain_dual and
    _keep_mask, and ``traj_margins`` -> {"trajs": {pass: N×T×2}, "keep":
    {pass: S×H×W}, "margins", "seconds"}."""
    from dino_tracker_tpu_torch.preprocessing import trajectories as traj
    fw = full_width_inputs()
    args = fw.TRAJ_ARGS
    t, h, w = wd.traj_t, wd.h, wd.w
    fwd, bwd = (torch.from_numpy(inp[k]).to(dev) for k in ("fwd", "bwd"))
    direct = lambda s: (torch.from_numpy(inp["direct"][s]).to(dev),
                        torch.from_numpy(inp["direct_masks"][s]).to(dev))
    fence(dev)
    t0 = time.perf_counter()
    trajs = traj.extract_trajectories_dual(fwd, bwd, direct_flow_fn=direct, **args)
    seconds = time.perf_counter() - t0
    keep = {"f": [], "u": []}
    for start in range(t - (args["min_trajectory_length"] - 1)):
        dflows, dmasks = traj._padded_direct(direct, start, t - 1, h, w, dev)
        tls = traj._chain_dual(fwd, bwd, start, dflows, dmasks, args["threshold"],
                               args["direct_flow_threshold"])
        for key, tl in zip("fu", tls):
            keep[key].append(traj._keep_mask(tl, args["min_trajectory_length"]).cpu().numpy())
    margins = traj_margins(fwd, bwd, direct, wd, fw.TOLERANCES["traj"]["eps_px"])
    return {"trajs": dict(zip("fu", trajs)), "keep": {k: np.stack(v) for k, v in keep.items()},
            "margins": margins, "seconds": seconds}


def traj_ambiguous_cells(trajs, starts, exact, first, coords, s0, h, w, eps_half):
    """The cells of frame ``s0`` whose occupancy two implementations can
    set apart, from the rows of the starts before ``s0`` (``starts``: each
    row's start, ``exact``: rows ideal in both implementations,
    ``full_width_inputs.traj_ideal_rows``): the cells on both sides of
    a coordinate within ``eps_half`` of a half-integer (the occupancy's
    rounding), and the four cells around the float64 position of every row
    whose chain came within the margin of a threshold before ``s0``
    (``first``, ``coords``: ``traj_margins``'s; alive in one
    implementation, dead in the other). Exact rows round alike everywhere.
    -> H×W bool."""
    amb = np.zeros((h, w), bool)
    earlier = (starts < s0) & ~exact
    pos = trajs[earlier, s0].astype(np.float64)
    pos = pos[np.isfinite(pos[:, 0])]
    near = (np.abs(np.mod(pos, 1.0) - 0.5) < eps_half).any(-1)
    rows = np.arange(len(trajs))[earlier]
    p0 = trajs[rows, starts[rows]].astype(np.int64)
    flipped = first[starts[rows], p0[:, 1], p0[:, 0]] <= s0
    cand = [pos[near], coords[starts[rows][flipped], s0, p0[flipped, 1], p0[flipped, 0]]]
    for p in cand:
        for fx in (np.floor, np.ceil):
            for fy in (np.floor, np.ceil):
                x = np.clip(fx(p[:, 0]), 0, w - 1).astype(np.int64)
                y = np.clip(fy(p[:, 1]), 0, h - 1).astype(np.int64)
                amb[y, x] = True
    return amb


def compare_traj(meta, rec, out):
    """Stage 1's chaining against the golden, each pass (TOLERANCES["traj"],
    full_width_inputs.py): every start's keep masks equal but at threshold
    pixels (``traj_margins``: the port's float64 chain within eps_px of a
    threshold or bound), their count capped; the kept pixels of each start
    equal up to the first start s0 where they differ, each difference at s0
    a threshold pixel, a flow-mask pixel within eps_px of the threshold or
    an occupancy cell an earlier row can round into either way
    (``traj_ambiguous_cells``); for every start before s0: the exact rows'
    counts, per-frame NaN counts and half-integer coordinates equal (no
    margin: every implementation computes them alike), the per-frame NaN
    counts of the others within the rows of the start that came within the
    margin of a threshold by that frame, the per-frame coordinate sums
    within sum_rel (and a frame's width a row that did), the sampled rows
    within sample_px and NaN where the golden's are but for such rows.
    Prints each pass's threshold pixels and how far a difference spreads."""
    fw = full_width_inputs()
    tol = meta["tolerances"]
    h, w, t = meta["widths"]["h"], meta["widths"]["w"], meta["widths"]["traj_t"]
    rows, notes = [], []
    margins = out["margins"]
    n_flips = 0
    for p in "fu":
        trajs, keep = out["trajs"][p], out["keep"][p]
        starts = fw.traj_row_starts(trajs)
        p0 = trajs[np.arange(len(trajs)), starts].astype(np.int64)
        # the rows ideal here and in the golden: the same bits in both
        ideal_g = fw.unpack_masks(rec[f"{p}/ideal"], h, w)
        exact = (fw.traj_ideal_rows(trajs, starts, h, w)
                 & ideal_g[starts, p0[:, 1], p0[:, 0]])
        got = fw.record_traj(trajs, keep, h, w, rec[f"{p}/idx"], exact)
        n_starts = keep.shape[0]
        first = margins["first"][p]
        near_any = first < t
        diff = fw.unpack_masks(rec[f"{p}/keep"], h, w) ^ keep
        n_flips += int(diff.sum())
        rows.append((f"{p}/keep masks: pixels off a threshold that differ",
                     float((diff & ~near_any).sum()), 0.0))
        kept_g, kept_p = (fw.unpack_masks(x, h, w) for x in (rec[f"{p}/kept"], got["kept"]))
        s0 = next((s for s in range(n_starts) if (kept_g[s] ^ kept_p[s]).any()), n_starts)
        if s0 < n_starts:
            amb = traj_ambiguous_cells(trajs, starts, exact, first, margins["coords"], s0, h,
                                       w, tol["eps_half"])
            d = kept_g[s0] ^ kept_p[s0]
            why = near_any[s0] | margins["mask_near"][s0] | amb
            rows.append((f"{p}/kept pixels at start {s0}, the first that differs: off every "
                         f"threshold", float((d & ~why).sum()), 0.0))
            later = got["count"][s0 + 1:].sum(), rec[f"{p}/count"][s0 + 1:].sum()
            notes.append(f"pass {p}: kept pixels differ first at start {s0} ({int(d.sum())} "
                         f"pixels, each at a threshold); the starts after it hold {later[0]} "
                         f"trajectories here, {later[1]} in the golden (not held)")
        else:
            notes.append(f"pass {p}: kept pixels equal at every start ({got['total']} "
                         f"trajectories)")
        held = slice(0, s0)
        # the rows of each start that came within the margin of a threshold
        # by each frame (their NaN can differ from that frame on)
        row_first = np.where(exact, t, first[starts, p0[:, 1], p0[:, 0]])
        near_by = np.stack([np.stack([((starts == s) & (row_first <= f)).sum()
                                      for f in range(t)]) for s in range(n_starts)])
        rows.append(_err(f"{p}/count of the starts before {s0}", got["count"][held],
                         rec[f"{p}/count"][held], 0.0))
        # the ideal rows' counts, at the starts where both keep the same rows
        # ideal (elsewhere the rows ideal in one lie within ulps of it)
        same = np.array([np.array_equal(ideal_g[s], fw.unpack_masks(got["ideal"], h, w)[s])
                         for s in range(s0)], bool)
        if not same.all():
            notes.append(f"pass {p}: rows ideal in one implementation only at starts "
                         f"{np.flatnonzero(~same).tolist()}")
        for k in ("exact_count", "exact_nan", "exact_half"):
            rows.append(_err(f"{p}/{k} of the starts before {s0} (ideal rows)",
                             got[k][:s0][same], rec[f"{p}/{k}"][:s0][same], 0.0))
        excess = np.abs(got["nan"][held] - rec[f"{p}/nan"][held]) - near_by[held]
        rows.append((f"{p}/per-frame NaN counts beyond the rows at a threshold, starts before "
                     f"{s0}", float(max(excess.max(initial=0), 0)), 0.0))
        size = np.asarray([w - 1, h - 1], np.float64)
        bound = (tol["sum_rel"] * np.maximum(np.abs(rec[f"{p}/sum"][held]), 1.0)
                 + near_by[held][..., None] * size)
        err = np.abs(got["sum"][held] - rec[f"{p}/sum"][held]) / bound
        rows.append((f"{p}/per-frame coordinate sums over their bound, starts before {s0}",
                     float(err.max(initial=0)), 1.0))
        idx = rec[f"{p}/idx"]
        mine = idx < got["count"][:s0].sum()
        a, b = got["vals"][mine], rec[f"{p}/vals"][mine]
        free = row_first[idx[mine]] < t
        nan_off = (np.isnan(a) != np.isnan(b)).any((1, 2)) & ~free
        rows.append((f"{p}/sampled rows NaN where the golden's are not, off a threshold",
                     float(nan_off.sum()), 0.0))
        both = np.isfinite(a) & np.isfinite(b)
        rows.append((f"{p}/sampled coordinates (px)",
                     float(np.abs(a - b)[both].max(initial=0)), tol["sample_px"]))
    rows.append(("threshold pixels whose keep masks differ, both passes", float(n_flips),
                 float(tol["max_threshold_pixels"])))
    near = {p: int((margins["first"][p] < t).sum()) for p in "fu"}
    print(f"full width traj: T={t} at {w}x{h}, the port's chaining {out['seconds']:.2f} s; "
          f"pixels within {tol['eps_px']:g} px of a threshold in the float64 chains, all "
          f"starts: pass f {near['f']}, u {near['u']}; keep-mask pixels that differ there: "
          f"{n_flips}; " + "; ".join(notes), flush=True)
    return _judge("traj", rows)


FULL_WIDTH_STAGES = {"vit": (full_width_vit, compare_vit),
                     "raft": (full_width_raft, compare_raft),
                     "train": (full_width_train, compare_train),
                     "refine": (full_width_refine, compare_refine),
                     "bb": (full_width_bb, compare_bb),
                     "traj": (full_width_traj, compare_traj)}


def phase_full_width(dev, smi, golden_dir=GOLDEN_DIR):
    """Phase 14: each stage's inputs rebuilt and checked against the golden's
    digests, run through the port's entry points on ``dev`` and held to the
    golden; each stage's largest error beside its bound, and its seconds.
    Returns the launches of K1-fwd, K1-bwd, K2, K3, K5-fwd and K5-bwd in the
    phase."""
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    reset_counts()
    for stage, (run, compare) in FULL_WIDTH_STAGES.items():
        t0 = time.perf_counter()
        meta, rec = load_golden(stage, golden_dir)
        inp, wd = golden_inputs(stage, meta)
        t_in = time.perf_counter() - t0
        out = run(inp, wd, dev)
        fence(dev)
        if stage == "vit":
            k2_by_dtype = out[1]
        rows = compare(meta, rec, out)
        share = lambda r: r[1] / r[2] if r[2] else (0.0 if r[1] == 0 else np.inf)
        worst = {}  # the largest error of each kind (dtype, last name), beside its bound
        for r in rows:
            parts = r[0].split("/")
            kind = (parts[0], parts[-1])
            if kind not in worst or share(r) > share(worst[kind]):
                worst[kind] = r
        top = max(rows, key=share)
        print(f"full width {stage}: {len(meta['input_digests'])} input digests equal the "
              f"golden's (JAX {meta['jax']}); {len(rows)} checks, each within its bound; "
              f"closest: {top[0]} {top[1]:.4g} (bound {top[2]:.4g}); "
              f"{time.perf_counter() - t0:.2f} s ({t_in:.2f} s making the inputs); {smi}",
              flush=True)
        for name, err, b in worst.values():
            print(f"full width {stage}:   {name} {err:.4g} (bound {b:.4g})", flush=True)
        del out, inp
        gc.collect()
        torch.cuda.empty_cache()
    launches = counted("blurpool_down_nhwc", "blurpool_up_nhwc", "flash_attention",
                       "corr_lookup", "batchnorm_fwd", "batchnorm_bwd")
    print(f"full width: launches K1-fwd {launches[0]}, K1-bwd {launches[1]}, K2 "
          f"{launches[2]} (f32 {k2_by_dtype['float32']}, bf16 {k2_by_dtype['bfloat16']}), "
          f"K3 {launches[3]}, K5-fwd {launches[4]}, K5-bwd {launches[5]}; the phase "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    check(all(launches) and all(k2_by_dtype.values()),
          "full width: a kernel did not launch in phase 14")
    return launches


def kernel_modules():
    """The ops modules that launch the port's counted kernels, in the order of
    ``ops/_guard.py``'s list."""
    from dino_tracker_tpu_torch.ops import _guard
    return [importlib.import_module(f"dino_tracker_tpu_torch.ops.{name}")
            for name in dict.fromkeys(_guard.KERNELS.values())]


def build_kernels(modules=None):
    """nvcc for each ops module's library at once (by default every kernel
    module's); prints each source's seconds and what ptxas reports for its
    kernels."""
    from dino_tracker_tpu_torch.ops import _build
    modules = modules or kernel_modules()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source, together
        jobs = {mod.LIBRARY: pool.submit(mod.load_library) for mod in modules}
        nvcc_s = {name: job.result()[1] for name, job in jobs.items()}
    print("build: " + ", ".join(f"csrc/{name}.cu nvcc {s:.2f} s" for name, s in nvcc_s.items())
          + f", all loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in nvcc_s:
        for kernel, usage in _build.ptxas_report(name):
            print(f"build: ptxas csrc/{name}.cu {kernel}: {usage}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--raft-frames", type=int, default=0,
                    help="run only the K3 build and stage 1 at this many frames")
    ap.add_argument("--preprocess-frames", type=int, default=0,
                    help="run only the K2 and K3 builds and the preprocess CLI at "
                         "this many frames")
    ap.add_argument("--e2e-frames", type=int, default=0,
                    help="run only the kernel builds and the whole system on one "
                         "video of this many frames")
    ap.add_argument("--e2e-iterations", type=int, default=0,
                    help="training iterations of --e2e-frames (default: "
                         "TrainConfig's total_iterations), gates at half of them")
    ap.add_argument("--train-only", action="store_true",
                    help="run only the K1, K4 and K5 builds, K4's and K5's kernel checks "
                         "and the inference and training slices (phases 4 and 5)")
    ap.add_argument("--resume-faults", action="store_true",
                    help="with --train-only: then phase 5's resume check from "
                         "checkpoints with each of three planted faults, each of which "
                         "it must miss")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="run only the kernel builds, the launches on cuda:1 and "
                         "phases 13 and 12 with this many ranks, one card each over "
                         "NCCL (needs that many cards); with --preprocess-frames T, "
                         "only the K2 and K3 builds and phase 13 at T frames")
    ap.add_argument("--full-width", action="store_true",
                    help="run only the kernel builds and phase 14 (the port at full "
                         "width against the JAX package's goldens)")
    args = ap.parse_args()
    check(torch.cuda.is_available(), "CUDA is not available: this smoke "
          "runs the port on an NVIDIA GPU and has no CPU fallback")
    from dino_tracker_tpu_torch.ops import batchnorm as bn
    from dino_tracker_tpu_torch.ops import blurpool as bp
    from dino_tracker_tpu_torch.ops import flash_attention as fa
    from dino_tracker_tpu_torch.ops import head_conv as hc
    from dino_tracker_tpu_torch.ops import window_gather as wg
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    smi = smi_lines[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    if args.raft_frames:  # stage 1 alone, then where one decode batch's time goes
        from dino_tracker_tpu_torch.models import raft
        build_kernels([wg])
        eng = phase_raft(dev, args.raft_frames)[3]
        ia, ib = np.zeros(8, np.int64), np.arange(1, 9) % args.raft_frames
        profile_decode(eng, ia, ib)
        conv_table(eng.model, dev)
        conv_table(eng.model, dev, n=1)
        # raft_decode itself on n pairs, as the engine ran short batches
        # before it padded them to 8
        fmaps, nets, inps = eng.encodings()
        by_n = [cuda_ms(lambda: raft.raft_decode(eng.model, fmaps[ia[:n]], fmaps[ib[:n]],
                                                 nets[ia[:n]], inps[ia[:n]]),
                        iters=2, warmup=1) for n in range(1, 9)]
        print("raft: raft_decode by pairs in the batch, unpadded: " + ", ".join(
            f"{n} {ms:.1f} ms" for n, ms in enumerate(by_n, 1)), flush=True)
        torch.backends.cudnn.benchmark = True  # cuDNN times its algorithms
        ms = cuda_ms(lambda: eng.decode(ia, ib), iters=3, warmup=1)
        torch.backends.cudnn.benchmark = False
        print(f"raft: one decode batch with torch.backends.cudnn.benchmark on: "
              f"{ms:.2f} ms", flush=True)
        return
    if args.mesh_devices:
        n = args.mesh_devices
        check(n >= 2 and torch.cuda.device_count() >= n, f"--mesh-devices {n} needs "
              f"{n} >= 2 CUDA devices, {torch.cuda.device_count()} visible")
        print("devices: " + " | ".join(smi_lines[:n]), flush=True)
        smis = " | ".join(smi_lines[:n])
    if args.mesh_devices and args.preprocess_frames:  # phase 13 alone, over NCCL
        from dino_tracker_tpu_torch.config import PreprocessConfig
        build_kernels([fa, wg])
        t = args.preprocess_frames
        cfg = PreprocessConfig(max_frames=t)
        root = os.path.join(WORK_DIR, "mesh_inputs")
        shutil.rmtree(root, ignore_errors=True)
        write_frames(os.path.join(root, "video"), t, cfg.video_resh, cfg.video_resw, dev)
        raft_path, vit_path = write_weights(root, cfg, dev)
        phase_mesh_preprocess(dev, os.path.join(root, "video"),
                              ["--config", write_preprocess_yaml(root, cfg), "--raft-checkpoint",
                               raft_path, "--dino-checkpoint", vit_path], n, False, smis, t)
        print_ok()
        return
    if args.train_only:  # the head's kernels, then the slices that run them
        build_kernels([bp, hc, bn])
        phase_head_check(dev)
        phase_bn_check(dev)
        _, video, dino = phase_slice(bp, dev)
        phase_train(bp, dev, video, dino, smi, args.resume_faults)
        return
    if args.full_width:  # phase 14 alone
        build_kernels()
        phase_full_width(dev, smi)
        return
    if args.preprocess_frames:  # the preprocess CLI alone
        build_kernels([fa, wg])
        phase_preprocess(dev, args.preprocess_frames)
        return
    build_kernels()
    if args.mesh_devices:  # phases 13 and 12 over one card per rank
        phase_other_card(bp, torch.device("cuda", 1))
        root = os.path.join(WORK_DIR, "e2e")
        shutil.rmtree(root, ignore_errors=True)
        opts, _ = write_e2e_inputs(root, E2E_T, E2E_ITERATIONS, E2E_ITERATIONS // 2,
                                   E2E_QUERY_FRAMES, E2E_POINTS, dev, E2E_SHIFTS[:1])
        opts = dict(zip(opts[::2], opts[1::2]))
        dirs, _ = phase_mesh_preprocess(
            dev, os.path.join(opts["--dataset-root-dir"], "0", "video"),
            ["--config", opts["--preprocess-config"], "--raft-checkpoint",
             opts["--raft-checkpoint"], "--dino-checkpoint", opts["--dino-checkpoint"]],
            n, False, smis, E2E_T)
        phase_mesh(dev, dirs[n], opts["--train-config"], opts["--benchmark-pickle-path"],
                   n, False, smis)
        print_ok()
        return
    if args.e2e_frames:  # the whole system alone, one video at DAVIS length
        from dino_tracker_tpu_torch.config import TrainConfig
        k = args.e2e_iterations or TrainConfig().total_iterations
        phase_e2e(dev, args.e2e_frames, k, k // 4, tuple(range(0, args.e2e_frames, 5)),
                  N_QUERIES, E2E_SHIFTS[:1])
        probe_train_banks(dev, os.path.join(WORK_DIR, "e2e", "videos", "0"))
        return

    k1 = phase_kernel_check(bp, dev)
    k1_bwd = phase_kernel_bwd_check(bp, dev)
    k2 = phase_attention_check(dev)
    k3 = phase_corr_lookup_check(dev)
    k4 = phase_head_check(dev)
    k5 = phase_bn_check(dev)
    infer_launches, video, dino = phase_slice(bp, dev)
    head_launches = counted("head_conv_fwd", "head_conv_bwd")
    bn_launches = counted("batchnorm_fwd", "batchnorm_bwd")
    train_launches = phase_train(bp, dev, video, dino, smi)
    del video, dino
    vit_launches, vit_s = phase_vit(dev)
    print(f"vit: K2 {vit_launches} launches x {k2['ms']:.3f} ms (phase 3) = "
          f"{vit_launches * k2['ms'] / 1e3:.3f} s, {vit_launches * k2['ms'] / 1e3 / vit_s:.3f} "
          f"of the features' {vit_s:.3f} s", flush=True)
    raft_launches = phase_raft(dev)[0]
    (pre_k2, pre_k3), weights = phase_preprocess(dev)
    phase_train_reference(dev)
    phase_reference(dev)
    phase_vit_reference(dev)
    phase_raft_reference(dev)
    phase_bb_reference(dev)
    e2e = phase_e2e(dev, weights=weights)
    e2e_root = os.path.join(WORK_DIR, "e2e")
    mesh_args = (os.path.join(e2e_root, "videos", "0"), os.path.join(e2e_root, "train.yaml"),
                 os.path.join(e2e_root, "benchmark.pkl"), MESH_RANKS)
    phase_dir_chunks(dev, *mesh_args[:2], smi)
    if torch.cuda.device_count() >= 2:
        phase_other_card(bp, torch.device("cuda", 1))
    else:
        print("other card: not run: one CUDA device is visible, and the launches on "
              "cuda:1 from cuda:0 need two (python3 chip_smoke.py --mesh-devices N)",
              flush=True)
    mesh = phase_mesh(dev, *mesh_args, True, smi)
    if torch.cuda.device_count() >= MESH_RANKS:  # the captured mesh step, one card a rank
        mesh = [a + b for a, b in zip(mesh, phase_mesh(
            dev, *mesh_args, False, " | ".join(smi_lines[:MESH_RANKS])))]
    else:
        print(f"mesh: the NCCL capture did not run: one CUDA device is visible, and "
              f"{MESH_RANKS} ranks over NCCL need one each (python3 chip_smoke.py "
              f"--mesh-devices N on N cards)", flush=True)
    _, mesh_pre = phase_mesh_preprocess(
        dev, os.path.join(e2e_root, "videos", "0", "video"),
        ["--config", os.path.join(e2e_root, "preprocessing.yaml"), "--raft-checkpoint",
         weights[0], "--dino-checkpoint", weights[1]], MESH_RANKS, True, smi, E2E_T)
    full = phase_full_width(dev, smi)
    print_kernels((k1, k1_bwd, k2, k3, *k4, *k5),
                  (infer_launches + train_launches[0] + e2e[0] + mesh[0] + full[0],
                   train_launches[1] + e2e[1] + mesh[1] + full[1],
                   vit_launches + pre_k2 + e2e[2] + mesh_pre[0] + full[2],
                   raft_launches + pre_k3 + e2e[3] + mesh_pre[1] + full[3],
                   head_launches[0] + train_launches[2], head_launches[1] + train_launches[3],
                   bn_launches[0] + train_launches[4] + e2e[4] + mesh[2] + full[4],
                   bn_launches[1] + train_launches[5] + e2e[5] + mesh[3] + full[5]))
    print_ok()


# the TPU kernel each kernel of ops/_guard.py's list replaces, in its order
REPLACES = {
    "blurpool_down_nhwc": "dino_tracker_tpu/ops/blurpool.py:59",
    "blurpool_up_nhwc": "dino_tracker_tpu/ops/blurpool.py:67",
    "flash_attention": "dino_tracker_tpu/ops/flash_attention.py:27",
    "corr_lookup": "dino_tracker_tpu/ops/window_gather.py:37",
    "head_conv_fwd":
        "none (XLA's convs: dino_tracker_tpu/models/tracker_head.py normalized_conv2d)",
    "head_conv_bwd": "none (XLA's conv VJPs: dino_tracker_tpu/models/tracker_head.py)",
    "batchnorm_fwd": "none (XLA's fusion: dino_tracker_tpu/models/nn.py batchnorm)",
    "batchnorm_bwd": "none (XLA's fusion of its VJP: dino_tracker_tpu/models/nn.py batchnorm)"}


def print_kernels(numbers, launches):
    """The kernels' JSON line. launches: the sum of the main-path runs (K2 and
    K3 also the preprocess CLI's and every rank's of phase 13, K1, K2, K3
    and K5 also the whole system's and phase 14's, K1 and K5 also every
    rank's of phase 12), each counted from 0; K4 over phases 4 and 5; in
    phase 5 also the kernels a trace saw in the replays (K5-bwd's by its
    input gradient's kernel); K1 ms / plain_ms / bound_ms: the sum over its
    three bf16 shapes; K2's at the ViT stage's shape; K3's at one decode
    batch's; K4's over one gates-on train step's head calls (its library_ms
    the head's cuDNN chain); K5's over an 8-frame step's four layers:
    K5-fwd's ms the apply alone against the chain's apply alone (plain_ms),
    its with_statistics_ms with the chain's statistics against the chain in
    train mode (plain_with_statistics_ms) and against PyTorch's train-mode
    F.batch_norm, then torch.relu on layers 0-2 (library_ms); K5-bwd's
    against autograd of the chain (plain_ms) and of F.batch_norm
    (library_ms)."""
    from dino_tracker_tpu_torch.ops import _guard
    check(list(REPLACES) == list(_guard.KERNELS),
          f"the smoke's kernels {list(REPLACES)} are not ops/_guard.py's {list(_guard.KERNELS)}")
    library = {mod.__name__.rsplit(".", 1)[1]: mod.LIBRARY for mod in kernel_modules()}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dino_tracker_tpu_torch/csrc/{library[module]}.cu",
         "replaces": REPLACES[name], "launches": n, **nums}
        for (name, module), n, nums in zip(_guard.KERNELS.items(), launches, numbers,
                                           strict=True)]}))


def print_ok():
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
