#!/usr/bin/env python3
"""Smoke check of the PyTorch/H100 port (`catre_tpu_torch`) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It imports no JAX. Phases, one line each (any failure raises, so the exit
code is non-zero):
  1. device:   the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build:    compile the CUDA kernels from catre_tpu_torch/csrc with nvcc;
  3. kernels:  K1, K2 and K3 vs their plain PyTorch twins at main-path shapes,
               in f32 (tight) and bf16 (loose), and their times; K1 and K2 in
               bf16 also vs the plain versions of their own order (max on the
               bare accumulator), their launches bit-equal, and a point count
               their 128-point tile does not divide; K3's chained
               tensor-core products alone, its launches bit-equal, and a point
               count its tile does not divide; K7 and K8 (K3's kernel with 2,
               4 and 8 objects per block and a rounded point reduction) vs
               their plain version, and vs K3 in f32, at the same shapes, in
               bf16 bit-equal across the objects per block and over six
               launches, at P = 900 (45 tiles an object) in f32 and bf16, with
               ptxas' registers, spills and stack frame; K9 vs its plain
               version for the three encoder columns at 512 clouds x 1024
               points, in bf16 nearer its own plain version than the same
               layers rounded as flax Dense, six launches bit-equal, at P =
               900 and 136 in f32 and bf16, with ptxas' figures of each
               column's bf16 kernel and its shared memory;
  4. identity: canned identity-delta heads with init = gt: 4 refine
               iterations must return the init;
  5. refine:   the flagship refine from `catre_tpu_torch.entry.entry` (shipped
               ..._120e_tpu.py config: bf16, fused kernels, 1024 + 1024
               points, 4 iterations, seeded weights) at B = 256 and 2048:
               finite outputs, obj/s from CUDA events, and exactly K1 = 4,
               K2 = 8, K3 = 4 launches per call;
               the same under fused_encoder=True (K9 = 12, K3 = 4, K1 = K2 =
               0) and under fused_block_size=4 (K8 = 4, K1 = 4, K2 = 8, K3 =
               0; at B = 254, which 4 does not divide, K3 = 4 and K8 = 0);
               K7 through fused_conv_per_rot_head(group=4) at B = 256;
               plus B = 8 f32 runs of the three kernel paths against the plain
               path;
  5c. sample:  the second main path, frames -> ball-crop sampler -> shipped
               refine: 32 seeded 480 x 640 u16 depth frames (the shipped
               TEST.IMS_PER_BATCH) with 2-8 ellipsoidal objects of 40-200 px
               each, 8 instance slots, NUM_PCL = 1024, ratio 0.6, through
               the loader's group sampler (`catre_tpu_torch.data.loader`):
               card against the port on the CPU with one priority field
               drawn on the CPU (equal indices and n_inside, bit-equal
               points) at the auto window, at window 128 and, on 8 images,
               at the full frame; the fused from-depth form, the
               materialized windowed form and candidates + select equal on
               the card; the card generator's own draws inside, without
               repeats where 1024 or more points are inside, cycling the
               scarce rows; the (256, 1024, 3) clouds through the shipped
               refine at B = 256 (finite poses, K1 = 4, K2 = 8, K3 = 4); ms
               per 32-image group for each form and window, the candidates
               and the select alone, and sample + refine obj/s;
  5d. loader:  split from disk -> test loader -> shipped refine: 256 frames of
               480 x 640 with 8 slots (`entry.write_example_split`: 16-bit
               depth PNGs, RLE masks) in a temporary directory, read by the
               shipped config's test loader (`entry.shipped_test_loader`:
               device cache, frozen plan, presampled candidates, auto
               window, 32 images a group, 4 decode threads; a seeded
               mean-shape table, gathered on the card by class): a cold pass
               (decode, device cache, candidates) and two warm passes into
               the shipped refine at B = 256 (finite poses, K1 = 4, K2 = 8,
               K3 = 4 a call); one uncached pass (4 threads, pinned buffers,
               side stream); pipelined batches bit-equal to batches
               dispatched one group at a time over 4 groups; the card's
               first 2 groups bit-equal to the CPU loader's under the
               loader's own draws; host decode ms a frame (`data/png.py`),
               cold s, warm and uncached obj/s, device cache and candidate
               GB;
  5e. evaluate: the same split -> `entry.evaluate_split` (shipped loader,
               shipped refine, `CATREEvaluator`, `run_inference`): a warm
               pass, a timed pass without probes and one with the default
               probe; 256 images scored, exactly K1 = 4, K2 = 8, K3 = 4 a
               batch, finite summaries, 100 at iteration 0 (init = gt) on
               IoU25 / IoU50 / IoU75 / re5te2 / te2 for every class with
               ground truth; predictions of prefetch 0 and 2 bit-equal; the
               packed and the host `select_kps` input paths bit-equal on
               the first 2 groups; a perturbed init below 100;
               images/s, slot and real obj/s, compute / overlap / process s
               per image, the seconds of evaluate() and peak memory;
  5f. do_test: the same split through the command line, in process:
               `catre_tpu_torch.main.main([... --eval-only ...])` on the
               shipped ..._120e_tpu.py, the split registered under its
               DATASETS.TEST name, its init estimates as an init-pose JSON
               (LOAD_POSES_TEST), the seeded mean-shape table as a pickle
               under a temporary data root; three runs: MODEL.WEIGHTS a
               directory of the port's checkpoints (the seed-0 shipped model,
               `save_checkpoint`), the same weights written as a
               reference-layout .pth and converted by
               `tools/convert_checkpoint.py`, and the .pth itself; each scores
               all 256 images with exactly K1 = 4, K2 = 8, K3 = 4 a batch,
               predictions bit-equal (dtypes too) to `entry.evaluate_split`'s
               with the same seed and table on the same init poses, 100 at
               iteration 0 on the present classes, predictions.pkl and
               config_dump.py written; images/s of each run's inference
               pass, its wall seconds and the weights' load seconds;
  6. K4:       the rotation-head backward kernel vs its plain version
               (autograd of the K3 twin), B = 64 and the main path's B = 512
               objects x 2048 points, f32 (tight) and bf16 (loose), per
               gradient tensor; times at B = 512; its transposed tensor-core
               products alone, its launches bit-equal, and a point count its
               tile does not divide;
  6b. K5, K6:  the training encoder tails, forward (with argmax) and backward,
               vs their plain versions at the main path's N = 1024 clouds x
               1024 points, f32 (tight) and bf16 (loose), per output tensor;
               forward `out` bit-equal to K2 / K1, two backward launches
               bit-equal; times in bf16; the K6 forward's out and idx
               bit-equal to the plain version's on exact-integer operands (x
               in {0, 1, 2}, weights in {-2 .. 2}) at P = 1024 and 1000 in f32
               and bf16, and in bf16 six launches bit-equal at the main path's
               shape; the same for the K5 forward (K2's kernel with the keyed
               fold), with a quarter of the channels negative on every row
               before the ReLU (idx 0); the bf16 K6 backward also vs the plain
               version of its own order (critical rows only), six launches
               bit-equal, P = 1000 in f32 and bf16 vs both plain versions, and
               its allocation beyond its outputs; the same for the bf16 K5
               backward (gate pass, routing pass, dx pass writing bf16 rows
               once), with dx's dtype, every row that no live channel points
               at exactly zero, ptxas' spills and stack frames, and its time on
               the inputs of one K5 backward captured from a B = 512 train
               step beside the random operands' time;
  7. train:    the flagship training step from `catre_tpu_torch.entry.train_entry`
               at the shipped flags (bf16, B = 512, 4 inner iterations,
               FUSED_HEADS_TRAIN and FUSED_ENCODER_TRAIN): one warm-up and 3
               timed steps, finite losses and parameters, exactly K5 = 8 + 8,
               K6 = 4 + 4, K3 = 4, K4 = 4, K1 = K2 = 0 launches per step, ms
               per step, train obj/s and peak memory; the same with
               fused_encoder_train=False (the plain encoder under autograd),
               one warm-up and one timed step;
               plus one B = 8 f32 step on the card (kernels) against the same
               step on a CPU copy (plain versions): metrics, parameters, and
               each parameter's gradient and change relative to its norm;
  7b. solver:  the same B = 512 bf16 step at the shipped kernel flags under
               the shipped config with CLIP_GRADIENTS (norm), ROT_HEAD.LR_MULT
               0.5, TS_HEAD.FREEZE and INIT_POSE_TYPE_TRAIN gt_noise / random
               / canonical, its optimizer from `optimizer_from_config` and its
               lr from `build_lr_fn` at two warm-up steps and two steps past
               ANNEAL_POINT of 120000: phase 7's launches per step, finite
               losses and parameters, the TS head bit-unchanged, ms per step
               and peak memory beside phase 7's; every registry type, 3 steps
               on the flagship model's f32 parameters, card vs a CPU copy fed
               the same gradients within 1e-5 x max(1, max|p|), and each
               type's ms per step on the card; one B = 8 f32 step with adamw,
               clipping and LR_MULT, card (kernels) vs CPU (plain versions),
               at phase 7's tolerances and each parameter's change within 3e-2
               of the CPU's in norm;
  7c. train from disk: phase 5d's split (records with gt pose, scale and
               bbox) -> the shipped config's train loader
               (`entry.shipped_train_loader`: 64 frames a group, B = 512,
               device cache, device batches, auto window, depth augmentation
               on the card, 4 decode threads) -> `engine.runner.
               batch_to_device` -> the B = 512 bf16 train step
               (`entry.train_from_split`): one warm-up and 3 timed steps,
               finite losses and parameters, phase 7's launches per step
               (K5 = 8 + 8, K6 = 4 + 4, K3 = K4 = 4, K1 = K2 = 0), ms per step
               and train obj/s beside phase 7's, the loader's cold seconds
               (decode and device cache), its ms a group through its own
               iterator (5 groups after one, synced; and a group's draws
               alone, CUDA events) and peak memory; the card's first 2 groups
               against the CPU loader's under the loader's own draws: record
               order, host fields, priorities and uniform augmentation fields
               bit-equal, the normal fields within 1 ulp, the clouds within
               2 ulp of each point's depth (the CPU tests' bound) and
               bit-equal where the CPU sampler is handed the card's
               augmented depth; skip(64) then one group
               bit-equal to group 2 of a fresh loader; one step under
               INIT_POSE_TYPE_TRAIN ["last_frame"] from a written pickle;
  7d. do_train from the command line: phase 5d's split through
               `catre_tpu_torch.main.main([...])` without --eval-only, in
               process, on the shipped ..._120e_tpu.py at full width (bf16,
               1024 + 1024 points, 64 frames a step, MAX_OBJS_TRAIN 512,
               depth augmentation on the card), the split registered under
               its DATASETS.TRAIN and DATASETS.TEST names, the mean-shape
               table as a pickle under a temporary data root and the init
               JSON for evaluation, as in 5f: 10 epochs of 4 iterations,
               WARMUP_ITERS 4, a checkpoint an epoch (10 kept), TEST.EVAL_PERIOD
               20, PRINT_FREQ 1. Finite metrics and parameters; launches over
               the run equal to the warm-up's schedule (an iteration at
               refine count n = min(4, epoch): K3 = K4 = n, K5 = 2n + 2n, K6 =
               n + n) and each evaluation's K1 = 4, K2 = 8, K3 = 4 a refine
               batch; 10 checkpoints; the median iter0/loss_total of the last
               8 iterations below that of the first 8; then the checkpoint of
               iteration 19 alone in a fresh OUTPUT_DIR with --resume runs
               iterations 20-39, its losses within TRAIN_LOSS_RTOL of the
               straight run's (and whether bit-equal). ms an iteration at n =
               4 without a checkpoint or an evaluation beside phase 7c's step,
               seconds a checkpoint save and an evaluation, the train loader's
               cold seconds and peak memory;
  7e. two processes: `catre_tpu_torch.parallel.launch` starts 2 processes on
               card 0, joined over gloo (NCCL refuses two ranks on one card).
               Each takes its 256 rows of phase 7's B = 512 global batch (seed
               0) through the train step at the shipped kernel flags, a warm-up
               and 3 timed steps (draws of the global batch, mask counts and
               gradients summed over the group), in f32 and then in the
               shipped bf16, then `do_test` on its half of phase 5d's split
               (the seed-0 weights as a checkpoint, the init JSON); this
               process then runs world 1 on the same rows and split. Gates:
               phase 7's launches per step on each rank and K1 = 4, K2 = 8, K3
               = 4 a do_test batch; the ranks' parameters bit-equal; in f32
               every step's metrics within 2e-3 of world 1's and the first
               backward's gradients within 1e-2 per parameter relative to
               their norm (7b's metric); in bf16 the metrics within 3e-2, and
               the first gradients no farther from the f32 step's than twice
               world 1's bf16 gradients are (or within 1e-2): in bf16 each
               world is its own rounding of the f32 step; rank 1 scores
               nothing, and rank 0's gathered predictions are world 1's bit
               for bit, or within the bf16 3e-2 with every summary within 0.5
               points. ms a step on each rank beside world 1's, the gradient
               all-reduce timed alone and its share of a step, peak memory a
               rank.
  8. tools:    the JAX package's tools as the port carries them, on the card's
               host (no cv2, JAX or tensorstore), under a data root of seeded
               asset pickles: `synth_nocs` writes 64 frames that the port's test
               loader reads (every listed image, finite clouds); `pose_data`
               recovers the pose of a written frame by Umeyama and by PnP within
               1e-3; `prepare_init_results` turns predictions into an init JSON
               that `load_init_poses_into_dataset` reads (poses, scales and
               masks back); `fps_sample` on the card gives the CPU's points;
               `soak` trains 8 iterations (one a step of 64 frames, the warm-up's
               refine counts, TRAIN2 at 0.25) with one checkpoint and one
               evaluation, then `--resume`s to iteration 9: finite losses, the
               warm-up's launches (K3 = K4 = n, K5 2n + 2n, K6 n + n) and K1 = 4,
               K2 = 8, K3 = 4 a refine call of the evaluation, ms an iteration at
               n = 4 beside 7d's; `sampler_spread` (2 seeds, 16 frames), arm A
               with iteration 0 the same in every run, then the arms
               f32,bf16_fused: K1 = 4, K2 = 8, K3 = 4 a bf16_fused refine call,
               none in f32; `repro_diff` of 5f's tables against themselves
               (every delta 0, exit 0) and `trainrun_report` on 7d's directory;
               an orbax directory in MODEL.WEIGHTS raises and names
               `tools/convert_checkpoint.py`.
  9. launchers and colour (9a) the shell launchers as subprocesses on the
               card: `test_catre_torch.sh` on 5d's split (registered through
               a dataset cache under a data root of its own) with the seed-0
               weights as a reference-layout .pth and 5f's init poses,
               predictions bit-equal to 5f's; `train_catre_torch.sh` one epoch
               of the split (4 iterations, finite losses);
               `scripts/repro_real275_torch.sh` on a REAL275-shaped root
               (synth_nocs frames, the asset pickles, SPD-style init poses, the
               .pth) ending in `repro_diff`'s exit 0 against the summary of an
               in-process `main --eval-only` on the same root; each run's wall
               seconds. (9b) the committed fixture JPEGs decoded as OpenCV did
               (`tests/data/jpeg`); the shipped train loader with
               PCL_WITH_COLOR, no decoded cache, COLOR_AUG_PROB 1 and
               CHANGE_BG_PROB 1 over a pool of VOC-sized JPEG and PNG
               backgrounds, under aae, roi10d, code and code_albu (the
               reference's chains), its 64-frame groups into the flagship train
               step (one step a family): phase 7's launches a step, `pcl_rgb`
               finite in [0, 1]; host ms an image for each family, ms a
               background decode and a replacement, the loader's ms a group,
               the step's ms after it, and the two beside 7c's step.
Then one JSON line of per-kernel results (each with its time, its plain
version's time and its bound: the larger of its bytes over 3.35 TB/s and its
operations over the card's peak for their type), the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.
"""

import copy
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import torch

KERNEL_B = 256               # objects for the kernel checks (512 clouds)
GROUPS = (2, 4, 8)           # objects per block of K7/K8
PATH_GROUP = 4               # ... on the refine paths that run them
RAGGED_B = 254               # a batch PATH_GROUP does not divide: K8 gives way to K3
REFINE_BATCHES = (256, 2048)
REFINE_CALLS = 3             # timed refine calls per batch size, after one warm-up
K3_REPEATS = 5               # further launches of K3 that must give the first one's bits
K3_RAGGED = (1999, 1000)     # points and cloud points that K3's 64-point tile does not divide
MULTI_REPEATS = 5            # further launches of K7 / K8 that must give the first one's bits
MULTI_RAGGED = (900, 450)    # K7 / K8: 15 tiles an object, 45 in a block's sequence per object
MULTI_KERNEL = "rot_head_wgmma_kernelILi{}ELb1E"   # the bf16 K7/K8 at G objects a block
CHAIN_TOL, CHAIN_TOL_ROUNDED = 1e-5, 1e-3    # K3's two chained products, x max|plain|
TAIL_REPEATS = 5             # further launches of K1 / K2 that must give the first one's bits
TAIL_RAGGED = 1000           # points that K1's and K2's 128-point tile does not divide
K1_KERNEL = "dense_relu_dense_max_wgmmaILi8"   # the bf16 K1 at cin = 128, as ptxas names it
K6F_KERNEL = "dense_relu_dense_max_wgmmaILi8ELb1E"   # K1's body with kIdx: the bf16 K6 forward
ARGMAX_INT_CLOUDS = 128      # clouds of the K5 / K6 forwards' exact-integer idx gates
ARGMAX_REPEATS = 5           # further launches of the bf16 K5 / K6 forwards that must give the first one's bits
K5F_KERNEL = "dense_relu_max_wgmmaILi8ELi2ELb1E"    # K2's body with kIdx: the bf16 K5 forward
K2_KERNEL = "dense_relu_max_wgmmaILi8E"       # the bf16 K2 at cin = 128, as ptxas names it
K6B_KERNELS = ("route_clouds", "cloud_passILi8E", "dw3_passILi8E", "dw4_passILi8E")  # bf16, cin 128
K6B_REPEATS = 5              # further launches of the bf16 K6 backward that must give the first one's bits
K6B_SCRATCH = 0.1            # its allocation beyond its outputs, at most this share of N P chid 2 bytes
K5B_KERNELS = ("gate_passILi8E", "route_clouds", "dx_passE")    # the bf16 K5 backward at cin = 128
K5B_REPEATS = 5              # further launches of the bf16 K5 backward that must give the first one's bits
K5B_SCRATCH = 0.1            # its allocation beyond its outputs, at most this share of N P cin 2 bytes
K9_REPEATS = 5               # further launches of each bf16 K9 column that must give the first one's bits
K9_RAGGED = (900, 136)       # points that K9's 128-point tile does not divide
K9_KERNELS = {"K9 stn3d": "chain3_stn_wgmmaILi3E", "K9 stnkd": "chain3_stn_wgmmaILi64E",
              "K9 main": "chain3_main_wgmmaILi4E"}     # the bf16 kernel of each column
K4_CHECK_B, K4_TIME_B = 64, 512
K4_REPEATS = 3               # further launches of K4 that must give the first one's bits
TN_TOL = 1e-5                # K4's transposed products alone, x max|plain|
TRAIN_B, TRAIN_STEPS = 512, 3     # timed train steps, after one warm-up
# phase 7b: the schedule's total (120 epochs x 1000 iterations) and the schedule steps of its
# warm-up step and three timed steps, two inside the 1000-iteration warm-up, two past ANNEAL_POINT
SCHEDULE_TOTAL, SCHEDULE_STEPS = 120_000, (500, 999, 90_000, 119_000)
OPT_STEPS, OPT_TIMED = 3, 10      # optimizer steps card vs CPU; timed card steps after them
OPT_TOL = 1e-5               # card vs CPU after OPT_STEPS, per parameter x max(1, max|p|)
# the B = 8 adamw step: its lr, at which an Adam element moves about lr a step whatever its
# gradient's size (so phase 7's 1e-3 parameter bound holds where a near-zero gradient takes
# the other sign), and each parameter's change within this share of the CPU's in norm
ADAMW_LR, ADAMW_CHANGE_RTOL = 1e-4, 3e-2
NEAR_TIE = 1e-6              # f32 argmax rows may differ where two rows are this close
# published peaks of one H100 SXM: device memory bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL = 2e-3, 1e-3   # kernel vs plain train step (tests/test_fused_train.py)
# the same step's first-backward gradients, per parameter relative to its
# norm: Ranger's first, unrectified updates move a parameter by only
# lr x gradient, which the two tolerances above cannot tell from zero
TRAIN_GRAD_RTOL = 1e-2
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # x max(1, max|twin|)
PATH_TOL = 5e-4              # kernel path vs plain path, f32 (the CPU slice tolerance)
IDENTITY_TOL = 1e-5
SAMPLE_FIXED_WINDOW = 128    # the sampler's fixed-window cell beside the auto window
SAMPLE_FULL_FRAME_IMS = 8    # images of the full-frame card-vs-CPU check
SAMPLE_CALLS = 3             # timed sample + refine calls, after one warm-up
LOADER_FRAMES = 256          # frames of the split that phase 5d writes and reads
LOADER_WARM_PASSES = 2       # timed passes of the shipped test loader after the cold one
LOADER_WORKERS = 4           # decode threads of the uncached pass
LOADER_DECODE_FRAMES = 32    # frames decoded one by one for the host decode time
LOADER_CPU_GROUPS = 2        # groups held card against CPU
TRAIN_CPU_GROUPS = 2         # phase 7c: train groups held card against CPU
LOADER_TIME_GROUPS = 5       # phase 7c: train groups timed through the loader's iterator
NORMAL_ULPS = 1              # the loader's normal fields, card vs CPU (float64 log / cos)
DEPTH_ULPS = 2               # the loader's clouds, card vs CPU, in ulp of each point's depth
LOADER_SERIAL_GROUPS = 4     # groups of the pipelined-vs-serial check (the pinned slots reused)
EVAL_PATH_GROUPS = 2         # groups on which the packed and the host select_kps paths agree
EVAL_NOISY_FRAMES = 64       # frames of the perturbed-init split that must score below 100
EVAL_NOISE_M = 0.1           # its translation noise, metres a component (numpy seed 0)
AP_EXACT = 1e-9              # an AP of 1 summed from float32 recall steps
TRAIN_CLI_EPOCHS = 10        # phase 7d: epochs of the split (4 iterations each), checkpoints kept
TRAIN_CLI_WARMUP = 4         # its SOLVER.WARMUP_ITERS
TRAIN_CLI_EVAL = 20          # its TEST.EVAL_PERIOD
TRAIN_CLI_RESUME = 19        # the checkpoint its resumed run starts after
TRAIN_CLI_LOSS_WINDOW = 8    # iterations of the median iter0/loss_total, first vs last
DIST_WORLD = 2               # phase 7e: processes on the one card, joined over gloo
DIST_TIMEOUT_S = 300         # ... a collective that waits longer raises
DIST_REDUCE_CALLS = 5        # ... gradient all-reduces timed alone
DIST_SUMMARY_PTS = 0.5       # ... do_test summaries, world 2 vs 1, where not bit-equal
DIST_BF16_SLACK = 2.0        # ... world 2's bf16 gradients from the f32 step's: this x world 1's
TOOLS_FRAMES = 64            # phase 8: frames synth_nocs writes (the soak's real_train, one step)
TOOLS_FRAMES2 = 16           # ... the soak's CAMERA-shaped TRAIN2 split
TOOLS_FRAMES_TEST = 16       # ... the soak's and the sampler study's test split
SOAK_EPOCHS, SOAK_MORE = 8, 2    # ... the soak's first run (one iteration an epoch), then resumed
SOAK_EVAL = 8                # ... its TEST.EVAL_PERIOD: one evaluation, at the first run's end
SPREAD_SEEDS = 2             # ... loader seeds of the sampler study
POSE_TOL = 1e-3              # ... pose_data's Umeyama and PnP labels against the written pose
FPS_INSTANCES, FPS_POINTS = 40, 32   # ... fps_sample, card against CPU
# phase 9b: the reference's chain strings of COLOR_AUG_TYPE code and code_albu
# (`core/base_data_loader.py:251-262, :292-317`)
AAE_CHAIN = """Sequential([
    Sometimes(0.5, CoarseDropout( p=0.2, size_percent=0.05) ),
    Sometimes(0.5, GaussianBlur(1.2*np.random.rand())),
    Sometimes(0.5, Add((-25, 25), per_channel=0.3)),
    Sometimes(0.3, Invert(0.2, per_channel=True)),
    Sometimes(0.5, Multiply((0.6, 1.4), per_channel=0.5)),
    Sometimes(0.5, Multiply((0.6, 1.4))),
    Sometimes(0.5, LinearContrast((0.5, 2.2), per_channel=0.3))
    ], random_order = False)"""
ALBU_CHAIN = """Compose([
    CoarseDropout(max_height=0.05*480, max_holes=0.05*640, p=0.4),
    OneOf([IAAAdditiveGaussianNoise(p=0.5), GaussNoise(p=0.5)], p=0.2),
    OneOf([MotionBlur(p=0.2), MedianBlur(blur_limit=3, p=0.1), Blur(blur_limit=3, p=0.1)],
          p=0.2),
    OneOf([CLAHE(clip_limit=2), IAASharpen(), IAAEmboss(), RandomBrightnessContrast()], p=0.3),
    InvertImg(p=0.2),
    RGBShift(r_shift_limit=105, g_shift_limit=45, b_shift_limit=40, p=0.5),
    RandomContrast(limit=0.9, p=0.5),
    RandomGamma(gamma_limit=(80,120), p=0.5),
    RandomBrightness(limit=1.2, p=0.5),
    HueSaturationValue(hue_shift_limit=172, sat_shift_limit=20, val_shift_limit=27, p=0.3),
    JpegCompression(quality_lower=4, quality_upper=100, p=0.4),
], p=0.8)"""
REPRO_FRAMES = 16            # phase 9a: REAL275-shaped test frames the repro script scores
LAUNCHER_TIMEOUT_S = 300     # ... a launcher run that takes longer fails the phase
COLOUR_FRAMES = 64           # phase 9b: frames with colour images, one train group
COLOUR_TIME_IMAGES = 6       # ... images each family augments for its host time
COLOUR_PNG_BACKGROUNDS = 2   # ... PNG backgrounds beside the committed JPEGs in the pool


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(name, kernel, twin, make_args):
    """Kernel vs twin in f32 and bf16 (no launch counting here); times in bf16."""
    errs = {}
    for cdt in (torch.float32, torch.bfloat16):
        args = make_args(cdt)
        ref = twin(*args)
        out = kernel(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise RuntimeError(f"{name} {cdt}: shape {tuple(out.shape)} or non-finite output")
        err = (out - ref).abs().max().item()
        limit = TOL[cdt] * max(1.0, ref.abs().max().item())
        log("kernels", f"{name} {str(cdt)[6:]} max_abs_err={err:.3e} limit={limit:.3e}")
        if not err <= limit:
            raise RuntimeError(f"{name} {cdt}: kernel disagrees with its twin: {err} > {limit}")
        errs[cdt] = err
    args = make_args(torch.bfloat16)
    ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: twin(*args))
    log("kernels", f"{name} bf16 kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    return {"max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "plain_ms": plain_ms}


def nearer_its_own_version(tag, out, own, other, what):
    """The tolerances above are too wide to tell two roundings of one
    function apart. Where a kernel's plain version differs from a sibling
    only in where it rounds, the kernel must lie well nearer its own plain
    version than the two plain versions lie apart (mean absolute difference)."""
    err, gap = (out - own).abs().mean().item(), (own - other).abs().mean().item()
    log("kernels", f"{tag} bf16: mean |kernel - plain| = {err:.3e}, mean |plain - {what}| = "
                   f"{gap:.3e}, must be under a quarter of it")
    if not err <= 0.25 * gap:
        raise RuntimeError(f"{tag}: the kernel is not nearer its plain version than {what} is")


def check_rot_head_multi(rot_args):
    """K7 and K8 at every objects-per-block count vs their plain version, f32
    and bf16, and vs K3 in f32 (where the rounded point reduction vanishes);
    in bf16 the same bits at every count and over MULTI_REPEATS more launches
    (an object's sums have one order whatever its block); P = 900, where the
    ring's stage, phase and warpgroup turn over at object boundaries; times in
    bf16 per count. -> {"K7": ..., "K8": ...} at PATH_GROUP, with ptxas'
    figures of that instantiation."""
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import rot_head as rot_ops
    from catre_tpu_torch.ops import rot_head_multi as multi_ops

    wrappers = {"K7": multi_ops.rot_head_grouped, "K8": multi_ops.rot_head_blocked}
    errs = {(tag, cdt): 0.0 for tag in wrappers for cdt in TOL}
    for cdt in TOL:
        args = rot_args(cdt)
        ref, k3_plain = multi_ops.rot_head_multi_twin(*args), rot_ops.rot_head_twin(*args)
        k3 = rot_ops.rot_head(*args)
        first = multi_ops.rot_head_blocked(*args, PATH_GROUP)
        for tag, fn in wrappers.items():
            for group in GROUPS:
                out = fn(*args, group)
                if cdt == torch.bfloat16 and not torch.equal(out, first):
                    raise RuntimeError(f"{tag} {group} objects per block bf16: not the bits of "
                                       f"K8 at {PATH_GROUP}")
                errs[tag, cdt] = max(errs[tag, cdt], tensor_errors(
                    "kernels", f"{tag} {group} objects per block", cdt, [out], [ref], ["out"]))
                if cdt == torch.float32:
                    tensor_errors("kernels", f"{tag} {group} objects per block vs K3", cdt,
                                  [out], [k3], ["out"])
                else:
                    nearer_its_own_version(f"{tag} {group} objects per block", out, ref, k3_plain,
                                           "K3's plain version (f32 point reduction)")
        if cdt == torch.bfloat16:     # and K3 nearer its own: its erf is its own polynomial
            nearer_its_own_version("K3", k3, k3_plain, ref,
                                   "the K7/K8 plain version (rounded point reduction)")
        k3_gap = (k3 - ref).abs().max().item()
        log("kernels", f"K3 vs the K7/K8 plain version {str(cdt)[6:]}: {k3_gap:.3e} "
                       "(the rounded point reduction)")
        if cdt == torch.bfloat16:
            log("kernels", f"K7, K8 bf16: {len(GROUPS)} objects-per-block counts bit-equal")
            for _ in range(MULTI_REPEATS):
                if not torch.equal(first, multi_ops.rot_head_blocked(*args, PATH_GROUP)):
                    raise RuntimeError("K8 bf16: two launches on the same inputs differ")
            log("kernels", f"K8 bf16: {1 + MULTI_REPEATS} launches on the same inputs bit-equal")
        p_ragged, n_pcl = MULTI_RAGGED
        pf, gterm, pack, _ = args
        pf = pf[:, :p_ragged].contiguous()
        pack = dataclasses.replace(pack, pw=pack.pw[:, :p_ragged].contiguous())
        plain = multi_ops.rot_head_multi_twin(pf, gterm, pack, n_pcl)
        for tag, fn in wrappers.items():
            outs = [fn(pf, gterm, pack, n_pcl, group) for group in GROUPS]
            tensor_errors("kernels", f"{tag} P={p_ragged} n_pcl={n_pcl}", cdt, outs,
                          [plain] * len(GROUPS), [f"{group} objects per block" for group in GROUPS])
            if cdt == torch.bfloat16 and not all(torch.equal(o, outs[0]) for o in outs):
                raise RuntimeError(f"{tag} P={p_ragged} bf16: objects-per-block counts differ")
    report = _build.ptxas_report("rot_head", MULTI_KERNEL.format(PATH_GROUP))
    log("kernels", f"K7/K8 bf16 kernel {MULTI_KERNEL.format(PATH_GROUP)}: {report}")
    plain_ms = time_ms(lambda: multi_ops.rot_head_multi_twin(*args))
    k3_ms = time_ms(lambda: rot_ops.rot_head(*args))
    results = {}
    for tag, fn in wrappers.items():
        by_group = {group: time_ms(lambda: fn(*args, group)) for group in GROUPS}
        log("kernels", f"{tag} bf16 B={args[0].shape[0]} ms by objects per block "
                       f"{ {g: round(t, 4) for g, t in by_group.items()} }, K3 {k3_ms:.4f} ms, "
                       f"plain version {plain_ms:.4f} ms")
        results[tag] = {"max_abs_err": errs[tag, torch.bfloat16],
                        "max_abs_err_f32": errs[tag, torch.float32],
                        "ms": by_group[PATH_GROUP], "plain_ms": plain_ms,
                        "ms_by_objects_per_block": by_group, "k3_ms": k3_ms, **report}
    return results


def check_k3_design(rot_args):
    """What the bf16 K3's design has to show beyond agreeing with its plain
    version at the main path's shape: the two chained `wgmma` products it is
    built on, alone, on canned operands (the first product's accumulators are
    the second's A registers); launches on the same inputs bit-equal, several
    times over (a missing fence or a ring stage given back too early shows
    only sometimes); and a point count that the 64-point tile does not divide,
    with a cloud / keypoint boundary inside a tile, in f32 and bf16."""
    from catre_tpu_torch.ops import rot_head as rot_ops

    gen = torch.Generator(device="cuda").manual_seed(3)   # its own: later phases keep their inputs
    x, w0, w1 = (torch.randn(*shape, device="cuda", generator=gen).bfloat16()
                 for shape in ((64, 64), (256, 64), (256, 256)))
    outs, refs = rot_ops.wgmma_chain(x, w0, w1), rot_ops.wgmma_chain_plain(x, w0, w1)
    torch.cuda.synchronize()
    # exact bf16 products, f32 sums in another order; a sum that rounds the other
    # way to bf16 moves one of the second product's 256 operands by one ulp
    for name, out, ref, rel in zip(("x @ w0^T", "round(x @ w0^T) @ w1^T"), outs, refs,
                                   (CHAIN_TOL, CHAIN_TOL_ROUNDED)):
        err, limit = (out - ref).abs().max().item(), rel * ref.abs().max().item()
        log("kernels", f"K3 wgmma chain {name}: max_abs_err={err:.3e} limit={limit:.3e}")
        if not err <= limit:
            raise RuntimeError(f"K3 wgmma chain {name}: {err} > {limit}")

    args = rot_args(torch.bfloat16)
    first = rot_ops.rot_head(*args)
    for _ in range(K3_REPEATS):
        if not torch.equal(first, rot_ops.rot_head(*args)):
            raise RuntimeError("K3 bf16: two launches on the same inputs differ")
    log("kernels", f"K3 bf16: {1 + K3_REPEATS} launches on the same inputs bit-equal")

    p_ragged, n_pcl = K3_RAGGED
    for cdt in TOL:
        pf, gterm, pack, _ = rot_args(cdt)
        pf = pf[:, :p_ragged].contiguous()
        pack = dataclasses.replace(pack, pw=pack.pw[:, :p_ragged].contiguous())
        tensor_errors("kernels", f"K3 P={p_ragged} n_pcl={n_pcl}", cdt,
                      [rot_ops.rot_head(pf, gterm, pack, n_pcl)],
                      [rot_ops.rot_head_twin(pf, gterm, pack, n_pcl)], ["out"])


def check_tail_design(tag, kernel, plain_fn, folded_fn, x_full, ws, ptxas_name):
    """What the bf16 K1 and K2 (max on the bare accumulator,
    `csrc/encoder_tail_wgmma.cuh`, `csrc/encoder_stn_tail_wgmma.cuh`) have to
    show beyond agreeing with their plain version: they agree with the plain
    version of their own order (`*_folded_twin`) too; launches on the same
    inputs are bit-equal, several times over (the running maxima are folded
    by atomics in any order, a ring slot given back too early shows only
    sometimes); and a point count that the 128-point tile does not divide, in
    f32 and bf16. The mean distances to the two plain versions are printed,
    not gated: the fold is exact, so the two differ only in the order of the
    f32 sums, as the kernel does from both. -> ptxas' registers, stack frame
    and spill bytes of the kernel."""
    from catre_tpu_torch.ops import _build

    bf = torch.bfloat16
    x = x_full.to(bf)
    out, plain, folded = (fn(x, *ws, bf) for fn in (kernel, plain_fn, folded_fn))
    tensor_errors("kernels", f"{tag} vs its folded plain version", bf, [out], [folded], ["out"])
    log("kernels", f"{tag} bf16: mean |kernel - folded plain| = "
                   f"{(out - folded).abs().mean().item():.3e}, mean |kernel - per-row plain| = "
                   f"{(out - plain).abs().mean().item():.3e}, mean |per-row plain - folded plain| = "
                   f"{(plain - folded).abs().mean().item():.3e}, elements that differ from the "
                   f"folded plain version {(out != folded).sum().item()} of {out.numel()}")
    for _ in range(TAIL_REPEATS):
        if not torch.equal(out, kernel(x, *ws, bf)):
            raise RuntimeError(f"{tag} bf16: two launches on the same inputs differ")
    log("kernels", f"{tag} bf16: {1 + TAIL_REPEATS} launches on the same inputs bit-equal")
    del x, out, plain, folded
    for cdt in TOL:
        x = x_full[:, :TAIL_RAGGED].to(cdt).contiguous()
        out = kernel(x, *ws, cdt)
        tensor_errors("kernels", f"{tag} P={TAIL_RAGGED}", cdt, [out, out],
                      [plain_fn(x, *ws, cdt), folded_fn(x, *ws, cdt)],
                      ["vs plain", "vs folded plain"])
    report = _build.ptxas_report("encoder_epilogue", ptxas_name)
    log("kernels", f"{tag} bf16 kernel {ptxas_name}: {report}")
    return report


def check_k9_design(tag, xc, params, relu_last):
    """What each bf16 K9 column (`csrc/encoder_chain_wgmma.cuh`) has to show
    beyond agreeing with its plain version at the main path's shape: launches
    on the same inputs bit-equal, several times over (the main design folds
    its maxima by atomics in any order; a ring stage given back too early
    shows only sometimes); point counts that the 128-point tile does not
    divide, in f32 and bf16. -> ptxas' registers, stack frame and spill bytes
    of the column's bf16 kernel and its shared memory."""
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_chain as chain_ops

    bf = torch.bfloat16
    x = xc.to(bf)
    first = chain_ops.chain3_max(x, *params, bf, relu_last=relu_last)
    for _ in range(K9_REPEATS):
        if not torch.equal(first, chain_ops.chain3_max(x, *params, bf, relu_last=relu_last)):
            raise RuntimeError(f"{tag} bf16: two launches on the same inputs differ")
    log("kernels", f"{tag} bf16: {1 + K9_REPEATS} launches on the same inputs bit-equal")
    del x, first
    for p_ragged in K9_RAGGED:
        for cdt in TOL:
            x = xc[:, :p_ragged].to(cdt).contiguous()
            tensor_errors("kernels", f"{tag} P={p_ragged}", cdt,
                          [chain_ops.chain3_max(x, *params, cdt, relu_last=relu_last)],
                          [chain_ops.chain3_max_twin(x, *params, cdt, relu_last=relu_last)], ["out"])
    report = _build.ptxas_report("encoder_chain", K9_KERNELS[tag])
    widths = [xc.shape[2]] + [w.shape[0] for w in params[0::2]]
    report["shared_memory"] = chain_ops._lib().catre_chain3_max_smem(*widths, 1)
    log("kernels", f"{tag} bf16 kernel {K9_KERNELS[tag]}: {report}")
    return report


def check_k4(head, dev, gen):
    """K4 vs its plain version (autograd of the K3 twin), per gradient tensor,
    in f32 and bf16 at B = K4_CHECK_B and at the main path's B = K4_TIME_B
    (where the weight-gradient products take their capped split-K schedule);
    times in bf16 at B = K4_TIME_B. And what the bf16 K4's design has to show
    beyond that, as `check_k3_design` does for K3: the products that read a
    staged weight transposed (d_a = d_x2 W1; d_pf = d_x0 W_pt over quarters)
    or by 64-column quarters, alone, on canned operands; launches on the same
    inputs bit-equal, every gradient tensor; and a point count that the
    64-point tile does not divide, with the cloud / keypoint boundary inside a
    tile, in f32 and bf16."""
    from catre_tpu_torch.ops import rot_head as rot_ops
    from catre_tpu_torch.ops import rot_head_train as train_ops

    n_pts = head.rot_head_x.point_weight.shape[0]
    names = train_ops.GRAD_NAMES

    def args(cdt, b, p=n_pts, n_pcl=n_pts // 2, gen=gen):
        with torch.no_grad():
            pack = rot_ops.pack_rot_head(head, cdt, weight_dtype=torch.float32)
            pack = dataclasses.replace(pack, pw=pack.pw[:, :p].contiguous())
            pf = torch.randn(b, p, 64, device=dev, generator=gen) * 0.5
            g2 = torch.randn(b, 2, 1024, device=dev, generator=gen) * 0.5
            d_out = torch.randn(b, 6, device=dev, generator=gen)
            return pf.to(cdt), (g2 @ pack.w_g.T).contiguous(), pack, n_pcl, d_out

    canned = torch.Generator(device="cuda").manual_seed(4)   # its own: `gen` keeps its sequence
    x, w0, w1 = (torch.randn(*shape, device="cuda", generator=canned).bfloat16()
                 for shape in ((64, 256), (256, 64), (256, 256)))
    outs, refs = train_ops.wgmma_tn(x, w0, w1), train_ops.wgmma_tn_plain(x, w0, w1)
    torch.cuda.synchronize()
    # exact bf16 products, f32 sums in another order
    for name, out, ref in zip(("x @ w1", "x @ w0 over quarters", "x[:, :64] @ w0^T by quarters"),
                              outs, refs):
        err, limit = (out - ref).abs().max().item(), TN_TOL * ref.abs().max().item()
        log("K4", f"wgmma transposed {name}: max_abs_err={err:.3e} limit={limit:.3e}")
        if not err <= limit:
            raise RuntimeError(f"K4 wgmma transposed {name}: {err} > {limit}")

    p_ragged, n_pcl = K3_RAGGED
    for cdt in TOL:
        a = args(cdt, K4_CHECK_B, p_ragged, n_pcl, canned)
        ref = train_ops.rot_head_bwd_twin(*a)
        with torch.no_grad():
            out = train_ops.rot_head_bwd(*a)
            tensor_errors("K4", f"B={K4_CHECK_B} P={p_ragged} n_pcl={n_pcl}", cdt,
                          [out[n] for n in names], [ref[n] for n in names],
                          [f"d_{n}" for n in names])
            for _ in range(K4_REPEATS):
                again = train_ops.rot_head_bwd(*a)
                if not all(torch.equal(out[n], again[n]) for n in names):
                    raise RuntimeError(f"K4 {cdt}: two launches on the same inputs differ")
        log("K4", f"{str(cdt)[6:]}: {1 + K4_REPEATS} launches on the same inputs bit-equal, "
                  f"all {len(names)} gradients")
        del a, ref, out, again

    errs = dict.fromkeys((torch.float32, torch.bfloat16), 0.0)
    for b in (K4_CHECK_B, K4_TIME_B):
        for cdt in (torch.float32, torch.bfloat16):
            a = args(cdt, b)
            ref = train_ops.rot_head_bwd_twin(*a)
            with torch.no_grad():
                out = train_ops.rot_head_bwd(*a)
            errs[cdt] = max(errs[cdt], tensor_errors(
                "K4", f"B={b}", cdt, [out[n] for n in names], [ref[n] for n in names],
                [f"d_{n}" for n in names]))
            del a, ref, out
    a = args(torch.bfloat16, K4_TIME_B)
    with torch.no_grad():
        ms = time_ms(lambda: train_ops.rot_head_bwd(*a))
    plain_ms = time_ms(lambda: train_ops.rot_head_bwd_twin(*a), iters=3, warmup=1)
    log("K4", f"B={K4_TIME_B} bf16 kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms")
    return {"max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "plain_ms": plain_ms}


def bound(nbytes, flops, peak_flops=PEAK_BF16):
    """The least time the card could take, {bound_ms, bound_by}; library_ms is
    None for every kernel here: no single PyTorch call computes any of them."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def tensor_errors(phase, tag, cdt, outs, refs, names):
    """Per-tensor max-abs error of a kernel's `outs` against its plain
    version's `refs`, each held to TOL[cdt] x max(1, max|ref|); returns the
    largest error."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, o, r in zip(names, outs, refs):
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise RuntimeError(f"{phase} {tag} {cdt} {name}: shape {tuple(o.shape)} or non-finite")
        err = (o.float() - r.float()).abs().max().item()
        limit = TOL[cdt] * max(1.0, r.abs().max().item())
        log(phase, f"{tag} {str(cdt)[6:]} {name} {tuple(o.shape)} max_abs_err={err:.3e} "
                   f"limit={limit:.3e}")
        if not err <= limit:
            raise RuntimeError(f"{phase} {tag} {cdt} {name}: kernel disagrees with its plain "
                               f"version: {err} > {limit}")
        worst = max(worst, err)
    return worst


def check_argmax(tag, cdt, h_plain, out_plain, idx_plain, idx):
    """The kernel's argmax rows against the plain version's: equal, or (where
    the two products rounded differently) the plain activation at the
    kernel's row is the plain max to within NEAR_TIE (f32) / TOL (bf16)."""
    if idx.dtype != torch.int32 or idx.min() < 0 or idx.max() >= h_plain.shape[1]:
        raise RuntimeError(f"{tag} {cdt}: idx out of range or not int32")
    at_idx = h_plain.gather(1, idx.long()[:, None, :])[:, 0].float()
    gap = (out_plain - at_idx).abs().max().item()
    differ = (idx != idx_plain).sum().item()
    rel = NEAR_TIE if cdt == torch.float32 else TOL[cdt]
    limit = rel * max(1.0, out_plain.abs().max().item())
    log("K5K6", f"{tag} {str(cdt)[6:]} idx: {differ} of {idx.numel()} rows differ from the plain "
                f"argmax, plain activation there within {gap:.3e} of the max (limit {limit:.3e})")
    if not gap <= limit:
        raise RuntimeError(f"{tag} {cdt}: the kernel's argmax row does not hold the max")


def check_train_tails(enc, dev, gen, n_clouds, n_pts):
    """K5 and K6, forward and backward, vs their plain versions at the main
    path's shape; -> {kernel name: results}."""
    from catre_tpu_torch.models.layers import dense
    from catre_tpu_torch.ops import encoder_epilogue as enc_ops
    from catre_tpu_torch.ops import encoder_epilogue_train as tt

    def weights(*layers):
        return [t.detach() for layer in layers for t in (layer.weight, layer.bias)]

    cases = {
        "K5": (weights(enc.stn.conv3), tt.dense_relu_max_fwd, tt.dense_relu_max_fwd_plain,
               tt.dense_relu_max_bwd, tt.dense_relu_max_bwd_plain, enc_ops.dense_relu_max,
               ("dx", "dW", "db")),
        "K6": (weights(enc.conv3, enc.conv4), tt.dense_relu_dense_max_fwd,
               tt.dense_relu_dense_max_fwd_plain, tt.dense_relu_dense_max_bwd,
               tt.dense_relu_dense_max_bwd_plain, enc_ops.dense_relu_dense_max,
               ("dx", "dW3", "db3", "dW4", "db4")),
    }
    results = {}
    x32 = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=gen))
    for tag, (ws, fwd, fwd_plain, bwd, bwd_plain, infer, names) in cases.items():
        cout = ws[-1].shape[0]
        d_out = torch.randn(n_clouds, cout, device=dev, generator=gen)
        errs_f, errs_b = {}, {}
        for cdt in (torch.float32, torch.bfloat16):
            x = x32.to(cdt)
            with torch.no_grad():
                out, idx = fwd(x, *ws, cdt)
                if not torch.equal(out, infer(x, *ws, cdt)):
                    raise RuntimeError(f"{tag} {cdt}: forward out is not bit-equal to its "
                                       "inference kernel")
                h = dense(x, ws[0], ws[1], cdt, act=True)
                if tag == "K6":
                    h = dense(h, ws[2], ws[3], cdt)
                out_p, idx_p = tt.max_argmax(h)
                errs_f[cdt] = tensor_errors("K5K6", f"{tag} fwd", cdt, [out], [out_p], ["out"])
                check_argmax(f"{tag} fwd", cdt, h, out_p, idx_p, idx)
                del h
                grads = bwd(x, *ws, idx, d_out, cdt)
                again = bwd(x, *ws, idx, d_out, cdt)
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise RuntimeError(f"{tag} {cdt}: two backward launches differ")
                ref = bwd_plain(x, *ws, idx, d_out, cdt)
                errs_b[cdt] = tensor_errors("K5K6", f"{tag} bwd", cdt, grads, ref, names)
                del grads, again, ref
        with torch.no_grad():      # x, idx: the bf16 case's
            times = {
                "fwd": (time_ms(lambda: fwd(x, *ws, torch.bfloat16)),
                        time_ms(lambda: fwd_plain(x, *ws, torch.bfloat16), iters=3, warmup=1)),
                "bwd": (time_ms(lambda: bwd(x, *ws, idx, d_out, torch.bfloat16)),
                        time_ms(lambda: bwd_plain(x, *ws, idx, d_out, torch.bfloat16), iters=3,
                                warmup=1)),
            }
        for which, (ms, plain_ms) in times.items():
            log("K5K6", f"{tag} {which} bf16 kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms")
        # bounds, bf16: the forward's dense products; the backward routed, counted
        # from this run's argmax rows (rows no channel points at need no reading)
        cin, n_rows = 128, n_clouds * n_pts
        crit = (idx.long() + torch.arange(n_clouds, device=dev)[:, None] * n_pts).unique().numel()
        if tag == "K5":
            fwd_flops = 2 * n_rows * cin * cout
            w_bytes = 2 * cout * cin
            # gate, dx and dW: one length-cin product each per (cloud, channel), f32 FMA;
            # dx written once in x's dtype
            bwd_bound = bound(2 * crit * cin + x.element_size() * n_rows * cin
                              + 8 * n_clouds * cout + w_bytes + 4 * cout * (cin + 1),
                              3 * 2 * n_clouds * cout * cin, PEAK_F32)
        else:
            chid = ws[0].shape[0]
            fwd_flops = 2 * n_rows * (cin * chid + chid * cout)
            w_bytes = 2 * (chid * cin + cout * chid)
            # h3p, dx and dW3 on the critical rows (tensor cores); g and dW4 per (cloud,
            # channel); dx written once in x's dtype
            bwd_bound = bound(2 * crit * cin + x.element_size() * n_rows * cin
                              + 8 * n_clouds * cout + w_bytes
                              + 4 * (chid * (cin + 1) + cout * (chid + 1)),
                              2 * (3 * crit * cin * chid + 2 * n_clouds * cout * chid))
        log("K5K6", f"{tag}: {crit} critical rows of {n_rows} ({crit / n_clouds:.1f} per cloud)")
        fwd_bound = bound(2 * n_rows * cin + w_bytes + 8 * n_clouds * cout, fwd_flops)
        for which, errs, bnd in (("fwd", errs_f, fwd_bound), ("bwd", errs_b, bwd_bound)):
            results[f"{tag} {which}"] = {
                "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
                "ms": times[which][0], "plain_ms": times[which][1], **bnd}
    return results


def check_k6_fwd_design(enc, dev, n_clouds, n_pts):
    """What the bf16 K6 forward (K1's body with the keyed argmax fold,
    `csrc/encoder_tail_wgmma.cuh`) has to show beyond `check_argmax`: on
    exact-integer operands, whose f32 sums are exact in any order while the
    bf16 roundings tie rows, out and idx bit-equal to the plain version's (and
    in bf16 to the plain version of the keyed fold), out bit-equal to K1, at
    P = n_pts and TAIL_RAGGED, in f32 and bf16; six launches on the main
    path's inputs bit-equal in out and idx. -> ptxas' report and the dynamic
    shared memory of the kernel."""
    from catre_tpu_torch.models.layers import dense
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_epilogue as enc_ops
    from catre_tpu_torch.ops import encoder_epilogue_train as tt

    ws = [t.detach() for layer in (enc.conv3, enc.conv4) for t in (layer.weight, layer.bias)]
    chid, cout = ws[0].shape[0], ws[2].shape[0]
    ints = torch.Generator(device="cuda").manual_seed(6)     # its own: `gen` keeps its sequence
    x_int = torch.randint(0, 3, (ARGMAX_INT_CLOUDS, n_pts, 128), device=dev, generator=ints).float()
    w_int = [torch.randint(lo, hi, shape, device=dev, generator=ints).float()
             for lo, hi, shape in ((-2, 3, (chid, 128)), (-8, 9, (chid,)), (-2, 3, (cout, chid)),
                                   (-8, 9, (cout,)))]
    with torch.no_grad():
        for cdt in TOL:
            for p in (n_pts, TAIL_RAGGED):
                x = x_int[:, :p].to(cdt).contiguous()
                out, idx = tt.dense_relu_dense_max_fwd(x, *w_int, cdt)
                h3 = dense(x, w_int[0], w_int[1], cdt, act=True)
                h = dense(h3, w_int[2], w_int[3], cdt)
                plain = tt.max_argmax(h)
                keyed = tt.max_argmax_keyed(h.float()) if cdt == torch.bfloat16 else plain
                acc = torch.nn.functional.linear(h3.float(), w_int[2])     # exact: integers
                bare = (plain[1] != acc.argmax(dim=1)).sum().item()
                del h3, acc
                log("K5K6", f"K6 fwd {str(cdt)[6:]} integer operands N={ARGMAX_INT_CLOUDS} P={p}: "
                            f"idx differs from the plain version's at {(idx != plain[1]).sum().item()} "
                            f"of {idx.numel()}, from the keyed plain fold's at "
                            f"{(idx != keyed[1]).sum().item()}; out equal {torch.equal(out, plain[0])}; "
                            f"the largest accumulator's row is not the lowest tied row at {bare}")
                if not (torch.equal(idx, plain[1]) and torch.equal(idx, keyed[1])
                        and torch.equal(out, plain[0]) and torch.equal(out, keyed[0])
                        and torch.equal(out, enc_ops.dense_relu_dense_max(x, *w_int, cdt))):
                    raise RuntimeError(f"K6 fwd {cdt} P={p}: out / idx not the plain version's on "
                                       "exact-integer operands")
                del x, h, plain, keyed
        x = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=ints)).bfloat16()
        first = tt.dense_relu_dense_max_fwd(x, *ws, torch.bfloat16)
        for _ in range(ARGMAX_REPEATS):
            again = tt.dense_relu_dense_max_fwd(x, *ws, torch.bfloat16)
            if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
                raise RuntimeError("K6 fwd bf16: two launches on the same inputs differ")
        log("K5K6", f"K6 fwd bf16 N={n_clouds}: {1 + ARGMAX_REPEATS} launches on the same inputs "
                    "bit-equal, out and idx")
    report = _build.ptxas_report("encoder_epilogue_train", K6F_KERNEL)
    report["shared_memory"] = tt._lib().catre_tail_smem(chid, cout)
    log("K5K6", f"K6 fwd bf16 kernel {K6F_KERNEL}: {report}")
    return report


def check_k5_fwd_design(enc, dev, n_clouds, n_pts):
    """What the bf16 K5 forward (K2's kernel with the keyed fold after the
    ReLU, `csrc/encoder_stn_tail_wgmma.cuh`) has to show beyond
    `check_argmax`: on exact-integer operands, with every fourth channel's
    weights at or below 0 and its bias at -50 (every row negative before the
    ReLU, so all tie at 0 and idx is 0), out and idx bit-equal to the plain
    version's (and in bf16 to the plain version of the keyed fold), out
    bit-equal to K2, at P = n_pts and TAIL_RAGGED, in f32 and bf16; six
    launches on the main path's inputs bit-equal in out and idx. -> ptxas'
    report and the dynamic shared memory of the kernel."""
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_epilogue as enc_ops
    from catre_tpu_torch.ops import encoder_epilogue_train as tt

    ws = [enc.stn.conv3.weight.detach(), enc.stn.conv3.bias.detach()]
    cout = ws[0].shape[0]
    ints = torch.Generator(device="cuda").manual_seed(5)     # its own: `gen` keeps its sequence
    x_int = torch.randint(0, 3, (ARGMAX_INT_CLOUDS, n_pts, 128), device=dev, generator=ints).float()
    w_int = torch.randint(-2, 3, (cout, 128), device=dev, generator=ints).float()
    b_int = torch.randint(-8, 9, (cout,), device=dev, generator=ints).float()
    w_int[::4], b_int[::4] = -w_int[::4].abs(), -50.0
    with torch.no_grad():
        for cdt in TOL:
            for p in (n_pts, TAIL_RAGGED):
                x = x_int[:, :p].to(cdt).contiguous()
                out, idx = tt.dense_relu_max_fwd(x, w_int, b_int, cdt)
                plain = tt.dense_relu_max_fwd_plain(x, w_int, b_int, cdt)
                keyed = (tt.dense_relu_max_fwd_keyed_plain(x, w_int, b_int, cdt)
                         if cdt == torch.bfloat16 else plain)
                dead = bool((idx[:, ::4] == 0).all())
                log("K5K6", f"K5 fwd {str(cdt)[6:]} integer operands N={ARGMAX_INT_CLOUDS} P={p}: "
                            f"idx differs from the plain version's at {(idx != plain[1]).sum().item()} "
                            f"of {idx.numel()}, from the keyed plain fold's at "
                            f"{(idx != keyed[1]).sum().item()}; out equal {torch.equal(out, plain[0])}; "
                            f"channels negative on every row all idx 0 {dead}")
                if not (torch.equal(idx, plain[1]) and torch.equal(idx, keyed[1])
                        and torch.equal(out, plain[0]) and torch.equal(out, keyed[0]) and dead
                        and torch.equal(out, enc_ops.dense_relu_max(x, w_int, b_int, cdt))):
                    raise RuntimeError(f"K5 fwd {cdt} P={p}: out / idx not the plain version's on "
                                       "exact-integer operands")
                del x, plain, keyed
        x = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=ints)).bfloat16()
        first = tt.dense_relu_max_fwd(x, *ws, torch.bfloat16)
        for _ in range(ARGMAX_REPEATS):
            again = tt.dense_relu_max_fwd(x, *ws, torch.bfloat16)
            if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
                raise RuntimeError("K5 fwd bf16: two launches on the same inputs differ")
        log("K5K6", f"K5 fwd bf16 N={n_clouds}: {1 + ARGMAX_REPEATS} launches on the same inputs "
                    "bit-equal, out and idx")
    report = _build.ptxas_report("encoder_epilogue_train", K5F_KERNEL)
    report["shared_memory"] = tt._lib().catre_k5_fwd_smem()
    log("K5K6", f"K5 fwd bf16 kernel {K5F_KERNEL}: {report}")
    return report


def check_k6_bwd_design(enc, dev, gen, n_clouds, n_pts):
    """What the bf16 K6 backward (`csrc/encoder_tail_bwd_wgmma.cuh`: critical
    rows only, no (N, P, chid) scratch) has to show beyond agreeing with the
    dense plain version (`check_train_tails`): it agrees with the plain version
    in its own order (route, g, gate, products on the critical rows) per output
    tensor at the main path's shape; six launches on the same inputs are
    bit-equal (sums in a fixed order, no float atomics); at P = TAIL_RAGGED, in
    f32 and bf16, both plain versions; its allocation beyond its outputs stays
    under K6B_SCRATCH of N P chid 2 bytes. -> ptxas' report and the dynamic
    shared memory of each of its passes."""
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_epilogue_train as tt

    ws = [t.detach() for layer in (enc.conv3, enc.conv4) for t in (layer.weight, layer.bias)]
    names = ("dx", "dW3", "db3", "dW4", "db4")
    plains = (("plain", tt.dense_relu_dense_max_bwd_plain),
              ("critical-row plain", tt.dense_relu_dense_max_bwd_critical_plain))
    bf, chid = torch.bfloat16, ws[0].shape[0]
    x32 = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=gen))
    d_out = torch.randn(n_clouds, ws[2].shape[0], device=dev, generator=gen)
    with torch.no_grad():
        x = x32.to(bf)
        _, idx = tt.dense_relu_dense_max_fwd(x, *ws, bf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads = tt.dense_relu_dense_max_bwd(x, *ws, idx, d_out, bf)
        torch.cuda.synchronize()
        beyond = (torch.cuda.max_memory_allocated() - base
                  - sum(g.numel() * g.element_size() for g in grads))
        limit = K6B_SCRATCH * n_clouds * n_pts * chid * 2
        log("K5K6", f"K6 bwd bf16 N={n_clouds}: allocation beyond its outputs "
                    f"{beyond / 2**20:.1f} MiB (limit {limit / 2**20:.1f} MiB)")
        if not beyond <= limit:
            raise RuntimeError(f"K6 bwd bf16 allocates {beyond} bytes beyond its outputs")
        tensor_errors("K5K6", f"K6 bwd N={n_clouds} vs its critical-row plain version", bf, grads,
                      tt.dense_relu_dense_max_bwd_critical_plain(x, *ws, idx, d_out, bf), names)
        for _ in range(K6B_REPEATS):
            again = tt.dense_relu_dense_max_bwd(x, *ws, idx, d_out, bf)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise RuntimeError("K6 bwd bf16: two launches on the same inputs differ")
        log("K5K6", f"K6 bwd bf16: {1 + K6B_REPEATS} launches on the same inputs bit-equal, "
                    "all five gradients")
        del x, grads, again
        for cdt in TOL:
            xr = x32[:, :TAIL_RAGGED].to(cdt).contiguous()
            _, idx_r = tt.dense_relu_dense_max_fwd(xr, *ws, cdt)
            outs = tt.dense_relu_dense_max_bwd(xr, *ws, idx_r, d_out, cdt)
            for tag, plain in plains:
                tensor_errors("K5K6", f"K6 bwd P={TAIL_RAGGED} vs {tag}", cdt, outs,
                              plain(xr, *ws, idx_r, d_out, cdt), names)
            del xr, outs
    lib = tt._lib()
    passes = {k: _build.ptxas_report("encoder_epilogue_train", k) for k in K6B_KERNELS}
    for i, k in enumerate(K6B_KERNELS[1:]):
        passes[k]["shared_memory"] = lib.catre_k6_bwd_smem(128, chid, ws[2].shape[0], i)
    log("K5K6", f"K6 bwd bf16 kernels: {passes}")
    return {"registers": max(r["registers"] for r in passes.values()),
            "stack_frame": max(r["stack_frame"] for r in passes.values()),
            "spill_stores": sum(r["spill_stores"] for r in passes.values()),
            "spill_loads": sum(r["spill_loads"] for r in passes.values()),
            "shared_memory": max(r.get("shared_memory", 0) for r in passes.values()),
            "passes": passes}


def check_k5_bwd_design(enc, dev, gen, n_clouds, n_pts):
    """What the bf16 K5 backward (`csrc/encoder_stn_tail_bwd.cuh`: gate pass,
    routing pass, dx pass writing every row once in bf16) has to show beyond
    agreeing with the dense plain version (`check_train_tails`), on the main
    path's shape with every fourth gate closed on every row and every sixth
    cotangent zero: it agrees with the plain version in its own order per
    output tensor; dx is bf16 and exactly zero on every row that no live
    channel points at; six launches on the same inputs are bit-equal; at P =
    TAIL_RAGGED, in f32 and bf16, both plain versions; its allocation beyond
    its outputs stays under K5B_SCRATCH of N P cin 2 bytes; ptxas reports no
    spill and no stack frame for its kernels. Then its time on the inputs of
    one K5 backward captured from a train step at B = TRAIN_B. -> ptxas'
    reports, the dynamic shared memory of its passes and that time."""
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_epilogue_train as tt
    from catre_tpu_torch.tools import probe_k5b

    w, b = enc.stn.conv3.weight.detach(), enc.stn.conv3.bias.detach().clone()
    b[::4] = -50.0                  # gates closed on every row: idx 0, d 0
    ws, cin, cout = [w, b], w.shape[1], w.shape[0]
    names, bf = ("dx", "dW", "db"), torch.bfloat16
    plains = (("plain", tt.dense_relu_max_bwd_plain),
              ("critical-row plain", tt.dense_relu_max_bwd_critical_plain))
    x32 = torch.relu(torch.randn(n_clouds, n_pts, cin, device=dev, generator=gen))
    d_out = torch.randn(n_clouds, cout, device=dev, generator=gen)
    d_out[:, ::6] = 0.0
    with torch.no_grad():
        x = x32.to(bf)
        _, idx = tt.dense_relu_max_fwd(x, *ws, bf)
        tt.dense_relu_max_bwd(x, *ws, idx, d_out, bf)           # warm up the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads = tt.dense_relu_max_bwd(x, *ws, idx, d_out, bf)
        torch.cuda.synchronize()
        beyond = (torch.cuda.max_memory_allocated() - base
                  - sum(g.numel() * g.element_size() for g in grads))
        limit = K5B_SCRATCH * n_clouds * n_pts * cin * 2
        log("K5K6", f"K5 bwd bf16 N={n_clouds}: allocation beyond its outputs "
                    f"{beyond / 2**20:.1f} MiB (limit {limit / 2**20:.1f} MiB)")
        if not beyond <= limit:
            raise RuntimeError(f"K5 bwd bf16 allocates {beyond} bytes beyond its outputs")
        if grads[0].dtype != bf or any(g.dtype != torch.float32 for g in grads[1:]):
            raise RuntimeError(f"K5 bwd bf16: gradients {[g.dtype for g in grads]}, want dx in bf16")
        hit = probe_k5b.live_rows(x, ws, idx, d_out)
        off = grads[0][~hit].abs().max().item()
        log("K5K6", f"K5 bwd bf16 N={n_clouds}: dx bf16; {int((~hit).sum())} of {hit.numel()} rows "
                    f"no live channel points at, max |dx| there {off}")
        if off != 0:
            raise RuntimeError("K5 bwd bf16: dx not zero on a row that no live channel points at")
        tensor_errors("K5K6", f"K5 bwd N={n_clouds} vs its critical-row plain version", bf, grads,
                      tt.dense_relu_max_bwd_critical_plain(x, *ws, idx, d_out, bf), names)
        for _ in range(K5B_REPEATS):
            again = tt.dense_relu_max_bwd(x, *ws, idx, d_out, bf)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise RuntimeError("K5 bwd bf16: two launches on the same inputs differ")
        log("K5K6", f"K5 bwd bf16: {1 + K5B_REPEATS} launches on the same inputs bit-equal, "
                    "dx, dW and db")
        del x, grads, again, hit
        for cdt in TOL:
            xr = x32[:, :TAIL_RAGGED].to(cdt).contiguous()
            _, idx_r = tt.dense_relu_max_fwd(xr, *ws, cdt)
            outs = tt.dense_relu_max_bwd(xr, *ws, idx_r, d_out, cdt)
            for tag, plain in plains:
                tensor_errors("K5K6", f"K5 bwd P={TAIL_RAGGED} vs {tag}", cdt, outs,
                              plain(xr, *ws, idx_r, d_out, cdt), names)
            del xr, outs
        del x32
    step_x, step_w, step_b, step_idx, step_dout = probe_k5b.capture_step_inputs(TRAIN_B)
    crit, live, _, _ = probe_k5b.bound(step_x, step_idx, step_dout)
    with torch.no_grad():
        step_ms = time_ms(lambda: tt.dense_relu_max_bwd(step_x, step_w, step_b, step_idx, step_dout,
                                                        bf))
    log("K5K6", f"K5 bwd bf16 on the inputs of a B={TRAIN_B} train step's first K5 backward "
                f"(N={step_x.shape[0]}): {step_ms:.4f} ms; {crit} critical rows, {live} live "
                "cotangents")
    del step_x, step_idx, step_dout
    lib = tt._lib()
    passes = {k: _build.ptxas_report("encoder_epilogue_train", k) for k in K5B_KERNELS}
    passes["gate_passILi8E"]["shared_memory"] = lib.catre_k5_bwd_smem(cin, cout, 0)
    passes["dx_passE"]["shared_memory"] = lib.catre_k5_bwd_smem(cin, cout, 1)
    log("K5K6", f"K5 bwd bf16 kernels: {passes}")
    if not all("registers" in r for r in passes.values()):
        raise RuntimeError(f"K5 bwd bf16: a kernel is missing from ptxas' report: {passes}")
    if any(r["spill_stores"] or r["spill_loads"] or r["stack_frame"] for r in passes.values()):
        raise RuntimeError(f"K5 bwd bf16: a kernel spills or keeps a stack frame: {passes}")
    return {"registers": max(r["registers"] for r in passes.values()),
            "stack_frame": max(r["stack_frame"] for r in passes.values()),
            "spill_stores": sum(r["spill_stores"] for r in passes.values()),
            "spill_loads": sum(r["spill_loads"] for r in passes.values()),
            "shared_memory": max(r.get("shared_memory", 0) for r in passes.values()),
            "ms_step_inputs": step_ms, "passes": passes}


def train_phase(dev, per_step, steps=TRAIN_STEPS, cfg=None, lr_fn=None, **model_overrides):
    """The flagship training step through `entry.train_entry` at B = TRAIN_B,
    bf16: one warm-up and `steps` timed steps, on the shipped config or `cfg`,
    at its base lr or `lr_fn(step)`; -> (launch counts, ms per step, peak
    GiB, state)."""
    from catre_tpu_torch import ops
    from catre_tpu_torch.entry import train_entry

    events, counts = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        counts.append(ops.launch_counts())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, history = train_entry(dev, batch_size=TRAIN_B, steps=1 + steps, seed=0,
                                 callback=on_step, cfg=cfg, lr_fn=lr_fn, **model_overrides)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    ms = events[0].elapsed_time(events[-1]) / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    prev = dict.fromkeys(per_step, 0)
    for i, c in enumerate(counts):
        step_counts = {k: c[k] - prev[k] for k in per_step}
        if step_counts != per_step:
            raise RuntimeError(f"train step {i}: launches {step_counts}, want {per_step}")
        prev = c
    for i, m in enumerate(history):
        if not all(torch.isfinite(v).all() for v in m.values()):
            raise RuntimeError(f"train step {i}: non-finite metrics {m}")
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        raise RuntimeError("non-finite parameters after training")
    loss = [round(m["loss_total"][-1].item(), 5) for m in history]
    what = "phase 7b solver config" if cfg is not None else (model_overrides or "shipped flags")
    log("train", f"B={TRAIN_B} bf16 {what} "
                 f"{history[0]['loss_total'].numel()} inner iterations, {steps} timed steps: "
                 f"{ms:.3f} ms/step, {TRAIN_B / ms * 1e3:.1f} train obj/s, peak {peak:.2f} GiB, "
                 f"launches per step {per_step}, last-iteration loss per step {loss}")
    return total, ms, peak, state


def same_bits(tag, a, b):
    """Two tensors (on any devices) bit-equal."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise RuntimeError(f"{tag}: not bit-equal")


def within_ulp(tag, a, b, ulps):
    """f32 tensors within `ulps` of b's spacing; -> (elements that differ,
    the largest distance in ulp)."""
    import numpy as np

    a, b = a.cpu().numpy(), b.cpu().numpy()
    ulp = np.abs(a - b) / np.spacing(np.abs(b))
    if a.shape != b.shape or not (ulp <= ulps).all():
        raise RuntimeError(f"{tag}: {float(ulp.max())} ulp apart, limit {ulps}")
    return int((a != b).sum()), float(ulp.max())


def within_depth_ulp(tag, a, b, ulps):
    """(N, P, 3) clouds within `ulps` of the spacing of b's depth at each
    point; -> (elements that differ, the largest distance in those ulp)."""
    import numpy as np

    a, b = a.cpu().numpy(), b.cpu().numpy()
    ulp = np.abs(a - b) / np.spacing(np.abs(b[..., 2:3]))
    if a.shape != b.shape or not (ulp <= ulps).all():
        raise RuntimeError(f"{tag}: {float(ulp.max())} ulp of the depth apart, limit {ulps}")
    return int((a != b).sum()), float(ulp.max())


def train_from_disk_phase(dev, card, records, per_step, phase7, root):
    """Phase 7c: the split on disk -> the shipped train loader -> the flagship
    train step (see 7c in the module docstring); -> the launch counts."""
    import itertools
    import pickle

    import numpy as np

    from catre_tpu_torch import ops
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import loader as dl
    from catre_tpu_torch.entry import shipped_train_loader, train_from_split
    from catre_tpu_torch.ops.sampling import depth_metres

    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    kw = dict(mean_points=table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader = shipped_train_loader(records, dev, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cfg, ims = loader.cfg, loader.ims_per_batch
    h, w = records[0]["height"], records[0]["width"]

    # the loader's time a group: groups through its own iterator after one,
    # synced; then the stream is rewound for the steps. A group's draws alone.
    groups = iter(loader)
    next(groups)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOADER_TIME_GROUPS):
        next(groups)
    torch.cuda.synchronize()
    group_ms = (time.perf_counter() - t0) * 1e3 / LOADER_TIME_GROUPS
    groups.close()
    loader.reset_stream()
    draws_ms = time_ms(lambda: loader._group_draws(list(range(ims)), ims, h, w),
                       LOADER_TIME_GROUPS)

    # the train steps: one warm-up, TRAIN_STEPS timed, the loader's next group in each
    events, counts = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        counts.append(ops.launch_counts())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, history = train_from_split(records, 1 + TRAIN_STEPS, dev, callback=on_step,
                                      loader=loader)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    ms = events[0].elapsed_time(events[-1]) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    prev = dict.fromkeys(per_step, 0)
    for i, c in enumerate(counts):
        step_counts = {k: c[k] - prev[k] for k in per_step}
        if step_counts != per_step:
            raise RuntimeError(f"train from disk, step {i}: launches {step_counts}, want "
                               f"{per_step}")
        prev = c
    if not all(torch.isfinite(v).all() for m in history for v in m.values()):
        raise RuntimeError("train from disk: non-finite metrics")
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        raise RuntimeError("train from disk: non-finite parameters")
    b = ims * cfg.max_objs_per_image
    loss = [round(m["loss_total"][-1].item(), 5) for m in history]
    log("train", f"phase 7c from disk B={b} ({ims} frames {h}x{w} a step, window "
                 f"{cfg.sample_window}, aug_depth {cfg.aug_depth}): {ms:.3f} ms/step (phase 7 "
                 f"{phase7[1]:.3f}, ratio {ms / phase7[1]:.4f}), {b / ms * 1e3:.1f} train obj/s "
                 f"(phase 7 {TRAIN_B / phase7[1] * 1e3:.1f}), peak {peak:.2f} GiB (phase 7 "
                 f"{phase7[2]:.2f}); loader: cold {cold_s:.3f} s (decode in "
                 f"{loader.num_workers} threads + device cache {loader.device_cache_gb():.3f} "
                 f"GB), {group_ms:.4f} ms a group through its iterator (a group's draws "
                 f"{draws_ms:.4f}); "
                 f"launches per step {per_step}, last-iteration loss per step {loss} | {card}")

    # the card against the CPU loader on the first groups, the loader's own draws
    fresh = shipped_train_loader(records, dev, **kw)
    card_batches = [dict(x, pcl=x["pcl"].clone())
                    for x in itertools.islice(iter(fresh), TRAIN_CPU_GROUPS)]
    cpu = shipped_train_loader(records, "cpu", cache_decoded="", num_workers=LOADER_WORKERS,
                               sample_window=cfg.sample_window, **kw)
    cpu_batches = list(itertools.islice(iter(cpu), TRAIN_CPU_GROUPS))
    d = fresh._dev
    n_diff, worst, pcl_diff, pcl_worst = 0, 0.0, 0, 0.0
    for k, (a, c) in enumerate(zip(card_batches, cpu_batches)):
        if a["scene_im_ids"] != c["scene_im_ids"] or set(a) != set(c):
            raise RuntimeError(f"train loader card vs CPU: group {k} holds other images or "
                               "fields")
        for key in set(a) - {"pcl", "scene_im_ids", "file_names"}:
            if a[key].dtype != c[key].dtype or not (a[key] == c[key]).all():
                raise RuntimeError(f"train loader card vs CPU: group {k} field {key} differs")
        n, u = within_depth_ulp(f"group {k} clouds", a["pcl"], c["pcl"], DEPTH_ULPS)
        pcl_diff, pcl_worst = pcl_diff + n, max(pcl_worst, u)
        gs = list(range(k * ims, (k + 1) * ims))
        on_card, on_cpu = fresh._group_draws(gs, ims, h, w), cpu._group_draws(gs, ims, h, w)
        same_bits(f"group {k} priorities", on_card["priorities"], on_cpu["priorities"])
        for name, field in on_card["aug_draws"].items():
            if name in ("fill_draw", "noise_draw"):
                n, u = within_ulp(f"group {k} {name}", field, on_cpu["aug_draws"][name],
                                  NORMAL_ULPS)
                n_diff, worst = n_diff + n, max(worst, u)
            else:
                same_bits(f"group {k} {name}", field, on_cpu["aug_draws"][name])
        # the CPU sampler on the card's augmented depth gives the card's clouds
        rows = fresh._rows([(g, fresh._index_at(g), None) for g in gs], ims)
        rows_t = torch.from_numpy(rows).to(dev)
        aug = dl.augment_depth(cfg, depth_metres(d["depth"][rows_t]), on_card["aug_draws"])
        host = [d[key][rows_t].cpu() for key in ("K", "packed", "pose", "scale")]
        pcl = dl.sample_group_from_cloud(cfg, False, aug.cpu(), *host,
                                         priorities=on_cpu["priorities"])[0]
        same_bits(f"group {k} clouds (CPU sampler on the card's augmented depth)",
                  pcl.reshape(a["pcl"].shape), a["pcl"])
    log("train", f"train loader card = CPU on the first {TRAIN_CPU_GROUPS} groups: record order, "
                 f"host fields, priorities and uniform fields bit for bit; normal fields "
                 f"{n_diff} elements apart, at most {worst:.1f} ulp (limit {NORMAL_ULPS}); "
                 f"clouds {pcl_diff} elements apart, at most {pcl_worst:.1f} ulp of the depth "
                 f"(limit {DEPTH_ULPS}), and bit-equal from the card's augmented depth")

    # skip(ims) then one group = the second group of the loader that did not skip
    skipped = shipped_train_loader(records, dev, **kw)
    skipped.skip(ims)
    got = next(iter(skipped))
    if got["scene_im_ids"] != card_batches[1]["scene_im_ids"]:
        raise RuntimeError("skip: other records")
    for key in set(got) - {"scene_im_ids", "file_names"}:
        same_bits(f"skip({ims}) field {key}", torch.as_tensor(got[key]),
                  torch.as_tensor(card_batches[1][key]))
    log("train", f"skip({ims}) then one group = group 2 of a fresh loader, bit for bit on the "
                 "card")

    # one step under the last_frame init, its poses from a pickle
    rng = np.random.default_rng(0)
    prev = {r["scene_im_id"]: np.stack([np.concatenate([a["pose"], a["scale"][:, None]], 1)
                                        for a in r["annotations"]]).astype(np.float32)
            + rng.normal(0, 0.005, (len(r["annotations"]), 3, 5)).astype(np.float32)
            for r in records}
    path = os.path.join(root, "last_frame.pkl")
    with open(path, "wb") as f:
        pickle.dump(prev, f)
    lf_cfg = load_config(str(FLAGSHIP_CONFIG))
    lf_cfg.INPUT.INIT_POSE_TYPE_TRAIN = ["last_frame"]
    lf_cfg.INPUT.INIT_POSE_TRAIN_PATH = path
    ops.reset_launch_counts()
    state, history = train_from_split(records, 1, dev, cfg=lf_cfg, **kw)
    torch.cuda.synchronize()
    lf_counts = ops.launch_counts()
    if {k: lf_counts[k] for k in per_step} != per_step:
        raise RuntimeError(f"last_frame step: launches {lf_counts}, want {per_step}")
    if not (all(torch.isfinite(v).all() for v in history[0].values())
            and all(torch.isfinite(p).all() for p in state.params.values())):
        raise RuntimeError("last_frame step: non-finite metrics or parameters")
    log("train", f"one step under INIT_POSE_TYPE_TRAIN ['last_frame'] from a pickle: "
                 f"last-iteration loss {history[0]['loss_total'][-1].item():.5f}, launches "
                 f"{per_step}")
    del loader, fresh, cpu, skipped
    dl.clear_decoded_caches()
    torch.cuda.empty_cache()
    for k in total:
        total[k] += lf_counts[k]
    return total, ms


def refine_phase(dev, B, calls, per_call, **overrides):
    """The flagship refine through `entry.entry` at batch B, bf16: one warm-up
    and `calls` timed calls with exactly `per_call` launches each; returns the
    launch counts of the timed calls."""
    from catre_tpu_torch import ops
    from catre_tpu_torch.entry import N_ITER, entry

    refine, args = entry(dev, batch_size=B, seed=0, **overrides)
    refine(*args)                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ops.reset_launch_counts()
    start.record()
    for _ in range(calls):
        poses, scales = refine(*args)
    end.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ms = start.elapsed_time(end) / calls
    want = {k: v * calls for k, v in per_call.items()}
    if counts != want:
        raise RuntimeError(f"B={B} {overrides}: launches {counts}, want {want}")
    if poses.shape != (N_ITER + 1, B, 3, 4) or scales.shape != (N_ITER + 1, B, 3):
        raise RuntimeError(f"B={B}: shapes {tuple(poses.shape)} {tuple(scales.shape)}")
    if not (torch.isfinite(poses).all() and torch.isfinite(scales).all()):
        raise RuntimeError(f"B={B} {overrides}: non-finite refine output")
    log("refine", f"B={B} bf16 {overrides or 'shipped flags'} {N_ITER} iterations: "
                  f"{ms:.3f} ms/call, {B / ms * 1e3:.1f} obj/s, "
                  f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches per call "
                  f"{ {k: v // calls for k, v in counts.items() if v} }")
    return counts


def same_outputs(tag, card, ref):
    """Sampler outputs (pcls, idx, n_inside, ...) equal: indices and counts
    exactly, points bit for bit."""
    for i, (a, b) in enumerate(zip(card, ref)):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"sample {tag}: output {i} is {tuple(a.shape)} {a.dtype}, "
                               f"want {tuple(b.shape)} {b.dtype}")
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        diff = int((a != b).sum())
        if diff:
            raise RuntimeError(f"sample {tag}: output {i} differs in {diff} of {a.numel()} "
                               "elements")


def check_draws(tag, cfg, d, gen):
    """The card generator's own draws through the fused form: every index
    inside, no repeat where num_pcl or more points are inside, the scarce
    rows cycling through all their inside points; -> (rows full, scarce,
    empty)."""
    from catre_tpu_torch.data.loader import sample_group_from_depth
    from catre_tpu_torch.ops.sampling import batch_ball_crop_candidates

    ws = cfg.sample_window
    _, idx, n_in = sample_group_from_depth(cfg, *d, generator=gen)
    _, inside, n_ref, origin = batch_ball_crop_candidates(d[0], d[1], d[2], d[5], d[3], d[4],
                                                          cfg.depth_sample_ball_ratio, ws)
    w = d[0].shape[-1]
    idx_w = (idx // w - origin[..., :1]) * ws + idx % w - origin[..., 1:]
    if not torch.equal(n_in, n_ref) or not torch.gather(inside, -1, idx_w)[n_in > 0].all():
        raise RuntimeError(f"sample {tag}: the generator's draws left the inside candidates")
    uniq = torch.sort(idx, dim=-1).values.diff(dim=-1).ne(0).sum(-1) + 1
    full, scarce = n_in >= cfg.num_pcl, (n_in > 0) & (n_in < cfg.num_pcl)
    if not (torch.equal(uniq[full], torch.full_like(uniq[full], cfg.num_pcl))
            and torch.equal(uniq[scarce], n_in[scarce].long())
            and bool(idx[n_in == 0].eq(idx[n_in == 0][:, :1]).all())):
        raise RuntimeError(f"sample {tag}: repeats in a full row, or a scarce row that does "
                           "not cycle through its inside points")
    return int(full.sum()), int(scarce.sum()), int((n_in == 0).sum())


def sample_phase(dev, card, model_seed=0):
    """Frames -> the loader's group sampler -> the shipped refine at B = IMS
    x slots (see 5c in the module docstring); returns the refine's launch
    counts."""
    from catre_tpu_torch import ops
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, loader_config_from
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import loader as dl
    from catre_tpu_torch.entry import N_ITER, entry, example_frames
    from catre_tpu_torch.ops.sampling import (batch_ball_crop_candidates,
                                              batch_select_from_candidates)

    shipped = load_config(str(FLAGSHIP_CONFIG))
    lcfg = loader_config_from(shipped, "test")
    ims, m = int(shipped.TEST.IMS_PER_BATCH), lcfg.max_objs_per_image
    f = example_frames(ims, 480, 640, m=m, seed=0)
    h, w = f["depth"].shape[1:]
    host = [f[k] for k in ("depth", "K", "packed", "poses", "scales", "mask_bbox")]
    d = [dl.to_device(a, dev) for a in host]
    auto = dl.auto_sample_window(f["records"], "test")
    cpu_gen = torch.Generator().manual_seed(0)
    log("sample", f"{ims} frames {h}x{w}, {int(f['n_objs'].sum())} objects in {ims * m} slots, "
                  f"NUM_PCL {lcfg.num_pcl}, ratio {lcfg.depth_sample_ball_ratio}, auto window "
                  f"{auto} (SAMPLE_WINDOW {lcfg.sample_window})")
    times = {}
    for tag, ws in (("auto", auto), (str(SAMPLE_FIXED_WINDOW), SAMPLE_FIXED_WINDOW)):
        cfg = dataclasses.replace(lcfg, sample_window=ws)
        pri = torch.rand(ims, m, ws * ws, generator=cpu_gen)
        cpu = dl.make_group_sampler(cfg, False, device="cpu")(*host, priorities=pri)
        pri = pri.to(dev)
        card_out = dl.make_group_sampler(cfg, False, device=dev)(*host, priorities=pri)
        same_outputs(f"window {tag}: card vs CPU", card_out, cpu)
        fused = dl.sample_group_from_depth(cfg, *d, priorities=pri)
        same_outputs(f"window {tag}: fused vs group sampler", fused, card_out)
        same_outputs(f"window {tag}: materialized vs fused",
                     dl.sample_group_from_cloud(cfg, False, *d[:5], priorities=pri), fused)
        cand_args = (d[0], d[1], d[2], d[5], d[3], d[4], cfg.depth_sample_ball_ratio, ws)
        cand = batch_ball_crop_candidates(*cand_args)
        same_outputs(f"window {tag}: candidates + select vs fused",
                     batch_select_from_candidates(*cand, cfg.num_pcl, w, ws, priorities=pri),
                     fused)
        rows = check_draws(f"window {tag}", cfg, d, torch.Generator(device=dev).manual_seed(1))
        log("sample", f"window {tag} ({ws}): card = CPU (indices, n_inside, points bit-equal), "
                      f"fused = materialized = candidates + select; own draws: {rows[0]} rows "
                      f"with >= {cfg.num_pcl} inside (no repeats), {rows[1]} scarce (cycling), "
                      f"{rows[2]} empty (index 0 repeated)")
        if rows[1] == 0:
            raise RuntimeError(f"sample window {tag}: no scarce row to check the cycling on")
        times[f"fused {tag}"] = time_ms(lambda: dl.sample_group_from_depth(cfg, *d,
                                                                           priorities=pri))
        times[f"materialized {tag}"] = time_ms(
            lambda: dl.sample_group_from_cloud(cfg, False, *d[:5], priorities=pri))
        times[f"candidates {tag}"] = time_ms(lambda: batch_ball_crop_candidates(*cand_args))
        times[f"select {tag}"] = time_ms(
            lambda: batch_select_from_candidates(*cand, cfg.num_pcl, w, ws, priorities=pri))
        del cpu, card_out, fused, cand, pri

    cfg0 = dataclasses.replace(lcfg, sample_window=0)
    k = SAMPLE_FULL_FRAME_IMS
    pri = torch.rand(k, m, h * w, generator=cpu_gen)
    same_outputs("full frame: card vs CPU",
                 dl.make_group_sampler(cfg0, False, device=dev)(*[a[:k] for a in host],
                                                                priorities=pri.to(dev)),
                 dl.make_group_sampler(cfg0, False, device="cpu")(*[a[:k] for a in host],
                                                                  priorities=pri))
    log("sample", f"full frame, {k} images: card = CPU (indices, n_inside, points bit-equal)")
    del pri
    gen = torch.Generator(device=dev).manual_seed(2)
    times["materialized full frame"] = time_ms(
        lambda: dl.sample_group_from_cloud(cfg0, False, *d[:5], generator=gen), iters=3, warmup=1)

    # the path a user runs: host frames -> group sampler (own draws) -> shipped refine
    cfg = dataclasses.replace(lcfg, sample_window=auto)
    sampler = dl.make_group_sampler(cfg, False, device=dev)
    b = ims * m
    refine, args = entry(dev, batch_size=b, seed=model_seed)
    kps, mean_scales = args[1], args[5]
    K = torch.from_numpy(f["K"]).to(dev).repeat_interleave(m, dim=0)
    poses = d[3].reshape(b, 3, 4)
    scales = d[4].reshape(b, 3)

    def sample_and_refine():
        pcl, _, _ = sampler(*host, generator=gen)
        return refine(pcl.reshape(b, lcfg.num_pcl, 3), kps, poses, scales, K, mean_scales)

    sample_and_refine()                                  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SAMPLE_CALLS):
        out_poses, out_scales = sample_and_refine()
    end.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {**dict.fromkeys(counts, 0), "dense_relu_dense_max": N_ITER * SAMPLE_CALLS,
            "dense_relu_max": 2 * N_ITER * SAMPLE_CALLS, "rot_head": N_ITER * SAMPLE_CALLS}
    if counts != want:
        raise RuntimeError(f"sample + refine: launches {counts}, want {want}")
    if out_poses.shape != (N_ITER + 1, b, 3, 4) or not (torch.isfinite(out_poses).all()
                                                       and torch.isfinite(out_scales).all()):
        raise RuntimeError("sample + refine: poses or scales not finite, or of a wrong shape")
    ms = start.elapsed_time(end) / SAMPLE_CALLS
    for name, t in times.items():
        log("sample", f"{name}: {t:.4f} ms per {ims}-image group | {card}")
    log("sample", f"sample (window {auto}, own draws, from host frames) + shipped refine, "
                  f"B={b}: {ms:.3f} ms/call, {b / ms * 1e3:.1f} obj/s, launches per call "
                  f"{ {k: v // SAMPLE_CALLS for k, v in counts.items() if v} } | {card}")
    del d, out_poses, out_scales
    torch.cuda.empty_cache()
    return counts


def same_batches(tag, card, ref):
    """Loader batches equal: the same images, host fields and clouds bit for
    bit (the clouds on any device)."""
    if len(card) != len(ref):
        raise RuntimeError(f"loader {tag}: {len(card)} batches, want {len(ref)}")
    for i, (a, b) in enumerate(zip(card, ref)):
        if a["scene_im_ids"] != b["scene_im_ids"] or set(a) != set(b):
            raise RuntimeError(f"loader {tag}: batch {i} holds other images or fields")
        for k in set(a) - {"pcl", "scene_im_ids", "file_names"}:
            if a[k].dtype != b[k].dtype or not (a[k] == b[k]).all():
                raise RuntimeError(f"loader {tag}: batch {i} field {k} differs")
        same_outputs(f"{tag} batch {i}", [a["pcl"]], [b["pcl"]])


def write_split(root):
    """Phase 5d's split of LOADER_FRAMES frames of 480 x 640 under `root`,
    which phases 5e-5f and 7c read too; -> the records."""
    from catre_tpu_torch.data import loader as dl
    from catre_tpu_torch.entry import write_example_split

    t0 = time.perf_counter()
    records = write_example_split(root, LOADER_FRAMES)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in records[:LOADER_DECODE_FRAMES]:
        dl.load_depth(r["depth_file"])
    decode_ms = (time.perf_counter() - t0) / LOADER_DECODE_FRAMES * 1e3
    n_objs = sum(len(r["annotations"]) for r in records)
    log("loader", f"wrote {LOADER_FRAMES} frames 480x640 ({n_objs} objects) in {write_s:.1f} s; "
                  f"png.py decode {decode_ms:.3f} ms a depth frame (one thread)")
    return records


def loader_phase(dev, card, records, keep, model_seed=0):
    """The split on disk -> the shipped test loader -> the shipped refine (see
    5d in the module docstring); returns the refine's launch counts over the
    warm passes. 5f's tables are copied under `keep`/5f for phase 8."""
    import numpy as np

    from catre_tpu_torch import ops
    from catre_tpu_torch.data import loader as dl
    from catre_tpu_torch.entry import N_ITER, entry, loader_refine_args, shipped_test_loader

    table = np.random.default_rng(model_seed).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    table_dev = torch.from_numpy(table).to(dev)
    n_objs = sum(len(r["annotations"]) for r in records)
    # the shipped path: device cache, frozen plan, presampled candidates
    kw = dict(mean_points=table, ship_mean_points=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader = shipped_test_loader(records, dev, **kw)
    build_s = time.perf_counter() - t0
    ims, m = loader.ims_per_batch, loader.cfg.max_objs_per_image
    b = ims * m
    refine, _ = entry(dev, batch_size=b, seed=model_seed)

    def run_pass(ld, keep=0):
        """Every batch through the refine; -> (s, batches, the first `keep` batches)."""
        kept, n = [], 0
        start = time.perf_counter()
        for batch in ld:
            poses, scales = refine(*loader_refine_args(batch, table_dev))
            if poses.shape != (N_ITER + 1, b, 3, 4) or not (torch.isfinite(poses).all()
                                                           and torch.isfinite(scales).all()):
                raise RuntimeError("loader + refine: poses or scales not finite, or of a "
                                   "wrong shape")
            if len(kept) < keep:
                kept.append(dict(batch, pcl=batch["pcl"].clone()))
            n += 1
        torch.cuda.synchronize()
        return time.perf_counter() - start, n, kept

    cold_s, n_batches, _ = run_pass(loader)
    if ims not in loader._plan_store or not loader._cand_store:
        raise RuntimeError("loader: the shipped path did not take the frozen plan and the "
                           "presampled candidates")
    want_batches = -(-LOADER_FRAMES // ims)
    if n_batches != want_batches:
        raise RuntimeError(f"loader: {n_batches} batches, want {want_batches}")
    log("loader", f"cold: device cache {build_s:.3f} s (decode in {loader.num_workers} "
                  f"threads, {loader.device_cache_gb():.3f} GB), first pass (plan, "
                  f"candidates {loader.candidates_gb():.3f} GB, {n_batches} batches of "
                  f"B={b}) {cold_s:.3f} s; window {loader.cfg.sample_window}")
    ops.reset_launch_counts()
    warm = []
    for _ in range(LOADER_WARM_PASSES):
        loader.reset_stream()
        s, _, kept = run_pass(loader, keep=LOADER_CPU_GROUPS)
        warm.append(s)
    counts = ops.launch_counts()
    calls = LOADER_WARM_PASSES * n_batches
    want = {**dict.fromkeys(counts, 0), "dense_relu_dense_max": N_ITER * calls,
            "dense_relu_max": 2 * N_ITER * calls, "rot_head": N_ITER * calls}
    if counts != want:
        raise RuntimeError(f"loader + refine: launches {counts}, want {want}")
    for i, s in enumerate(warm):
        log("loader", f"warm pass {i + 1} (frozen, presampled, own draws) + shipped refine: "
                      f"{s:.4f} s, {LOADER_FRAMES * m / s:.1f} obj/s ({n_objs / s:.1f} "
                      f"real objects/s) | {card}")

    # the card against the CPU loader on the first groups, the loader's own draws
    cpu = shipped_test_loader(records[:LOADER_CPU_GROUPS * ims], "cpu", cache_decoded="",
                              sample_window=loader.cfg.sample_window, **kw)
    same_batches("card vs CPU", kept, list(cpu))
    log("loader", f"card = CPU on the first {LOADER_CPU_GROUPS} groups (host fields, "
                  "indices, clouds bit for bit)")

    # uncached: decode threads, pinned buffers on a side stream, two groups in flight
    unc = shipped_test_loader(records, dev, cache_decoded="", num_workers=LOADER_WORKERS,
                              sample_window=loader.cfg.sample_window, **kw)
    run_pass(unc)                                       # warm the uploader's buffers
    unc.reset_stream()
    unc_s, _, _ = run_pass(unc)
    log("loader", f"uncached pass ({LOADER_WORKERS} threads, pinned, side stream) + shipped "
                  f"refine: {unc_s:.4f} s, {LOADER_FRAMES * m / unc_s:.1f} obj/s | {card}")
    sub = records[:LOADER_SERIAL_GROUPS * ims]
    piped = shipped_test_loader(sub, dev, cache_decoded="", num_workers=LOADER_WORKERS,
                                sample_window=loader.cfg.sample_window, **kw)
    piped_batches = [dict(x, pcl=x["pcl"].clone()) for x in piped]
    piped.reset_stream()
    same_batches("pipelined vs serial", piped_batches, list(piped.iter_serial()))
    log("loader", f"pipelined = serial over {LOADER_SERIAL_GROUPS} groups (pinned slots "
                  "reused from the third)")
    del loader, unc, piped
    counts_eval = evaluate_phase(dev, card, records, table, model_seed)
    counts_test = do_test_phase(dev, card, records, table, keep, model_seed)
    # the registry holds the device caches and the candidates (1.5 GB each): later phases
    # measure peaks
    del table_dev
    dl.clear_decoded_caches()
    torch.cuda.empty_cache()
    return counts, counts_eval, counts_test


def same_predictions(tag, got, ref):
    """Two evaluators' predictions equal: the same images at every iteration,
    every array of the same dtype and bits."""
    if len(got) != len(ref):
        raise RuntimeError(f"evaluate {tag}: {len(got)} iterations, want {len(ref)}")
    for it, (a, b) in enumerate(zip(got, ref)):
        if sorted(a) != sorted(b) or not a:
            raise RuntimeError(f"evaluate {tag}: iteration {it} holds other images")
        for sid in a:
            for k, x in a[sid].items():
                y = b[sid][k]
                if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                    raise RuntimeError(f"evaluate {tag}: iteration {it} {sid} {k} differs")


def evaluate_phase(dev, card, records, table, model_seed=0):
    """The split of 5d -> `entry.evaluate_split` (see 5e in the module
    docstring); returns the launch counts of the timed pass."""
    import itertools

    import numpy as np

    from catre_tpu_torch import ops
    from catre_tpu_torch.engine.refiner import make_refine_fn
    from catre_tpu_torch.entry import (N_ITER, evaluate_split, flagship_config,
                                       shipped_test_loader)
    from catre_tpu_torch.eval.evaluator import CATREEvaluator, run_inference
    from catre_tpu_torch.models.catre import init_model

    n_objs = sum(len(r["annotations"]) for r in records)
    shipped = shipped_test_loader(records, dev, mean_points=table, ship_mean_points=False)
    ims, m = shipped.ims_per_batch, shipped.cfg.max_objs_per_image
    cfg = flagship_config(num_pcl=shipped.cfg.num_pcl, num_kps=shipped.cfg.num_kps)
    del shipped
    evaluate_split(records, dev, table, model_seed, compute_probe_every=0)      # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats, results = evaluate_split(records, dev, table, model_seed, warmup=0,
                                    compute_probe_every=0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_ims = stats["images"]
    if n_ims != LOADER_FRAMES:
        raise RuntimeError(f"evaluate: {n_ims} images scored, want {LOADER_FRAMES}")
    calls = -(-LOADER_FRAMES // ims)
    want = {**dict.fromkeys(counts, 0), "dense_relu_dense_max": N_ITER * calls,
            "dense_relu_max": 2 * N_ITER * calls, "rot_head": N_ITER * calls}
    if counts != want:
        raise RuntimeError(f"evaluate: launches {counts}, want {want}")
    if sorted(results) != list(range(N_ITER + 1)) or not all(
            np.isfinite(v) for r in results.values() for v in r["summary"].values()):
        raise RuntimeError("evaluate: an iteration's table is missing or not finite")
    present = sorted({a["category_id"] + 1 for r in records for a in r["annotations"]})
    iou_aps, pose_aps = results[0]["iou_aps"], results[0]["pose_aps"]
    at_init = {c: [iou_aps[c, 1], iou_aps[c, 2], iou_aps[c, 3], pose_aps[c, 0, 0],
                   pose_aps[c, -1, 0]] for c in present}
    if not present or not all(v >= 1.0 - AP_EXACT for vs in at_init.values() for v in vs):
        raise RuntimeError(f"evaluate: iteration 0 (init = gt) below 100 on a present class: "
                           f"{at_init}")
    s = stats["total_s"]
    log("evaluate", f"timed pass (no probe, prefetch 2): {n_ims} images in {s:.4f} s, "
                    f"{n_ims / s:.1f} images/s, {n_ims * m / s:.1f} slot obj/s, {n_objs / s:.1f} "
                    f"real obj/s; overlap_fetch_s_per_img {stats['overlap_fetch_s_per_img']:.6f}, "
                    f"process_s_per_img {stats['process_s_per_img']:.6f}; evaluate() over "
                    f"{N_ITER + 1} iterations {stats['score_s']:.3f} s; peak {peak:.2f} GiB; "
                    f"launches per batch { {k: v // calls for k, v in counts.items() if v} } "
                    f"| {card}")
    log("evaluate", f"iteration 0: 100 on IoU25/50/75, re5te2, te2 for the classes {present}; "
                    f"iteration {N_ITER} summary "
                    f"{ {k: round(float(v), 2) for k, v in results[N_ITER]['summary'].items()} }")
    stats, _ = evaluate_split(records, dev, table, model_seed)
    log("evaluate", f"probed pass (every 8th batch after 1 of warm-up): compute_s_per_img "
                    f"{stats['compute_s_per_img']:.6f}, overlap_fetch_s_per_img "
                    f"{stats['overlap_fetch_s_per_img']:.6f}, process_s_per_img "
                    f"{stats['process_s_per_img']:.6f}, {stats['images']} images timed | {card}")

    # prefetch 0 = 2, and the two input paths, on the shipped loader and refine
    refine = make_refine_fn(init_model(cfg, seed=model_seed, device=dev), N_ITER)

    def preds(n_groups=None, ship=False, **kw):
        ld = shipped_test_loader(records, dev, mean_points=table, ship_mean_points=ship)
        ev = CATREEvaluator(records, n_iters=N_ITER)
        src = ld if n_groups is None else itertools.islice(ld, n_groups)
        run_inference(refine, src, ev, N_ITER, warmup=0, compute_probe_every=0,
                      mean_table=table, device=dev, **kw)
        return ev._preds

    same_predictions("prefetch 0 vs 2", preds(prefetch=0), preds(prefetch=2))
    same_predictions("host select_kps vs packed",
                     preds(EVAL_PATH_GROUPS, ship=True, use_mean_table=False),
                     preds(EVAL_PATH_GROUPS))
    log("evaluate", f"predictions bit-equal (dtypes too): prefetch 0 = 2 over the split; packed "
                    f"= host select_kps on the first {EVAL_PATH_GROUPS} groups")

    rng = np.random.default_rng(0)
    noisy = [dict(r, annotations=[dict(a, pose_est=a["pose_est"].copy()) for a in r["annotations"]])
             for r in records[:EVAL_NOISY_FRAMES]]
    for r in noisy:                  # the ground truth stays: gt_annotations keeps the originals
        for a in r["annotations"]:
            a["pose_est"][:, 3] += rng.normal(0, EVAL_NOISE_M, 3).astype(np.float32)
    _, res = evaluate_split(noisy, dev, table, model_seed, warmup=0, compute_probe_every=0)
    te2 = res[0]["summary"]["te2"]
    if not te2 < 100.0:
        raise RuntimeError(f"evaluate: a perturbed init scores te2 {te2} at iteration 0")
    log("evaluate", f"perturbed init ({EVAL_NOISY_FRAMES} frames, N(0, {EVAL_NOISE_M} m) on t): "
                    f"iteration 0 te2 {te2:.2f}, IoU75 {res[0]['summary']['IoU75']:.2f}")
    return counts


def reference_layout(sd):
    """A state dict of the port -> the reference's layout (Conv1d weights
    (out, in, 1), a rotation head's [conv, GN, GELU] list with layer 0 joined,
    conv_p; the TS head's [Linear, GN, GELU] list): the key map of
    `utils/checkpoint.py` read backwards, for this check only."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "rot_head":
            head, rest = ".".join(parts[:2]), parts[2:]
            if rest[0] == "layer0_global_weight":
                w = torch.cat([v, sd[f"{head}.layer0_point_weight"]], dim=1)
                out[f"{head}.layers.0.weight"] = w[:, :, None]
            elif rest[0] == "layer0_bias":
                out[f"{head}.layers.0.bias"] = v
            elif rest[0] in ("gns", "layers"):
                i = 3 * int(rest[1]) + (1 if rest[0] == "gns" else 3)
                out[f"{head}.layers.{i}.{rest[2]}"] = v[:, :, None] if v.dim() == 2 else v
            elif rest[0] == "neck":
                out[f"{head}.neck.0.{rest[1]}"] = v[:, :, None] if v.dim() == 2 else v
            elif rest[0] == "point_weight":
                out[f"{head}.conv_p.weight"] = v.reshape(1, -1, 1)
            elif rest[0] == "point_bias":
                out[f"{head}.conv_p.bias"] = v
        elif parts[0] == "ts_head" and parts[1] in ("linears", "gns"):
            out[f"ts_head.linears.{3 * int(parts[2]) + (parts[1] == 'gns')}.{parts[3]}"] = v
        else:    # pcl_net's convs are Conv1d; its fc layers and fc_t / fc_s are Linear
            out[k] = v[:, :, None] if ".conv" in k and v.dim() == 2 else v
    return out


def cli_workspace(work, records, table):
    """A data root under `work` holding the mean-shape table as its pickle,
    and the records' init estimates as an init-pose JSON; -> the JSON's path."""
    import pickle

    import numpy as np

    from catre_tpu_torch.data import meta

    meta.set_data_root(os.path.join(work, "data"))
    os.makedirs(meta.MODEL_DIR)
    with open(meta.CR_MEAN_MODEL_PATH, "wb") as f:
        pickle.dump({meta.ID2OBJ[i + 1]: table[i] for i in range(6)}, f)
    init_file = os.path.join(work, "init_poses.json")
    with open(init_file, "w") as f:
        json.dump({r["scene_im_id"]: [
            {"obj_id": a["category_id"] + 1, "pose_est": np.asarray(a["pose_est"]).tolist(),
             "scale_est": np.asarray(a["scale_est"]).tolist(), "score": a["score"],
             "bbox_est": [float(x) for x in a["bbox_est"]],
             "segmentation": {"counts": [int(c) for c in a["segmentation"]["counts"]],
                              "size": list(a["segmentation"]["size"])}}
            for a in r["annotations"]] for r in records}, f)
    return init_file


def do_test_phase(dev, card, records, table, keep, model_seed=0):
    """The split of 5d through `main --eval-only` (see 5f in the module
    docstring); returns the launch counts of its three runs. The native run's
    tables are copied to `keep`/5f."""
    import pickle
    import shutil

    import numpy as np

    from catre_tpu_torch import main as cli
    from catre_tpu_torch import ops
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.entry import N_ITER, evaluate_split, flagship_config
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.tools import convert_checkpoint
    from catre_tpu_torch.utils.checkpoint import save_checkpoint

    shipped = load_config(str(FLAGSHIP_CONFIG))
    name, ims = shipped.DATASETS.TEST[0], int(shipped.TEST.IMS_PER_BATCH)
    old_root = meta.DATA_ROOT
    total = None
    with tempfile.TemporaryDirectory(prefix="catre_do_test_") as work:
        init_file = cli_workspace(work, records, table)
        nocs.register_dataset(name, lambda: [dict(r) for r in records])

        # the reference: evaluate_split on the records with the same init poses (the
        # JSON orders each image's objects by class, as load_init_poses_into_dataset does)
        ref_records = nocs.load_init_poses_into_dataset([dict(r) for r in records], init_file)
        evaluate_split(ref_records, dev, table, model_seed, warmup=0, compute_probe_every=0,
                       output_dir=os.path.join(work, "ref"))
        with open(os.path.join(work, "ref", "predictions.pkl"), "rb") as f:
            ref = pickle.load(f)

        model = init_model(flagship_config(), seed=model_seed)
        save_checkpoint(os.path.join(work, "ckpt"), 0, {"model": model})
        pth = os.path.join(work, "model_final.pth")
        torch.save({"model": reference_layout(model.state_dict())}, pth)
        convert_checkpoint.main([pth, os.path.join(work, "converted")])
        present = sorted({a["category_id"] + 1 for r in records for a in r["annotations"]})
        calls = -(-LOADER_FRAMES // ims)
        runs = (("native", os.path.join(work, "ckpt")),
                ("converted", os.path.join(work, "converted")), ("pth", pth))
        for tag, weights in runs:
            out_dir = os.path.join(work, "out_" + tag)
            # main's INFO lines go to this file, not to the check's output
            quiet = logging.StreamHandler(open(os.path.join(work, f"log_{tag}.txt"), "w"))
            logging.getLogger().addHandler(quiet)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                res = cli.main(["--config-file", str(FLAGSHIP_CONFIG), "--eval-only",
                                f"OUTPUT_DIR={out_dir}", f"MODEL.WEIGHTS={weights}",
                                "MODEL.LOAD_POSES_TEST=True",
                                f"DATASETS.INIT_POSE_FILES_TEST=('{init_file}',)"])[name]
            finally:
                wall = time.perf_counter() - t0
                for h in [quiet, *cli._HANDLERS]:
                    logging.getLogger().removeHandler(h)
                    h.close()
                cli._HANDLERS.clear()
            counts = ops.launch_counts()
            want = {**dict.fromkeys(counts, 0), "dense_relu_dense_max": N_ITER * calls,
                    "dense_relu_max": 2 * N_ITER * calls, "rot_head": N_ITER * calls}
            if counts != want:
                raise RuntimeError(f"do_test {tag}: launches {counts}, want {want}")
            total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
            with open(os.path.join(out_dir, "predictions.pkl"), "rb") as f:
                got = pickle.load(f)
            if len(got[0]) != LOADER_FRAMES or not os.path.exists(
                    os.path.join(out_dir, "config_dump.py")):
                raise RuntimeError(f"do_test {tag}: {len(got[0])} images scored, or no "
                                   "config_dump.py")
            same_predictions(f"do_test {tag} vs evaluate_split", got, ref)
            if tag == "native":
                os.makedirs(os.path.join(keep, "5f"))
                for i in range(N_ITER + 1):
                    shutil.copy(os.path.join(out_dir, f"metrics_tab_iter{i}.txt"),
                                os.path.join(keep, "5f"))
                shutil.copy(os.path.join(work, "ref", "predictions.pkl"),
                            os.path.join(keep, "5f", "evaluate_split_predictions.pkl"))
            iou_aps, pose_aps = res["results"][0]["iou_aps"], res["results"][0]["pose_aps"]
            at_init = [v for c in present for v in (iou_aps[c, 1], iou_aps[c, 2], iou_aps[c, 3],
                                                     pose_aps[c, 0, 0], pose_aps[c, -1, 0])]
            if not all(v >= 1.0 - AP_EXACT for v in at_init):
                raise RuntimeError(f"do_test {tag}: iteration 0 (init = gt) below 100")
            st = res["stats"]
            log("do_test", f"main --eval-only, MODEL.WEIGHTS {tag}: {len(got[0])} images, "
                           f"inference pass {st['total_s']:.4f} s = "
                           f"{LOADER_FRAMES / st['total_s']:.1f} images/s, the whole run "
                           f"{wall:.2f} s, weights loaded in {st['load_s']:.4f} s; launches "
                           f"per batch { {k: v // calls for k, v in counts.items() if v} }; "
                           f"predictions bit-equal to evaluate_split's, iteration 0 at 100 "
                           f"on {present} | {card}")
        nocs._DATASET_REGISTRY.pop(name)
        meta.set_data_root(old_root)
    return total


def do_train_phase(card, records, per_step, ms_7c, keep):
    """Phase 7d: the split of 5d trained through `main` without --eval-only,
    then resumed from a middle checkpoint (see 7d in the module docstring);
    -> (the launch counts of both runs, the median ms an iteration at the full
    refine count). The straight run's metrics.json and log.txt are copied to
    `keep`/7d."""
    import shutil
    import statistics

    import numpy as np

    from catre_tpu_torch import main as cli
    from catre_tpu_torch import ops
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.engine import runner
    from catre_tpu_torch.entry import N_ITER
    from catre_tpu_torch.utils import checkpoint as ckpt

    shipped = load_config(str(FLAGSHIP_CONFIG))
    per_epoch = len(records) // int(shipped.SOLVER.IMS_PER_BATCH)
    n_iters = TRAIN_CLI_EPOCHS * per_epoch
    n_train = int(shipped.MODEL.CATRE.N_ITER_TRAIN)
    warm = int(shipped.MODEL.CATRE.N_ITER_TRAIN_WARM_EPOCH)

    def n_at(it):             # the warm-up's refine count at iteration it
        return min(n_train, max(1, int(n_train * (it // per_epoch + 1) / warm)))

    calls = -(-len(records) // int(shipped.TEST.IMS_PER_BATCH))
    per_eval = {"dense_relu_dense_max": N_ITER * calls, "dense_relu_max": 2 * N_ITER * calls,
                "rot_head": N_ITER * calls}

    def want(iters, n_evals):
        total = dict.fromkeys(ops.launch_counts(), 0)
        for it in iters:
            for k, v in per_step.items():
                total[k] += v * n_at(it) // N_ITER
        for k, v in per_eval.items():
            total[k] += n_evals * v
        return total

    # measurement only: the seconds of each checkpoint save, periodic evaluation
    # (and its launches) and train loader build
    seconds = {"save": [], "eval": [], "cold": []}
    save, do_test, loader_cls = ckpt.save_checkpoint, runner.do_test, runner.CATRELoader

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = save(*a, **k)
        seconds["save"].append(time.perf_counter() - t0)
        return out

    def timed_test(*a, **k):
        torch.cuda.synchronize()
        before, t0 = ops.launch_counts(), time.perf_counter()
        out = do_test(*a, **k)
        torch.cuda.synchronize()
        seconds["eval"].append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
        if got != per_eval:
            raise RuntimeError(f"do_train: a periodic evaluation launched {got}, want {per_eval}")
        return out

    def timed_loader(*a, **k):
        if k.get("phase") != "train":
            return loader_cls(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loader_cls(*a, **k)
        torch.cuda.synchronize()
        seconds["cold"].append(time.perf_counter() - t0)
        return out

    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    old_root = meta.DATA_ROOT
    names = (shipped.DATASETS.TRAIN[0], shipped.DATASETS.TEST[0])
    with tempfile.TemporaryDirectory(prefix="catre_do_train_") as work:
        init_file = cli_workspace(work, records, table)
        for name in names:
            nocs.register_dataset(name, lambda: [dict(r) for r in records])
        common = [f"SOLVER.TOTAL_EPOCHS={TRAIN_CLI_EPOCHS}",
                  f"SOLVER.WARMUP_ITERS={TRAIN_CLI_WARMUP}", "SOLVER.CHECKPOINT_PERIOD=1",
                  f"SOLVER.MAX_TO_KEEP={TRAIN_CLI_EPOCHS}", f"TEST.EVAL_PERIOD={TRAIN_CLI_EVAL}",
                  "TRAIN.PRINT_FREQ=1", "SEED=0", "MODEL.LOAD_POSES_TEST=True",
                  f"DATASETS.INIT_POSE_FILES_TEST=('{init_file}',)"]

        def run(out_dir, resume):
            quiet = logging.StreamHandler(open(out_dir + ".log", "w"))   # main's INFO lines
            logging.getLogger().addHandler(quiet)
            ckpt.save_checkpoint, runner.do_test, runner.CATRELoader = \
                timed_save, timed_test, timed_loader
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                state = cli.main(["--config-file", str(FLAGSHIP_CONFIG),
                                  *(["--resume"] if resume else []), f"OUTPUT_DIR={out_dir}",
                                  *common])
            finally:
                ckpt.save_checkpoint, runner.do_test, runner.CATRELoader = \
                    save, do_test, loader_cls
                for h in [quiet, *cli._HANDLERS]:
                    logging.getLogger().removeHandler(h)
                    h.close()
                cli._HANDLERS.clear()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(out_dir, "metrics.json")) as f:
                lines = {r["iteration"]: r for r in map(json.loads, f)}
            if not all(np.isfinite(v) for r in lines.values() for v in r.values()) or not all(
                    torch.isfinite(p).all() for p in state.params.values()):
                raise RuntimeError(f"do_train {out_dir}: non-finite metrics or parameters")
            return state, lines, ops.launch_counts(), wall, torch.cuda.max_memory_allocated()

        out = os.path.join(work, "straight")
        state, lines, counts, wall, peak = run(out, False)
        evals = n_iters // TRAIN_CLI_EVAL
        if sorted(lines) != list(range(n_iters)) or counts != want(range(n_iters), evals):
            raise RuntimeError(f"do_train: iterations {sorted(lines)}, launches {counts}, want "
                               f"{want(range(n_iters), evals)}")
        steps = sorted(ckpt._step_files(os.path.join(out, "ckpt")))
        if steps != list(range(per_epoch - 1, n_iters, per_epoch)):
            raise RuntimeError(f"do_train: checkpoints of steps {steps}")
        # "time" at iteration i + 1 is iteration i's wall; those at the warm-up's full
        # count without a checkpoint (and so without an evaluation) are the steady ones
        steady = [lines[i + 1]["time"] * 1e3 for i in range(n_iters - 1)
                  if n_at(i) == n_train and (i + 1) % per_epoch]
        loss0 = [lines[i]["iter0/loss_total"] for i in range(n_iters)]
        first = statistics.median(loss0[:TRAIN_CLI_LOSS_WINDOW])
        last = statistics.median(loss0[-TRAIN_CLI_LOSS_WINDOW:])
        mb = os.path.getsize(ckpt._step_files(os.path.join(out, "ckpt"))[steps[-1]]) / 2**20
        log("do_train", f"main without --eval-only on the shipped config, {len(records)} frames, "
                        f"{n_iters} iterations (n by epoch "
                        f"{[n_at(i) for i in range(0, n_iters, per_epoch)]}), {len(steps)} checkpoints, {evals} evaluations: "
                        f"{statistics.median(steady):.3f} ms an iteration at n = {n_train} "
                        f"(median of {len(steady)} without a checkpoint or an evaluation, "
                        f"{min(steady):.3f}-{max(steady):.3f}; phase 7c's step from disk "
                        f"{ms_7c:.3f}), checkpoint save {statistics.median(seconds['save']):.4f} s "
                        f"(median of {len(seconds['save'])}, {mb:.1f} MiB each), evaluations "
                        f"{[round(x, 3) for x in seconds['eval']]} s, train loader cold "
                        f"{seconds['cold'][0]:.3f} s, the whole run {wall:.2f} s, peak "
                        f"{peak / 2**30:.2f} GiB; launches "
                        f"{ {k: v for k, v in counts.items() if v} } (the warm-up's schedule "
                        f"and {evals} x {per_eval}) | {card}")
        os.makedirs(os.path.join(keep, "7d"))
        for f in ("metrics.json", "log.txt"):
            shutil.copy(os.path.join(out, f), os.path.join(keep, "7d"))
        fell = last < first
        log("do_train", f"iter0/loss_total median of the first {TRAIN_CLI_LOSS_WINDOW} "
                        f"iterations {first:.5f}, of the last {last:.5f}: "
                        f"{'falls' if fell else 'does NOT fall'}")
        if not fell:
            raise RuntimeError("do_train: iter0/loss_total did not fall")

        # the checkpoint of iteration TRAIN_CLI_RESUME alone in a fresh OUTPUT_DIR, --resume
        again = os.path.join(work, "resumed")
        os.makedirs(os.path.join(again, "ckpt"))
        shutil.copy(ckpt._step_files(os.path.join(out, "ckpt"))[TRAIN_CLI_RESUME],
                    os.path.join(again, "ckpt"))
        seconds["eval"].clear()
        state2, lines2, counts2, wall2, _ = run(again, True)
        resumed = range(TRAIN_CLI_RESUME + 1, n_iters)
        n_evals2 = n_iters // TRAIN_CLI_EVAL - (TRAIN_CLI_RESUME + 1) // TRAIN_CLI_EVAL
        if sorted(lines2) != list(resumed) or counts2 != want(resumed, n_evals2):
            raise RuntimeError(f"do_train --resume: iterations {sorted(lines2)}, launches "
                               f"{counts2}, want {want(resumed, n_evals2)}")
        rel, n_vals, bit_equal = 0.0, 0, True
        for i in resumed:
            for k, v in lines2[i].items():
                if "loss" in k:
                    ref = lines[i][k]
                    rel = max(rel, abs(v - ref) / max(abs(ref), 1e-12))
                    bit_equal &= v == ref
                    n_vals += 1
        p_err = max((state2.params[k] - p).abs().max().item() for k, p in state.params.items())
        log("do_train", f"--resume after iteration {TRAIN_CLI_RESUME} in a fresh OUTPUT_DIR: "
                        f"iterations {resumed.start}-{resumed.stop - 1} in {wall2:.2f} s, "
                        f"{n_vals} losses within rtol {rel:.3e} of the straight run's (limit "
                        f"{TRAIN_LOSS_RTOL:.0e}), bit-equal: {'yes' if bit_equal else 'no'}; final "
                        f"parameters {p_err:.3e} apart; launches "
                        f"{ {k: v for k, v in counts2.items() if v} }")
        if not rel <= TRAIN_LOSS_RTOL:
            raise RuntimeError("do_train --resume: the losses disagree with the straight run's")
        for name in names:
            nocs._DATASET_REGISTRY.pop(name)
        meta.set_data_root(old_root)
    del state, state2
    torch.cuda.empty_cache()
    return {k: counts[k] + counts2[k] for k in counts}, statistics.median(steady)


def dist_test_cfg(work, init_file, out_dir):
    """Phase 7e's do_test config: the shipped file on phase 5d's split, the
    seed-0 flagship weights in `work`/ckpt, the split's init JSON."""
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import apply_overrides, load_config

    return apply_overrides(load_config(str(FLAGSHIP_CONFIG)), [
        f"OUTPUT_DIR={out_dir}", f"MODEL.WEIGHTS={os.path.join(work, 'ckpt')}",
        "MODEL.LOAD_POSES_TEST=True", f"DATASETS.INIT_POSE_FILES_TEST=('{init_file}',)"])


def dist_train(dev, rows, **model_overrides):
    """Phase 7e's train half on this process: the flagship trainer of phase 7
    (seed 0, a global batch of TRAIN_B, `model_overrides` on the shipped
    config's model) on `rows` of its batch, one warm-up and TRAIN_STEPS
    timed steps, synced; -> {"metrics": each step's on the host, "ms" a
    timed step, "counts": each step's launches, "peak" GiB, "digest": the
    final parameters' sha256}, the first backward's gradients, the trainer."""
    import hashlib

    from catre_tpu_torch import ops
    from catre_tpu_torch.entry import flagship_trainer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = flagship_trainer(dev, batch_size=TRAIN_B, seed=0, **model_overrides)
    batch = {k: v[rows] for k, v in t.batch.items()}
    grads, hook = first_grads(t.step.model, t.step.optimizer)
    metrics, counts, times = [], [], []
    for _ in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        t.state, m = t.step(t.state, batch, t.generator, t.lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(ops.launch_counts())
        metrics.append({k: v.cpu().numpy().tolist() for k, v in m.items()})
    hook.remove()
    digest = hashlib.sha256(b"".join(p.detach().cpu().numpy().tobytes()
                                     for p in t.state.params.values())).hexdigest()
    return ({"metrics": metrics, "ms": sum(times[1:]) / TRAIN_STEPS * 1e3, "counts": counts,
             "peak": torch.cuda.max_memory_allocated() / 2**30, "digest": digest}, grads, t)


def dist_rank(dev, work, records, init_file, name):
    """Phase 7e on one process of the group (`parallel.launch` started it on
    the card): `dist_train` on its rows of the global batch in f32 and at the
    shipped bf16, the gradient all-reduce timed alone, then `do_test` on its
    share of phase 5d's split; writes `work`/rank<r>.json and the first
    gradients of both runs."""
    from catre_tpu_torch import ops
    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.engine import runner
    from catre_tpu_torch.parallel import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    meta.set_data_root(os.path.join(work, "data"))
    nocs.register_dataset(name, lambda: [dict(r) for r in records])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    n = TRAIN_B // world
    rows = slice(rank * n, (rank + 1) * n)
    out, grads = {}, {}
    out["f32"], grads["f32"], t = dist_train(dev, rows, dtype=None)
    del t
    out["bf16"], grads["bf16"], t = dist_train(dev, rows)
    # the bf16 step's gradient bucket, all-reduced alone
    params = list(t.state.params.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_REDUCE_CALLS):
        comm.all_reduce_grads_(params)
    torch.cuda.synchronize()
    out["reduce_ms"] = (time.perf_counter() - t0) / DIST_REDUCE_CALLS * 1e3
    out["n_grad"] = sum(p.grad.numel() for p in params if p.grad is not None)
    del t, params
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = runner.do_test(dist_test_cfg(work, init_file, os.path.join(work, "world2")),
                         device=dev)[name]
    torch.cuda.synchronize()
    out.update(test_s=time.perf_counter() - t0, test_counts=ops.launch_counts(),
               peak=torch.cuda.max_memory_allocated() / 2**30,
               summary={int(it): r["summary"] for it, r in res["results"].items()})
    if rank == 0:
        torch.save(grads, os.path.join(work, "grads.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dist_phase(dev, card, records, per_step, per_batch):
    """Phase 7e: DIST_WORLD processes on the one card through
    `parallel.launch` (gloo), against world 1 in this process (see 7e in the
    module docstring), with `per_step` launches a train step and `per_batch`
    a do_test batch; -> the launch counts of both worlds."""
    import pickle

    import numpy as np

    from catre_tpu_torch import ops
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.engine import runner
    from catre_tpu_torch.entry import N_ITER, flagship_config
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.parallel.comm import inference_slice
    from catre_tpu_torch.parallel.launch import launch
    from catre_tpu_torch.utils.checkpoint import save_checkpoint

    shipped = load_config(str(FLAGSHIP_CONFIG))
    name, ims = shipped.DATASETS.TEST[0], int(shipped.TEST.IMS_PER_BATCH)
    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    old_root = meta.DATA_ROOT
    with tempfile.TemporaryDirectory(prefix="catre_dist_") as work:
        init_file = cli_workspace(work, records, table)
        save_checkpoint(os.path.join(work, "ckpt"), 0, {"model": init_model(flagship_config(),
                                                                             seed=0)})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launch(dist_rank, (work, records, init_file, name), ["cuda:0"] * DIST_WORLD,
               timeout_s=DIST_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        grads2 = torch.load(os.path.join(work, "grads.pt"))

        # world 1 in this process on the same rows, weights and split
        world1, grads1 = {}, {}
        for dtype, overrides in (("f32", {"dtype": None}), ("bf16", {})):
            world1[dtype], grads1[dtype], t = dist_train(dev, slice(None), **overrides)
            del t
        torch.cuda.empty_cache()
        nocs.register_dataset(name, lambda: [dict(r) for r in records])
        ops.reset_launch_counts()
        res1 = runner.do_test(dist_test_cfg(work, init_file, os.path.join(work, "world1")),
                              device=dev)[name]
        torch.cuda.synchronize()
        test_counts1 = ops.launch_counts()
        preds = []
        for d in ("world2", "world1"):
            with open(os.path.join(work, d, "predictions.pkl"), "rb") as f:
                preds.append(pickle.load(f))
        nocs._DATASET_REGISTRY.pop(name)
        meta.set_data_root(old_root)

    # the train step: every rank's launches, the ranks alike, world 2 = world 1
    def step_errors(a, b):
        return [max(abs(x - y) / max(abs(y), 1e-12) for k in m1 for x, y in zip(m2[k], m1[k]))
                for m2, m1 in zip(a["metrics"], b["metrics"])]

    runs = [(f"rank {r} {dt}", out[dt]) for r, out in enumerate(ranks) for dt in ("f32", "bf16")]
    runs += [(f"world 1 {dt}", world1[dt]) for dt in ("f32", "bf16")]
    for who, run in runs:
        if any(c != {**dict.fromkeys(c, 0), **per_step} for c in run["counts"]):
            raise RuntimeError(f"phase 7e {who}: launches per step {run['counts']}, want "
                               f"{per_step}")
        if not all(np.isfinite(v).all() for m in run["metrics"] for v in m.values()):
            raise RuntimeError(f"phase 7e {who}: non-finite metrics")
    for dt in ("f32", "bf16"):
        if (ranks[0][dt]["digest"] != ranks[1][dt]["digest"]
                or ranks[0][dt]["metrics"] != ranks[1][dt]["metrics"]):
            raise RuntimeError(f"phase 7e {dt}: the two ranks' parameters or metrics differ")
    err = {dt: (step_errors(ranks[0][dt], world1[dt]), *grad_error(grads2[dt], grads1[dt]))
           for dt in ("f32", "bf16")}
    # in bf16 each world is one rounding of the f32 step: their distances from it, side by side
    off32 = {w: grad_error(g["bf16"], grads1["f32"]) for w, g in (("1", grads1), ("2", grads2))}
    bf, reduce_share = ranks[0]["bf16"], N_ITER * ranks[0]["reduce_ms"] / ranks[0]["bf16"]["ms"]
    log("dist", f"{DIST_WORLD} processes on one card (gloo), B={TRAIN_B} global at the shipped "
                f"flags, {1 + TRAIN_STEPS} steps, world 2 vs world 1 on the same rows: f32 "
                f"metrics max rel err by step {[float(f'{e:.3e}') for e in err['f32'][0]]} (rtol "
                f"{TRAIN_LOSS_RTOL:.0e}), first backward's gradients {err['f32'][1]:.3e} "
                f"({err['f32'][2]}; limit {TRAIN_GRAD_RTOL:.0e}); bf16 metrics "
                f"{[float(f'{e:.3e}') for e in err['bf16'][0]]}, gradients {err['bf16'][1]:.3e} "
                f"({err['bf16'][2]}); bf16 gradients from the f32 step's: world 1 "
                f"{off32['1'][0]:.3e} ({off32['1'][1]}), world 2 {off32['2'][0]:.3e} "
                f"({off32['2'][1]}); the ranks' parameters bit-equal; launches per step a rank "
                f"{ {k: v for k, v in per_step.items() if v} }")
    log("dist", f"bf16 {bf['ms']:.3f} / {ranks[1]['bf16']['ms']:.3f} ms a timed step on ranks 0 / "
                f"1 against world 1's {world1['bf16']['ms']:.3f} (ratio "
                f"{bf['ms'] / world1['bf16']['ms']:.4f}); f32 {ranks[0]['f32']['ms']:.3f} against "
                f"{world1['f32']['ms']:.3f}; gradient all-reduce ({ranks[0]['n_grad']} f32, one "
                f"bucket) {ranks[0]['reduce_ms']:.3f} ms alone, x{N_ITER} a step = "
                f"{reduce_share:.1%} of rank 0's bf16 step; peak a rank in bf16 training "
                f"{bf['peak']:.2f} / {ranks[1]['bf16']['peak']:.2f} GiB (world 1 "
                f"{world1['bf16']['peak']:.2f}), with do_test after it {ranks[0]['peak']:.2f} / "
                f"{ranks[1]['peak']:.2f}; the launch {launch_s:.1f} s | {card}")
    if not (max(err["f32"][0]) <= TRAIN_LOSS_RTOL and err["f32"][1] <= TRAIN_GRAD_RTOL
            and max(err["bf16"][0]) <= TOL[torch.bfloat16]
            and off32["2"][0] <= max(DIST_BF16_SLACK * off32["1"][0], TRAIN_GRAD_RTOL)):
        raise RuntimeError("phase 7e: world 2's train step disagrees with world 1's")

    # do_test: rank 1 scores nothing, rank 0 the gathered predictions as world 1 does
    n = len(records)
    calls = [-(-len(range(n)[inference_slice(n, r, DIST_WORLD)]) // ims)
             for r in range(DIST_WORLD)]
    for who, got_counts, n_calls in [*((f"rank {r}", out["test_counts"], calls[r])
                                       for r, out in enumerate(ranks)),
                                     ("world 1", test_counts1, -(-n // ims))]:
        want = {**dict.fromkeys(got_counts, 0), **{k: v * n_calls for k, v in per_batch.items()}}
        if got_counts != want:
            raise RuntimeError(f"phase 7e {who}: do_test launches {got_counts}, want {want}")
    if ranks[1]["summary"]:
        raise RuntimeError("phase 7e: rank 1's do_test scored")
    got, ref = preds
    bit_equal, gap = True, 0.0
    for it, (a, b) in enumerate(zip(got, ref)):
        if sorted(a) != sorted(b) or len(b) != n:
            raise RuntimeError(f"phase 7e do_test: iteration {it} holds other images")
        for sid in b:
            for k, y in b[sid].items():
                x = a[sid][k]
                bit_equal &= x.dtype == y.dtype and x.tobytes() == y.tobytes()
                if y.size:
                    gap = max(gap, float(np.abs(x.astype(np.float64) - y).max()
                                         / max(1.0, float(np.abs(y).max()))))
    pts = max(abs(ranks[0]["summary"][str(it)][k] - v) for it, r in res1["results"].items()
              for k, v in r["summary"].items())
    log("dist", f"do_test at world {DIST_WORLD} on phase 5d's {n} frames: ranks 0 / 1 "
                f"{ranks[0]['test_s']:.2f} / {ranks[1]['test_s']:.2f} s, {calls} batches (K1 "
                f"{N_ITER}, K2 {2 * N_ITER}, K3 {N_ITER} a batch), rank 1 returns no results; "
                f"rank 0's gathered predictions vs world 1's: bit-equal "
                f"{'yes' if bit_equal else 'no'}, max gap {gap:.3e} x max(1, |ref|) (bf16 limit "
                f"{TOL[torch.bfloat16]:.0e}), summaries {pts:.4f} points apart (limit "
                f"{DIST_SUMMARY_PTS})")
    if not (bit_equal or (gap <= TOL[torch.bfloat16] and pts <= DIST_SUMMARY_PTS)):
        raise RuntimeError("phase 7e: world 2's do_test disagrees with world 1's")
    counts = [c for out in ranks for dt in ("f32", "bf16") for c in out[dt]["counts"]]
    counts += [out["test_counts"] for out in ranks]
    counts += [c for dt in ("f32", "bf16") for c in world1[dt]["counts"]] + [test_counts1]
    return {k: sum(c[k] for c in counts) for k in test_counts1}


def write_pose_frame(base, R, t, s, model_name, inst=3, half=50):
    """A NOCS-format frame of one instance under the pose (R, t) and NOCS
    scale s: a curved surface of (2 half)^2 pixels around t's projection,
    its depth whole millimetres, its coordinate map (R^T (X - t) / s + 0.5)
    rounded to 8 bits, written by `data/png.py`; -> the intrinsics."""
    import numpy as np

    from catre_tpu_torch.data import meta, png

    K = meta.REAL_INTRINSICS.astype(np.float64)
    u0, v0 = np.round(K[:2] @ (t / t[2])).astype(int)
    vs, us = np.mgrid[v0 - half: v0 + half, u0 - half: u0 + half]
    xn, yn = (us - u0) / half, (vs - v0) / half
    z = np.round((t[2] + 0.08 * xn - 0.05 * yn + 0.06 * (xn ** 2 + yn ** 2)) * 1000) / 1000
    X = np.stack([(us - K[0, 2]) / K[0, 0] * z, (vs - K[1, 2]) / K[1, 1] * z, z], axis=-1)
    nocs = (X - t) @ R / s
    if np.abs(nocs).max() >= 0.5:
        raise ValueError("the surface leaves the NOCS cube")
    rgb = np.round((nocs + 0.5) * 255).astype(np.uint8)
    rgb[..., 2] = np.round((0.5 - nocs[..., 2]) * 255).astype(np.uint8)    # z flipped
    depth = np.zeros((meta.IM_HEIGHT, meta.IM_WIDTH), np.uint16)
    mask = np.zeros(depth.shape, np.uint8)
    coord = np.zeros(depth.shape + (3,), np.uint8)
    depth[vs, us] = np.round(z * 1000).astype(np.uint16)
    mask[vs, us] = inst
    coord[vs, us] = rgb[..., ::-1]                                         # BGR
    for suffix, img in (("depth", depth), ("mask", mask), ("coord", coord)):
        png.write_png(f"{base}_{suffix}.png", img)
    with open(base + "_meta.txt", "w") as f:
        f.write(f"{inst} 1 {model_name}\n")
    return K


def tools_phase(dev, card, per_step, per_call, ms_7d, keep):
    """Phase 8 (see the module docstring); -> the launch counts of the soak's
    two runs and the sampler study's."""
    import argparse
    import contextlib
    import io
    import pickle
    import statistics

    import numpy as np

    from catre_tpu_torch import ops
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import apply_overrides, load_config
    from catre_tpu_torch.data import loader as dl
    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.data.rle import rle_to_binary_mask
    from catre_tpu_torch.engine import runner
    from catre_tpu_torch.entry import N_ITER
    from catre_tpu_torch.geom.rotations import euler_to_mat
    from catre_tpu_torch.tools import (fps_sample, pose_data, prepare_init_results, repro_diff,
                                       sampler_spread, soak, synth_nocs, trainrun_report)
    from catre_tpu_torch.utils import checkpoint as ckpt

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.launch_counts(), 0)
    want_call = {k: v for k, v in per_call.items() if v}
    old_root, env_root = meta.DATA_ROOT, os.environ.pop("CATRE_DATA_ROOT", None)
    registered = set(nocs._DATASET_REGISTRY)
    work_dir = tempfile.TemporaryDirectory(prefix="catre_tools_")
    work = work_dir.name
    data = os.path.join(work, "data")
    quiet = logging.StreamHandler(open(os.path.join(work, "tools.log"), "w"))  # INFO lines
    logging.getLogger().addHandler(quiet)
    try:
        # the asset pickles under a data root of the phase's own, seeded
        meta.set_data_root(data)
        os.makedirs(meta.MODEL_DIR)
        rng = np.random.default_rng(8)
        table = rng.normal(size=(6, 1024, 3)).astype(np.float32) * 0.15
        models = {f"inst_{j}": rng.normal(size=(1024, 3)).astype(np.float32) * 0.1
                  for j in range(FPS_INSTANCES)}
        assets = {meta.CR_MEAN_MODEL_PATH: {meta.ID2OBJ[i + 1]: table[i] for i in range(6)},
                  meta.ABS_SCALE_PATH: {f"{o}_{i}_norm": rng.uniform(0.08, 0.3, 3)
                                        .astype(np.float32) for o in meta.OBJECTS
                                        for i in range(2)},
                  meta.TEST_MODEL_PATH: models}
        for path, obj in assets.items():
            with open(path, "wb") as f:
                pickle.dump(obj, f)

        # synth_nocs -> the port's test loader (the split is also the soak's real_train)
        real = os.path.join(data, "REAL")
        t0 = time.perf_counter()
        synth_nocs.generate_split(real, split="real_train", n_frames=TOOLS_FRAMES, n_objs=6,
                                  seed=0)
        gen_s = time.perf_counter() - t0
        nocs.register_dataset("nocs_tools_real_train", image_root=real, use_cache=False)
        dicts = sampler_spread.inject_fixed_init(nocs.get_dataset_dicts("nocs_tools_real_train"))
        with open(os.path.join(real, "real_train_list_all.txt")) as f:
            n_listed = len(f.read().split())
        loader = dl.CATRELoader(dicts, dl.LoaderConfig(aug_depth=False, sample_window=-1),
                                phase="test", ims_per_batch=16, device=dev)
        seen, n_obj = set(), 0          # a padding image of the trailing group has no id
        for batch in loader:
            pcl, valid = torch.as_tensor(batch["pcl"]), batch["valid"].astype(bool)
            if pcl.shape[1:] != (1024, 3) or not torch.isfinite(pcl).all():
                raise RuntimeError(f"tools: a test batch of the synthetic split: {pcl.shape}")
            m = len(valid) // len(batch["scene_im_ids"])
            for i, sid in enumerate(batch["scene_im_ids"]):
                if sid is not None and sid not in seen:
                    seen.add(sid)
                    n_obj += int(valid[i * m:(i + 1) * m].sum())
        n_img = len(seen)
        if not (len(dicts) == n_listed == n_img > 0 and n_obj >= n_img):
            raise RuntimeError(f"tools: {n_listed} frames listed, {len(dicts)} records, "
                               f"{n_img} images through the test loader")
        log("tools", f"synth_nocs wrote {n_listed} frames 480x640 in {gen_s:.2f} s "
                     f"({gen_s / n_listed * 1e3:.1f} ms a frame); the test loader read "
                     f"{n_img} images, {n_obj} objects, finite clouds")
        del loader
        dl.clear_decoded_caches()

        # pose_data: a known pose back by Umeyama and by PnP
        R = euler_to_mat(torch.tensor([[0.3, -0.4, 0.5]], dtype=torch.float64))[0].numpy()
        t, s_gt = np.array([0.05, -0.03, 0.9]), 0.45
        base = os.path.join(work, "pose_0000")
        K = write_pose_frame(base, R, t, s_gt, "bottle_0_norm")
        errs = {}
        for method in ("umeyama", "pnp"):
            lab = pose_data.process_frame(base, K, method=method,
                                          scale_factors={"bottle_0_norm": s_gt})
            errs[method] = max(abs(lab["scales"][0] - s_gt),
                               float(np.abs(lab["rotations"][0] - R).max()),
                               float(np.abs(lab["translations"][0] - t).max()))
        log("tools", f"pose_data on a written frame of a known pose: max error of s, R, t "
                     f"Umeyama {errs['umeyama']:.3e}, PnP (numpy EPnP) {errs['pnp']:.3e}, "
                     f"limit {POSE_TOL:.0e}")
        if not max(errs.values()) <= POSE_TOL:
            raise RuntimeError("tools: pose_data missed the written pose")

        # prepare_init_results: predictions -> init JSON -> the test records
        n = 4
        rots = euler_to_mat(torch.from_numpy(rng.uniform(-1, 1, (n, 3)))).numpy()
        s_nocs = rng.uniform(0.5, 1.5, n)
        RTs = np.tile(np.eye(4), (n, 1, 1))
        RTs[:, :3, :3] = s_nocs[:, None, None] * rots
        RTs[:, :3, 3] = rng.normal(size=(n, 3))
        preds = {"pred_RTs": RTs, "pred_scales": rng.uniform(0.2, 0.6, (n, 3)),
                 "pred_class_ids": np.array([1, 2, 3, 6]),
                 "pred_bboxes": rng.integers(0, 400, (n, 4)), "pred_scores": rng.uniform(size=n),
                 "gt_handle_visibility": np.array([1, 1, 1, 0])}
        masks = rng.uniform(size=(meta.IM_HEIGHT, meta.IM_WIDTH, n)) > 0.7
        for sub, obj in (("pose", preds), ("seg", {"masks": masks})):
            os.makedirs(os.path.join(work, sub))
            with open(os.path.join(work, sub, "results_test_scene_1_0000.pkl"), "wb") as f:
                pickle.dump(obj, f)
        init_json = os.path.join(work, "init", "init_poses.json")
        if prepare_init_results.main(["--pose-dir", os.path.join(work, "pose"), "--seg-dir",
                                      os.path.join(work, "seg"), "--out", init_json]) != 0:
            raise RuntimeError("tools: prepare_init_results failed")
        with open(init_json) as f:
            entries = json.load(f)["scene_1/0000"]
        pose_want = np.concatenate([rots, RTs[:, :3, 3:]], axis=2)
        scale_want = preds["pred_scales"] * s_nocs[:, None]
        err = max(max(np.abs(np.asarray(e["pose_est"]) - pose_want[i]).max(),
                      np.abs(np.asarray(e["scale_est"]) - scale_want[i]).max())
                  for i, e in enumerate(entries))
        same_masks = all(np.array_equal(rle_to_binary_mask(e["segmentation"]), masks[:, :, i])
                         for i, e in enumerate(entries))
        recs = nocs.load_init_poses_into_dataset([{"scene_im_id": "scene_1/0000"}], init_json)
        if not (len(entries) == n and err <= 1e-6 and same_masks
                and len(recs[0]["annotations"]) == n):
            raise RuntimeError(f"tools: prepare_init_results round trip: {len(entries)} entries, "
                               f"pose / scale error {err:.3e}, masks equal {same_masks}")
        log("tools", f"prepare_init_results: {n} predictions -> JSON -> "
                     f"load_init_poses_into_dataset, poses and scales within {err:.1e}, "
                     "masks equal after the RLE")

        # fps_sample on the card against the CPU
        out_pkl = os.path.join(work, "fps.pkl")
        sync()
        t0 = time.perf_counter()
        fps_sample.main(["--split", "test", "--num-points", str(FPS_POINTS), "--out", out_pkl,
                         "--device", dev.type])
        fps_s = time.perf_counter() - t0
        with open(out_pkl, "rb") as f:
            card_kps = pickle.load(f)
        cpu_kps = fps_sample.fps_keypoints(models, FPS_POINTS, "cpu")
        key = f"fps{FPS_POINTS}_and_center"
        if list(card_kps) != list(cpu_kps) or not all(
                np.array_equal(card_kps[k][key], cpu_kps[k][key]) for k in cpu_kps):
            raise RuntimeError("tools: fps_sample on the card differs from the CPU")
        log("tools", f"fps_sample: {len(models)} instances x {FPS_POINTS} points on the card "
                     f"in {fps_s:.3f} s (the CLI), the same points as on the CPU")

        # the soak: SOAK_EPOCHS iterations and one checkpoint, then --resume to the end
        soak_out = os.path.join(work, "soak")
        opts = ["TRAIN.PRINT_FREQ=1", f"TEST.EVAL_PERIOD={SOAK_EVAL}"]
        soak_cfg = soak.soak_config(argparse.Namespace(epochs=SOAK_EPOCHS, out=soak_out,
                                                       opts=opts))
        n_train = int(soak_cfg.MODEL.CATRE.N_ITER_TRAIN)
        warm = int(soak_cfg.MODEL.CATRE.N_ITER_TRAIN_WARM_EPOCH)
        per_epoch = max(TOOLS_FRAMES // int(soak_cfg.SOLVER.IMS_PER_BATCH), 1)
        eval_calls = -(-TOOLS_FRAMES_TEST // int(soak_cfg.TEST.IMS_PER_BATCH))

        def n_at(it):
            return min(n_train, max(1, int(n_train * (it // per_epoch + 1) / warm)))

        def want(iters, n_evals):
            w = dict.fromkeys(total, 0)
            for it in iters:
                for k, v in per_step.items():
                    w[k] += v * n_at(it) // N_ITER
            for k, v in per_call.items():
                w[k] += n_evals * eval_calls * v
            return w

        common = ["--data-root", data, "--out", soak_out, "--frames", str(TOOLS_FRAMES),
                  "--frames2", str(TOOLS_FRAMES2), "--frames-test", str(TOOLS_FRAMES_TEST),
                  "--device", dev.type, "--opts", *opts]
        walls, n_first, soak_counts = [], SOAK_EPOCHS * per_epoch, dict(total)
        for epochs, resume, iters in ((SOAK_EPOCHS, False, range(n_first)),
                                      (SOAK_EPOCHS + SOAK_MORE, True,
                                       range(n_first, n_first + SOAK_MORE * per_epoch))):
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            soak.main(["--epochs", str(epochs), *(["--resume"] if resume else []), *common])
            sync()
            walls.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            n_evals = sum((it + 1) % SOAK_EVAL == 0 for it in iters)
            if counts != want(iters, n_evals):
                raise RuntimeError(f"tools: soak launches {counts}, want {want(iters, n_evals)}")
            soak_counts = {k: soak_counts[k] + v for k, v in counts.items()}
            steps = sorted(ckpt._step_files(os.path.join(soak_out, "ckpt")))
            if steps[-1] != iters[-1] or (not resume and steps != [iters[-1]]):
                raise RuntimeError(f"tools: soak checkpoints {steps}")
        with open(os.path.join(soak_out, "metrics.json")) as f:
            lines = {r["iteration"]: r for r in map(json.loads, f)}
        last = n_first + SOAK_MORE * per_epoch
        if sorted(lines) != list(range(last)) or not all(
                np.isfinite(v) for r in lines.values() for v in r.values()):
            raise RuntimeError(f"tools: soak metrics of iterations {sorted(lines)}, or not finite")
        steady = [lines[i + 1]["time"] * 1e3 for i in range(n_first - 1)
                  if n_at(i) == n_train and (i + 1) % SOAK_EVAL]
        total = dict(soak_counts)
        log("tools", f"soak: {n_first} iterations (n {[n_at(i) for i in range(n_first)]}), one "
                     f"checkpoint and one evaluation in {walls[0]:.2f} s, --resume to "
                     f"iteration {last - 1} in {walls[1]:.2f} s; losses finite, last "
                     f"loss_total {lines[last - 1]['loss_total']:.5f}; "
                     f"{statistics.median(steady):.3f} ms an iteration at n = {n_train} "
                     f"(median of {len(steady)}, {min(steady):.3f}-{max(steady):.3f}; phase 7d "
                     f"{ms_7d:.3f}); launches { {k: v for k, v in soak_counts.items() if v} }, "
                     f"the warm-up's schedule (an iteration at n: K3 = K4 = n, K5 2n + 2n, K6 "
                     f"n + n) and the evaluation's {want_call} a refine call | {card}")

        # the sampler study on the soak's test split: arm A, then the dtype study
        calls = []
        make = sampler_spread.make_refine_fn

        def counted(model, n_iter):
            fn = make(model, n_iter)

            def refine(*a, **k):
                sync()
                before = ops.launch_counts()
                out = fn(*a, **k)
                sync()
                after = ops.launch_counts()
                calls.append((model.cfg.fused_heads,
                              {kk: v - before[kk] for kk, v in after.items() if v != before[kk]}))
                return out
            return refine

        spread = ["--out", os.path.join(work, "spread"), "--data-root", data, "--frames",
                  str(TOOLS_FRAMES_TEST), "--seeds", str(SPREAD_SEEDS), "--ref-seeds", "0",
                  "--device", dev.type]
        sampler_spread.make_refine_fn = counted
        try:
            for argv in (spread, spread + ["--dtype-arms", "f32,bf16_fused"]):
                calls.clear()
                ops.reset_launch_counts()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    report = sampler_spread.run_study(sampler_spread.parse_args(argv))
                wall = time.perf_counter() - t0
                total = {k: total[k] + v for k, v in ops.launch_counts().items()}
                runs = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[spread] ")
                        and "seed=" in ln]
                bad = [c for f, c in calls if c != (want_call if f else {})]
                if bad or not calls:
                    raise RuntimeError(f"tools: sampler_spread launches {bad} a refine call "
                                       f"(fused: {want_call}, plain: none)")
                if "--dtype-arms" not in argv:
                    if report["iter0_max_ptp"] != 0.0:
                        raise RuntimeError("tools: sampler_spread iteration 0 moved with the seed")
                    log("tools", f"sampler_spread arm A: {SPREAD_SEEDS} seeds on "
                                 f"{report['frames']} frames in {wall:.2f} s ({runs}); iter-0 "
                                 f"max ptp {report['iter0_max_ptp']}, IoU50 "
                                 f"{report['ours']['IoU50']['mean']:.2f} +- "
                                 f"{report['ours']['IoU50']['std']:.3f}; {len(calls)} refine "
                                 f"calls, each {want_call}")
                else:
                    d = report["delta_bf16_fused_vs_f32"]
                    log("tools", f"sampler_spread dtype arms f32,bf16_fused in {wall:.2f} s "
                                 f"({runs}); |dmean| bf16_fused vs f32: "
                                 f"{ {k: round(v['abs_dmean'], 3) for k, v in d.items()} }; "
                                 f"bf16_fused {sum(f for f, _ in calls)} calls each "
                                 f"{want_call}, f32 none | {card}")
        finally:
            sampler_spread.make_refine_fn = make

        # the run reports on phase 5f's tables and phase 7d's directory
        t5f, d7d = os.path.join(keep, "5f"), os.path.join(keep, "7d")
        summary = repro_diff.load_table_summary(t5f, N_ITER)
        with open(os.path.join(work, "ref_summary.json"), "w") as f:
            json.dump(summary, f)
        outs = []
        for mod, argv in ((repro_diff, [t5f, os.path.join(work, "ref_summary.json")]),
                          (trainrun_report, [d7d, "--log", os.path.join(d7d, "log.txt"),
                                             "--points", "5"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv)
            outs.append((rc, buf.getvalue()))
        deltas = outs[0][1].count("(delta +0.00)")
        if outs[0][0] != 0 or deltas != len(summary) or "parity OK" not in outs[0][1]:
            raise RuntimeError(f"tools: repro_diff of 5f's tables against themselves: rc "
                               f"{outs[0][0]}\n{outs[0][1]}")
        if outs[1][0] != 0 or "| iter |" not in outs[1][1]:
            raise RuntimeError(f"tools: trainrun_report on 7d: rc {outs[1][0]}\n{outs[1][1]}")
        ss = [ln for ln in outs[1][1].splitlines() if ln.startswith("steady-state")]
        ss = ss[0] if ss else "no steady-state line"
        log("tools", f"repro_diff of 5f's iteration-{N_ITER} table against itself: "
                     f"{deltas} metrics at delta 0, exit 0; trainrun_report on 7d: "
                     f"{len(outs[1][1].splitlines())} lines, {ss}")

        # an orbax directory of the JAX package in MODEL.WEIGHTS
        ob = os.path.join(work, "orbax")
        os.makedirs(os.path.join(ob, "3", "default"))
        with open(os.path.join(ob, "3", ckpt.ORBAX_STEP_FILE), "w") as f:
            f.write("{}")
        keys = ["params", "ts_head", "fc_t", "Dense_0", "kernel"]
        with open(os.path.join(ob, "3", "default", "_METADATA"), "w") as f:
            json.dump({"tree_metadata": {str(tuple(keys)): {
                "key_metadata": [{"key": k, "key_type": 2} for k in keys],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
                "use_ocdbt": True, "use_zarr3": False}, f)
        cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), [f"MODEL.WEIGHTS={ob}"])
        import importlib.util

        installed = importlib.util.find_spec("tensorstore") is not None
        held = sys.modules.get("tensorstore")
        sys.modules["tensorstore"] = None             # what a host without it sees
        try:
            runner.build_model(cfg, dev)
            raise AssertionError("an orbax directory loaded without tensorstore")
        except RuntimeError as e:
            if "catre_tpu_torch.tools.convert_checkpoint" not in str(e):
                raise
            msg = str(e)
        finally:
            if held is None:
                sys.modules.pop("tensorstore", None)
            else:
                sys.modules["tensorstore"] = held
        log("tools", f"MODEL.WEIGHTS=<orbax dir> without tensorstore (installed here: "
                     f"{installed}): {msg[:160]}...")
    finally:
        logging.getLogger().removeHandler(quiet)
        quiet.close()
        for name in set(nocs._DATASET_REGISTRY) - registered:
            nocs._DATASET_REGISTRY.pop(name)
        dl.clear_decoded_caches()
        meta.set_data_root(old_root)
        if env_root is not None:
            os.environ["CATRE_DATA_ROOT"] = env_root
        work_dir.cleanup()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log("tools", f"phase 8 in {time.perf_counter() - t_phase:.1f} s")
    return total


def launcher_env(data_root):
    """The environment of a launcher run: the data root, no CATRE_ variable
    else, this interpreter first on PATH (the scripts call `python`)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("CATRE_")}
    env["CATRE_DATA_ROOT"] = data_root
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", "")
    return env


def run_launcher(tag, cmd, env, work):
    """One launcher from the repository root; its output to a file under
    `work`; -> (stdout, wall seconds). A non-zero exit fails the phase."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                          timeout=LAUNCHER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(work, f"{tag}.out"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"launchers: {tag} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, wall


def write_real275_root(root, table, model_seed=0):
    """A REAL275-shaped data root: the asset pickles, REPRO_FRAMES real_test
    frames from synth_nocs, SPD-style init poses (the gt with noise, the gt
    masks) and the seed-0 weights as the released checkpoint's .pth; -> the
    paths of the init JSON and the .pth."""
    import pickle

    import numpy as np

    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.entry import flagship_config
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.tools import synth_nocs
    from catre_tpu_torch.tools.fetch_assets import CKPT_NAME

    meta.set_data_root(root)
    os.makedirs(meta.MODEL_DIR)
    rng = np.random.default_rng(9)
    assets = {meta.CR_MEAN_MODEL_PATH: {meta.ID2OBJ[i + 1]: table[i] for i in range(6)},
              meta.ABS_SCALE_PATH: {f"{o}_{i}_norm": rng.uniform(0.08, 0.3, 3).astype(np.float32)
                                    for o in meta.OBJECTS for i in range(2)}}
    for path, obj in assets.items():
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    synth_nocs.generate_split(os.path.join(root, "NOCS", "REAL"), split="real_test",
                              n_frames=REPRO_FRAMES, n_objs=6, seed=0)
    init = {r["scene_im_id"]: [
        {"obj_id": a["category_id"] + 1, "score": 0.9,
         "pose_est": (np.asarray(a["pose"]) + rng.normal(0, 0.01, (3, 4))).tolist(),
         "scale_est": (np.asarray(a["scale"]) * 1.05).tolist(),
         "bbox_est": [float(v) for v in a["bbox"]], "segmentation": a["segmentation"]}
        for a in r["annotations"]] for r in nocs.NOCSDataset("nocs_test_real", use_cache=False)()}
    init_file = os.path.join(root, "NOCS", "test_init_poses", "init_pose_spd_nocs_real.json")
    os.makedirs(os.path.dirname(init_file))
    with open(init_file, "w") as f:
        json.dump(init, f)
    pth = os.path.join(root, "checkpoints", CKPT_NAME)
    os.makedirs(os.path.dirname(pth))
    model = init_model(flagship_config(), seed=model_seed)
    torch.save({"model": reference_layout(model.state_dict())}, pth)
    return init_file, pth


def launchers_phase(card, records, keep):
    """Phase 9a (see the module docstring)."""
    import pickle

    import numpy as np

    from catre_tpu_torch import main as cli
    from catre_tpu_torch.config.build import CONFIG_DIR, FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import meta, nocs
    from catre_tpu_torch.entry import flagship_config
    from catre_tpu_torch.models.catre import init_model

    shipped = load_config(str(FLAGSHIP_CONFIG))
    repro_cfg = str(CONFIG_DIR / "nocs_real" /
                    "aug05_kpsMS_r9d_catreDisR_shared_tspcl_convPerRot_scaleexp_120e.py")
    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1  # 5f's
    old_root = meta.DATA_ROOT
    walls = {}
    try:
        with tempfile.TemporaryDirectory(prefix="catre_launchers_") as work:
            # 5d's split under a data root of its own, found by the launcher's process
            # through its dataset cache; the seed-0 weights as a .pth; 5f's init poses
            init_file = cli_workspace(work, records, table)
            data = meta.DATA_ROOT
            for name in (shipped.DATASETS.TRAIN[0], shipped.DATASETS.TEST[0]):
                path = nocs.NOCSDataset(name)._cache_path()
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    pickle.dump(records, f)
            pth = os.path.join(work, "model_final.pth")
            model = init_model(flagship_config(), seed=0)
            torch.save({"model": reference_layout(model.state_dict())}, pth)
            env = launcher_env(data)

            out = os.path.join(work, "test_out")
            _, walls["test_catre_torch.sh"] = run_launcher(
                "test_launcher", ["./test_catre_torch.sh", str(FLAGSHIP_CONFIG), "1", pth,
                                  f"OUTPUT_DIR={out}", "MODEL.LOAD_POSES_TEST=True",
                                  f"DATASETS.INIT_POSE_FILES_TEST=('{init_file}',)"], env, work)
            with open(os.path.join(out, "predictions.pkl"), "rb") as f:
                got = pickle.load(f)
            with open(os.path.join(keep, "5f", "evaluate_split_predictions.pkl"), "rb") as f:
                ref = pickle.load(f)
            same_predictions("test_catre_torch.sh vs 5f", got, ref)
            log("launchers", f"test_catre_torch.sh <shipped config> 1 <seed-0 .pth>: "
                             f"{len(got[0])} images, predictions bit-equal to 5f's "
                             f"(evaluate_split), {walls['test_catre_torch.sh']:.1f} s")

            out = os.path.join(work, "train_out")
            _, walls["train_catre_torch.sh"] = run_launcher(
                "train_launcher", ["./train_catre_torch.sh", str(FLAGSHIP_CONFIG), "1",
                                   f"OUTPUT_DIR={out}", "SOLVER.TOTAL_EPOCHS=1",
                                   "SOLVER.WARMUP_ITERS=1", "SOLVER.CHECKPOINT_PERIOD=100",
                                   "TEST.EVAL_PERIOD=0", "TRAIN.PRINT_FREQ=1", "SEED=0"],
                env, work)
            lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json"))]
            n_iter = len(lines)
            done = f"training done: {n_iter} iterations" in open(os.path.join(out, "log.txt")).read()
            if not (n_iter and done and [x["iteration"] for x in lines] == list(range(n_iter))
                    and all(np.isfinite(x["loss_total"]) for x in lines)):
                raise RuntimeError(f"launchers: train_catre_torch.sh logged {lines}")
            log("launchers", f"train_catre_torch.sh <shipped config> 1: {n_iter} iterations "
                             f"of 5d's split, losses {[round(x['loss_total'], 4) for x in lines]}, "
                             f"{walls['train_catre_torch.sh']:.1f} s")

            # the repro script on a REAL275-shaped root, against main run in this process
            real = os.path.join(work, "real275")
            init_json, real_pth = write_real275_root(real, table)
            ref_out = os.path.join(work, "repro_ref")
            quiet = logging.StreamHandler(open(os.path.join(work, "repro_ref.log"), "w"))
            logging.getLogger().addHandler(quiet)
            try:
                cli.main(["--config-file", repro_cfg, "--eval-only", f"OUTPUT_DIR={ref_out}",
                          f"MODEL.WEIGHTS={real_pth}",
                          f"DATASETS.INIT_POSE_FILES_TEST=('{init_json}',)"])
            finally:
                for h in [quiet, *cli._HANDLERS]:
                    logging.getLogger().removeHandler(h)
                    h.close()
                cli._HANDLERS.clear()
            with open(os.path.join(ref_out, "metrics_tab_iter4.txt")) as f:
                rows = [line.split() for line in f if line.strip()]
            summary = {r[0]: float(r[-1]) for r in rows[1:]}
            ref_json = os.path.join(work, "ref_summary.json")
            with open(ref_json, "w") as f:
                json.dump(summary, f)
            out = os.path.join(work, "repro_out")
            stdout, walls["repro_real275_torch.sh"] = run_launcher(
                "repro", ["scripts/repro_real275_torch.sh", real, out],
                dict(launcher_env(real), CATRE_REF_SUMMARY_JSON=ref_json), work)
            if "parity OK" not in stdout or "all assets present" not in stdout:
                raise RuntimeError("launchers: the repro script did not end in repro_diff's OK")
            with open(os.path.join(out, "predictions.pkl"), "rb") as f:
                got = pickle.load(f)
            with open(os.path.join(ref_out, "predictions.pkl"), "rb") as f:
                ref = pickle.load(f)
            try:
                same_predictions("repro vs in-process", got, ref)
                same = "bit-equal to"
            except RuntimeError:
                same = "not bit-equal to"
            log("launchers", f"scripts/repro_real275_torch.sh on a REAL275-shaped root "
                             f"({REPRO_FRAMES} synth_nocs frames, the f32 config): repro_diff "
                             f"exit 0 against the in-process run's {len(summary)} summaries "
                             f"(IoU50 {summary.get('IoU50')}, re5te2 {summary.get('re5te2')}), "
                             f"predictions {same} it; {walls['repro_real275_torch.sh']:.1f} s "
                             f"| {card}")
    finally:
        meta.set_data_root(old_root)
    return walls


class TimedLoader:
    """A loader whose groups are timed as they are drawn (host seconds),
    handed to `check`, and followed by a CUDA event (where the step that
    takes the group starts)."""

    def __init__(self, loader, check):
        self.loader, self.cfg, self.check = loader, loader.cfg, check
        self.seconds, self.events = [], []

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it)
            self.seconds.append(time.perf_counter() - t0)
            self.check(batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            yield batch


def colour_train_phase(dev, card, per_step, ms_7c):
    """Phase 9b (see the module docstring); -> the launch counts."""
    import numpy as np

    from catre_tpu_torch import ops
    from catre_tpu_torch.data import aug_color, jpeg, png
    from catre_tpu_torch.data import loader as dl
    from catre_tpu_torch.entry import shipped_train_loader, train_from_split, write_example_split

    repo = os.path.dirname(os.path.abspath(__file__))
    fixtures = os.path.join(repo, "tests", "data", "jpeg")
    ref = np.load(os.path.join(fixtures, "cv2_imread.npz"))
    decodable = [n for n in ref.files if n != "progressive"]
    for name in decodable:
        got = jpeg.read_jpeg(os.path.join(fixtures, name + ".jpg"))
        if got.shape != ref[name].shape or not (got == ref[name]).all():
            raise RuntimeError(f"colour: jpeg.py's decode of {name}.jpg differs from OpenCV's")
    try:
        jpeg.read_jpeg(os.path.join(fixtures, "progressive.jpg"))
        raise RuntimeError("colour: a progressive JPEG was decoded")
    except ValueError as e:
        if "progressive" not in str(e):
            raise
    log("colour", f"jpeg.py decodes the {len(decodable)} committed fixture JPEGs as OpenCV did "
                  "(bit-equal); the progressive one raises and names its format")

    families = {"aae": "", "roi10d": "", "code": AAE_CHAIN, "code_albu": ALBU_CHAIN}
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.launch_counts(), 0)
    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    with tempfile.TemporaryDirectory(prefix="catre_colour_") as work:
        # the pool: the committed VOC-sized JPEGs and smooth PNGs written here
        pool = os.path.join(work, "pool")
        os.makedirs(pool)
        bg_jpegs = sorted(f for f in os.listdir(fixtures) if f.startswith("background_"))
        for f in bg_jpegs:
            with open(os.path.join(fixtures, f), "rb") as src, \
                    open(os.path.join(pool, f), "wb") as dst:
                dst.write(src.read())
        y, x = np.mgrid[0:375, 0:500]
        for i in range(COLOUR_PNG_BACKGROUNDS):
            img = np.stack([x % 256, (y * (i + 2)) % 256, (x + y) % 256], -1).astype(np.uint8)
            png.write_png(os.path.join(pool, f"background_png_{i}.png"), img)
        t0 = time.perf_counter()
        for f in bg_jpegs:
            jpeg.read_jpeg(os.path.join(pool, f))
        decode_ms = (time.perf_counter() - t0) / len(bg_jpegs) * 1e3

        t0 = time.perf_counter()
        os.makedirs(os.path.join(work, "split"))
        records = write_example_split(os.path.join(work, "split"), COLOUR_FRAMES, images=True)
        write_s = time.perf_counter() - t0
        frames = [aug_color.read_image(r["file_name"])[:, :, ::-1]
                  for r in records[:COLOUR_TIME_IMAGES]]
        h, w = frames[0].shape[:2]
        mask = np.zeros((h, w), bool)
        mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = True
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            aug_color.replace_background(np.random.default_rng(i), f, mask, pool)
        replace_ms = (time.perf_counter() - t0) / len(frames) * 1e3
        family_ms = {}
        for fam, code in families.items():
            aug = aug_color.build_color_augmentor(fam, code, seed=0)
            t0 = time.perf_counter()
            for i, f in enumerate(frames):
                aug(np.random.default_rng(i), np.ascontiguousarray(f))
            family_ms[fam] = (time.perf_counter() - t0) / len(frames) * 1e3
        log("colour", f"host, one thread, {h}x{w}: ms an image aae {family_ms['aae']:.1f}, "
                      f"roi10d {family_ms['roi10d']:.1f}, code {family_ms['code']:.1f}, "
                      f"code_albu {family_ms['code_albu']:.1f}; a background JPEG of the "
                      f"pool decoded in {decode_ms:.1f} ms, a replacement (read, fit, paste) "
                      f"{replace_ms:.1f} ms; the colour split written in {write_s:.1f} s")

        # the colour loader's groups into the flagship train step, under each family
        for fam, code in families.items():
            rgb_bad = []

            def check(batch):
                rgb = batch.get("pcl_rgb")
                if (rgb is None or rgb.shape != tuple(batch["pcl"].shape)
                        or not np.isfinite(rgb).all() or rgb.min() < 0 or rgb.max() > 1):
                    rgb_bad.append(batch["scene_im_ids"])

            loader = TimedLoader(shipped_train_loader(
                records, dev, mean_points=table, pcl_with_color=True, cache_decoded="",
                color_aug_prob=1.0, change_bg_prob=1.0, color_aug_type=fam,
                color_aug_code=code, bg_image_dir=pool, bg_type="file_dir"), check)
            events, counts = [], []

            def on_step(i, metrics):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                counts.append(ops.launch_counts())

            torch.cuda.synchronize()
            ops.reset_launch_counts()
            state, history = train_from_split(records, 1, dev, callback=on_step, loader=loader)
            torch.cuda.synchronize()
            prev = dict.fromkeys(per_step, 0)
            for i, c in enumerate(counts):
                got = {k: c[k] - prev[k] for k in per_step}
                if got != per_step:
                    raise RuntimeError(f"colour {fam}, step {i}: launches {got}, want {per_step}")
                prev = c
            for k, v in ops.launch_counts().items():
                total[k] += v
            if rgb_bad or len(loader.seconds) != 1:
                raise RuntimeError(f"colour {fam}: pcl_rgb missing, non-finite or outside "
                                   f"[0, 1] in {rgb_bad}")
            if not (all(torch.isfinite(v).all() for m in history for v in m.values())
                    and all(torch.isfinite(p).all() for p in state.params.values())):
                raise RuntimeError(f"colour {fam}: non-finite metrics or parameters")
            group_ms = loader.seconds[0] * 1e3
            step_ms = loader.events[0].elapsed_time(events[0])
            log("colour", f"{fam}: the shipped train loader with PCL_WITH_COLOR, "
                          f"COLOR_AUG_PROB 1, CHANGE_BG_PROB 1 ({len(os.listdir(pool))} "
                          f"backgrounds): {group_ms:.1f} ms a "
                          f"{loader.loader.ims_per_batch}-frame group (host), pcl_rgb finite "
                          f"in [0, 1]; the flagship step on it {step_ms:.1f} ms from the group "
                          f"to the step's end, so {group_ms + step_ms:.1f} ms a step from "
                          f"this loader (phase 7c {ms_7c:.3f}); launches a step "
                          f"{ {k: v for k, v in per_step.items() if v} }, last-iteration loss "
                          f"{history[-1]['loss_total'][-1].item():.5f}")
            del loader, state
            dl.clear_decoded_caches()
        torch.cuda.empty_cache()
        log("colour", f"phase 9b in {time.perf_counter() - t_phase:.1f} s | {card}")
    return total


def first_grads(model, optimizer):
    """Record the gradients the first optimizer step of `model` is given
    (the first inner iteration's backward): -> (name -> gradient, hook)."""
    grads = {}

    def hook(opt, args, kwargs):
        if not grads:
            grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                          if p.grad is not None})

    return grads, optimizer.register_step_pre_hook(hook)


def grad_error(grads_a, grads_b):
    """Worst per-parameter ||a - b|| / ||b|| -> (error, parameter)."""
    if grads_a.keys() != grads_b.keys() or not grads_b:
        raise RuntimeError("gradients of different parameters: "
                           f"{sorted(grads_a.keys() ^ grads_b.keys())}")
    errs = {n: ((grads_a[n] - g).norm() / g.norm().clamp(min=1e-30)).item()
            for n, g in grads_b.items()}
    worst = max(errs, key=lambda n: errs[n] if errs[n] == errs[n] else float("inf"))
    return errs[worst], worst


def train_kernel_vs_plain(dev):
    """One B = 8 f32 train step on the card (K3-K6) against the same step on a
    CPU copy of the model, optimizer and prepared batch (the kernels' plain
    versions): the metrics, the parameters, and the first backward's
    gradients relative to their norms."""
    from catre_tpu_torch.engine.train import init_train_state, make_train_step, prepare_train_batch
    from catre_tpu_torch.entry import flagship_trainer
    from catre_tpu_torch.solver.ranger import Ranger

    t = flagship_trainer(dev, batch_size=8, seed=1, dtype=None)
    model, opt = t.step.model, t.step.optimizer
    cpu_model = copy.deepcopy(model).cpu()
    cpu_opt = Ranger(cpu_model.named_parameters(), **opt.defaults)
    cpu_step = make_train_step(cpu_model, t.step.loss_cfg, t.step.noise_cfg, cpu_opt,
                               t.step.sym_bank.cpu(), t.step.n_iter)
    (g_card, h_card), (g_cpu, h_cpu) = first_grads(model, opt), first_grads(cpu_model, cpu_opt)
    prepared = prepare_train_batch(t.generator, t.batch, t.step.noise_cfg)
    _, m_card = t.step.step_on_prepared(t.state, prepared, t.lr)
    _, m_cpu = cpu_step.step_on_prepared(init_train_state(cpu_model, cpu_opt),
                                         {k: v.cpu() for k, v in prepared.items()}, t.lr)
    torch.cuda.synchronize()
    h_card.remove()
    h_cpu.remove()
    loss_err = max(((m_card[k].cpu() - m_cpu[k]).abs() / m_cpu[k].abs().clamp(min=1e-12)).max()
                   .item() for k in m_cpu)
    card_params = dict(model.named_parameters())
    param_err = max((card_params[n].detach().cpu() - p.detach()).abs().max().item()
                    for n, p in cpu_model.named_parameters())
    grad_err, grad_worst = grad_error(g_card, g_cpu)
    log("train", f"B=8 f32 kernel step vs plain step: metrics max rel err {loss_err:.3e} "
                 f"(rtol {TRAIN_LOSS_RTOL:.0e}), parameters max abs err {param_err:.3e} "
                 f"(limit {TRAIN_PARAM_TOL:.0e}), first backward's gradients over "
                 f"{len(g_cpu)} parameters max rel err {grad_err:.3e} ({grad_worst}; "
                 f"limit {TRAIN_GRAD_RTOL:.0e})")
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL
            and grad_err <= TRAIN_GRAD_RTOL):
        raise RuntimeError("the kernel train step disagrees with the plain train step")


def solver_train_phase(dev, per_step, phase7):
    """Phase 7b's B = TRAIN_B bf16 train step at the shipped kernel flags
    under `entry.solver_example_config()`, its lr from `build_lr_fn` at SCHEDULE_STEPS:
    phase 7's launches per step, finite losses and parameters, the TS head's
    parameters bit-unchanged; ms per step and peak memory beside phase 7's.
    -> launch counts."""
    from catre_tpu_torch.config.build import model_config_from
    from catre_tpu_torch.entry import solver_example_config
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.solver.schedule import build_lr_fn

    cfg = solver_example_config()
    lr_at = build_lr_fn(dict(cfg.SOLVER), SCHEDULE_TOTAL)
    lrs = [lr_at(s) for s in SCHEDULE_STEPS]
    log("train", f"phase 7b lr at schedule steps {SCHEDULE_STEPS} of {SCHEDULE_TOTAL}: {lrs}")
    counts, ms, peak, state = train_phase(dev, per_step, cfg=cfg, lr_fn=lambda i: lrs[i])
    initial = init_model(model_config_from(cfg), seed=0).state_dict()
    ts = [n for n in state.params if n.startswith("ts_head.")]
    changed = [n for n in ts if not torch.equal(state.params[n].detach().cpu(), initial[n])]
    moved = [n for n in state.params if not n.startswith("ts_head.")
             and not torch.equal(state.params[n].detach().cpu(), initial[n])]
    log("train", f"phase 7b: {len(ts)} frozen ts_head parameters bit-unchanged: {not changed}; "
                 f"{len(moved)} of {len(state.params) - len(ts)} others moved; "
                 f"{ms:.3f} ms/step (phase 7 {phase7[1]:.3f}, ratio {ms / phase7[1]:.4f}), "
                 f"peak {peak:.2f} GiB (phase 7 {phase7[2]:.2f})")
    if changed or not moved:
        raise RuntimeError(f"FREEZE: ts_head parameters changed {changed}, others moved "
                           f"{len(moved)}")
    return counts


def registry_card_vs_cpu(dev):
    """Every registry type, OPT_STEPS optimizer steps on the flagship model's
    f32 parameters on the card against a CPU copy fed the same gradients, per
    parameter within OPT_TOL x max(1, max|p|); then each type's ms per
    optimizer step on the card (a side line, no limit)."""
    from catre_tpu_torch.entry import flagship_config
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.solver.build import OPTIMIZER_TYPES, build_optimizer

    card, cpu = init_model(flagship_config(), seed=2, device=dev), init_model(flagship_config(),
                                                                             seed=2)
    initial = {k: v.clone() for k, v in cpu.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    grads = [{n: torch.randn(p.shape, generator=gen) * 1e-2 for n, p in cpu.named_parameters()}
             for _ in range(OPT_STEPS)]
    card_grads = [{n: g.to(dev) for n, g in step.items()} for step in grads]
    times, worst = {}, (0.0, "")
    for typ in OPTIMIZER_TYPES:
        solver = {"OPTIMIZER_CFG": {"type": typ, "lr": 1e-3}}
        opts = []
        for model, seq in ((cpu, grads), (card, card_grads)):
            model.load_state_dict(initial)
            opt = build_optimizer(solver, model.named_parameters())
            named = dict(model.named_parameters())
            for step in seq:
                for n, g in step.items():
                    named[n].grad = g.clone()
                opt.step()
            opts.append(opt)
        want = dict(cpu.named_parameters())
        for n, p in card.named_parameters():
            err = (p.detach().cpu() - want[n].detach()).abs().max().item()
            scale = max(1.0, want[n].detach().abs().max().item())
            if not err <= OPT_TOL * scale:
                raise RuntimeError(f"{typ}: {n} card vs CPU max abs err {err:.3e} over "
                                   f"{OPT_TOL:.0e} x {scale:.3f}")
            worst = max(worst, (err / scale, f"{typ} {n}"))
        times[typ] = time_ms(opts[1].step, iters=OPT_TIMED, warmup=0)
    log("solver", f"{len(OPTIMIZER_TYPES)} registry types, {OPT_STEPS} steps on the flagship "
                  f"model's {sum(p.numel() for p in cpu.parameters())} f32 parameters: card vs "
                  f"CPU worst max abs err / max(1, max|p|) {worst[0]:.3e} ({worst[1]}; limit "
                  f"{OPT_TOL:.0e})")
    log("solver", "ms per optimizer step on the card: " + ", ".join(
        f"{typ} {ms:.3f}" for typ, ms in times.items()))


def adamw_kernel_vs_plain(dev):
    """One B = 8 f32 train step with adamw, clipping and LR_MULT on the card
    (K3-K6) against the same step on a CPU copy (the kernels' plain versions),
    with phase 7's tolerances, at lr ADAMW_LR; and each parameter's change
    within ADAMW_CHANGE_RTOL of the CPU's in norm."""
    from catre_tpu_torch.engine.train import init_train_state, make_train_step, prepare_train_batch
    from catre_tpu_torch.entry import flagship_trainer, solver_example_config
    from catre_tpu_torch.solver.build import optimizer_from_config

    cfg = solver_example_config()
    cfg.SOLVER.OPTIMIZER_CFG = {"type": "AdamW", "lr": ADAMW_LR, "weight_decay": 0.01}
    cfg.MODEL.CATRE.TS_HEAD.FREEZE = False
    t = flagship_trainer(dev, batch_size=8, seed=1, cfg=cfg, dtype=None)
    model, opt = t.step.model, t.step.optimizer
    cpu_model = copy.deepcopy(model).cpu()
    cpu_opt = optimizer_from_config(cfg, cpu_model)
    cpu_step = make_train_step(cpu_model, t.step.loss_cfg, t.step.noise_cfg, cpu_opt,
                               t.step.sym_bank.cpu(), t.step.n_iter)
    before = {n: p.detach().cpu().clone() for n, p in cpu_model.named_parameters()}
    (g_card, h_card), (g_cpu, h_cpu) = first_grads(model, opt), first_grads(cpu_model, cpu_opt)
    prepared = prepare_train_batch(t.generator, t.batch, t.step.noise_cfg)
    _, m_card = t.step.step_on_prepared(t.state, prepared, t.lr)
    _, m_cpu = cpu_step.step_on_prepared(init_train_state(cpu_model, cpu_opt),
                                         {k: v.cpu() for k, v in prepared.items()}, t.lr)
    torch.cuda.synchronize()
    h_card.remove()
    h_cpu.remove()
    loss_err = max(((m_card[k].cpu() - m_cpu[k]).abs() / m_cpu[k].abs().clamp(min=1e-12)).max()
                   .item() for k in m_cpu)
    card_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    param_err = max((card_params[n] - p.detach()).abs().max().item()
                    for n, p in cpu_model.named_parameters())
    change = {n: ((card_params[n] - p.detach()).norm()
                  / (p.detach() - before[n]).norm().clamp(min=1e-30)).item()
              for n, p in cpu_model.named_parameters()}
    change_worst = max(change, key=change.get)
    grad_err, grad_worst = grad_error(g_card, g_cpu)
    log("train", f"B=8 f32 adamw + clipping + LR_MULT kernel step vs plain step at lr "
                 f"{ADAMW_LR:.0e}: metrics max rel err {loss_err:.3e} (rtol "
                 f"{TRAIN_LOSS_RTOL:.0e}), parameters max abs err {param_err:.3e} (limit "
                 f"{TRAIN_PARAM_TOL:.0e}), change vs the CPU's in norm {change[change_worst]:.3e} "
                 f"({change_worst}; limit {ADAMW_CHANGE_RTOL:.0e}), first backward's gradients "
                 f"max rel err {grad_err:.3e} ({grad_worst}; limit {TRAIN_GRAD_RTOL:.0e})")
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL
            and change[change_worst] <= ADAMW_CHANGE_RTOL and grad_err <= TRAIN_GRAD_RTOL):
        raise RuntimeError("the adamw kernel train step disagrees with the plain train step")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from catre_tpu_torch import ops
    from catre_tpu_torch.engine.refiner import make_refine_fn
    from catre_tpu_torch.entry import (N_ITER, example_batch, flagship_config,
                                       near_identity_model)
    from catre_tpu_torch.geom.rotations import rot6d_to_mat
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.models.layers import dense
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_chain as chain_ops
    from catre_tpu_torch.ops import encoder_epilogue as enc_ops
    from catre_tpu_torch.ops import rot_head as rot_ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 1. device
    card = card_line()
    log("device", f"{card} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
                  f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    log("build", f"{len(_build.KERNEL_SOURCES)} libraries in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels vs twins at main-path shapes, weights of the seeded flagship model
    cfg = flagship_config()
    model = init_model(cfg, seed=0, device=dev)
    enc = model.pcl_net
    gen = torch.Generator(device=dev).manual_seed(0)
    n_clouds, n_pts = 2 * KERNEL_B, cfg.num_pcl
    x_stn = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=gen))
    x_main = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=gen))
    head = copy.deepcopy(model.rot_head)
    with torch.no_grad():
        for prm in head.parameters():
            prm.mul_(50.0)                       # signal well above the 1e-3 init
    pf = torch.randn(KERNEL_B, 2 * n_pts, 64, device=dev, generator=gen) * 0.5
    g2 = torch.randn(KERNEL_B, 2, 1024, device=dev, generator=gen) * 0.5
    results = {}
    with torch.no_grad():
        results["K2"] = check_kernel(
            "K2 dense_relu_max", enc_ops.dense_relu_max, enc_ops.dense_relu_max_twin,
            lambda cdt: (x_stn.to(cdt), enc.stn.conv3.weight, enc.stn.conv3.bias, cdt))
        results["K2"].update(check_tail_design(
            "K2", enc_ops.dense_relu_max, enc_ops.dense_relu_max_twin,
            enc_ops.dense_relu_max_folded_twin, x_stn,
            [enc.stn.conv3.weight.detach(), enc.stn.conv3.bias.detach()], K2_KERNEL),
            shared_memory=enc_ops._lib().catre_stn_tail_smem())
        results["K1"] = check_kernel(
            "K1 dense_relu_dense_max", enc_ops.dense_relu_dense_max,
            enc_ops.dense_relu_dense_max_twin,
            lambda cdt: (x_main.to(cdt), enc.conv3.weight, enc.conv3.bias, enc.conv4.weight,
                         enc.conv4.bias, cdt))
        results["K1"].update(check_tail_design(
            "K1", enc_ops.dense_relu_dense_max, enc_ops.dense_relu_dense_max_twin,
            enc_ops.dense_relu_dense_max_folded_twin, x_main,
            [t.detach() for layer in (enc.conv3, enc.conv4) for t in (layer.weight, layer.bias)],
            K1_KERNEL))

        def rot_args(cdt):
            pack = rot_ops.pack_rot_head(head, cdt)
            return pf.to(cdt), (g2 @ pack.w_g.T).contiguous(), pack, n_pts

        results["K3"] = check_kernel("K3 rot_head", rot_ops.rot_head, rot_ops.rot_head_twin,
                                     rot_args)
        check_k3_design(rot_args)
        results.update(check_rot_head_multi(rot_args))

        # K9: the three encoder columns, weights of the seeded model
        x3 = torch.randn(n_clouds, n_pts, 3, device=dev, generator=gen) * 0.2
        x64 = torch.relu(torch.randn(n_clouds, n_pts, 64, device=dev, generator=gen))
        columns = {
            "K9 stn3d": (x3, (enc.stn.conv1, enc.stn.conv2, enc.stn.conv3), True),
            "K9 stnkd": (x64, (enc.fstn.conv1, enc.fstn.conv2, enc.fstn.conv3), True),
            "K9 main": (x64, (enc.conv2, enc.conv3, enc.conv4), False),
        }
        for tag, (xc, layers, relu_last) in columns.items():
            params = [t for layer in layers for t in (layer.weight, layer.bias)]
            widths = [xc.shape[2]] + [layer.weight.shape[0] for layer in layers]
            results[tag] = check_kernel(
                f"{tag} chain3_max {'-'.join(map(str, widths))}",
                lambda *a: chain_ops.chain3_max(*a, relu_last=relu_last),
                lambda *a: chain_ops.chain3_max_twin(*a, relu_last=relu_last),
                lambda cdt: (xc.to(cdt), *params, cdt))
            x16 = xc.bfloat16()
            h = dense(dense(x16, *params[0:2], torch.bfloat16, act=True), *params[2:4],
                      torch.bfloat16, act=True)
            nearer_its_own_version(
                tag, chain_ops.chain3_max(x16, *params, torch.bfloat16, relu_last=relu_last),
                chain_ops.chain3_max_twin(x16, *params, torch.bfloat16, relu_last=relu_last),
                dense(h, *params[4:6], torch.bfloat16, act=relu_last).amax(dim=1).float(),
                "the same layers rounded as flax Dense (K1/K2's rounding)")
            del x16, h
            results[tag].update(check_k9_design(tag, xc, params, relu_last))
            rows = n_clouds * n_pts
            macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
            results[tag].update(bound(2 * rows * widths[0] + 2 * macs + 4 * sum(widths[1:])
                                      + 4 * n_clouds * widths[-1], 2 * rows * macs))
        log("kernels", f"beside K9 at the same {n_clouds} clouds: K2 {results['K2']['ms']:.4f} ms "
                       f"(each STN column's tail), K1 {results['K1']['ms']:.4f} ms (the main "
                       "column's tail); K9 also holds the column's first layer(s)")
        del x3, x64, columns, xc     # 0.13 GiB that would sit under every later peak

    # ---- 4. identity: canned identity-delta heads, init = gt, 4 iterations
    ident = near_identity_model(model)
    b = example_batch(KERNEL_B, cfg.num_pcl, cfg.num_kps, device=dev, seed=1)
    rot_init = rot6d_to_mat(torch.randn(KERNEL_B, 6, device=dev, generator=gen))
    t_init = torch.stack([torch.rand(KERNEL_B, device=dev, generator=gen) * 0.4 - 0.2,
                          torch.rand(KERNEL_B, device=dev, generator=gen) * 0.4 - 0.2,
                          torch.rand(KERNEL_B, device=dev, generator=gen) * 0.6 + 0.6], dim=1)
    pose_init = torch.cat([rot_init, t_init[:, :, None]], dim=2)
    poses, scales = make_refine_fn(ident, N_ITER)(b["pcl"], b["obj_kps"], pose_init,
                                                  b["obj_scale"], b["K"])
    dp = (poses - pose_init[None]).abs().max().item()
    ds = (scales - b["obj_scale"][None]).abs().max().item()
    log("identity", f"B={KERNEL_B} x{N_ITER} iterations: max |pose - init| = {dp:.3e}, "
                    f"max |scale - init| = {ds:.3e}, limit {IDENTITY_TOL:.0e}")
    if not (dp <= IDENTITY_TOL and ds <= IDENTITY_TOL):
        raise RuntimeError("identity-delta refine moved the init")

    # ---- 5a. reference: kernel path vs plain path, f32, small batch
    cfg32 = dataclasses.replace(cfg, dtype=None)
    m32 = init_model(cfg32, seed=0, device=dev)
    b8 = example_batch(8, cfg.num_pcl, cfg.num_kps, device=dev, seed=2)
    args8 = (b8["pcl"], b8["obj_kps"], b8["obj_pose"], b8["obj_scale"], b8["K"])
    m32.cfg = dataclasses.replace(cfg32, fused_heads=False)
    plain = make_refine_fn(m32, N_ITER)(*args8)
    for overrides in ({}, {"fused_encoder": True}, {"fused_block_size": PATH_GROUP}):
        m32.cfg = dataclasses.replace(cfg32, **overrides)
        fused = make_refine_fn(m32, N_ITER)(*args8)
        derr = max((a - p).abs().max().item() for a, p in zip(fused, plain))
        log("refine", f"B=8 f32 kernel path {overrides or 'K1-K3'} vs plain path: "
                      f"max_abs_err={derr:.3e} limit={PATH_TOL:.0e}")
        if not derr <= PATH_TOL:
            raise RuntimeError(f"the kernel path {overrides} disagrees with the plain path")

    # ---- 5b. the main paths, through the port's entry point: flagship refine, bf16,
    # with K1-K3; with the encoder columns through K9; with the rot head through K8
    zero = dict.fromkeys(ops.launch_counts(), 0)
    n_tails = {"dense_relu_dense_max": N_ITER, "dense_relu_max": 2 * N_ITER}
    per_call = {**zero, **n_tails, "rot_head": N_ITER}
    launches = dict(zero)
    refine_paths = [({}, per_call),
                    ({"fused_encoder": True}, {**zero, "chain3_max": 3 * N_ITER,
                                               "rot_head": N_ITER}),
                    ({"fused_block_size": PATH_GROUP}, {**zero, **n_tails,
                                                        "rot_head_blocked": N_ITER})]
    for overrides, want in refine_paths:
        for B in REFINE_BATCHES:
            counts = refine_phase(dev, B, REFINE_CALLS, want, **overrides)
            for k in launches:
                launches[k] += counts[k]
    refine_phase(dev, RAGGED_B, 1, per_call, fused_block_size=PATH_GROUP)

    # K7 has no caller in the model: its path is the op's own `group` argument
    with torch.no_grad():
        pf16, g16 = pf.bfloat16(), g2.bfloat16()
        ops.reset_launch_counts()
        out7 = rot_ops.fused_conv_per_rot_head(pf16, g16[:, 0], g16[:, 1], model.rot_head, n_pts,
                                               torch.bfloat16, group=PATH_GROUP)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        out8 = rot_ops.fused_conv_per_rot_head_blocked(pf16, g16[:, 0], g16[:, 1], model.rot_head,
                                                       n_pts, torch.bfloat16, PATH_GROUP)
    if counts != {**zero, "rot_head_grouped": 1}:
        raise RuntimeError(f"fused_conv_per_rot_head(group={PATH_GROUP}): launches {counts}")
    if out7.shape != (KERNEL_B, 6) or not torch.isfinite(out7).all() or not torch.equal(out7, out8):
        raise RuntimeError("fused_conv_per_rot_head(group=...) disagrees with the blocked op")
    launches["rot_head_grouped"] += counts["rot_head_grouped"]
    log("refine", f"fused_conv_per_rot_head(group={PATH_GROUP}) B={KERNEL_B} bf16: launches "
                  f"{ {k: v for k, v in counts.items() if v} }, equal to the blocked op")

    # ---- 5c. the sample path: frames -> group sampler -> shipped refine
    counts = sample_phase(dev, card)
    for k in launches:
        launches[k] += counts[k]

    # ---- 5d. split from disk -> test loader -> shipped refine; 5e. the same split scored
    split_dir = tempfile.TemporaryDirectory(prefix="catre_split_")
    keep_dir = tempfile.TemporaryDirectory(prefix="catre_keep_")    # 5f's and 7d's outputs
    records = write_split(split_dir.name)
    for counts in loader_phase(dev, card, records, keep_dir.name):
        for k in launches:
            launches[k] += counts[k]

    # ---- 6. K4 vs its plain version, per gradient tensor
    results["K4"] = check_k4(head, dev, gen)

    # ---- 6b. K5 and K6 vs their plain versions, forward and backward
    results.update(check_train_tails(enc, dev, gen, 2 * TRAIN_B, cfg.num_pcl))
    results["K6 fwd"].update(check_k6_fwd_design(enc, dev, 2 * TRAIN_B, cfg.num_pcl))
    results["K5 fwd"].update(check_k5_fwd_design(enc, dev, 2 * TRAIN_B, cfg.num_pcl))
    results["K6 bwd"].update(check_k6_bwd_design(enc, dev, gen, 2 * TRAIN_B, cfg.num_pcl))
    results["K5 bwd"].update(check_k5_bwd_design(enc, dev, gen, 2 * TRAIN_B, cfg.num_pcl))

    # ---- 7. the training main path, through the port's entry point, at the shipped
    # flags; then with the plain encoder under autograd, in the same run
    plain_per_step = dict(zero)
    plain_per_step.update({"rot_head": N_ITER, "rot_head_bwd": N_ITER})
    train_per_step = dict(plain_per_step)
    train_per_step.update({"dense_relu_max_train_fwd": 2 * N_ITER,
                           "dense_relu_max_train_bwd": 2 * N_ITER,
                           "dense_relu_dense_max_train_fwd": N_ITER,
                           "dense_relu_dense_max_train_bwd": N_ITER})
    phase7 = train_phase(dev, train_per_step)
    for counts in (phase7[0],
                   train_phase(dev, plain_per_step, steps=1, fused_encoder_train=False)[0]):
        for k in launches:
            launches[k] += counts[k]
    train_kernel_vs_plain(dev)

    # ---- 7b. the solver: the train step under a config with clipping, LR_MULT, FREEZE,
    # three init modes and the schedule's lr; every registry type card vs CPU; an adamw step
    counts = solver_train_phase(dev, train_per_step, phase7)
    for k in launches:
        launches[k] += counts[k]
    registry_card_vs_cpu(dev)
    adamw_kernel_vs_plain(dev)

    # ---- 7c. the split on disk -> the shipped train loader -> the train step
    counts, ms_7c = train_from_disk_phase(dev, card, records, train_per_step, phase7,
                                          split_dir.name)
    for k in launches:
        launches[k] += counts[k]

    # ---- 7d. the same split trained from the command line, then resumed
    counts, ms_7d = do_train_phase(card, records, train_per_step, ms_7c, keep_dir.name)
    for k in launches:
        launches[k] += counts[k]

    # ---- 7e. two processes on the one card: the train step and do_test over a group
    counts = dist_phase(dev, card, records, train_per_step, per_call)
    for k in launches:
        launches[k] += counts[k]

    # ---- 8. the tools on the card: the synthetic split, labels, init poses, FPS, the
    # soak and its resume, the sampler study, the run reports, an orbax directory
    counts = tools_phase(dev, card, train_per_step, per_call, ms_7d, keep_dir.name)
    for k in launches:
        launches[k] += counts[k]

    # ---- 9. the launchers as subprocesses (their launches are their processes'), then
    # colour augmentation and background replacement into the train step
    t9 = time.perf_counter()
    launchers_phase(card, records, keep_dir.name)
    counts = colour_train_phase(dev, card, train_per_step, ms_7c)
    for k in launches:
        launches[k] += counts[k]
    log("launchers", f"phase 9 in {time.perf_counter() - t9:.1f} s")
    split_dir.cleanup()
    keep_dir.cleanup()

    # bounds of K1-K4 at the shapes they were timed at, bf16: their dense products
    # (K3 once forward, K4 the forward again and two products per forward product)
    rows, n_obj_pts = n_clouds * n_pts, 2 * n_pts
    head_flops = 2 * n_obj_pts * (64 * 512 + 2 * 256 * 256)      # per object
    w_tail, w_head = 2 * (128 * 512 + 512 * 1024), 2 * (64 * 512 + 2 * 256 * 256)
    results["K1"].update(bound(2 * rows * 128 + w_tail + 4 * n_clouds * 1024,
                               2 * rows * (128 * 512 + 512 * 1024)))
    results["K2"].update(bound(2 * rows * 128 + 2 * 128 * 1024 + 4 * n_clouds * 1024,
                               2 * rows * 128 * 1024))
    results["K3"].update(bound(KERNEL_B * (2 * n_obj_pts * 64 + 4 * 2 * 512) + w_head,
                               KERNEL_B * head_flops))
    for tag in ("K7", "K8"):     # K3's model work: the Pallas bodies compute each product once
        results[tag].update(bound(KERNEL_B * (2 * n_obj_pts * 64 + 4 * 2 * 512) + w_head,
                                  KERNEL_B * head_flops))
    results["K4"].update(bound(K4_TIME_B * ((2 + 4) * n_obj_pts * 64 + 4 * 4 * 512) + 3 * w_head,
                               K4_TIME_B * 3 * head_flops))
    # what K4's design moves and multiplies beyond that: pf once per head for each of
    # four passes (and once for d_W_pt); the bf16 operand arrays of the weight-gradient
    # products, a written once and read three times, d_x2 once and twice, d_x0 once and
    # once; d_pf as two f32 partials written, read and joined; layer 0 twice in full and
    # twice by quarters, layer 1 three times, d_a twice, d_pf once, the weight gradients
    design = bound(K4_TIME_B * n_obj_pts * (9 * 2 * 64 + 9 * 2 * 512 + 5 * 4 * 64),
                   K4_TIME_B * 2 * n_obj_pts * (6 * 64 * 512 + 6 * 2 * 256 * 256))
    log("K4", f"bound of the design's own bytes and operations: {design['bound_ms']:.4f} ms "
              f"({design['bound_by']}); of the function's {results['K4']['bound_ms']:.4f} ms")
    src = "catre_tpu_torch/csrc/"
    vjp = "catre_tpu/ops/pallas_encoder_epilogue_vjp.py:"
    kernels = [
        dict(name="K1 dense_relu_dense_max", route="cuda", source=src + "encoder_tail_wgmma.cuh",
             replaces="catre_tpu/ops/pallas_encoder_epilogue.py:98",
             launches=launches["dense_relu_dense_max"], **results["K1"]),
        dict(name="K2 dense_relu_max", route="cuda", source=src + "encoder_stn_tail_wgmma.cuh",
             replaces="catre_tpu/ops/pallas_encoder_epilogue.py:89",
             launches=launches["dense_relu_max"], **results["K2"]),
        dict(name="K3 rot_head", route="cuda", source=src + "rot_head.cu",
             replaces="catre_tpu/ops/pallas_heads.py:276",
             launches=launches["rot_head"], **results["K3"]),
        dict(name="K4 rot_head_bwd", route="cuda", source=src + "rot_head_bwd.cu",
             replaces="catre_tpu/ops/pallas_heads_vjp.py:100",
             launches=launches["rot_head_bwd"], **results["K4"]),
        dict(name="K5 dense_relu_max_train_fwd", route="cuda",
             source=src + "encoder_stn_tail_wgmma.cuh", replaces=vjp + "67",
             launches=launches["dense_relu_max_train_fwd"], **results["K5 fwd"]),
        dict(name="K5 dense_relu_max_train_bwd", route="cuda",
             source=src + "encoder_stn_tail_bwd.cuh", replaces=vjp + "77",
             launches=launches["dense_relu_max_train_bwd"], **results["K5 bwd"]),
        dict(name="K6 dense_relu_dense_max_train_fwd", route="cuda",
             source=src + "encoder_tail_wgmma.cuh", replaces=vjp + "107",
             launches=launches["dense_relu_dense_max_train_fwd"], **results["K6 fwd"]),
        dict(name="K6 dense_relu_dense_max_train_bwd", route="cuda",
             source=src + "encoder_tail_bwd_wgmma.cuh", replaces=vjp + "121",
             launches=launches["dense_relu_dense_max_train_bwd"], **results["K6 bwd"]),
        dict(name="K7 rot_head_grouped", route="cuda", source=src + "rot_head.cu",
             replaces="catre_tpu/ops/pallas_heads.py:358",
             launches=launches["rot_head_grouped"], **results["K7"]),
        dict(name="K8 rot_head_blocked", route="cuda", source=src + "rot_head.cu",
             replaces="catre_tpu/ops/pallas_heads_blocked.py:141",
             launches=launches["rot_head_blocked"], **results["K8"]),
    ] + [
        # one entry per column shape; the three share the launch counter (3 per encoder call)
        dict(name=f"{tag} chain3_max", route="cuda", source=src + "encoder_chain_wgmma.cuh",
             replaces="catre_tpu/ops/pallas_encoder.py:78",
             launches=launches["chain3_max"] // 3, **results[tag])
        for tag in ("K9 stn3d", "K9 stnkd", "K9 main")
    ]
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError("a kernel of the main path never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
