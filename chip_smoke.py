#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a), nvcc, and this checkout; imports no
JAX.  Phases, each of which raises (exit code 1) on failure:

  0. print the card's name and power limit; build the CUDA kernels from
     ``photometric_bundle_adjustment_tpu_torch/csrc`` (one nvcc each, all
     started together) and time the build; print each Hamming kernel
     instance's registers, spills and tensor-core instruction count (from
     ``cuobjdump``) and its shared memory, and each megakernel instance's
     registers and spills; measure the card's sustained mma.sync rate in
     the b1 and s8 forms (``csrc/mma_rate.cu``);
  1. the megakernel (the warp computed inside it) against its plain
     PyTorch version (``warp_slabs`` + ``mega_rj_reference``) on the
     card, at EuRoC scale (164 images of 480x752, ~4.8k landmarks, ~30k
     observations; a state pushed so that some observations leave the
     image, some lie behind the camera and some are not finite), timed
     on the device beside its plain version (CUDA graphs of 20 calls) and
     through its wrapper; then on a pinhole toy state 8448 pixels wide;
  2. the photometric path: two first builds of the map's level-0 solver
     bit-equal, then ``refine_photometric`` on the synthetic EuRoC-scale
     map (3 pyramid levels, 20 iterations, Huber 9), checking that the
     cost falls at every level, that the result is finite, that the pose
     error against ground truth shrank and that the megakernel launched
     once per build;
  3. the SfM front end at EuRoC V1's size (82 stereo frames, 164 images of
     480x752, 1500 detection slots): ``SfmPipeline.detect_keypoints``,
     ``match_stereo`` and ``pair_matching.match_pairs`` over the whole
     13,284-pair worklist with ``match.matches_to_pairs`` on the card
     (held equal to the host's ``compact_matches_np``), checking the
     corner counts, detection and description against the CPU plain
     path, the stereo inliers against the rendered ground truth, and the
     Hamming kernel's launches on the path (one per ``match_batch``: both
     directions from one distance tile); then ``best_two_both`` over the
     whole worklist bit for bit against its plain version and a
     ``torch._int_mm`` form, all three timed with CUDA events;
  4. the patch sampler and the two kernel-sampled fused solvers:
     (a) the sampler kernel against its plain version at EuRoC scale, on
     the observation rows of phase 2's map at level 0, in their own order,
     with the warped level-0 coordinates (some pushed off the image, one
     at -1e6) and a few zero columns, timed on the device (CUDA graphs of
     20 calls) beside one ``grid_sample`` call, the kernel also through
     its wrapper; (b) ``make_kernel_fused_solver`` on that map from its
     initial state (20 iterations, Huber 9, the classic loop), checking
     that the cost falls, the result is finite, the pose error shrank,
     the first build equals the gather solver's on the card and repeats
     bit for bit, and the sampler launched once per build and residual
     pass; (c) ``make_kernel_dense_solver`` on ``euroc_scale_pba`` in the
     slot-major layout (20 iterations, Huber 9, the fused-cost loop),
     with the same checks but the pose error;
  5. the dense slot-major megakernel family and the kernel's bf16 tier on
     ``euroc_scale_pba`` at full size (164 noise images of 480x752, 24,000
     observations in 6 x 4,800 slot rows): (a) the dense family's first
     build and damped solve against the chunk family's on the same
     problem, and two first builds bit-equal in each tier; (b) the bf16
     kernel against its plain version on the widened
     stack, timed on the device beside its plain version and the f32
     kernel on the same inputs; (c) ``make_mega_solver(..., plan_slot)`` in
     f32 and in bf16 (20 iterations, Huber 9, the fused-cost loop),
     checking that the cost falls and stays finite and that the
     megakernel launched once per build, with LM it/s and peak memory;
     (d) ``refine_photometric(sample_bf16=True)`` on the initial phase-2
     map, checking the cost at every level and the pose error;
  6. the probes: every variant of the grid-overhead probe
     (``scripts.grid_overhead.run``: 11 variants, each against its plain
     version, two calls bit-equal, timed on the device and printed beside
     the output-only variant and its bound, with the smallest share of a
     bound and one ``torch.zeros`` of the output as the output-only
     floor) and the window read (``scripts.exp_roll``: the script's call
     at B = 1, then B = 4,096 tiles in each mode, bit for bit against the
     plain version, timed beside one ``torch.roll``);
  7. geometric bundle adjustment, which has no kernel of its own (the JAX
     package computes it in XLA): (a) bench.py's workload at full size
     (``synth_ba_problem``: pinhole, 200 cameras, 8,192 landmarks, 6
     observations each, 0.3 px noise, f32), two first builds bit-equal in
     the dense and chunk families of ``ops/geo_mega.make_geo_solver``,
     20 iterations of each and of ``bundle_adjustment`` (the cost falls,
     pose and inverse-depth errors shrink, the three final costs agree),
     and bench.py's fixed LM step timed with CUDA events, printed as
     ``geo_lm_iters_per_s`` beside the card line; (b) the real EuRoC V1
     map of ``runs/map_r5_run20.pkl`` through ``SfmPipeline.from_map``,
     which must take the chunk branch, solved in f32 on the card and in
     f64 on the CPU, as saved and with its free poses and inverse depths
     perturbed from a seed (the card within 1% of the CPU; the perturbed
     cost halves at least), with the reprojection RMS and the cam-0
     position RMSE against the reference run's map before and after;
     (c) ``entry()``, the non-fused photometric ``make_solver`` and
     ``lm_solve`` on the SE3 fit of the reference's test, on the card.
     No kernel of the port launches in this phase;
  8. RANSAC on the card, no kernel of its own (the JAX package computes
     it in XLA), on phase 3's pipeline: ``SfmPipeline.match_all`` over
     all 13,284 pairs (one Hamming launch, then the five-point RANSAC of
     each pair, 128 hypotheses, in f64, in chunks sized by memory), with
     its wall time cold and warm (a second call), pairs per second
     (``match_all_pairs_per_s``, warm), chunks, peak memory and, from
     ``torch.profiler`` over one chunk's call, the device's busy share and
     kernels per chunk; the successful pairs
     against the ground truth (rotation error and the angle between the
     translation directions, median and 95th percentile, the median
     rotation error at most ``RANSAC_ROT_MEDIAN``; the share of inliers
     within ``GT_PX`` of the true correspondence at least ``GT_SHARE``);
     ``ransac_relative_pose`` on 64 pairs of the worklist on the card and
     on the CPU with the same injected samples (inlier masks differing in
     at most ``RANSAC_MASK_SHARE`` of their entries; the refinement
     from the CPU's best hypothesis and inliers reaching translation
     directions within ``RANSAC_DIR_RAD`` on both); and ``ransac_pnp`` (P3P, 512
     hypotheses, 2 locally optimised rounds) on all 164 cameras at once,
     up to 512 detected corners each, every corner's world point where
     its ray meets the room, 30% of the bearings replaced by outliers
     from a seeded generator (median pose error at most
     ``PNP_POSE_MEDIAN``);
  9. the SfM run, no kernel of its own (the JAX package computes the map
     stages' geometry in XLA): ``SfmPipeline.run`` from images to
     ``Stage.DONE`` on 82 stereo frames (164 images of 480x752) of the
     indoor room (``synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)``,
     seed 0), default ``SfmConfig``, f64: the wall and device-block seconds
     of each stage, the counters, BA solves, localisation waves, the map's
     size, peak memory and ``sfm_keyframes_per_s`` (82 frames over the
     run's wall, the map stages' share beside it); at least
     ``SFM_REGISTERED`` of the images registered, the cam-0 ATE against
     the rendered poses after an SE3 alignment at most ``SFM_ATE_M``, the
     reprojection RMS at most ``SFM_RMS_PX``, the Hamming kernel launched
     exactly twice (``match_stereo``, ``match_all``) and no other kernel;
     then one BA solve of the map (inverse depths perturbed) under
     ``torch.profiler``: device kernels, busy share; the map is then set
     back to the state the run left it in;
 10. the megakernel against its plain version on the level-0 problem of
     phase 9's finished map (compared, timed and bounded as in phase 1),
     then ``apps/pba.refine_map`` on that map with the app's
     defaults (3 levels, 20 iterations, Huber 9, f32): cameras, landmarks
     and patch observations, each level's set-up and solve seconds, LM
     it/s, tries and costs, peak memory, the cam-0 ATE and reprojection RMS
     before and after; the cost falls at every level, the ATE after is at
     most ``PBA_ATE_M``, the megakernel (#1) launches and no other kernel;
 11. ``apps/sfm --global-init`` (``run_global_init``) on phase 9's images,
     detected and matched again: the rotation and translation averaging's
     costs, iterations and seconds, the component, the triangulation
     loop's seconds, batches and landmarks, the rest of ``run``; at least
     ``SFM_REGISTERED`` of the images registered, RMS at most
     ``SFM_RMS_PX``, the cam-0 ATE at most ``GLOBAL_ATE_M``, the Hamming
     kernel launched twice and no other kernel;
 12. calibration at euroc_calib's size (``synthetic.synth_aprilgrid``: 52
     stereo frames, 0.1 px noise) of the ds rig of
     ``refbaseline/artifacts/ref_opt_calib.json`` and the kb4 rig of
     tests/data/opt_calib_kb4.json, from perturbed intrinsics through
     ``cameras.initialize``, in f64 on the card and on the CPU: iterations
     and seconds of each; the RMSE within 10% of the noise, the
     intrinsics within ``CALIB_INTR_PX`` of the truth, the card within
     ``CALIB_REL`` of the CPU.  No kernel of the port runs in this phase.
 13. the distributed slice (``parallel/``), ``DIST_RANKS`` spawned ranks
     sharing the card under Gloo, then one rank under NCCL: (a)
     ``refine_photometric_distributed`` on phase 9's finished map,
     replicated, camera-partitioned and on one NCCL rank, each against the
     single-device fused solve on the card (observations per rank, wall
     and solve seconds, LM and CG iterations, collectives per build and
     their bytes; the cost falls, ``cost_rel`` at most ``DIST_COST_REL``,
     the ranks bit-equal, the written-back map's cam-0 ATE at most
     ``PBA_ATE_M``, no kernel); then one group of ranks runs each
     collective against its definition, (b) ``dist_fused`` on the real V1
     map perturbed as phase 7 (b), replicated and partitioned, against
     the single-device fused solve, (c) ``dist_pgo`` on a pose graph of
     phase 9's cameras against ``pose_graph_optimization``, and (d)
     ``ring_match_all_pairs`` on phase 3's descriptors, bit-equal to phase
     3's ``match_pairs`` result, the Hamming kernel launched once per ring
     step on every rank;
 14. the scale path (``scripts/scale_stress.py``'s sizes: 200, 512 and
     1,024 cameras, up to 98,304 landmarks and 983,040 observations),
     its seconds printed: (a) each size in f32 through three paths of
     ``SCALE_ITERS`` LM iterations: ``geometric_ba.bundle_adjustment`` on
     the card, and ``scale_stress.run_one`` on one NCCL rank, replicated
     and camera-partitioned (observations, plan and solve seconds, LM and
     CG iterations, peak MiB beside ``mem_model``'s; the initial costs
     within ``SCALE_INIT_REL`` of each other, the cost falls, the ranks
     bit-equal); (b) the same three paths in f64 at the medium size, the
     final costs within ``SCALE_F64_REL`` of each other; (c) the JAX
     script's mesh, ``SCALE_GLOO_RANKS`` Gloo ranks sharing the card, at
     the small size in both modes, the CG total beside the JAX script's
     CPU figure ``SCALE_CG_REF``, the final cost within ``SCALE_GLOO_REL``
     of (a)'s one-rank run; (d) ``refine_photometric`` (3 levels, 20
     iterations, Huber 9) on ``synth_pba_pipe(**SCALE_MAP)``, 960 images
     of 480x752: the host render and set-up seconds, per level the cost
     (it falls at every level), LM it/s and tries, the wall, peak MiB and
     #1's launches (one per build, no other kernel); after the run #1's
     first level-0 build, its inputs recorded during the run, is held
     against its plain version as in phase 10.
 15. (run right after phase 7) the port's benchmark: ``bench.main`` in
     this process on the card at full size, the CPU baselines off
     (minutes of host work that measure the host): every line it prints
     strict JSON without ``error``, the metrics ``BENCH_LINES`` in the
     JAX main's order with the headline last, every value finite and
     positive; #1 (both tiers) and #3
     launched exactly as often as the bench called them (each line's
     ``kernel`` record: launches equal to calls, and the counters' rise
     their sum); the bench's ``ba_lm_iters_per_s_cuda`` from a CUDA graph
     within ``BENCH_GEO_GRAPH_REL`` of phase 7 (a)'s (the same step on
     the same inputs), the host-launched ratio printed beside it.
 16. the value curve (``scripts/pba_value_curve.run_ladder``) on phase 9's
     map as its run left it (restored, with no affine brightness, as
     phase 10 started): the JAX script's rungs of 0, 2, 5, 10 and 20 cm
     in f32 with phase 10's settings, then the 0 cm rung in bf16, each
     row printed as a JSON line (ATE against the rendered poses after an
     SE3 and a Sim3 alignment, stereo baselines, costs, iterations,
     seconds, per-level costs); the cost rises at no level of any rung,
     the 0 cm rung's final cost is phase 10's within ``VC_REPEAT_RTOL``
     and the bf16 rung's is the f32 rung's within ``VC_BF16_RTOL``, #1
     launches in both tiers and no other kernel.  Before it, outside the
     counted run, #1's bf16 tier against its plain version on the map's
     problem at each pyramid level (the chunk layout the bf16 rung builds
     on);
 17. ``scripts/multiprocess_smoke.py`` as a subprocess with ``--procs 1``
     (one NCCL rank on cuda:0) and ``--procs 2`` (two processes sharing
     cuda:0 under Gloo, by ``mesh.host_rule``): each exits 0 and prints
     OK on that backend and device; the wall time of each.

Then it prints the run's total seconds, one JSON line describing the six
kernels (the megakernel's f32 and bf16 tiers, the Hamming best-two, the
patch sampler, the grid probe and the window read; the megakernel's
launches are phases 2, 10, 14, 15 and 16 (its bf16 tier's 5 (c, d), 15
and 16), its error the largest of phases 1, 10 and 14, its times phase
1's; the Hamming kernel's launches are phases 3, 8, 9, 11, 13's ranks
and 15), the card line again, and as
the last line
``{"ok": true, "device": {...}}``.  The bounds of the megakernel and the
sampler charge their output on observation columns only.

Without CUDA it exits with code 2 and prints no result.

Bounds (``bound_ms``) are reckoned from this run's inputs against the
H100 SXM's published peaks at 700 W (``utils/roofline.py``): 3.35 TB/s of
device memory, 67 TFLOP/s of f32 outside the tensor cores and 1,979 TOP/s
of dense int8 tensor-core operations.  The data sheet gives no rate for b1 products,
so the Hamming bound takes the faster of the int8 peak and the b1 rate
phase 0 measured.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the H100 SXM's published peaks at 700 W
from photometric_bundle_adjustment_tpu_torch.utils.roofline import (
    H100_BYTES_PER_S,
    hamming_bound_ms,
    mega_bound_ms,
    mma_rates,
    sample_bound_ms,
)

LEVELS, MAX_ITERATIONS, HUBER = 3, 20, 9.0
# The kernel contracts a*b + c into FMAs (nvcc's default), the plain
# version does not: about one ulp per operation.  The residual
# r = (I_t - b_t) - e (I_ref - b_r) cancels operands of image scale, so its
# error is a few ulps of the largest intensity, not of r; the cost
# 0.5 rho(|r|^2) then moves by sum_p |w r_p| times that, plus the second
# order 0.5 sum_p d_p^2 of a move d_p (0.5 |r_k^2 - r^2| = |d| |r + d / 2|),
# which is all there is where the plain version's residual is exactly 0:
# a patch on a plateau of one uint8 value, sampled bilinearly, gives r = 0
# in the plain version and an ulp of the intensity through the kernel's
# FMAs.  Each observation's cost is held at COST_RTOL relative plus
# sum_p (|r_p sw| d_p + 0.5 d_p^2), d_p COST_FMA_ULPS ulps of the image
# scale (|r_p sw| >= |w r_p|, as sw <= 1).
COST_RTOL = 1e-5
COST_FMA_ULPS = 8
ROWS_ATOL = 1e-4        # times max|ref| of each row block
# The fused kernel computes the warp itself: its pixel coordinates differ
# from the plain version's by a few ulps (FMA) of the projection's scale.
# Each entry's bound adds the first-order move that WARP_ULPS ulps of
# |u| + fx cause (``warp_bounds``), through the samples and through the
# Huber weight that follows the residual, and a column with a point that
# close to a pixel edge (the bilinear gradient jumps there) is held only
# to its NaN pattern and the total cost.  Beside that, each row block of
# the kernel is held to the plain version evaluated in f64 on the same
# inputs: no further from it than F64_FACTOR times the f32 plain
# version's own distance plus ROWS_ATOL times its max |ref|.
WARP_ULPS = 16
F64_FACTOR = 2.0

# the patch sampler against its plain version: a few ulps of the image
# scale (FMA contraction), as the megakernel's rows
SAMPLE_ATOL = 1e-4      # times max|image|
# the kernel solvers' first build against the gather solver's on the card:
# the ROADMAP's parity tolerances (cost rtol, pieces atol x max|ref|, rtol)
NEQ_TOL = (2e-4, 3e-3, 2e-3)
NEQ_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "H_pp", "g_c", "g_p", "M",
             "inv0"]

# phase 7: geometric BA.  bench.py's workload: 20 iterations of each
# family and of bundle_adjustment, whose final costs agree to GEO_COST_RTOL
# (one f32 problem, three orders of summation); the fixed step timed over
# GEO_STEPS chained steps.  The real map: the card's f32 solve within
# MAP_COST_RTOL of the CPU's f64 solve, as saved and perturbed (free poses
# by MAP_POSE_NOISE tangent noise, inverse depths by MAP_DEPTH_NOISE).
GEO_ITERATIONS, GEO_COST_RTOL, GEO_STEPS = 20, 1e-3, 50
MAP_ITERATIONS, MAP_COST_RTOL = 20, 1e-2
MAP_POSE_NOISE, MAP_DEPTH_NOISE, SEED_MAP = 2e-3, 1e-2, 0

# the front end at EuRoC V1's size (bench.py's 82 stereo frames)
FRONT_FRAMES, FRONT_H, FRONT_W = 82, 480, 752
CORNERS_MEDIAN = (300, 500)
GT_PX, GT_SHARE = 2.0, 0.8
# phase 8: RANSAC.  match_all's median relative rotation error over the
# successful pairs (rad); the card against the CPU on RANSAC_PAIRS pairs
# with the same samples: the share of inlier-mask entries that may
# differ, and the angle between the translation directions (rad) that the
# refinement reaches on both from the same hypothesis and inliers.  The
# whole RANSAC's directions are printed: a rounding flip at a threshold
# picks another hypothesis or inlier, and a short baseline leaves the
# translation nearly free, so the refined directions of such a pair end
# up to 2e-2 rad apart.  PnP on every image with PNP_OUTLIERS of its
# bearings replaced, its median pose error
RANSAC_ROT_MEDIAN, RANSAC_PAIRS = 1e-2, 64
RANSAC_MASK_SHARE, RANSAC_DIR_RAD = 1e-3, 1e-6
PNP_CORNERS, PNP_OUTLIERS, PNP_POSE_MEDIAN = 512, 0.3, 1e-3
# phase 9: the SfM run from images to a finished map, on the indoor
# room.  At least SFM_REGISTERED of the images registered; the cam-0
# trajectory's ATE against the rendered poses after an SE3 alignment (the
# stereo baseline fixes the scale) at most SFM_ATE_M; the final map's
# reprojection RMS at most SFM_RMS_PX.  SFM_ATE_CPU_M is the ATE of the
# JAX package's run of the same scene on the CPU in f64
# (``python scripts/sfm_run_jax.py``: 164 cameras, 693 landmarks, RMS
# 0.7249 px); the bound is twice it, as the card draws other RANSAC
# samples.  SFM_PROFILE_NOISE perturbs the inverse depths of the map that
# one BA solve is profiled on.
SFM_REGISTERED, SFM_RMS_PX, SFM_PROFILE_NOISE = 0.95, 1.0, 0.01
SFM_ATE_CPU_M = 5.71063769969957e-3
SFM_ATE_M = 2 * SFM_ATE_CPU_M
# phase 10: apps/pba's refinement of phase 9's map (the app's defaults:
# LEVELS levels, MAX_ITERATIONS iterations, Huber HUBER, f32).  The cam-0
# ATE after it at most PBA_ATE_M, twice that of the JAX package's CPU
# refinement of its own map of the same scene (``python
# scripts/pba_global_jax.py``: ATE 5.711 -> 1.789 mm, RMS 0.8915 px).
PBA_ATE_CPU_M = 1.788737915296198e-3
PBA_ATE_M = 2 * PBA_ATE_CPU_M
# phase 11: apps/sfm --global-init on the same images.  At least
# SFM_REGISTERED of them registered, RMS at most SFM_RMS_PX, the cam-0 ATE
# at most GLOBAL_ATE_M, twice that of the JAX package's --global-init run
# on the CPU (the same script: 164 cameras, 674 landmarks, RMS 0.7413 px).
GLOBAL_ATE_CPU_M = 3.603430372051806e-2
GLOBAL_ATE_M = 2 * GLOBAL_ATE_CPU_M
# phase 12: calibration at euroc_calib's size (CALIB_FRAMES stereo frames,
# synth_aprilgrid with CALIB_NOISE_PX of noise, CALIB_SEED) of the rig of each
# file, from intrinsics perturbed by CALIB_START_PX (fx, fy, cx, cy, px)
# and 5% (ds's xi, alpha; kb4's distortion starts at 0 in
# ``cameras.initialize``).  The RMSE within CALIB_RMSE_SHARE of the noise;
# the intrinsics within CALIB_INTR_PX of the truth, in pixels
# (``calibration.projection_gap``: ds trades fx against xi, so the pieces
# alone say little); the card's f64 result within CALIB_REL of the CPU's
# run of the same function.
CALIB_FILES = (("ds", "refbaseline/artifacts/ref_opt_calib.json"),
               ("kb4", "tests/data/opt_calib_kb4.json"))
CALIB_FRAMES, CALIB_NOISE_PX, CALIB_RMSE_SHARE = 52, 0.1, 0.1
CALIB_START_PX, CALIB_INTR_PX, CALIB_REL = (5.0, 5.0, 3.0, 3.0), 0.5, 1e-9
CALIB_SEED = 0
# phase 13: the distributed slice.  DIST_RANKS ranks share the card under
# Gloo (NCCL refuses two ranks on one device), then one rank runs under
# NCCL.  (a) refine_photometric_distributed on phase 9's finished map
# (MAX_ITERATIONS iterations, Huber HUBER, full resolution), replicated and
# camera-partitioned, each against the single-device fused solve: the
# final costs within DIST_COST_REL relative (the distributed parity line
# of the JAX package's verify notes), the ranks bit-equal, the cam-0 ATE
# of the written-back map at most PBA_ATE_M.  (b) dist_fused on the real
# V1 map perturbed as phase 7 (b), DIST_GEO_ITERATIONS iterations, Huber
# 1, against the single-device fused solve at tests/test_dist_fused.py's
# bounds (initial cost 1e-6 relative, final 1e-4, cameras 1e-4), the
# partitioned PCG (DIST_PCG_CG iterations at most) against the replicated
# solve (cost 1e-4, cameras 1e-3).  (c) dist_pgo on a pose graph of phase
# 9's cameras, every co-visible pair an edge, perturbed as
# tests/test_dist_pgo.py:18-38 does (PGO_EDGE_NOISE on the edges,
# PGO_POSE_NOISE on the poses, f64), against pose_graph_optimization: the
# cost at most its cost x (1 + 1e-6), every pose within 1e-5.  (d) the
# ring matcher on phase 3's descriptors, every worklist pair bit-equal to
# phase 3's match_pairs result.
DIST_RANKS, DIST_COST_REL = 4, 1e-3
DIST_GEO_ITERATIONS, DIST_PCG_CG = 8, 600
PGO_EDGE_NOISE, PGO_POSE_NOISE = 0.02, 0.1
# phase 14: the scale path.  (a) each size of scale_stress.SIZES in f32,
# SCALE_ITERS LM iterations (Huber 1) through bundle_adjustment and
# run_one at D = 1 in both modes: the three initial costs within
# SCALE_INIT_REL relative (one f32 problem summed in three orders), the
# cost falls on every path.  (b) the medium size in f64: the three final
# costs within SCALE_F64_REL (f32 spreads them by 1e-2 on the CPU and 1e-1
# on the card after two steps of an ill-conditioned 3,072-unknown system;
# f64 holds them to 1e-9).  (c) SCALE_GLOO_RANKS Gloo ranks at the small
# size: the final cost within SCALE_GLOO_REL of (a)'s one-rank run of the
# same mode, the CG total printed beside SCALE_CG_REF (RESULTS.md:419, and
# the port's and the JAX script's CPU runs).  (d) the 960-image map.
SCALE_ITERS, SCALE_INIT_REL, SCALE_F64_REL = 2, 1e-5, 1e-7
SCALE_GLOO_RANKS, SCALE_GLOO_REL, SCALE_CG_REF = 8, 5e-4, 213
SCALE_MAP = dict(K=960, L=28_800, H=480, W=752, obs_per_lm=5,
                 long_tracks=1170)
# phase 15: the port's bench.py, its lines in the JAX main's order (no
# stats record: no wall estimate); its geometric step is phase 7 (a)'s
BENCH_LINES = ["match_pairs_per_s_cuda", "pba_lm_iters_per_s_cuda",
               "pba_lm_iters_per_s_cuda_bf16", "keyframes_per_s_cuda",
               "ba_lm_iters_per_s_cuda"]
# the same step's device rate (from a CUDA graph) in both: held to 5%;
# the host-launched rates, which move 1.6x to 1.9x between runs, are
# printed beside it
BENCH_GEO_GRAPH_REL = 0.05
# phase 16: the value curve (scripts/pba_value_curve.run_ladder) on phase
# 9's map as its run left it, the JAX script's rungs (sigma_t in m) in f32
# with phase 10's settings, then the 0 cm rung in bf16; no rung's cost may
# rise at any level, and the 0 cm rung repeats phase 10's refinement (the
# same map through the same call, builds bit-repeatable) to VC_REPEAT_RTOL
VC_RUNGS = (0.0, 0.02, 0.05, 0.10, 0.20)
VC_REPEAT_RTOL = 1e-6
# the bf16 0 cm rung's final cost against the f32 0 cm rung's: 1.19e-6
# apart on the H100 (1.4330043e7 against 1.4330060e7, the same in two
# calls, builds bit-repeatable); the bound is eight times that
VC_BF16_RTOL = 1e-5
# phase 17: the multi-process smoke as a subprocess at each of MP_PROCS
# (one NCCL rank on cuda:0; two processes sharing cuda:0 under Gloo), the
# parent's wait for its workers MP_TIMEOUT seconds
MP_PROCS = {1: "backend nccl; device cuda:0", 2: "backend gloo; device cuda:0"}
MP_TIMEOUT = 300
# detection on the card against the CPU plain path, as in the tests:
# corners identical; angles to 1e-4 rad; descriptor bits may flip only
# where cos/sin differ by an ulp and a rotated tap lands on .5
CHECK_IMAGES, ANGLE_ATOL, BIT_FLIP_SHARE = 4, 1e-4, 5e-4


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counts():
    """Set every kernel's launch count to 0."""
    from photometric_bundle_adjustment_tpu_torch.ops import (
        hamming,
        patch_sample,
        pba_mega,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        exp_roll,
        grid_overhead,
    )

    pba_mega.KERNEL_LAUNCHES = 0
    pba_mega.KERNEL_LAUNCHES_BF16 = 0
    hamming.KERNEL_LAUNCHES = 0
    patch_sample.KERNEL_LAUNCHES = 0
    grid_overhead.KERNEL_LAUNCHES = 0
    exp_roll.KERNEL_LAUNCHES = 0


def timed_pair(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two ``graph_ms`` readings
    (a CUDA graph of 20 calls each) taken in the order
    plain/kernel/kernel/plain."""
    from photometric_bundle_adjustment_tpu_torch.profile_solve import graph_ms

    p = [graph_ms(plain)]
    k = [graph_ms(kernel), graph_ms(kernel)]
    p.append(graph_ms(plain))
    return float(np.mean(k)), float(np.mean(p))


def pose_errors(cameras: dict, poses_gt: dict, se3):
    """Mean translation (m) and rotation (rad) error of each camera against
    ground truth."""
    keys = sorted(poses_gt)
    T = torch.as_tensor(np.stack([cameras[k] for k in keys]))
    G = torch.as_tensor(np.stack([poses_gt[k] for k in keys]))
    xi = se3.log(se3.compose(se3.inverse(G), T))
    return float(xi[:, :3].norm(dim=1).mean()), float(xi[:, 3:].norm(dim=1).mean())


def warp_bounds(ref, images, warp):
    """What the kernel's own warp may move, column by column: its pixel
    coordinates differ from the plain version's by up to WARP_ULPS ulps
    (FMA) of the projection's scale, |u| + fx (the point's coordinates
    carry ulps of |q|, which the focal length scales; for u near 0 the
    ulp of u alone would be far too small).  Within a bilinear cell the value moves by |gradient| times that
    and the x-gradient by |v00 - v01 - v10 + v11| times the y move (the
    y-gradient likewise), which the Jacobian rows carry through GA and GB
    and A0, A1 through their products.  The Huber weight sw =
    sqrt(HUBER / |r|) (1 where |r| <= HUBER) follows the residual: a move
    dr changes it by at most 0.5 |dr| / max(|r|, HUBER) of itself, and
    every row that carries sw with it.  Returns (smooth, dr, drsw, dJ,
    dA0, dA1): the columns with no point within WARP_ULPS ulps of a pixel
    edge (the gradient jumps there, so nothing first-order holds), and
    first-order bounds of the residual (P, N), of r sw (P, N), the 136
    Jacobian rows and the 17 rows of A0 and A1."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    ux, uy, GA, GB, consts = warp
    timg = consts.timg
    P = pba_mega.P
    N = ux.shape[1]
    eps = torch.finfo(torch.float32).eps
    _, H, W = images.shape
    du = WARP_ULPS * eps * (ux.abs() + consts.intr_t[0].abs())
    dv = WARP_ULPS * eps * (uy.abs() + consts.intr_t[1].abs())
    xy = torch.cat([ux, uy]).double()
    smooth = ~((xy - xy.round()).abs() <= torch.cat([du, dv])).any(0)
    x = ux.clamp(0, W - 1.001)
    y = uy.clamp(0, H - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = images.float().reshape(-1)
    base = timg.clamp_min(0).long()[None, :] * (H * W) + y0.long() * W \
        + x0.long()
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + W], flat[base + W + 1]
    gx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
    cross = (v00 - v01 - v10 + v11).abs()
    sw = (-ref[15]).abs()[None, :]                # Jacobian column 15 = -sw
    dr = gx.abs() * du + gy.abs() * dv            # (P, N)
    rsw = ref[136:144].abs()
    norm_r = rsw.norm(dim=0) / sw[0].clamp_min(1e-30)
    dsw = 0.5 * dr.norm(dim=0) / norm_r.clamp_min(HUBER)     # relative, (N,)
    dgeo = (GA.abs().reshape(13, P, N) * (cross * dv)
            + GB.abs().reshape(13, P, N) * (cross * du)) * sw
    zero = torch.zeros_like(dgeo[:2])
    J = ref[:136].reshape(P, 17, N).permute(1, 0, 2).abs()   # (17, P, N)
    dJ = torch.cat([dgeo[0:6], zero, dgeo[6:12], zero, dgeo[12:13]]) \
        + J * dsw
    drsw = dr * sw + rsw * dsw
    dA0 = (dJ * J[16] + J * dJ[16]).sum(dim=1)
    dA1 = (dJ * rsw + J * drsw).sum(dim=1)
    return smooth, dr, drsw, dJ.permute(1, 0, 2).reshape(136, N), dA0, dA1


def compare_payloads(out, ref, images, label: str, warp,
                     ref64=None) -> float:
    """Kernel payload against the plain version's; returns max |err| over
    the finite entries.  NaN columns (non-finite projections) must match.
    ``images`` sets the intensity scale of the cost row's FMA bound.
    Every row block is held at ROWS_ATOL times its max |ref|.

    ``warp`` = (ux, uy, GA, GB, consts), the plain version's warp and the
    kernel's static columns.  The kernel computes its own warp, so each
    entry's bound also takes what a move of WARP_ULPS ulps of its
    coordinates moves (``warp_bounds``), and the columns with a point
    that close to a pixel edge are held only to their NaN pattern and the
    total cost (their count is printed).  ``ref64``, where given, is the
    plain version evaluated in f64 on the same inputs: each row block of
    the kernel, on the smooth columns, is held no further from it than
    F64_FACTOR times the f32 plain version's own distance plus ROWS_ATOL
    times its max |ref|."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    cost_k, cost_r = out[pba_mega.ROW_COST], ref[pba_mega.ROW_COST]
    nan_k, nan_r = torch.isnan(cost_k), torch.isnan(cost_r)
    check(bool((nan_k == nan_r).all()), f"{label}: NaN columns differ")
    ok = ~nan_r
    check(bool(torch.isfinite(out[:, ok]).all()), f"{label}: non-finite output")
    eps = torch.finfo(torch.float32).eps
    ulp_img = eps * float(images.abs().max())
    N = out.shape[1]
    smooth, dr, drsw, dJ, dA0, dA1 = warp_bounds(ref, images, warp)
    smooth &= ok
    extra = {"J": dJ, "r*sw": drsw, "A0": dA0, "A1": dA1,
             "pad": torch.zeros_like(ref[179:184])}
    if ref64 is not None:
        # a column whose f64 projection is not finite (at the edge of the
        # model's domain) has no f64 value to hold; counted and printed
        fin64 = torch.isfinite(ref64[pba_mega.ROW_COST])[smooth]
    rel = ((cost_k[ok] - cost_r[ok]).abs()
           / cost_r[ok].abs().clamp_min(1e-30)).max()
    total_rel = abs(float(cost_k[ok].double().sum() - cost_r[ok].double().sum())
                    ) / max(float(cost_r[ok].double().sum()), 1e-30)
    max_err, blocks = 0.0, []
    for name, rows in [("J", slice(0, 136)), ("r*sw", slice(136, 144)),
                       ("A0", slice(145, 162)), ("A1", slice(162, 179)),
                       ("pad", slice(179, 184))]:
        a, b = out[rows][:, smooth], ref[rows][:, smooth]
        err = (a - b).abs()
        scale = max(float(b.abs().max()), 1e-6)
        worst = float((err / (ROWS_ATOL * scale + extra[name][:, smooth])
                       ).max())
        check(worst <= 1.0, f"{label}: rows {name} beyond {ROWS_ATOL} x "
              f"{scale:.4e} + the warp's bound ({worst:.3f} of it)")
        max_err = max(max_err, float(err.max()))
        blocks.append(f"{name} {float(err.max()):.2e}/{scale:.2e} "
                      f"({worst:.2f} of bound)")
        if ref64 is not None:
            c64 = ref64[rows][:, smooth][:, fin64]
            k64 = float((a[:, fin64].double() - c64).abs().max())
            p64 = float((b[:, fin64].double() - c64).abs().max())
            check(k64 <= F64_FACTOR * p64 + ROWS_ATOL * scale,
                  f"{label}: rows {name} {k64:.4e} from the f64 plain "
                  f"version, the f32 plain version {p64:.4e}")
            blocks[-1] += f", f64: kernel {k64:.2e}, plain {p64:.2e}"
    # per-observation cost: rtol plus the FMA bound of the residual, to
    # first and second order
    cost_err = (cost_k - cost_r).abs()
    d = COST_FMA_ULPS * ulp_img + dr
    bound = COST_RTOL * cost_r.abs() \
        + (ref[136:144].abs() * d + 0.5 * d * d).sum(dim=0)
    ratio = torch.where(smooth, cost_err / bound.clamp_min(1e-30),
                        torch.zeros_like(cost_err))
    worst, at = (float(v) for v in ratio.max(dim=0))
    check(worst <= 1.0, f"{label}: cost row beyond rtol {COST_RTOL} + "
          f"{COST_FMA_ULPS} ulps of the image scale + the warp's bound "
          f"({worst:.3f} of it at column {int(at)}: kernel "
          f"{float(cost_k[int(at)]):.9e}, plain {float(cost_r[int(at)]):.9e})")
    check(total_rel <= COST_RTOL, f"{label}: total cost rel err {total_rel}")
    max_err = max(max_err, float(cost_err[smooth].max()))
    print(f"  {label}: {int(ok.sum())} of {N} columns finite, "
          f"{int((ok & ~smooth).sum())} with a point within {WARP_ULPS} ulps "
          f"of |u| + fx of a pixel edge; max|err| {max_err:.3e}, cost max rel "
          f"{float(rel):.3e}, total cost rel {total_rel:.3e}, cost err "
          f"{worst:.3f} of bound")
    print(f"    max|err| / max|ref| per row block: {', '.join(blocks)}")
    if ref64 is not None:
        print(f"    against f64: {int(fin64.sum())} of {int(smooth.sum())} "
              f"smooth columns finite in f64")
    return max_err


def pushed_state(problem, device):
    """The problem's state with observations made off-image and
    non-finite through the state, as the megakernel now takes no pixel
    planes: every 7th camera moved 0.8 m sideways (its targets leave the
    image), every 97th landmark at a negative inverse depth (behind the
    camera), landmark 5 at an infinite one (projections not finite).
    Returns (cams, rho)."""
    pose = problem.cam_states.pose.clone()
    pose[::7, 0] += 0.8
    rho = problem.inv_depth.clone()
    rho[::97] = -rho[::97].abs()
    rho[5] = float("inf")
    return problem.cam_states._replace(pose=pose), rho


def bits_equal(build, label: str):
    """Two builds of the same input must be bit-equal."""
    c1, neq1 = build()
    c2, neq2 = build()
    same = torch.equal(c1, c2) and all(torch.equal(a, b)
                                       for a, b in zip(neq1, neq2))
    check(same, f"{label}: two builds of the same input differ")
    print(f"  {label}: two first builds bit-equal (cost {float(c1):.9e}, "
          f"{len(neq1)} normal-equation pieces)")


def mega_against_plain(model, images, cams, rho, c, label: str, device):
    """The fused kernel against its plain version (``warp_slabs`` +
    ``mega_rj_reference``) on these card inputs: the payloads compared
    (``compare_payloads``, also against the plain version in f64), zero
    columns zero, both timed on the device
    and the kernel through its wrapper, the bound counted.  Returns
    (max_abs_err, ms, plain_ms, bound_ms)."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.profile_solve import time_ms

    ref = pba_mega.mega_fused_reference(model, images, cams, rho, c, HUBER)
    out = pba_mega.mega_fused(model, images, cams, rho, c, HUBER)
    ref64 = pba_mega.mega_fused_reference(
        model, images.double(), type(cams)(*(x.double() for x in cams)),
        rho.double(), c._replace(d3=c.d3.double(), intr_t=c.intr_t.double(),
                                 refp=c.refp.double()), HUBER)
    torch.cuda.synchronize()
    ux, uy, _, GA, GB = pba_mega.warp_slabs(model, cams, rho, c)
    max_err = compare_payloads(out, ref, images, label, (ux, uy, GA, GB, c),
                               ref64)
    check(bool((out[:, c.timg < 0] == 0).all()),
          f"{label}: a zero column is not zero")
    del out, ref, ref64, ux, uy, GA, GB

    def kernel():
        return pba_mega.mega_fused(model, images, cams, rho, c, HUBER)

    ms, plain_ms = timed_pair(kernel, lambda: pba_mega.mega_fused_reference(
        model, images, cams, rho, c, HUBER))
    wrapper_ms = time_ms(kernel, device)
    print(f"  kernel {ms:.4f} ms, plain (warp_slabs + mega_rj_reference) "
          f"{plain_ms:.4f} ms per build on the device (CUDA graphs of 20 "
          f"calls, plain/kernel/kernel/plain); through the wrapper "
          f"{wrapper_ms:.4f} ms per call (20 calls between CUDA events: the "
          f"host's launch rate)")
    bound_ms = mega_bound_ms(model, images, cams, rho, c, log=print)
    print(f"  bound {bound_ms:.4f} ms: the kernel at "
          f"{bound_ms / ms:.1%} of it")
    return max_err, ms, plain_ms, bound_ms


def kernel_phase(pipe, device):
    """Phase 1: the fused kernel against its plain version at EuRoC scale,
    timed, and on an 8448-pixel-wide image.  Returns (max_abs_err, ms,
    plain_ms, bound_ms)."""
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device=device)
    K = problem.cam_states.pose.shape[0]
    model = pipe.calib.cam_types[0]
    images = images_flat.reshape(-1, H, W).contiguous()
    cams, rho = pushed_state(problem, device)
    _, rows = pba_mega.build_chunk_mega_plan(problem)
    c = pba_mega.make_mega_consts(model, problem, rows)
    N = c.cols.shape[1]
    n_obs = int((c.timg >= 0).sum())
    print(f"phase 1: fused kernel vs plain at {K} images of {H}x{W}, model "
          f"{model}, {n_obs} observations in {N} columns (one zero column)")
    result = mega_against_plain(model, images, cams, rho, c, "EuRoC scale",
                                device)

    # an image wider than the TPU kernel's 14-bit column field
    imgs, cw, rw, constw, _ = synthetic.wide_image_state(device=device)
    refw = pba_mega.mega_fused_reference("pinhole", imgs, cw, rw, constw,
                                         HUBER)
    warpw = pba_mega.warp_slabs("pinhole", cw, rw, constw)
    outw = pba_mega.mega_fused("pinhole", imgs, cw, rw, constw, HUBER)
    torch.cuda.synchronize()
    compare_payloads(outw, refw, imgs, f"W={imgs.shape[2]}",
                     warpw[:2] + warpw[3:] + (constw,))
    check(bool((outw[:, constw.timg < 0] == 0).all()),
          "zero columns are not zero")
    return result


def slice_phase(pipe, device, se3):
    """Phase 2: the photometric path, after two first builds of its
    level-0 solver are held bit-equal.  Returns the kernel launch count."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    from photometric_bundle_adjustment_tpu_torch.optim import ba

    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    n_obs = sum(len(lm.obs) - 1 for lm in pipe.landmarks.values())
    print(f"phase 2: refine_photometric, {len(pipe.cameras)} images, "
          f"{len(pipe.landmarks)} landmarks, {n_obs} observations, "
          f"{LEVELS} levels x {MAX_ITERATIONS} iterations")
    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device=device)
    solve = pba_mega.make_mega_solver(pipe.calib.cam_types[0], images_flat, H,
                                      W, problem, device=device)
    cfg = ba.BAConfig(huber_delta=HUBER)
    bits_equal(lambda: solve.build(problem, cfg),
               f"chunk family at level 0 ({solve.consts.cols.shape[1]} "
               f"columns)")
    del solve, problem, images_flat
    reset_counts()
    t0 = time.perf_counter()
    res = pba_refine.refine_photometric(
        pipe, levels=LEVELS, max_iterations=MAX_ITERATIONS,
        huber_delta=HUBER, log=lambda s: None, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pba_mega.KERNEL_LAUNCHES
    for lv in pipe.photometric_levels:
        print(f"  level {lv['level']} ({lv['W']}x{lv['H']}): cost "
              f"{lv['initial_cost']:.6e} -> {lv['cost']:.6e}, "
              f"{lv['iterations']} iterations, {lv['tries']} tries, set-up "
              f"{lv['setup_s']:.3f} s, solve {lv['solve_s']:.3f} s, "
              f"{lv['iterations'] / lv['solve_s']:.2f} LM it/s, "
              f"{lv['tries'] / lv['solve_s']:.2f} tries/s")
        check(math.isfinite(lv["cost"]), f"level {lv['level']}: non-finite cost")
        check(lv["cost"] < lv["initial_cost"],
              f"level {lv['level']}: cost did not fall")
    err1 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    print(f"  total {wall:.2f} s; kernel launches {launches}; pose error "
          f"vs ground truth: translation {err0[0]:.5f} -> {err1[0]:.5f} m, "
          f"rotation {err0[1]:.6f} -> {err1[1]:.6f} rad")
    check(math.isfinite(float(res.cost)), "final cost is not finite")
    check(all(np.isfinite(p).all() for p in pipe.cameras.values()),
          "non-finite pose")
    check(all(math.isfinite(lm.inv_depth) for lm in pipe.landmarks.values()),
          "non-finite inverse depth")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "pose error against ground truth did not shrink")
    expected = sum(lv["tries"] + 1 for lv in pipe.photometric_levels)
    check(launches == expected,
          f"kernel launches {launches} != builds {expected}")
    return launches


def grid_sample_values(images, ux, uy, img):
    """The value (not the gradient) of the sampler through one
    ``torch.nn.functional.grid_sample`` call: the stack as one tall image,
    coordinates clamped to their column's image and stacked,
    ``align_corners=True`` and border padding.  Returns (call, values);
    ``call`` times the one library call alone.  A yardstick; the port
    never calls it."""
    K, H, W = images.shape
    x = ux.clamp(0, W - 1.001)
    y = img.clamp_min(0).long()[None, :] * H + uy.clamp(0, H - 1.001)
    grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (K * H - 1) - 1],
                       dim=-1)[None]
    tall = images.reshape(1, 1, K * H, W)

    def call():
        return torch.nn.functional.grid_sample(
            tall, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    return call, call()[0, 0]


def check_first_build(solve, solve_ref, problem, plan, cfg, label: str):
    """The kernel solver's build against the gather solver's on the card,
    at the ROADMAP's parity tolerances."""
    cost, neq = solve.build(problem, plan, cfg)
    ref_cost, ref_neq = solve_ref.build(problem, plan, cfg)
    rel = abs(float(cost) - float(ref_cost)) / abs(float(ref_cost))
    check(rel <= NEQ_TOL[0], f"{label}: first build cost rel err {rel}")
    worst = []
    for name, a, b in zip(NEQ_NAMES, neq, ref_neq):
        scale = max(float(b.abs().max()), 1e-30)
        bound = NEQ_TOL[1] * scale + NEQ_TOL[2] * b.abs()
        ratio = float(((a - b).abs() / bound).max())
        check(ratio <= 1.0, f"{label}: {name} beyond the parity tolerance "
              f"({ratio:.3f} of bound)")
        worst.append(f"{name} {ratio:.1e}")
    print(f"  {label}: first build = the gather solver's on the card (cost "
          f"rel {rel:.2e}; pieces at this share of their bound: "
          f"{', '.join(worst)})")


def run_solver(solve, problem, plan, cfg, label: str):
    """One counted solve: returns (problem, result, launches, seconds)."""
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p, res = solve(problem, plan, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ps.KERNEL_LAUNCHES
    init, cost = float(res.initial_cost), float(res.cost)
    print(f"  {label}: cost {init:.6e} -> {cost:.6e}, {res.iterations} "
          f"iterations, {res.tries} tries, {res.builds} builds, "
          f"{res.residual_passes} residual passes in {secs:.3f} s: "
          f"{res.iterations / secs:.2f} LM it/s, {res.tries / secs:.2f} "
          f"tries/s; sampler launches {launches}")
    check(math.isfinite(cost), f"{label}: non-finite cost")
    check(cost < init, f"{label}: cost did not fall")
    check(bool(torch.isfinite(p.cam_states.pose).all()
               and torch.isfinite(p.inv_depth).all()),
          f"{label}: non-finite state")
    check(launches == res.builds + res.residual_passes,
          f"{label}: sampler launches {launches} != builds {res.builds} + "
          f"residual passes {res.residual_passes}")
    return p, res, launches, secs


def sampler_phase(pipe, device, se3):
    """Phase 4: the patch sampler at EuRoC scale and the two
    kernel-sampled fused solvers.  Returns the sampler's JSON fields."""
    from photometric_bundle_adjustment_tpu_torch.models import (
        photometric_ba as pba,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps
    from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        graph_ms,
        time_ms,
    )

    problem, images_flat, H, W, cam_list, _ = \
        pba_refine.build_photometric_problem(pipe, device=device)
    K = problem.cam_states.pose.shape[0]
    model = pipe.calib.cam_types[0]
    solve_k = pba.make_kernel_fused_solver(model, images_flat, H, W, problem,
                                           device=device)
    images, rj_fn = solve_k.images, solve_k.fns[1]

    # (a) the kernel against its plain version on the warped coordinates
    # of the problem's own rows
    o = problem.obs
    O = o.valid.shape[0]
    ux, uy, _ = rj_fn.warp(ba.take_rows(problem.cam_states, o.anchor_cam),
                           ba.take_rows(problem.cam_states, o.target_cam),
                           problem.inv_depth[o.landmark], o.aux)
    fin = torch.isfinite(ux) & torch.isfinite(uy)
    ux = torch.where(fin, ux, torch.full_like(ux, -1e6)).contiguous()
    uy = torch.where(fin, uy, torch.full_like(uy, -1e6)).contiguous()
    cols = torch.arange(0, O, 97, device=device)
    ux[:, cols[0::3]] -= 0.8 * W
    uy[:, cols[1::3]] += 0.7 * H
    ux[:, cols[2::3]] += 1.3 * W
    ux[:, 5] = -1e6
    uy[:, 5] = -1e6
    img = pba._column_images(problem, device)[:O].clone()
    img[::1001] = -1                         # a few zero columns
    args = (images, ux, uy, img, (H, W), True)
    zero = img < 0
    print(f"phase 4: patch sampler vs plain at {K} images of {H}x{W}, "
          f"{O} observation columns in the problem's order "
          f"({int(zero.sum())} of them zero columns)")
    out = ps.sample_patches(*args)
    ref = ps.sample_patches_reference(*args)
    torch.cuda.synchronize()
    scale = float(images.abs().max())
    max_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(max_err <= SAMPLE_ATOL * scale,
          f"sampler max err {max_err} > {SAMPLE_ATOL} * {scale}")
    check(all(bool((a[:, zero] == 0).all()) for a in out),
          "sampler zero columns are not zero")
    print(f"  max|err| {max_err:.3e} (bound {SAMPLE_ATOL * scale:.3e}); "
          f"{int(zero.sum())} zero columns exactly zero")
    ms, plain_ms = timed_pair(lambda: ps.sample_patches(*args),
                              lambda: ps.sample_patches_reference(*args))
    wrapper_ms = time_ms(lambda: ps.sample_patches(*args), device)
    call, lib_val = grid_sample_values(images, ux, uy, img)
    lib_err = float((lib_val - out[0])[:, ~zero].abs().max())
    check(lib_err <= 1e-2 * scale, f"grid_sample differs by {lib_err}")
    library_ms = graph_ms(call)
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call on the "
          f"device (CUDA graphs of 20 calls, plain/kernel/kernel/plain); one "
          f"grid_sample call {library_ms:.4f} ms (a graph of 20) for the "
          f"value alone, no gradient (within {lib_err:.2e} of the kernel's "
          f"value); through the wrapper {wrapper_ms:.4f} ms per call (20 "
          f"calls between CUDA events: the host's launch rate)")
    bound_ms = sample_bound_ms(images, ux, uy, img, log=print)
    print(f"  bound {bound_ms:.4f} ms: the kernel at {bound_ms / ms:.1%} "
          f"of it")
    del out, ref, args

    # (b) make_kernel_fused_solver on the map in its own order, classic loop
    cfg = ba.BAConfig(max_iterations=MAX_ITERATIONS, huber_delta=HUBER)
    plan = fused.plan_for_problem(problem, pow2_buckets=False)
    solve_g = pba.make_fused_solver(model, images_flat, H, W, device=device)
    check_first_build(solve_k, solve_g, problem, plan, cfg, "kernel_fused")
    bits_equal(lambda: solve_k.build(problem, plan, cfg), "kernel_fused")
    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    p, _, launches_b, _ = run_solver(solve_k, problem, plan, cfg,
                                     f"kernel_fused ({K} images of {H}x{W}, "
                                     f"{O} rows, classic loop)")
    poses = p.cam_states.pose.double().cpu().numpy()
    err1 = pose_errors(dict(zip(cam_list, poses)), pipe.poses_gt, se3)
    print(f"  kernel_fused pose error vs ground truth: translation "
          f"{err0[0]:.5f} -> {err1[0]:.5f} m, rotation {err0[1]:.6f} -> "
          f"{err1[1]:.6f} rad")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "kernel_fused: pose error against ground truth did not shrink")

    # (c) make_kernel_dense_solver on the uniform EuRoC-scale problem
    t0 = time.perf_counter()
    prob_u, imgs_u, Hu, Wu = synthetic.euroc_scale_pba(seed=SEED,
                                                       device=device)
    prob_d, plan_d = fused.densify_problem(prob_u, pow2_buckets=False)
    Ku = prob_u.cam_states.pose.shape[0]
    solve_d = pba.make_kernel_dense_solver("pinhole", imgs_u, Hu, Wu, prob_d,
                                           device=device)
    S = plan_d.lm_cam.shape[0]
    print(f"  euroc_scale_pba: {Ku} images of {Hu}x{Wu}, "
          f"{int((prob_u.obs.valid != 0).sum())} observations in {S} x "
          f"{prob_u.inv_depth.shape[0]} slots (set up in "
          f"{time.perf_counter() - t0:.1f} s)")
    cfg_d = cfg._replace(cost_from_build=True)
    solve_gd = pba.make_fused_solver("pinhole", imgs_u, Hu, Wu, device=device)
    check_first_build(solve_d, solve_gd, prob_d, plan_d, cfg_d,
                      "kernel_dense")
    bits_equal(lambda: solve_d.build(prob_d, plan_d, cfg_d), "kernel_dense")
    _, _, launches_c, _ = run_solver(solve_d, prob_d, plan_d, cfg_d,
                                     "kernel_dense (fused-cost loop)")
    return dict(launches=launches_b + launches_c, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=library_ms)


def dense_phase(pipe, device, se3):
    """Phase 5: the dense slot-major family and the bf16 tier.  Returns
    the bf16 entry's JSON fields."""
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        graph_ms,
    )

    t0 = time.perf_counter()
    prob_u, imgs_u, H, W = synthetic.euroc_scale_pba(seed=SEED, device=device)
    prob_d, plan_d = fused.densify_problem(prob_u, pow2_buckets=False)
    K = prob_u.cam_states.pose.shape[0]
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated(device) / 2**20
    solve_d = pba_mega.make_mega_solver("pinhole", imgs_u, H, W, prob_d,
                                        plan_d, device=device)
    solve_c = pba_mega.make_mega_solver("pinhole", imgs_u, H, W, prob_u,
                                        device=device)
    S = plan_d.lm_cam.shape[0]
    n_obs = int((prob_u.obs.valid != 0).sum())
    print(f"phase 5: dense family on euroc_scale_pba, {K} images of {H}x{W}, "
          f"{n_obs} observations in {S} x {prob_u.inv_depth.shape[0]} slot "
          f"rows, the kernel on {solve_d.consts.cols.shape[1]} columns (set "
          f"up in {time.perf_counter() - t0:.1f} s)")

    # (a) the dense family's first build and damped solve = the chunk's
    cfg = ba.BAConfig(max_iterations=MAX_ITERATIONS, huber_delta=HUBER,
                      cost_from_build=True)
    c_d, neq_d = solve_d.build(prob_d, cfg)
    c_c, neq_c = solve_c.build(prob_u, cfg)
    rel = abs(float(c_d) - float(c_c)) / abs(float(c_c))
    check(rel <= 1e-5, f"dense build cost rel err {rel} against the chunk's")
    free = ~prob_u.fixed_cams
    deltas_d = solve_d.solve_lam(neq_d, 1e-4, free, cfg)
    deltas_c = solve_c.solve_lam(neq_c, 1e-4, free, cfg)
    errs = []
    for name, a, b in zip(("delta_c", "delta_p"), deltas_d, deltas_c):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(err <= 2e-3, f"dense {name} differs from the chunk family's "
              f"by {err:.3e} x max")
        errs.append(f"{name} {err:.2e}")
    print(f"  (a) first build = the chunk family's (cost rel {rel:.2e}); "
          f"damped solve at lambda 1e-4: max|err| / max|ref| "
          f"{', '.join(errs)}")
    del neq_d, neq_c, solve_c
    for tier, c in (("f32", cfg), ("bf16", cfg._replace(sample_bf16=True))):
        bits_equal(lambda: solve_d.build(prob_d, c), f"dense family, {tier}")

    # (b) the bf16 kernel against its plain version on the widened stack
    cfg16 = cfg._replace(sample_bf16=True)
    consts = solve_d.consts
    rest = (prob_d.cam_states, prob_d.inv_depth, consts, HUBER)
    bf = solve_d.stack(cfg16)
    stack_mib = bf.numel() * bf.element_size() / 2**20
    out = pba_mega.mega_fused("pinhole", bf, *rest)
    ref = pba_mega.mega_fused_reference("pinhole", bf.float(), *rest)
    torch.cuda.synchronize()
    ux, uy, _, GA, GB = pba_mega.warp_slabs(
        "pinhole", prob_d.cam_states, prob_d.inv_depth, consts)
    max_err = compare_payloads(out, ref, bf.float(), "(b) bf16 kernel",
                               (ux, uy, GA, GB, consts))
    del ux, uy, GA, GB
    del out, ref
    ms, plain_ms = timed_pair(
        lambda: pba_mega.mega_fused("pinhole", bf, *rest),
        lambda: pba_mega.mega_fused_reference("pinhole", bf, *rest))
    ms32 = graph_ms(lambda: pba_mega.mega_fused("pinhole", solve_d.images,
                                                *rest))
    print(f"  bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the f32 "
          f"kernel on the same inputs {ms32:.4f} ms per build on the device "
          f"(CUDA graphs of 20 calls)")
    bound_ms = mega_bound_ms("pinhole", bf, prob_d.cam_states,
                             prob_d.inv_depth, consts, log=print)
    print(f"  bound {bound_ms:.4f} ms: the bf16 kernel at "
          f"{bound_ms / ms:.1%} of it")

    # (c) the dense solver in both tiers, the fused-cost loop
    launches = 0
    for tier, c in (("f32", cfg), ("bf16", cfg16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held_mib = torch.cuda.memory_allocated(device) / 2**20
        reset_counts()
        t0 = time.perf_counter()
        p, res = solve_d(prob_d, c)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n32, n16 = pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16
        init, cost = float(res.initial_cost), float(res.cost)
        print(f"  (c) dense solver, {tier}: cost {init:.6e} -> {cost:.6e}, "
              f"{res.iterations} iterations, {res.tries} tries in {secs:.3f} "
              f"s: {res.iterations / secs:.2f} LM it/s, "
              f"{res.tries / secs:.2f} tries/s; launches f32 {n32}, bf16 "
              f"{n16}; peak {torch.cuda.max_memory_allocated(device) / 2**20:.1f}"
              f" MiB, {held_mib:.1f} held before the solve ({base_mib:.1f} "
              f"before the solvers were made, the bf16 stack {stack_mib:.1f})")
        check(math.isfinite(cost) and cost < init,
              f"dense {tier}: cost did not fall to a finite value")
        check(bool(torch.isfinite(p.cam_states.pose).all()
                   and torch.isfinite(p.inv_depth).all()),
              f"dense {tier}: non-finite state")
        want = (res.tries + 1, 0) if tier == "f32" else (0, res.tries + 1)
        check((n32, n16) == want, f"dense {tier}: launches (f32, bf16) "
              f"{(n32, n16)} != builds {want}")
        launches += n16
    del solve_d, rest, bf

    # (d) refine_photometric in the bf16 tier on the initial map
    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    reset_counts()
    t0 = time.perf_counter()
    pba_refine.refine_photometric(
        pipe, levels=LEVELS, max_iterations=MAX_ITERATIONS,
        huber_delta=HUBER, sample_bf16=True, log=lambda s: None,
        device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n32, n16 = pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16
    for lv in pipe.photometric_levels:
        print(f"  (d) bf16 level {lv['level']} ({lv['W']}x{lv['H']}): cost "
              f"{lv['initial_cost']:.6e} -> {lv['cost']:.6e}, "
              f"{lv['iterations']} iterations, {lv['tries']} tries, "
              f"{lv['iterations'] / lv['solve_s']:.2f} LM it/s")
        check(math.isfinite(lv["cost"]) and lv["cost"] < lv["initial_cost"],
              f"bf16 level {lv['level']}: cost did not fall")
    err1 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    builds = sum(lv["tries"] + 1 for lv in pipe.photometric_levels)
    print(f"  (d) total {wall:.2f} s; launches f32 {n32}, bf16 {n16}; pose "
          f"error: translation {err0[0]:.5f} -> {err1[0]:.5f} m, rotation "
          f"{err0[1]:.6f} -> {err1[1]:.6f} rad")
    check((n32, n16) == (0, builds),
          f"refine bf16: launches (f32, bf16) {(n32, n16)} != (0, {builds})")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "refine bf16: pose error against ground truth did not shrink")
    return dict(launches=launches + n16, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None)


def probe_phase(device):
    """Phase 6: the grid-overhead probe and the window read.  Returns the
    JSON fields of both."""
    from photometric_bundle_adjustment_tpu_torch.profile_solve import graph_ms
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        exp_roll,
        grid_overhead as go,
    )

    print("phase 6: the grid-overhead probe (11 variants: device ms, plain "
          "ms, bound, share of the bound; two calls bit-equal)")
    reset_counts()
    rows = go.run(device, log=lambda line: print("  " + line))
    go_launches = go.KERNEL_LAUNCHES
    base = rows[0]["ms"]
    for r in rows:
        extra = "" if r is rows[0] else f", {r['ms'] - base:+.4f} ms"
        print(f"  {r['ms']:.4f} ms{extra} beside the output-only variant, "
              f"{r['share']:.1%} of its bound: {r['label']}")
    low = min(rows, key=lambda r: r["share"])
    print(f"  smallest share of the bound: {low['share']:.1%} "
          f"({low['label']})")
    scratch = next(r for r in rows if "scratch_bytes" in r)
    print(f"  the scratch variant reserves {scratch['scratch_bytes']} B of "
          f"dynamic shared memory per block")
    ng_cols = go.NG * go.GROUP
    zeros_ms = graph_ms(lambda: torch.zeros((go.OUT_ROWS, ng_cols),
                                            device=device))
    print(f"  output-only floor, one torch.zeros of the output: "
          f"{zeros_ms:.4f} ms (beside {base:.4f} ms for grid+out only)")
    entry = next(r for r in rows
                 if r["label"] == f"3 prefetch ({ng_cols} code), no scratch")
    # no single PyTorch call computes the zeros and the checksums
    grid = dict(launches=go_launches, max_abs_err=entry["max_abs_err"],
                ms=entry["ms"], plain_ms=entry["plain_ms"],
                bound_ms=entry["bound_ms"], bound_by="bytes",
                library_ms=None)

    print("  window read: the script's call, B = 1")
    reset_counts()
    ok = exp_roll.main(["--device", str(device)])
    roll_launches = exp_roll.KERNEL_LAUNCHES
    check(all(ok.values()), f"exp_roll entry point: {ok}")
    gen = torch.Generator(device="cpu").manual_seed(0)
    fields = None
    for B in (1, 4096):
        x = torch.randn((B, exp_roll.ROWS, exp_roll.COLS),
                        generator=gen).to(device)
        s = torch.full((B,), exp_roll.SHIFT, dtype=torch.int32, device=device)
        for mode in exp_roll.MODES:
            out = exp_roll.window(x, s, mode)
            ref = exp_roll.window_reference(x, s, mode)
            check(torch.equal(out, ref),
                  f"exp_roll {mode} at B={B} differs from its plain version")
            err = float((out - ref).abs().max())
            ms, plain_ms = timed_pair(
                lambda: exp_roll.window(x, s, mode),
                lambda: exp_roll.window_reference(x, s, mode))
            # the function needs only the 128 columns of its window: each
            # of them read once, each output written once, the shifts read
            nbytes = 4 * (2 * out.numel() + s.numel())
            bound_ms = 1e3 * nbytes / H100_BYTES_PER_S
            line = (f"  {mode} at B={B}: bit-identical; {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ("
                    f"{nbytes / 1e6:.2f} MB)")
            if mode == "roll":
                shift = -exp_roll.SHIFT
                check(torch.equal(torch.roll(x, shift, 2)[..., :exp_roll.WIN],
                                  out), "torch.roll differs from the kernel")
                library_ms = graph_ms(lambda: torch.roll(x, shift, 2))
                line += f"; one torch.roll {library_ms:.4f} ms"
                if B == 4096:
                    fields = dict(launches=roll_launches, max_abs_err=err,
                                  ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by="bytes",
                                  library_ms=library_ms)
            print(line + f": the kernel at {bound_ms / ms:.1%} of the bound")
    return grid, fields


def cuobjdump_usage(name: str):
    """Each kernel function of the built library ``name``: its registers,
    stack and local memory (``cuobjdump -res-usage``; spills would show as
    stack or local memory) and its tensor-core instructions (``-sass``:
    IMMA, BMMA or HGMMA).  Returns {function: (usage dict, mma list)}."""
    import re

    from photometric_bundle_adjustment_tpu_torch.ops import _build

    cuobjdump = _build._nvcc().rsplit("/", 1)[0] + "/cuobjdump"

    def dump(flag):
        return subprocess.run([cuobjdump, flag, _build.load(name)._name],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout

    def per_function(text, pattern):
        out, fn = {}, None
        for line in text.splitlines():
            m = re.search(r"Function\s*:?\s*(\w+)", line)
            if m:
                fn = m.group(1)
                out.setdefault(fn, [])
            elif fn:
                out[fn] += re.findall(pattern, line)
        return out

    res = per_function(dump("-res-usage"), r"(REG|STACK|LOCAL):(\d+)")
    mma = per_function(dump("-sass"), r"\b(IMMA|BMMA|HGMMA)\b")
    return {fn: (dict((k, int(v)) for k, v in res.get(fn, [])),
                 mma.get(fn, [])) for fn in set(res) | set(mma)}


def hamming_resources():
    """Phase 0's account of the Hamming kernel: each instance's registers,
    spills and tensor-core instructions, then its dynamic shared memory at
    the front end's F = 512.  Fails unless every instance issues
    tensor-core instructions and none spills."""
    import re

    from photometric_bundle_adjustment_tpu_torch.ops import hamming

    for fn, (usage, mma) in sorted(cuobjdump_usage("hamming").items()):
        # hamming_kernel<kBoth>
        tag = re.search(r"hamming_kernelILb(\d)E", fn)
        if not tag:
            continue
        both = tag.group(1) == "1"
        ops = {op: mma.count(op) for op in sorted(set(mma))}
        print(f"  hamming, {'both directions' if both else 'forward'}: "
              f"{usage.get('REG', 'not read')} registers, stack "
              f"{usage.get('STACK', 'not read')} B, local "
              f"{usage.get('LOCAL', 'not read')} B; tensor-core SASS "
              f"{', '.join(f'{k} x{v}' for k, v in ops.items()) or 'none'}")
        check(usage.get("STACK", 0) == 0 and usage.get("LOCAL", 0) == 0,
              f"{fn} spills registers")
        check(sum(ops.values()) > 0, f"{fn} issues no tensor-core "
              f"instruction")
    print(f"  hamming: {hamming.smem_bytes(512, 512, True)} B of shared "
          f"memory a block at F = 512, both directions "
          f"({hamming.smem_bytes(512, 512, False)} B forward)")


def mega_resources():
    """Phase 0's account of the megakernel: the registers, stack and local
    memory (spills) of each template instance (camera model, texel type),
    as ``cuobjdump`` reads them.  Reported, not
    checked: a spill costs time, not correctness."""
    import re

    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    n = 0
    for fn, (usage, _) in sorted(cuobjdump_usage("pba_mega").items()):
        tag = re.search(r"mega_kernelILi(\d)E(\w+?)EEv", fn)
        if not tag:
            continue
        n += 1
        texel = "bf16" if "bfloat16" in tag.group(2) else "f32"
        print(f"  pba_mega, {pba_mega.MODELS[int(tag.group(1))]}, {texel}: "
              f"{usage.get('REG', 'not read')} registers, stack "
              f"{usage.get('STACK', 'not read')} B, local "
              f"{usage.get('LOCAL', 'not read')} B")
    check(n == 2 * len(pba_mega.MODELS),
          f"{n} megakernel instances read, expected {2 * len(pba_mega.MODELS)}")


def int_mm_best_two(desc, valid):
    """The Hamming best-two of every ordered image pair through the int8
    tensor cores, as one PyTorch library call per image: descriptors as
    {0, 1} bit planes, H(a, b) = pop(a) + pop(b) - 2 a.b by
    ``torch._int_mm``, then the plain min reductions.  Returns best,
    second, idx, each (I, F, I): [a, row, b].  A yardstick for the
    kernel's time; the port never calls it."""
    from photometric_bundle_adjustment_tpu_torch.ops import hamming

    I, F, _ = desc.shape
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    planes = ((desc[..., None] >> shifts) & 1).reshape(I * F, 256)
    planes = planes.to(torch.int8)
    pop = planes.sum(1, dtype=torch.int32)
    big = torch.tensor(hamming.BIG, dtype=torch.int32, device=desc.device)
    col_ok = valid.reshape(1, -1)
    out = [torch.empty((I, F, I), dtype=torch.int32, device=desc.device)
           for _ in range(3)]
    for i in range(I):
        rows = slice(i * F, (i + 1) * F)
        ab = torch._int_mm(planes[rows], planes.t())
        dist = torch.where(col_ok, pop[rows, None] + pop[None, :] - 2 * ab, big)
        for o, r in zip(out, hamming.best_two_from(dist.reshape(F, I, F), 2)):
            o[i] = r
    return out


def front_end_phase(device, b1_rate):
    """Phase 3: the SfM front end at EuRoC V1's size; ``b1_rate`` is phase
    0's measured b1 mma rate, for the Hamming bound.  Returns the Hamming
    kernel's JSON fields, the pipeline, the sequence, and the descriptors
    with their compacted all-pairs matches (phase 13's ring reference)."""
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.features import (
        describe,
        match,
        pair_matching,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import hamming
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        time_ms,
    )

    t0 = time.perf_counter()
    seq = synthetic.synth_stereo_sequence(n_frames=FRONT_FRAMES, H=FRONT_H,
                                          W=FRONT_W, seed=SEED, device=device)
    n_img = len(seq.images)
    print(f"phase 3: SfM front end, {n_img} images of {FRONT_H}x{FRONT_W} "
          f"(rendered on the card in {time.perf_counter() - t0:.1f} s)")
    pipe = SfmPipeline(seq.images, seq.calib, log=lambda s: None,
                       device=device)
    cfg = pipe.cfg

    # the main path, counts from 0
    reset_counts()
    t0 = time.perf_counter()
    pipe.detect_keypoints()
    t1 = time.perf_counter()
    pipe.match_stereo()
    t2 = time.perf_counter()
    ids = np.array(pipe._pair_worklist())
    _, valid, desc, _ = pipe._stack_features()
    table = pair_matching.match_pairs(
        desc, valid, ids[:, 0], ids[:, 1], cfg.feature_match_max_dist,
        cfg.feature_match_test_next_best)
    compact = match.matches_to_pairs(table, cfg.max_matches_per_pair)
    count = compact[2].cpu().numpy()
    t3 = time.perf_counter()
    launches = hamming.KERNEL_LAUNCHES
    n_stereo = len(pipe.matches)

    n = np.array([int(pipe.corners[k]["valid"].sum()) for k in pipe.fcids])
    P, F = len(ids), desc.shape[1]
    print(f"  detect: {1e3 * (t1 - t0) / n_img:.2f} ms per image "
          f"({t1 - t0:.3f} s, {pipe.counters['detect_batches']} batches of "
          f"8); valid corners per image min {n.min()}, median "
          f"{int(np.median(n))}, max {n.max()}; compacted to F={F}")
    check(CORNERS_MEDIAN[0] <= np.median(n) <= CORNERS_MEDIAN[1],
          f"median corner count {np.median(n)} outside {CORNERS_MEDIAN}")
    n_m = sum(len(m["matches"]) for m in pipe.matches.values())
    n_i = sum(len(m["inliers"]) for m in pipe.matches.values())
    print(f"  match_stereo: {n_stereo} pairs in {t2 - t1:.3f} s, {n_m} "
          f"matches, {n_i} epipolar inliers")
    print(f"  match_pairs: {P} pairs at F={F} in {t3 - t2:.3f} s with the "
          f"compaction on the card ({P / (t3 - t2):.0f} pairs/s); "
          f"{int((table >= 0).sum())} mutual matches, {int(count.sum())} "
          f"kept at {cfg.max_matches_per_pair} per pair")
    for got, ref in zip(compact, pair_matching.compact_matches_np(
            table.cpu().numpy(), cfg.max_matches_per_pair)):
        check(np.array_equal(got.cpu().numpy(), ref),
              "matches_to_pairs differs from compact_matches_np")
    check(P == FRONT_FRAMES * (FRONT_FRAMES - 1) * 2,
          f"worklist has {P} pairs")
    print(f"  Hamming kernel launches on the path: {launches}")
    check(launches == 2, f"Hamming launches {launches} != 1 for "
          f"match_stereo + 1 for match_pairs")

    # stereo inliers against the rendered ground truth
    close = 0
    for ((f, _), _), m in pipe.matches.items():
        inl = m["inliers"]
        uv_r = pipe.corners[(f, 1)]["uv"][inl[:, 1]]
        uv_t, front = seq.correspondence(
            (f, 0), (f, 1), pipe.corners[(f, 0)]["uv"][inl[:, 0]])
        close += int(((np.linalg.norm(uv_t - uv_r, axis=1) <= GT_PX)
                      & front).sum())
    share = close / max(n_i, 1)
    print(f"  stereo inliers within {GT_PX} px of the true correspondence: "
          f"{close} of {n_i} ({share:.1%})")
    check(n_i > 0 and share >= GT_SHARE,
          f"only {share:.1%} of the stereo inliers on the ground truth")

    # detection and description on the card against the CPU plain path
    keys = pipe.fcids[:CHECK_IMAGES]
    imgs = torch.as_tensor(np.stack([seq.images[k] for k in keys]))
    ref = interop.features_to_numpy(dict(zip(
        ("uv", "valid", "angles", "desc"),
        describe.detect_and_describe_batch(imgs, cfg.num_features_per_image))))
    flips = bits = 0
    ang_err = 0.0
    for i, k in enumerate(keys):
        c = pipe.corners[k]
        check(np.array_equal(c["uv"], ref["uv"][i])
              and np.array_equal(c["valid"], ref["valid"][i]),
              f"corners of {k} differ from the CPU plain path")
        v = c["valid"]
        ang_err = max(ang_err, float(np.abs(c["angles"][v]
                                            - ref["angles"][i][v]).max()))
        x = c["desc"][v] ^ ref["desc"][i][v]
        flips += int(np.unpackbits(x.view(np.uint8)).sum())
        bits += x.size * 32
    print(f"  {len(keys)} images against the CPU plain path: corners "
          f"identical, angles within {ang_err:.2e} rad, {flips} of {bits} "
          f"descriptor bits differ")
    check(ang_err <= ANGLE_ATOL, f"angles differ by {ang_err}")
    check(flips <= BIT_FLIP_SHARE * bits, f"{flips} descriptor bits differ")

    # the kernel against its plain version over the whole worklist
    a = torch.as_tensor(ids[:, 0], device=device)
    b = torch.as_tensor(ids[:, 1], device=device)

    def kernel_both():
        return hamming.best_two_both(desc, valid, desc, valid, a, b)

    def plain_both():
        return hamming.best_two_both_reference(desc, valid, desc, valid, a, b)

    out, ref = kernel_both(), plain_both()
    torch.cuda.synchronize()
    max_err = max(int((o - r).abs().max()) for o, r in zip(out, ref))
    check(all(torch.equal(o, r) for o, r in zip(out, ref)),
          f"Hamming kernel differs from its plain version (max {max_err})")
    print(f"  kernel bit-identical to the plain version over all {P} pairs, "
          f"both directions")
    lib = int_mm_best_two(desc, valid)
    for (o_f, o_b), l in zip(zip(out[:3], out[3:]), lib):
        check(torch.equal(l[a, :, b], o_f) and torch.equal(l[b, :, a], o_b),
              "the _int_mm form differs from the kernel")
    del ref, lib

    plain_ms = [time_ms(plain_both, device, reps=1, warmup=0)]
    ms = [time_ms(kernel_both, device, reps=10, warmup=1)]
    library_ms = time_ms(lambda: int_mm_best_two(desc, valid), device,
                         reps=2, warmup=1)
    ms.append(time_ms(kernel_both, device, reps=10, warmup=0))
    plain_ms.append(time_ms(plain_both, device, reps=1, warmup=0))
    ms, plain_ms = float(np.mean(ms)), float(np.mean(plain_ms))
    print(f"  all-pairs best-two, both directions in one launch: kernel "
          f"{ms:.4f} ms ({P / ms * 1e3:.0f} pairs/s), plain {plain_ms:.4f} "
          f"ms, _int_mm form {library_ms:.4f} ms over all {n_img}^2 ordered "
          f"pairs (CUDA events; plain/kernel/library/kernel/plain)")
    bound_ms, bound_by = hamming_bound_ms(valid, a, b, F, b1_rate,
                                          log=print)
    print(f"  bound {bound_ms:.4f} ms ({bound_by}): the kernel at "
          f"{bound_ms / ms:.1%} of it")
    ring_ref = dict(desc=desc.cpu(), valid=valid.cpu(), ids=ids,
                    compact=[x.cpu().numpy() for x in compact],
                    max_matches=cfg.max_matches_per_pair,
                    threshold=cfg.feature_match_max_dist,
                    ratio=cfg.feature_match_test_next_best)
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms), pipe, seq, ring_ref


def pose_error_stats(matches, keys, poses_gt, se3):
    """Rotation errors (rad) and angles between the translation
    directions (rad) of the relative poses ``matches[k]["T_i_j"]`` of the
    pairs ``keys`` against ground truth."""
    f64 = torch.float64
    T = torch.as_tensor(np.stack([matches[k]["T_i_j"] for k in keys]),
                        dtype=f64)
    Ta = torch.as_tensor(np.stack([poses_gt[a] for a, _ in keys]), dtype=f64)
    Tb = torch.as_tensor(np.stack([poses_gt[b] for _, b in keys]), dtype=f64)
    T_gt = se3.compose(se3.inverse(Ta), Tb)
    rot = torch.linalg.norm(se3.so3_log(se3.quat_mul(
        se3.quat_conj(se3.rotation(T)), se3.rotation(T_gt))), dim=-1)
    t_gt = se3.translation(T_gt)
    cos = torch.sum(se3.translation(T) * t_gt, -1) / (
        torch.linalg.norm(se3.translation(T), dim=-1)
        * torch.linalg.norm(t_gt, dim=-1))
    return rot.numpy(), torch.arccos(torch.clamp(cos, -1.0, 1.0)).numpy()


def direction_angles(Ta, Tb, se3) -> torch.Tensor:
    """Angles (rad) between the translation directions of poses Ta and Tb
    (B, 7)."""
    ta, tb = se3.translation(Ta), se3.translation(Tb)
    cos = torch.sum(ta * tb, -1) / (torch.linalg.norm(ta, dim=-1)
                                    * torch.linalg.norm(tb, dim=-1))
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def relative_conditioning(b0, b1, inl, T, se3) -> torch.Tensor:
    """Condition number (B,) of each pair's refinement at its pose T: the
    largest eigenvalue of J^T J of ``ransac.relative_residual`` over the
    second smallest (the smallest is the translation's scale, which the
    residual does not see)."""
    from photometric_bundle_adjustment_tpu_torch.features import ransac

    out = []
    for i in range(T.shape[0]):
        res = ransac.relative_residual(b0[i:i + 1], b1[i:i + 1], inl[i:i + 1])
        J = torch.func.jacfwd(lambda d: res(se3.right_plus(
            T[i:i + 1], d[None]))[0])(torch.zeros(6, dtype=T.dtype))
        ev = torch.linalg.eigvalsh(J.T @ J)
        out.append(ev[-1] / ev[1])
    return torch.stack(out)


def ransac_phase(pipe, seq, device, se3) -> int:
    """Phase 8: match_all with RANSAC over the whole worklist, against
    ground truth, the card against the CPU, and PnP on every image.
    Returns the Hamming launches of match_all."""
    from photometric_bundle_adjustment_tpu_torch.core import cameras
    from photometric_bundle_adjustment_tpu_torch.features import (
        match,
        nister,
        pair_matching,
        ransac,
    )
    from photometric_bundle_adjustment_tpu_torch.optim.ba import full_f32
    from photometric_bundle_adjustment_tpu_torch.ops import hamming
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        profile_run,
    )

    cfg = pipe.cfg
    P = len(pipe._pair_worklist())
    print(f"phase 8: RANSAC. (a) SfmPipeline.match_all over {P} pairs, "
          f"{cfg.ransac_hypotheses} five-point hypotheses a pair, f64")
    # the main path, counts from 0
    reset_counts()
    done = dict(pipe.counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    pipe.match_all()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = hamming.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    chunks = pipe.counters["match_chunks"] - done.get("match_chunks", 0)
    check(pipe.counters["match_pairs"] - done.get("match_pairs", 0) == P,
          "match_all skipped pairs")
    check(launches == 1, f"match_all launched the Hamming kernel "
          f"{launches} times, not once")
    # a second call, warm (the generator draws on: other samples)
    t0 = time.perf_counter()
    pipe.match_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    C = -(-P // chunks)
    print(f"  match_all: {wall:.3f} s warm, match_all_pairs_per_s "
          f"{P / wall:.1f} (the first call {cold:.3f} s, {P / cold:.1f}/s); "
          f"{chunks} RANSAC chunks of {C} pairs on average; Hamming launches "
          f"{launches} in the first call; peak {peak:.1f} MiB")

    # (b) the successful pairs against the ground truth
    keys = [(pipe.fcids[a], pipe.fcids[b]) for a, b in pipe._pair_worklist()]
    ok = [k for k in keys if len(pipe.matches[k]["inliers"])]
    n_inl = sum(len(pipe.matches[k]["inliers"]) for k in ok)
    check(len(ok) > 0, "no pair passed RANSAC")
    rot, ang = pose_error_stats(pipe.matches, ok, seq.poses_gt, se3)
    image = {k: i for i, k in enumerate(sorted(seq.poses_gt))}
    src, dst, uv_a, uv_b = [], [], [], []
    for a, b in ok:
        inl = pipe.matches[(a, b)]["inliers"]
        src.append(np.full(len(inl), image[a]))
        dst.append(np.full(len(inl), image[b]))
        uv_a.append(pipe.corners[a]["uv"][inl[:, 0]])
        uv_b.append(pipe.corners[b]["uv"][inl[:, 1]])
    uv_t, front = seq.correspondences(
        np.concatenate(src), np.concatenate(dst),
        torch.as_tensor(np.concatenate(uv_a), device=device))
    close = int(((np.linalg.norm(uv_t - np.concatenate(uv_b), axis=1)
                  <= GT_PX) & front).sum())
    share = close / n_inl
    print(f"  (b) {len(ok)} of {P} pairs succeeded, {n_inl} inliers; "
          f"rotation error median {np.median(rot):.3e}, p95 "
          f"{np.percentile(rot, 95):.3e} rad; translation direction median "
          f"{np.median(ang):.3e}, p95 {np.percentile(ang, 95):.3e} rad; "
          f"inliers within {GT_PX} px of the true correspondence: {close} "
          f"of {n_inl} ({share:.1%})")
    check(np.median(rot) <= RANSAC_ROT_MEDIAN,
          f"median rotation error {np.median(rot):.3e} rad")
    check(share >= GT_SHARE, f"only {share:.1%} of the inliers on the "
          f"ground truth")

    # the device's busy share over one chunk's call (the Hamming match,
    # the compaction and one RANSAC chunk)
    sub = pipe._pair_worklist()[:C]
    n0 = pipe.counters["match_chunks"]
    prof = profile_run(lambda: pipe._run_pair_matching(sub), 1, device)
    n_sub = pipe.counters["match_chunks"] - n0
    print(f"  {len(sub)} pairs ({n_sub} chunk) under the profiler: wall "
          f"{prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f}%), "
          f"{prof['device_kernels_per_run'] / n_sub:.0f} device kernels a "
          f"chunk")
    for op, (count, t) in list(prof["top_self_ms"].items())[:5]:
        print(f"    {op[:100]}: {t:.3f} ms over {count} calls")

    # (c) the card against the CPU on the same samples
    ids = np.array(pipe._pair_worklist())
    _, valid, desc, bear = pipe._stack_features()
    pairs, pvalid, count = match.matches_to_pairs(pair_matching.match_pairs(
        desc, valid, ids[:, 0], ids[:, 1], cfg.feature_match_max_dist,
        cfg.feature_match_test_next_best), cfg.max_matches_per_pair)
    cand = np.nonzero(count.cpu().numpy()
                      > cfg.relative_pose_ransac_min_inliers)[0]
    sel = cand[np.linspace(0, len(cand) - 1, RANSAC_PAIRS).astype(int)]
    sel_d = torch.as_tensor(sel, device=device)
    i1 = torch.as_tensor(ids[sel, 0], device=device)
    i2 = torch.as_tensor(ids[sel, 1], device=device)
    b0 = bear[i1[:, None], pairs[sel_d, :, 0].long()]
    b1 = bear[i2[:, None], pairs[sel_d, :, 1].long()]
    pv = pvalid[sel_d]
    idx = ransac._sample_indices(torch.Generator().manual_seed(0),
                                 cfg.ransac_hypotheses, 5, pv.cpu())
    kw = dict(threshold=cfg.relative_pose_ransac_thresh,
              min_inliers=cfg.relative_pose_ransac_min_inliers,
              num_hypotheses=cfg.ransac_hypotheses)
    t0 = time.perf_counter()
    Tg, inl_g, _ = ransac.ransac_relative_pose(b0, b1, pv, idx=idx.to(device),
                                               **kw)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    Tc, inl_c, _ = ransac.ransac_relative_pose(b0.cpu(), b1.cpu(), pv.cpu(),
                                               idx=idx, **kw)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    inl_g = inl_g.cpu()
    diff = float((inl_g != inl_c).double().mean())
    same = (inl_g == inl_c).all(-1)
    ang = direction_angles(Tg.cpu(), Tc, se3)
    cond = relative_conditioning(b0.cpu(), b1.cpu(), inl_c, Tc, se3)
    # the refinement alone, from the CPU's best hypothesis and its inliers
    with full_f32():
        b0c, b1c, pvc = b0.cpu(), b1.cpu(), pv.cpu()
        Es, ev = nister.five_point_candidates(ransac._gather_rows(b0c, idx),
                                              ransac._gather_rows(b1c, idx))
        T0, w0 = ransac._best_relative(b0c, b1c, pvc, ransac._prescreen(
            b0c, b1c, pvc, Es, ev), kw["threshold"])
        Tr = [ransac._refine_relative(x0, x1, w, T0.to(x0.device), 10).cpu()
              for x0, x1, w in ((b0, b1, w0.to(device)), (b0c, b1c, w0))]
    ang_lm = direction_angles(*Tr, se3)
    print(f"  (c) {RANSAC_PAIRS} pairs on the card ({card_ms:.1f} ms) and the "
          f"CPU ({cpu_ms:.1f} ms), same samples: {diff:.3%} of the inlier "
          f"entries differ ({int(same.sum())} pairs with equal masks); "
          f"translation directions within {RANSAC_DIR_RAD:.0e} rad on "
          f"{int((ang <= RANSAC_DIR_RAD).sum())} pairs, at most "
          f"{float(ang.max()):.3e} (at equal masks {float(ang[same].max()):.3e}"
          f"); refinement conditioned {float(cond.min()):.1e} to "
          f"{float(cond.max()):.1e}")
    print(f"      the refinement alone from the CPU's best hypothesis on both: "
          f"translation directions within {float(ang_lm.max()):.3e} rad")
    check(diff <= RANSAC_MASK_SHARE, f"{diff:.3%} of the inlier entries "
          f"differ between the card and the CPU")
    check(float(ang_lm.max()) <= RANSAC_DIR_RAD, f"refined translation "
          f"directions {float(ang_lm.max()):.3e} rad apart on the card and "
          f"the CPU")

    # (d) PnP on every image: bearings of its corners, the room points
    # their rays meet, PNP_OUTLIERS of the bearings replaced
    gen = torch.Generator(device=device).manual_seed(0)
    f64 = torch.float64
    n_k = np.array([min(PNP_CORNERS, int(pipe.corners[k]["valid"].sum()))
                    for k in pipe.fcids])
    F, K = int(n_k.max()), len(pipe.fcids)
    uv = torch.as_tensor(np.stack([pipe.corners[k]["uv"][:F]
                                   for k in pipe.fcids]), dtype=f64,
                         device=device)
    # detection fills its slots valid first: the first n_k rows of each
    valid_p = (torch.arange(F, device=device)[None]
               < torch.as_tensor(n_k, device=device)[:, None])
    intr = torch.as_tensor(np.asarray(pipe.calib.intrinsics), dtype=f64,
                           device=device)
    cam = torch.as_tensor([c for _, c in pipe.fcids], device=device)
    f = cameras.unproject_unit(pipe.model, intr[cam][:, None], uv)
    image = {k: i for i, k in enumerate(sorted(seq.poses_gt))}
    p_w = seq.world_points(np.repeat([image[k] for k in pipe.fcids], F),
                           uv.reshape(-1, 2)).reshape(K, F, 3)
    bad = torch.rand((K, F), generator=gen, device=device) < PNP_OUTLIERS
    rnd = torch.randn((K, F, 3), generator=gen, device=device, dtype=f64)
    rnd[..., 2] = rnd[..., 2].abs() + 0.5
    f = torch.where(bad[..., None], rnd / torch.linalg.norm(
        rnd, dim=-1, keepdim=True), f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T_w_c, inl = ransac.ransac_pnp(f, p_w, valid_p, gen, num_hypotheses=512,
                                   lo_rounds=2, solver="p3p")
    torch.cuda.synchronize()
    pnp_ms = 1e3 * (time.perf_counter() - t0)
    T_gt = torch.as_tensor(np.stack([seq.poses_gt[k] for k in pipe.fcids]),
                           dtype=f64, device=device)
    err = torch.linalg.norm(se3.log(se3.compose(se3.inverse(T_gt), T_w_c)),
                            dim=-1).cpu().numpy()
    bad = bad & valid_p
    good = valid_p & ~bad
    recall = float((inl & good).sum() / good.sum())
    kept_bad = float((inl & bad).sum() / bad.sum())
    print(f"  (d) ransac_pnp on {K} cameras x {n_k.min()} to {F} corners "
          f"({PNP_OUTLIERS:.0%} "
          f"outliers), P3P, 512 hypotheses, 2 LO rounds: {pnp_ms:.1f} ms; "
          f"pose error median {np.median(err):.3e}, max {err.max():.3e}; "
          f"inlier recall {recall:.2%}, outliers kept {kept_bad:.2%}")
    check(np.median(err) <= PNP_POSE_MEDIAN,
          f"PnP median pose error {np.median(err):.3e}")
    return launches


def kernel_counts() -> dict:
    """Every kernel's launch count."""
    from photometric_bundle_adjustment_tpu_torch.ops import (
        hamming,
        patch_sample,
        pba_mega,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        exp_roll,
        grid_overhead,
    )

    return {"pba_mega": pba_mega.KERNEL_LAUNCHES,
            "pba_mega_bf16": pba_mega.KERNEL_LAUNCHES_BF16,
            "hamming": hamming.KERNEL_LAUNCHES,
            "patch_sample": patch_sample.KERNEL_LAUNCHES,
            "grid_overhead": grid_overhead.KERNEL_LAUNCHES,
            "exp_roll": exp_roll.KERNEL_LAUNCHES}


def geo_errors(problem, poses_gt, rho_gt, se3):
    """Mean translation (m) and rotation (rad) error of the observed
    cameras' poses (a camera no observation names keeps its initial
    pose) and mean relative inverse-depth error, against ground truth."""
    o = problem.obs
    seen = torch.zeros(poses_gt.shape[0], dtype=torch.bool,
                       device=poses_gt.device)
    seen[o.target_cam[o.valid != 0]] = True
    seen[o.anchor_cam[o.valid != 0]] = True
    xi = se3.log(se3.compose(se3.inverse(poses_gt[seen].double()),
                             problem.cam_states[seen].double()))
    rho, gt = problem.inv_depth.double(), rho_gt.double()
    return (float(xi[:, :3].norm(dim=1).mean()),
            float(xi[:, 3:].norm(dim=1).mean()),
            float(((rho - gt).abs() / gt).mean()))


def geo_solve(solve, args, label: str):
    """One geometric solve, timed; checks that its cost falls and that
    its result is finite.  Returns (problem, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, res = solve(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    init, cost = float(res.initial_cost), float(res.cost)
    print(f"  {label}: cost {init:.6e} -> {cost:.6e}, {res.iterations} "
          f"iterations, {res.tries} tries in {secs:.3f} s "
          f"({res.iterations / secs:.2f} LM it/s)")
    check(math.isfinite(cost) and cost < init, f"{label}: cost did not fall")
    cams = p.cam_states if isinstance(p.cam_states, tuple) else (p.cam_states,)
    check(all(bool(torch.isfinite(x).all()) for x in cams + (p.inv_depth,)),
          f"{label}: non-finite state")
    return p, res


def geo_bench_phase(device, card: str, se3):
    """Phase 7 (a): bench.py's geometric workload at full size."""
    from photometric_bundle_adjustment_tpu_torch.models import (
        geometric_ba,
        synthetic,
    )
    from photometric_bundle_adjustment_tpu_torch.ops import geo_mega
    from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        GEO,
        GEO_PIXEL_NOISE,
        SEED,
        fixed_step_ms,
        geo_fixed_step,
        graph_ms,
    )

    t0 = time.perf_counter()
    problem, poses_gt, rho_gt = synthetic.synth_ba_problem(
        "pinhole", K=GEO["K"], L=GEO["L"], obs_per_landmark=GEO["obs_per_lm"],
        seed=SEED, pixel_noise=GEO_PIXEL_NOISE, dtype=torch.float32,
        device=device)
    prob_d, plan_d = fused.densify_problem(problem, pow2_buckets=False)
    dense = geo_mega.make_geo_solver("pinhole", prob_d, plan_d, device=device)
    chunk = geo_mega.make_geo_solver("pinhole", problem, device=device)
    torch.cuda.synchronize()
    O = problem.obs.valid.shape[0]
    print(f"phase 7: geometric BA. (a) bench.py's workload: pinhole, "
          f"{GEO['K']} cameras, {GEO['L']} landmarks, {O} observations "
          f"({prob_d.obs.valid.shape[0]} slot rows), f32; problem, plans "
          f"and solvers in {time.perf_counter() - t0:.1f} s")
    cfg = ba.BAConfig(max_iterations=GEO_ITERATIONS, huber_delta=1.0)
    for label, solve, prob in (("dense", dense, prob_d),
                               ("chunk", chunk, problem)):
        bits_equal(lambda: solve.build(prob, cfg), f"geo {label} build")
    e0 = geo_errors(prob_d, poses_gt, rho_gt, se3)
    solved, res_d = geo_solve(dense, (prob_d, cfg), "make_geo_solver dense")
    e1 = geo_errors(solved, poses_gt, rho_gt, se3)
    n_seen = int(torch.unique(torch.cat([prob_d.obs.anchor_cam,
                                         prob_d.obs.target_cam])).numel())
    print(f"    errors of the {n_seen} observed cameras: translation "
          f"{e0[0]:.3e} -> {e1[0]:.3e} m, rotation {e0[1]:.3e} -> "
          f"{e1[1]:.3e} rad; inverse depth {e0[2]:.3e} -> {e1[2]:.3e} "
          f"(at 0.3 px the translations drift from ground truth along the "
          f"chain of cameras: held on the zero-noise twin below)")
    check(e1[1] < e0[1] and e1[2] < e0[2],
          "geo: rotation or inverse-depth error did not shrink")
    # the same workload at zero pixel noise, where ground truth is the
    # optimum: every error must shrink
    p0, gt0, rho0 = synthetic.synth_ba_problem(
        "pinhole", K=GEO["K"], L=GEO["L"], obs_per_landmark=GEO["obs_per_lm"],
        seed=SEED, pixel_noise=0.0, dtype=torch.float32, device=device)
    p0, plan0 = fused.densify_problem(p0, pow2_buckets=False)
    z0 = geo_errors(p0, gt0, rho0, se3)
    s0, _ = geo_solve(geo_mega.make_geo_solver("pinhole", p0, plan0,
                                               device=device), (p0, cfg),
                      "zero-noise twin, dense")
    z1 = geo_errors(s0, gt0, rho0, se3)
    print(f"    zero-noise twin: translation {z0[0]:.3e} -> {z1[0]:.3e} m, "
          f"rotation {z0[1]:.3e} -> {z1[1]:.3e} rad, inverse depth "
          f"{z0[2]:.3e} -> {z1[2]:.3e}")
    check(all(b < 0.1 * a for a, b in zip(z0, z1)),
          "geo zero-noise twin: errors did not shrink tenfold")
    _, res_c = geo_solve(chunk, (problem, cfg), "make_geo_solver chunk")
    _, res_b = geo_solve(
        lambda p, c: geometric_ba.bundle_adjustment(p, "pinhole", c),
        (problem, cfg), "bundle_adjustment")
    costs = [float(r.cost) for r in (res_d, res_c, res_b)]
    check(max(costs) - min(costs) <= GEO_COST_RTOL * min(costs),
          f"geo: final costs {costs} differ by more than rtol "
          f"{GEO_COST_RTOL}")

    step = geo_fixed_step(dense, prob_d, cfg._replace(max_iterations=1))
    ms = fixed_step_ms(step, prob_d, GEO_STEPS, device)
    ms_graph = graph_ms(lambda: step(prob_d)[1])
    print(f"  fixed LM step (build_geo on the dense plan, fused.solve_lam "
          f"at lambda 1e-4, retraction): {ms:.4f} ms launched from the host "
          f"({GEO_STEPS} chained steps less one, CUDA events), "
          f"{ms_graph:.4f} ms from a CUDA graph of 20 steps")
    print(f"  geo_lm_iters_per_s {1e3 / ms:.2f} (host-launched; "
          f"{1e3 / ms_graph:.2f} from the graph) on {card}")
    return 1e3 / ms, 1e3 / ms_graph


def reference_trajectory(path) -> dict:
    """{(frame, cam): (7,) pose} of the reference run's CAMERA lines."""
    ref = {}
    for line in path.read_text().splitlines():
        f = line.split()
        if f and f[0] == "CAMERA":
            ref[(int(f[1]), int(f[2]))] = np.array(f[3:10], float)
    return ref


def map_report(problem, cams, ref: dict, model: str) -> tuple[float, float]:
    """(reprojection RMS px, cam-0 position RMSE m against the reference
    run after Umeyama alignment) of a geometric problem's state."""
    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
    from photometric_bundle_adjustment_tpu_torch.optim import ba
    from photometric_bundle_adjustment_tpu_torch.utils import evaluation

    o = problem.obs
    r = geometric_ba.make_residual_fn(model)(
        ba.take_rows(problem.cam_states, o.anchor_cam),
        ba.take_rows(problem.cam_states, o.target_cam),
        problem.inv_depth[o.landmark], o.aux).double()
    rms = float(torch.sqrt((r * r).sum(1).mean()))
    poses = problem.cam_states.double().cpu().numpy()
    est = {k: poses[i] for i, k in enumerate(cams) if k in ref}
    rmse = evaluation.ate_rmse(evaluation.trajectory_from_cameras(est),
                               evaluation.trajectory_from_cameras(
                                   {k: ref[k] for k in est}))
    return rms, rmse


def perturb_map(problem, seed: int):
    """The map with its free poses moved by MAP_POSE_NOISE tangent noise
    and its inverse depths by MAP_DEPTH_NOISE relative noise (numpy
    seed), in float64 on the CPU."""
    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba

    rng = np.random.default_rng(seed)
    free = ~problem.fixed_cams.cpu().numpy()
    d = np.zeros((free.shape[0], 6))
    d[free] = rng.normal(0, MAP_POSE_NOISE, (int(free.sum()), 6))
    rho = problem.inv_depth.cpu().double() * torch.as_tensor(
        1.0 + rng.normal(0, MAP_DEPTH_NOISE, problem.inv_depth.shape[0]))
    poses = geometric_ba.cam_retract(problem.cam_states.cpu().double(),
                                     torch.as_tensor(d))
    return poses, rho


def real_map_problems(device):
    """The real EuRoC V1 map of runs/ (``SfmPipeline.from_map`` on its
    cached corners and the reference calibration) as geometric problems:
    ``({f32: on device, f64: on the CPU}, camera keys, model)``."""
    import pickle
    from pathlib import Path

    from photometric_bundle_adjustment_tpu_torch.io import calib_io
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    root = Path(__file__).resolve().parent
    with open(root / "runs" / "map_r5_run20.pkl", "rb") as f:
        m = pickle.load(f)
    with open(root / "runs" / "cache_r5" / "corners.pkl", "rb") as f:
        corners = pickle.load(f)["data"]
    calib = calib_io.load_calibration(
        str(root / "refbaseline" / "artifacts" / "ref_opt_calib.json"))
    problems = {}
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        pipe = SfmPipeline.from_map(m, corners, calib, log=lambda s: None,
                                    device=dev)
        problems[dtype], cams, _ = pipe._build_ba_problem(dtype=dtype)
    return problems, cams, calib.cam_types[0]


def real_map_phase(device):
    """Phase 7 (b): the real EuRoC V1 map on the card against the port's
    own f64 CPU solve."""
    from pathlib import Path

    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
    from photometric_bundle_adjustment_tpu_torch.optim import ba
    from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
        SchurPlan,
    )

    root = Path(__file__).resolve().parent
    ref = reference_trajectory(root / "refbaseline" / "artifacts"
                               / "run_v1_trajectory.txt")
    problems, cams, model = real_map_problems(device)
    p32 = problems[torch.float32]
    K, L = p32.cam_states.shape[0], p32.inv_depth.shape[0]
    print(f"  (b) the real map: {K} cameras, {L} landmarks, "
          f"{p32.obs.valid.shape[0]} observations, model {model!r}, f32 on "
          f"the card, f64 on the CPU; {MAP_ITERATIONS} iterations, Huber 1")
    _, plan = geometric_ba._accel_plan(p32)
    check(isinstance(plan, SchurPlan), "real map: not the chunk branch")
    print("    _accel_plan: the chunk branch (heavy-tailed map)")
    cfg = ba.BAConfig(max_iterations=MAP_ITERATIONS)
    pert = perturb_map(problems[torch.float64], SEED_MAP)
    for state in ("saved", "perturbed"):
        runs = {}
        for dtype, prob in problems.items():
            if state == "perturbed":
                prob = prob._replace(
                    cam_states=pert[0].to(prob.inv_depth.device, dtype),
                    inv_depth=pert[1].to(prob.inv_depth.device, dtype))
            rms0, rmse0 = map_report(prob, cams, ref, model)
            t0 = time.perf_counter()
            solved, res = geometric_ba.bundle_adjustment(prob, model, cfg)
            if prob.inv_depth.is_cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rms1, rmse1 = map_report(solved, cams, ref, model)
            init, cost = float(res.initial_cost), float(res.cost)
            where = "card f32" if dtype == torch.float32 else "CPU f64"
            print(f"    {state}, {where}: cost {init:.6e} -> {cost:.6e}, "
                  f"{res.iterations} iterations, {res.tries} tries in "
                  f"{secs:.2f} s; reprojection RMS {rms0:.4f} -> {rms1:.4f} "
                  f"px; cam-0 RMSE against the reference run {rmse0:.5f} -> "
                  f"{rmse1:.5f} m")
            check(math.isfinite(cost) and cost <= init,
                  f"real map {state} {where}: cost rose")
            check(bool(torch.isfinite(solved.cam_states).all()),
                  f"real map {state} {where}: non-finite poses")
            if state == "perturbed":
                check(cost < 0.5 * init,
                      f"real map perturbed {where}: cost did not fall")
            runs[where] = cost
        rel = abs(runs["card f32"] - runs["CPU f64"]) / runs["CPU f64"]
        print(f"    {state}: card f32 final cost {rel:.3e} from the CPU's "
              f"f64 (limit {MAP_COST_RTOL})")
        check(rel <= MAP_COST_RTOL, f"real map {state}: the card's final cost "
              f"is {rel:.3e} from the f64 solve")
    print("    (the cam-0 RMSE is the distance from the reference C++ run's "
          "own map, not ground-truth ATE)")


def entry_points_phase(device):
    """Phase 7 (c): ``entry()``, the non-fused photometric solver and the
    generic manifold LM on the card."""
    from photometric_bundle_adjustment_tpu_torch import entry as port_entry
    from photometric_bundle_adjustment_tpu_torch.core import se3
    from photometric_bundle_adjustment_tpu_torch.models import (
        photometric_ba as pba,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.optim import ba
    from photometric_bundle_adjustment_tpu_torch.optim.lm import (
        LMConfig,
        lm_solve,
    )

    step, (problem,) = port_entry.entry(device=device)
    cost, dc, dp = step(problem)
    print(f"  (c) entry(): cost {float(cost):.6e}, |delta_c| "
          f"{float(dc.abs().max()):.3e}, |delta_p| {float(dp.abs().max()):.3e}")
    check(bool(torch.isfinite(cost) and torch.isfinite(dc).all()
               and torch.isfinite(dp).all()) and dc.shape == (4, 8)
          and dp.shape == (256,), "entry(): non-finite or misshapen")

    prob, images, H, W, _, _ = synthetic.synth_pba_problem(K=4, L=256,
                                                           device=device)
    solve = pba.make_solver("pinhole", images, H, W, device=device)
    geo_solve(solve, (prob, ba.BAConfig(max_iterations=10, huber_delta=9.0)),
              "photometric make_solver")

    # the SE3 fit of the reference's test_ceres_se3.cpp (f64 on the card)
    eps = float(np.finfo(np.float64).eps)
    xi = torch.tensor([0.2, 0.5, -1.0, 0.3, -0.1, 0.7], dtype=torch.float64,
                      device=device)
    T_t = se3.exp(xi)
    T_aw = se3.inverse(T_t)
    T0 = se3.exp(torch.zeros_like(xi))
    T_f, res = lm_solve(lambda T: se3.log(se3.compose(T_aw, T)), T0,
                        se3.right_plus, 6,
                        LMConfig(max_iterations=50, function_tolerance=0.01 * eps,
                                 gradient_tolerance=0.0,
                                 parameter_tolerance=0.0))
    mse = float(torch.sum(se3.log(se3.compose(T_aw, T_f)) ** 2))
    print(f"    lm_solve SE3 fit: {res.iterations} iterations, cost "
          f"{float(res.initial_cost):.3e} -> {float(res.cost):.3e}, mse "
          f"{mse:.3e} (limit {10 * eps:.3e})")
    check(mse < 10 * eps, "lm_solve did not converge")


def geo_phase(device, card: str, se3) -> tuple[float, float]:
    """Phase 7: geometric BA.  Returns ``geo_lm_iters_per_s``,
    host-launched and from a CUDA graph."""
    reset_counts()
    rate = geo_bench_phase(device, card, se3)
    real_map_phase(device)
    entry_points_phase(device)
    counts = kernel_counts()
    print(f"  kernel launches in phase 7: {counts} (the geometric path runs "
          f"no hand-written kernel; the JAX package has no Pallas kernel "
          f"there)")
    check(not any(counts.values()), "phase 7 launched a kernel")
    return rate



def drive_sfm(pipe, runner, seq, ate_bound: float, phase: int, device):
    """Drive ``runner`` (``pipe.run`` or ``run_global_init(pipe)``) as the
    main path, the counts from 0, to ``Stage.DONE``; print the stages,
    counters and summary; check at least SFM_REGISTERED of ``seq``'s
    images registered, the cam-0 ATE at most ``ate_bound``, the RMS at
    most SFM_RMS_PX, exactly two Hamming launches (``match_stereo``,
    ``match_all``) and no other kernel.  Returns (wall s, peak MiB,
    counts)."""
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        Stage,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    runner()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    check(pipe.stage == Stage.DONE, f"the run stopped at {pipe.stage}")

    t, td = pipe.timings, pipe.timings_dev
    print("  stages (wall s / device-block s / host s): " + ", ".join(
        f"{k} {t[k]:.3f}/{td.get(k, 0.0):.3f}/{t[k] - td.get(k, 0.0):.3f}"
        for k in t if k != "ba_iters") + f"; ba_iters {t.get('ba_iters', 0)}")
    print("  counters: " + " ".join(
        f"{k}={v}" for k, v in sorted(pipe.counters.items())))
    print(f"  {pipe.summary()}")
    n_img = len(seq.images)
    check(len(pipe.cameras) >= SFM_REGISTERED * n_img,
          f"only {len(pipe.cameras)} of {n_img} images registered")
    m = sfm_run.measure(pipe, seq)
    print(f"  cam-0 ATE (SE3 alignment, {m['cam0_frames']} frames) "
          f"{m['ate_m']:.6e} m (bound {ate_bound} m); reprojection RMS "
          f"{m['rms_px']:.4f} px over {m['observations']} observations "
          f"(bound {SFM_RMS_PX} px)")
    check(m["ate_m"] <= ate_bound, f"ATE {m['ate_m']:.3e} m over {ate_bound} m")
    check(m["rms_px"] <= SFM_RMS_PX, f"reprojection RMS {m['rms_px']:.3f} px")
    check(counts["hamming"] == 2,
          f"the run launched the Hamming kernel {counts['hamming']} times, "
          f"not twice (match_stereo, match_all)")
    others = {k: v for k, v in counts.items() if k != "hamming" and v}
    check(not others, f"the run launched other kernels: {others}")
    print(f"  kernel launches in phase {phase}: {counts}")
    return wall, peak, counts


def sfm_phase(device, card: str):
    """Phase 9: ``SfmPipeline.run`` from images to ``Stage.DONE`` on the
    indoor room, 82 stereo frames, default ``SfmConfig``.  Returns the
    Hamming launches of the run, the finished pipeline (its map as the
    run left it) and the sequence."""
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        profile_run,
    )

    t0 = time.perf_counter()
    seq = synthetic.synth_stereo_sequence(
        n_frames=FRONT_FRAMES, H=FRONT_H, W=FRONT_W, seed=SEED,
        room_radius=synthetic.INDOOR_ROOM_RADIUS, device=device)
    n_img = len(seq.images)
    print(f"phase 9: SfmPipeline.run, {n_img} images of {FRONT_H}x{FRONT_W} "
          f"in the indoor room (radius {synthetic.INDOOR_ROOM_RADIUS} m; "
          f"rendered in {time.perf_counter() - t0:.1f} s), default SfmConfig")
    logs = []
    pipe = SfmPipeline(seq.images, seq.calib, log=logs.append, device=device)
    # the main path, counts from 0
    wall, peak, counts = drive_sfm(pipe, pipe.run, seq, SFM_ATE_M, 9, device)
    front = ("detect", "match_stereo", "match_all")
    map_s = wall - sum(pipe.timings.get(k, 0.0) for k in front)
    print(f"  wall {wall:.3f} s; sfm_keyframes_per_s "
          f"{FRONT_FRAMES / wall:.3f} (the map stages {map_s:.3f} s, "
          f"{map_s / wall:.1%} of the wall); device blocks "
          f"{pipe.device_seconds:.3f} s, host {wall - pipe.device_seconds:.3f}"
          f" s; peak {peak:.1f} MiB")
    rounds = sum(s.startswith("Selected ") for s in logs)
    n_obs = sum(len(lm.obs) for lm in pipe.landmarks.values())
    print(f"  BA solves {pipe.counters.get('ba_solves', 0)}, localisation "
          f"waves {pipe.counters.get('localize_waves', 0)} in {rounds} "
          f"candidate rounds, cameras {len(pipe.cameras)} of {n_img}, "
          f"landmarks {len(pipe.landmarks)}, observations {n_obs}, outlier "
          f"tracks {len(pipe.outlier_tracks)}")
    for line in logs[-4:-2]:
        print(f"  log: {line}")

    # one more BA solve under the profiler, of the finished map with its
    # inverse depths perturbed by SFM_PROFILE_NOISE (seeded), so that the
    # solve iterates as the run's solves do; the map is restored after it
    finished = interop.map_state_to_numpy(pipe)
    rng = np.random.default_rng(SEED)
    for lm in pipe.landmarks.values():
        lm.inv_depth *= 1.0 + SFM_PROFILE_NOISE * rng.normal()
    n_logs = len(logs)
    prof = profile_run(pipe.optimize, 1, device)
    (ba_line,) = [s for s in logs[n_logs:] if s.startswith("BA: ")]
    iters = int(ba_line.split(" in ")[1].split()[0])
    print(f"  one BA solve under the profiler (inverse depths perturbed by "
          f"{SFM_PROFILE_NOISE:.0%}): wall {prof['wall_ms']:.1f} ms, "
          f"{prof['device_kernels_per_run']:.0f} device kernels "
          f"({prof['device_kernels_per_run'] / max(iters, 1):.0f} an "
          f"iteration), device busy {prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f}%); {ba_line}")
    interop.set_map_state(pipe, finished)
    print(card)
    return counts["hamming"], pipe, seq


def refine_phase(pipe, seq, device, card: str):
    """Phase 10: the megakernel against its plain version on the level-0
    problem of phase 9's finished map, then ``apps/pba.refine_map`` (the
    app's defaults) on that map.  Returns the megakernel's launches in
    the refinement, (max_abs_err, ms, plain_ms, bound_ms) of the
    comparison and the refinement's final cost."""
    from photometric_bundle_adjustment_tpu_torch.apps import pba as pba_app
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    n_patch = sum(len(lm.obs) - 1 for lm in pipe.landmarks.values())
    before = sfm_run.measure(pipe, seq)
    print(f"phase 10: apps/pba's refine_map on phase 9's map: "
          f"{len(pipe.cameras)} cameras, {len(pipe.landmarks)} landmarks, "
          f"{n_patch} patch observations; {LEVELS} levels, "
          f"{MAX_ITERATIONS} iterations, Huber {HUBER}, f32")
    # the kernel on this map's level-0 problem (the refinement's first
    # build at level 0 starts from it), outside the counted run
    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device=device)
    model = pipe.calib.cam_types[0]
    _, rows = pba_mega.build_chunk_mega_plan(problem)
    c = pba_mega.make_mega_consts(model, problem, rows)
    print(f"  fused kernel vs plain on its level-0 problem: model {model}, "
          f"{int((c.timg >= 0).sum())} observations in {c.cols.shape[1]} "
          f"columns")
    compared = mega_against_plain(
        model, images_flat.reshape(-1, H, W).contiguous(),
        problem.cam_states, problem.inv_depth, c, "phase 9's map", device)
    del problem, images_flat, c

    logs = []
    # the main path, counts from 0
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    levels = pba_app.refine_map(pipe, iterations=MAX_ITERATIONS, huber=HUBER,
                                levels=LEVELS, log=logs.append,
                                device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    for lv in levels:
        print(f"  level {lv['level']} ({lv['W']}x{lv['H']}): set-up "
              f"{lv['setup_s']:.3f} s, solve {lv['solve_s']:.3f} s, "
              f"{lv['iterations']} iterations "
              f"({lv['iterations'] / lv['solve_s']:.2f} LM it/s), "
              f"{lv['tries']} tries, cost {lv['initial_cost']:.6e} -> "
              f"{lv['cost']:.6e}")
        check(lv["cost"] < lv["initial_cost"],
              f"the cost did not fall at level {lv['level']}")
        check(math.isfinite(lv["cost"]), f"level {lv['level']}: cost not finite")
    after = sfm_run.measure(pipe, seq)
    print(f"  wall {wall:.3f} s; peak {peak:.1f} MiB; {logs[-1].strip()}")
    print(f"  cam-0 ATE {before['ate_m']:.6e} -> {after['ate_m']:.6e} m "
          f"(bound {PBA_ATE_M} m); reprojection RMS {before['rms_px']:.4f} "
          f"-> {after['rms_px']:.4f} px")
    check(after["ate_m"] <= PBA_ATE_M,
          f"refined ATE {after['ate_m']:.3e} m over {PBA_ATE_M} m")
    others = {k: v for k, v in counts.items() if k != "pba_mega" and v}
    check(counts["pba_mega"] > 0, "the refinement never launched #1")
    check(not others, f"the refinement launched other kernels: {others}")
    print(f"  kernel launches in phase 10: {counts}")
    print(card)
    return counts["pba_mega"], compared, levels[-1]["cost"]


def global_init_phase(seq, device, card: str) -> int:
    """Phase 11: ``apps/sfm --global-init`` (``run_global_init``) on phase
    9's images, matched again.  Returns the Hamming launches."""
    from photometric_bundle_adjustment_tpu_torch.apps.sfm import (
        run_global_init,
    )
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    print(f"phase 11: apps/sfm --global-init on phase 9's {len(seq.images)} "
          f"images (detected and matched again)")
    pipe = SfmPipeline(seq.images, seq.calib, log=lambda s: None,
                       device=device)
    # the main path, counts from 0
    wall, peak, counts = drive_sfm(pipe, lambda: run_global_init(pipe), seq,
                                   GLOBAL_ATE_M, 11, device)
    st = pipe.global_init_stats
    rot, tr, tri = st["rotation"], st["translation"], st["triangulation"]
    print(f"  component: {st['cameras']} cameras, {st['edges']} edges")
    print(f"  rotation averaging: cost {rot['initial_cost']:.6e} -> "
          f"{rot['cost']:.6e} in {rot['iterations']} iterations, "
          f"{rot['seconds']:.3f} s")
    print("  translation averaging: " + "; ".join(
        f"cost {t['initial_cost']:.6e} -> {t['cost']:.6e} in "
        f"{t['iterations']} iterations"
        + (f" (rescaled x{t['scale']:.4f})" if "scale" in t else "")
        for t in tr["solves"]) + f"; {tr['seconds']:.3f} s")
    print(f"  triangulation loop: {tri['pairs']} camera pairs, "
          f"{pipe.counters.get('triangulate_calls', 0)} batches, "
          f"{tri['landmarks']} landmarks, {tri['seconds']:.3f} s")
    print(f"  wall {wall:.3f} s; peak {peak:.1f} MiB")
    print(card)
    return counts["hamming"]


def calibration_phase(device, card: str):
    """Phase 12: ``models/calibration.calibrate`` at euroc_calib's size
    for a ds and a kb4 rig, in f64 on the card and on the CPU."""
    from photometric_bundle_adjustment_tpu_torch.core import cameras
    from photometric_bundle_adjustment_tpu_torch.io import calib_io
    from photometric_bundle_adjustment_tpu_torch.models import (
        calibration,
        synthetic,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    print(f"phase 12: calibration, {CALIB_FRAMES} stereo frames of the "
          f"AprilGrid, {CALIB_NOISE_PX} px noise, f64")
    for model, path in CALIB_FILES:
        c = calib_io.load_calibration(os.path.join(root, path))
        g = synthetic.synth_aprilgrid(c.intrinsics, c.T_i_c, model,
                                      n_frames=CALIB_FRAMES,
                                      noise_px=CALIB_NOISE_PX, seed=CALIB_SEED)
        frames = sorted({f for f, _ in g.corners})
        rng = np.random.default_rng(CALIB_SEED + 1)
        start = np.array(g.intrinsics)
        start[:, :4] += rng.normal(0.0, CALIB_START_PX, (len(start), 4))
        start[:, 4:] *= 1.05
        intr0 = np.stack([cameras.initialize(model, torch.as_tensor(k))
                          .numpy() for k in start])
        T_w_i0 = np.stack([g.init_poses[(f, 0)] for f in frames])
        out = []
        for dev in (device, torch.device("cpu")):
            data = calibration.build_data(
                g.corners, frames, calibration.aprilgrid_corners_3d(),
                device=dev)
            init = calibration.CalibParams(*(
                torch.as_tensor(x, dtype=torch.float64, device=dev)
                for x in (T_w_i0, g.T_i_c, intr0)))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, res = calibration.calibrate(model, data, init)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out.append(([x.cpu().numpy() for x in params], res,
                        time.perf_counter() - t0))
        (pg, rg, sg), (pc, rc, sc) = out
        n_res = 2 * data.uv.shape[0]
        rmse = math.sqrt(2.0 * float(rg.cost) / n_res)
        gap = calibration.projection_gap(model, pg[2], g.intrinsics, g.W,
                                         g.H)
        rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(pg, pc))
        print(f"  {model}: {n_res} residuals, {6 * len(frames) + 28} "
              f"tangent dims; card {rg.iterations} iterations in {sg:.3f} s, "
              f"CPU {rc.iterations} in {sc:.3f} s; cost "
              f"{float(rg.initial_cost):.6e} -> {float(rg.cost):.6e}, RMSE "
              f"{rmse:.5f} px (noise {CALIB_NOISE_PX}); |fx fy cx cy - "
              f"truth| max {np.abs(pg[2][:, :4] - g.intrinsics[:, :4]).max():.4f}"
              f" px; projection gap {gap:.4f} px (bound {CALIB_INTR_PX}); "
              f"card vs CPU {rel:.3e} relative (bound {CALIB_REL})")
        check(abs(rmse - CALIB_NOISE_PX) <= CALIB_RMSE_SHARE * CALIB_NOISE_PX,
              f"{model}: RMSE {rmse:.4f} px against noise {CALIB_NOISE_PX}")
        check(gap <= CALIB_INTR_PX, f"{model}: intrinsics {gap:.3f} px off")
        check(rel <= CALIB_REL, f"{model}: card vs CPU {rel:.3e}")
        check(np.array_equal(pg[1][0], g.T_i_c[0]),
              f"{model}: camera 0's extrinsics moved")
    print(card)


def dist_photometric(pipe, finished, seq, device, before):
    """Phase 13 (a): ``refine_photometric_distributed`` on phase 9's map
    (restored before each run): DIST_RANKS ranks replicated and
    camera-partitioned, then one rank under NCCL."""
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    for label, n, part in (("replicated", DIST_RANKS, False),
                           ("camera-partitioned PCG", DIST_RANKS, True),
                           ("replicated, one rank", 1, False)):
        interop.set_map_state(pipe, finished)
        logs = []
        # the main path, counts from 0 (the ranks count their own)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, parity = pba_refine.refine_photometric_distributed(
            pipe, n_ranks=n, max_iterations=MAX_ITERATIONS,
            huber_delta=HUBER, camera_partition=part, log=logs.append,
            device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        st = pipe.distributed_stats
        after = sfm_run.measure(pipe, seq)
        builds = max(st["builds"], 1)
        per_build = ", ".join(
            f"{k} {v / builds:g} x {st['bytes'][k] / v:,.0f} B"
            for k, v in sorted(st["calls"].items()) if k.startswith("build."))
        cg = ", ".join(f"{k} {v}" for k, v in sorted(st["calls"].items())
                       if k.startswith("cg."))
        for line in logs:
            if line.startswith("mesh:"):
                print(f"  {line}")
        print(f"  (a) {label}: {n} rank(s), backend {st['backend']}; valid "
              f"observations per rank {st['valid_obs']}; wall {wall:.3f} s "
              f"(the solve {st['solve_s']:.3f} s on rank 0); "
              f"{res.iterations} LM iterations, {st['builds']} builds, "
              f"{st['tries']} tries, {st['cg_iterations']} CG iterations")
        print(f"      collectives per build: {per_build}; per try: "
              f"cost.psum {st['calls'].get('cost.psum', 0) / max(st['tries'], 1):g}"
              + (f"; in CG: {cg}" if cg else ""))
        print(f"      cost {float(res.initial_cost):.6e} -> "
              f"{float(res.cost):.6e}; single-device {parity['cost_single']:.6e}"
              f" ({parity['iters_single']} iterations), cost_rel "
              f"{parity['cost_rel']:.3e} (bound {DIST_COST_REL}), pose "
              f"max|d| {parity['pose_maxdiff']:.3e}; ranks bit-equal "
              f"{st['ranks_bit_equal']}; cam-0 ATE {before['ate_m']:.6e} -> "
              f"{after['ate_m']:.6e} m (bound {PBA_ATE_M} m), RMS "
              f"{after['rms_px']:.4f} px")
        check(st["backend"] == ("nccl" if n == 1 else "gloo"),
              f"{label}: backend {st['backend']}")
        check(float(res.cost) < float(res.initial_cost),
              f"{label}: the cost did not fall")
        check(parity["cost_rel"] <= DIST_COST_REL,
              f"{label}: cost_rel {parity['cost_rel']:.3e}")
        check(st["ranks_bit_equal"], f"{label}: ranks not bit-equal")
        check(after["ate_m"] <= PBA_ATE_M,
              f"{label}: ATE {after['ate_m']:.3e} m over {PBA_ATE_M} m")
        check(not any(counts.values()),
              f"{label}: the solve launched a kernel: {counts}")
        check(not part or st["cg_iterations"] > 0, f"{label}: no CG")
    interop.set_map_state(pipe, finished)


def pose_graph_of(finished, seed: int):
    """(T_gt (K, 7) f64, T0, PoseGraph, fixed) of a finished map's cameras:
    every co-visible pair an edge, the edges perturbed by PGO_EDGE_NOISE
    and the poses by PGO_POSE_NOISE (right-plus tangent noise, numpy
    seed), camera 0 fixed, as tests/test_dist_pgo.py:18-38."""
    import itertools

    from photometric_bundle_adjustment_tpu_torch.core import se3
    from photometric_bundle_adjustment_tpu_torch.models import pose_graph as pg

    keys = sorted(finished["cameras"])
    index = {k: i for i, k in enumerate(keys)}
    pairs = set()
    for lm in finished["landmarks"].values():
        cams = sorted({index[f] for f in lm["obs"]})
        pairs.update(itertools.combinations(cams, 2))
    edges = np.array(sorted(pairs), np.int64)
    rng = np.random.default_rng(seed)
    T_gt = torch.as_tensor(np.stack([finished["cameras"][k] for k in keys]),
                           dtype=torch.float64)
    i, j = torch.as_tensor(edges[:, 0]), torch.as_tensor(edges[:, 1])
    T_ij = se3.right_plus(se3.compose(se3.inverse(T_gt[i]), T_gt[j]),
                          torch.as_tensor(rng.normal(0, PGO_EDGE_NOISE,
                                                     (len(edges), 6))))
    dpose = rng.normal(0, PGO_POSE_NOISE, (len(keys), 6))
    dpose[0] = 0.0
    T0 = se3.right_plus(T_gt, torch.as_tensor(dpose))
    fixed = torch.zeros(len(keys), dtype=torch.bool)
    fixed[0] = True
    graph = pg.PoseGraph(edge_i=i, edge_j=j, T_ij=T_ij,
                         weight=torch.ones(len(edges), dtype=torch.float64))
    return T_gt, T0, graph, fixed


def dist_phase(pipe, finished, seq, ring_ref, device, card: str) -> int:
    """Phase 13: the distributed slice (``parallel/``) on the card.
    ``finished`` is phase 9's map as its run left it, ``ring_ref`` phase
    3's descriptors and compacted matches.  Returns the Hamming launches
    of the ring, summed over its ranks."""
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.core import se3
    from photometric_bundle_adjustment_tpu_torch.features import pair_matching
    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
    from photometric_bundle_adjustment_tpu_torch.models import pose_graph as pg
    from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
    from photometric_bundle_adjustment_tpu_torch.optim.lm import LMConfig
    from photometric_bundle_adjustment_tpu_torch.parallel import (
        dist_fused,
        dist_pgo,
        mesh,
    )
    from photometric_bundle_adjustment_tpu_torch.profile_solve import SEED
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    D = DIST_RANKS
    # phase 10 refined the map in place: measure it as phase 9 left it
    interop.set_map_state(pipe, finished)
    before = sfm_run.measure(pipe, seq)
    print(f"phase 13: the distributed slice, {D} ranks sharing "
          f"{torch.cuda.get_device_name(0)} under Gloo, then one rank under "
          f"NCCL (ranks that share one card give no scaling measurement)")
    dist_photometric(pipe, finished, seq, device, before)

    # (b) the real V1 map, perturbed as phase 7 (b)
    problems, _, model = real_map_problems(device)
    pert = perturb_map(problems[torch.float64], SEED_MAP)
    p32 = problems[torch.float32]._replace(
        cam_states=pert[0].to(device, torch.float32),
        inv_depth=pert[1].to(device, torch.float32))
    cfg = ba.BAConfig(max_iterations=DIST_GEO_ITERATIONS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, rs = geometric_ba.make_fused_solver(model)(
        p32, fused.plan_for_problem(p32), cfg)
    torch.cuda.synchronize()
    geo_single_s = time.perf_counter() - t0
    geo = dist_fused.prepare(p32, D)
    fam = dist_fused.Family("geometric", model)
    # (c) the pose graph of phase 9's cameras
    T_gt, T0, graph, fixed = pose_graph_of(finished, SEED)
    pgo_cfg = LMConfig(max_iterations=50, function_tolerance=1e-16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T_ref, r_pgo = pg.pose_graph_optimization(
        T0.to(device), pg.PoseGraph(*(x.to(device) for x in graph)),
        fixed.to(device))
    torch.cuda.synchronize()
    pgo_single_s = time.perf_counter() - t0
    # (d) the ring on phase 3's descriptors
    rr = ring_ref
    calls = [
        (mesh.selftest, (), {}),
        (dist_fused.solve_rank, (geo, fam, cfg), {}),
        (dist_fused.solve_rank, (geo, fam, cfg),
         dict(camera_partition=True, n_cg=DIST_PCG_CG)),
        (dist_pgo.solve_rank, (dist_pgo.prepare(graph, D), T0.numpy(),
                               fixed.numpy(), pgo_cfg), {}),
        (pair_matching.ring_rank, (rr["desc"], rr["valid"],
                                   rr["max_matches"], rr["threshold"],
                                   rr["ratio"]), {}),
    ]
    reset_counts()
    t0 = time.perf_counter()
    st, rep, pcg, pgo, ring = mesh.spawn(mesh.run_calls, D, calls,
                                         device=device)
    wall = time.perf_counter() - t0
    print(f"  (b, c, d) one group of {D} ranks: wall {wall:.3f} s; "
          f"collectives against their definitions: {st['checks']} "
          f"(backend {st['backend']}, {st['device']})")
    check(len(st["checks"]) == 9, "a collective failed its self-test")

    K, L = p32.cam_states.shape[0], p32.inv_depth.shape[0]
    print(f"  (b) the real V1 map ({K} cameras, {L} landmarks, "
          f"{int((p32.obs.valid != 0).sum())} observations, perturbed), "
          f"{DIST_GEO_ITERATIONS} iterations, f32: valid observations per "
          f"rank {rep['valid_obs']}")
    init = float(rs.initial_cost)
    for label, out in (("replicated", rep), ("camera-partitioned PCG", pcg)):
        builds = max(out["builds"], 1)
        per_build = ", ".join(
            f"{k} {v / builds:g} x {out['bytes'][k] / v:,.0f} B"
            for k, v in sorted(out["calls"].items()) if k.startswith("build."))
        print(f"      {label}: {out['seconds']:.3f} s, {out['iterations']} "
              f"iterations, {out['builds']} builds, {out['tries']} tries, "
              f"{out['cg_iterations']} CG iterations; per build {per_build}; "
              f"cost {out['initial_cost']:.6e} -> {out['cost']:.6e}; ranks "
              f"bit-equal {out['ranks_bit_equal']}")
        check(out["ranks_bit_equal"], f"(b) {label}: ranks not bit-equal")
    dcam = float(np.abs(rep["cam_states"] - ps.cam_states.cpu().numpy()).max())
    print(f"      single-device fused solve: {geo_single_s:.3f} s, cost "
          f"{init:.6e} -> {float(rs.cost):.6e}; replicated against it: "
          f"initial {abs(rep['initial_cost'] - init) / init:.3e}, final "
          f"{abs(rep['cost'] - float(rs.cost)) / float(rs.cost):.3e}, "
          f"cameras {dcam:.3e}")
    check(abs(rep["initial_cost"] - init) < 1e-6 * init + 1e-9,
          "(b) initial cost differs from the single-device solve")
    check(abs(rep["cost"] - float(rs.cost)) <= 1e-4 * float(rs.cost) + 1e-9,
          "(b) final cost differs from the single-device solve")
    check(dcam < 1e-4, f"(b) cameras {dcam:.3e} from the single-device solve")
    dpcg = float(np.abs(pcg["cam_states"] - rep["cam_states"]).max())
    print(f"      partitioned against replicated: cost "
          f"{abs(pcg['cost'] - rep['cost']) / rep['cost']:.3e}, cameras "
          f"{dpcg:.3e}")
    check(abs(pcg["cost"] - rep["cost"]) <= 1e-4 * rep["cost"] + 1e-9,
          "(b) PCG cost differs from the replicated solve")
    check(dpcg < 1e-3, f"(b) PCG cameras {dpcg:.3e} from the replicated")

    c0, c1, iters = pgo["stats"]
    err = torch.linalg.norm(se3.log(se3.compose(
        se3.inverse(T_ref.cpu()), torch.as_tensor(pgo["poses"]))), dim=-1)
    per_build = pgo["bytes"]["build.psum"] / pgo["calls"]["build.psum"]
    print(f"  (c) pose graph of phase 9's {T0.shape[0]} cameras, "
          f"{graph.edge_i.shape[0]} co-visible pairs, f64: {pgo['seconds']:.3f}"
          f" s, {iters} iterations, cost {c0:.6e} -> {c1:.6e}, "
          f"{pgo['calls']['build.psum']} builds x {per_build:,.0f} B; "
          f"single-device pose_graph_optimization {pgo_single_s:.3f} s, "
          f"{r_pgo.iterations} iterations, cost {float(r_pgo.cost):.6e}; "
          f"pose error max {float(err.max()):.3e}; ranks bit-equal "
          f"{pgo['ranks_bit_equal']}")
    check(c1 <= float(r_pgo.cost) * (1 + 1e-6) + 1e-12,
          "(c) the distributed cost is above the single-device cost")
    check(float(err.max()) < 1e-5, f"(c) poses {float(err.max()):.3e} off")
    check(pgo["ranks_bit_equal"], "(c) ranks not bit-equal")

    ids = rr["ids"]
    a, b = ids[:, 0], ids[:, 1]
    p, v, c = rr["compact"]
    ok = (np.array_equal(ring["pairs"][a, b], p)
          and np.array_equal(ring["pvalid"][a, b], v)
          and np.array_equal(ring["count"][a, b], c))
    n = ring["pairs"].shape[0]
    print(f"  (d) ring_match_all_pairs: {n} images, {D} ranks, "
          f"{ring['seconds']:.3f} s on rank 0; shifts {ring['calls']} of "
          f"{ring['bytes'].get('ring.ppermute', 0):,} B; Hamming launches "
          f"per rank {ring['launches']}; every one of the {len(ids)} "
          f"worklist pairs (a, b) bit-equal to phase 3's match_pairs: {ok}")
    check(ok, "(d) the ring differs from phase 3's match_pairs")
    check(ring["launches"] == [D] * D,
          f"(d) Hamming launches {ring['launches']}, not {D} per rank")
    counts = kernel_counts()
    check(not any(counts.values()), f"phase 13's parent launched {counts}")
    print(card)
    return sum(ring["launches"])


def scale_geometric(name, dtype, device) -> dict:
    """Phase 14 (a, b): one size of ``scale_stress.SIZES`` in ``dtype``
    through the single-device solve and ``run_one`` on one rank in both
    modes; returns {path: (initial cost, final cost)}."""
    from photometric_bundle_adjustment_tpu_torch.models import (
        geometric_ba,
        synthetic,
    )
    from photometric_bundle_adjustment_tpu_torch.optim import ba
    from photometric_bundle_adjustment_tpu_torch.scripts import scale_stress

    K, L, opl = scale_stress.SIZES[name]
    prec = "f32" if dtype == torch.float32 else "f64"
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", K, L, opl, pixel_noise=0.5, dtype=dtype, device=device)
    O = problem.obs.anchor_cam.shape[0]
    mm = scale_stress.mem_model(K, L, O, 1)
    print(f"  {name}, {prec}: K {K}, L {L}, O {O}, {K * 6} camera unknowns; "
          f"mem_model at D = 1: build {mm['build_MB']:.0f} MB, M "
          f"{mm['M_MB']:.0f} MB, reduced (replicated) "
          f"{mm['replicated_MB']:.0f} MB, (partitioned) "
          f"{mm['partitioned_MB']:.0f} MB")
    # the single-device path: the plan alone timed, then bundle_adjustment
    # (which makes the same plan again)
    t0 = time.perf_counter()
    _, plan = geometric_ba._accel_plan(problem)
    plan_s = time.perf_counter() - t0
    family = type(plan).__name__
    del plan
    cfg = ba.BAConfig(max_iterations=SCALE_ITERS, huber_delta=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    p, res = geometric_ba.bundle_adjustment(problem, "pinhole", cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    c0, c1 = float(res.initial_cost), float(res.cost)
    print(f"    single device ({family}): plan {plan_s:.3f} s, plan + solve "
          f"{secs:.3f} s, {res.iterations} iterations, {res.tries} tries, "
          f"cost {c0:.9e} -> {c1:.9e}, peak {peak:.1f} MiB")
    check(math.isfinite(c1) and c1 < c0,
          f"(a) {name} {prec} single device: the cost did not fall")
    check(bool(torch.isfinite(p.cam_states).all()
               and torch.isfinite(p.inv_depth).all()),
          f"(a) {name} {prec} single device: non-finite state")
    costs = {"single": (c0, c1)}
    del p, problem
    # the rank is another process: hand it the blocks this one has cached
    torch.cuda.empty_cache()
    for mode in ("replicated", "partitioned"):
        t0 = time.perf_counter()
        r = scale_stress.run_one(K, L, opl, mode, SCALE_ITERS, ranks=1,
                                 device=device, dtype=dtype)
        wall = time.perf_counter() - t0
        print(f"    run_one {mode}, 1 rank ({r.backend}): plan "
              f"{r.prep_s:.3f} s, solve {r.solve_s:.3f} s (wall {wall:.3f} s "
              f"with the rank's start), {r.cg} CG iterations, cost "
              f"{r.initial_cost:.9e} -> {r.cost:.9e}, peak "
              f"{r.peak_bytes / 2**20:.1f} MiB; ranks bit-equal "
              f"{r.ranks_bit_equal}")
        check(r.O == O, f"(a) {name} {mode}: {r.O} observations, not {O}")
        check(r.backend == "nccl", f"(a) {name} {mode}: backend {r.backend}")
        check(r.ok, f"(a) {name} {prec} {mode}: the cost did not fall")
        check(r.ranks_bit_equal, f"(a) {name} {mode}: ranks not bit-equal")
        check((r.cg > 0) == (mode == "partitioned"),
              f"(a) {name} {mode}: {r.cg} CG iterations")
        costs[mode] = (r.initial_cost, r.cost)
    init = [c[0] for c in costs.values()]
    spread = (max(init) - min(init)) / min(init)
    print(f"    initial costs within {spread:.3e} relative (bound "
          f"{SCALE_INIT_REL})")
    check(spread <= SCALE_INIT_REL, f"(a) {name} {prec}: initial costs "
          f"{init} spread {spread:.3e}")
    return costs


def scale_photometric(device) -> tuple[int, float]:
    """Phase 14 (d): ``refine_photometric`` on the 960-image map; returns
    #1's launches in the run and its max |err| against the plain version
    on the run's first level-0 build."""
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.profile_solve import SEED

    t0 = time.perf_counter()
    pipe = synthetic.synth_pba_pipe(seed=SEED, **SCALE_MAP)
    render_s = time.perf_counter() - t0
    n_obs = sum(len(lm.obs) - 1 for lm in pipe.landmarks.values())
    H, W = SCALE_MAP["H"], SCALE_MAP["W"]
    args = ", ".join(f"{k}={v}" for k, v in SCALE_MAP.items())
    print(f"  (d) synth_pba_pipe({args}, seed={SEED}) rendered on the host "
          f"in {render_s:.3f} s: "
          f"{len(pipe.cameras)} images, {len(pipe.landmarks)} landmarks, "
          f"{n_obs} patch observations, {8 * len(pipe.cameras)} camera "
          f"unknowns; refine_photometric, {LEVELS} levels x "
          f"{MAX_ITERATIONS} iterations, Huber {HUBER}, f32")
    # the inputs of #1's first full-resolution launch, recorded as the run
    # makes it; the call itself goes through unchanged
    first = []
    kernel = pba_mega.mega_fused

    def recording(model, images, *rest):
        if not first and tuple(images.shape[1:]) == (H, W):
            first.append((model, images) + rest)
        return kernel(model, images, *rest)

    # the main path, counts from 0
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pba_mega.mega_fused = recording
    try:
        t0 = time.perf_counter()
        res = pba_refine.refine_photometric(
            pipe, levels=LEVELS, max_iterations=MAX_ITERATIONS,
            huber_delta=HUBER, log=lambda s: None, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pba_mega.mega_fused = kernel
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    levels_s = 0.0
    for lv in pipe.photometric_levels:
        levels_s += lv["setup_s"] + lv["solve_s"]
        print(f"      level {lv['level']} ({lv['W']}x{lv['H']}): set-up "
              f"{lv['setup_s']:.3f} s, solve {lv['solve_s']:.3f} s, "
              f"{lv['iterations']} iterations "
              f"({lv['iterations'] / lv['solve_s']:.2f} LM it/s), "
              f"{lv['tries']} tries ({lv['tries'] / lv['solve_s']:.2f}/s), "
              f"cost {lv['initial_cost']:.6e} -> {lv['cost']:.6e}")
        check(math.isfinite(lv["cost"]) and lv["cost"] < lv["initial_cost"],
              f"(d) the cost did not fall at level {lv['level']}")
    print(f"      wall {wall:.3f} s (the problem and the pyramid "
          f"{wall - levels_s:.3f} s); peak {peak:.1f} MiB; kernel launches "
          f"{counts}")
    check(math.isfinite(float(res.cost)), "(d) final cost is not finite")
    expected = sum(lv["tries"] + 1 for lv in pipe.photometric_levels)
    check(counts["pba_mega"] == expected,
          f"(d) #1 launched {counts['pba_mega']} times, builds {expected}")
    others = {k: v for k, v in counts.items() if k != "pba_mega" and v}
    check(not others, f"(d) the refinement launched other kernels: {others}")
    check(len(first) == 1, "(d) no full-resolution build was recorded")
    model, images, cams, rho, c, huber = first.pop()
    check(huber == HUBER, f"(d) the build ran at Huber {huber}")
    print(f"      #1 against its plain version on the first level-0 build: "
          f"{int((c.timg >= 0).sum())} observations in {c.cols.shape[1]} "
          f"columns")
    err = mega_against_plain(model, images, cams, rho, c, "the 960-image map",
                             device)[0]
    return counts["pba_mega"], err


def scale_phase(device, card: str) -> tuple[int, float]:
    """Phase 14: the scale path.  Returns #1's launches in (d) and its max
    |err| against the plain version there."""
    from photometric_bundle_adjustment_tpu_torch.scripts import scale_stress

    t_phase = time.perf_counter()
    reset_counts()
    torch.cuda.empty_cache()
    print(f"phase 14: the scale path, scripts/scale_stress.py's sizes on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"  (a) f32, {SCALE_ITERS} LM iterations, Huber 1, three paths")
    one_rank = {name: scale_geometric(name, torch.float32, device)
                for name in scale_stress.SIZES}
    print("  (b) f64 at the medium size")
    f64 = scale_geometric("medium", torch.float64, device)
    final = [c[1] for c in f64.values()]
    spread = (max(final) - min(final)) / min(final)
    print(f"    final costs {final}: within {spread:.3e} relative (bound "
          f"{SCALE_F64_REL})")
    check(spread <= SCALE_F64_REL, f"(b) f64 final costs spread {spread:.3e}")

    K, L, opl = scale_stress.SIZES["small"]
    D = SCALE_GLOO_RANKS
    print(f"  (c) the JAX script's mesh: {D} ranks sharing the card, small")
    for mode in ("replicated", "partitioned"):
        t0 = time.perf_counter()
        r = scale_stress.run_one(K, L, opl, mode, SCALE_ITERS, ranks=D,
                                 device=device)
        wall = time.perf_counter() - t0
        ref = one_rank["small"][mode][1]
        rel = abs(r.cost - ref) / ref
        print(f"    {mode}, {D} ranks ({r.backend}): plan {r.prep_s:.3f} s, "
              f"solve {r.solve_s:.3f} s (wall {wall:.3f} s), cost "
              f"{r.initial_cost:.9e} -> {r.cost:.9e}, {rel:.3e} from one "
              f"rank (bound {SCALE_GLOO_REL}); CG iterations {r.cg} "
              f"(RESULTS.md:419 and both packages' CPU runs: "
              f"{SCALE_CG_REF}); rank 0's peak "
              f"{r.peak_bytes / 2**20:.1f} MiB; ranks bit-equal "
              f"{r.ranks_bit_equal}")
        check(r.backend == "gloo", f"(c) {mode}: backend {r.backend}")
        check(r.ok, f"(c) {mode}: the cost did not fall")
        check(r.ranks_bit_equal, f"(c) {mode}: ranks not bit-equal")
        check(rel <= SCALE_GLOO_REL, f"(c) {mode}: {rel:.3e} from one rank")
        check((r.cg > 0) == (mode == "partitioned"),
              f"(c) {mode}: {r.cg} CG iterations")
    counts = kernel_counts()
    check(not any(counts.values()), f"(a-c) launched a kernel: {counts}")

    launches, err = scale_photometric(device)
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    print(card)
    return launches, err


def bench_phase(device, card: str, geo_rate: tuple[float, float]) -> dict:
    """Phase 15: ``bench.main`` at full size without the CPU baselines.
    ``geo_rate`` is phase 7 (a)'s ``geo_lm_iters_per_s``, host-launched
    and from a CUDA graph.  Returns the kernels' launches in the phase."""
    import contextlib
    import io

    from photometric_bundle_adjustment_tpu_torch import bench

    def not_strict(name):
        raise ValueError(f"bench printed {name}, not strict JSON")

    t_phase = time.perf_counter()
    print(f"phase 15: bench.main on {card}, full size, CPU baselines off")
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(device, cpu_baselines=False)
    counts = kernel_counts()
    text = out.getvalue()
    print(text, end="")
    lines = [json.loads(x, parse_constant=not_strict)
             for x in text.splitlines()]
    errors = [x for x in lines if "error" in x]
    check(rc == 0 and not errors, f"bench failed (rc {rc}): {errors}")
    names = [x["metric"] for x in lines]
    check(names == BENCH_LINES, f"bench printed {names}, not {BENCH_LINES}")
    for x in lines:
        check(math.isfinite(x["value"]) and x["value"] > 0,
              f"bench {x['metric']} value {x['value']}")
    by = {x["metric"]: x for x in lines}
    expected = {"pba_mega": 0, "pba_mega_bf16": 0, "hamming": 0,
                "patch_sample": 0, "grid_overhead": 0, "exp_roll": 0}
    for metric, counter in (("pba_lm_iters_per_s_cuda", "pba_mega"),
                            ("pba_lm_iters_per_s_cuda_bf16", "pba_mega_bf16"),
                            ("match_pairs_per_s_cuda", "hamming")):
        k = by[metric]["kernel"]
        print(f"  {metric}: {k['name']} {k['ms']:.4f} ms on the device at "
              f"the step's inputs, {k['share']:.1%} of its "
              f"{k['bound_ms']:.4f} ms bound ({k['bound_by']}); "
              f"{k['launches']} launches for {k['calls']} calls")
        check(k["launches"] == k["calls"] > 0,
              f"{metric}: {k['launches']} launches for {k['calls']} calls")
        expected[counter] = k["calls"]
    print(f"  kernel launches in phase 15: {counts}")
    check(counts == expected, f"phase 15 launched {counts}, the bench "
                              f"called {expected}")
    geo = by["ba_lm_iters_per_s_cuda"]
    host, graph = geo_rate
    ratio = geo["graph_iters_per_s"] / graph
    print(f"  ba_lm_iters_per_s_cuda {geo['value']:.2f} host-launched, "
          f"{geo['graph_iters_per_s']:.2f} from a CUDA graph, against phase "
          f"7 (a)'s geo_lm_iters_per_s {host:.2f} and {graph:.2f} (ratios "
          f"{geo['value'] / host:.3f} host-launched, {ratio:.4f} from the "
          f"graph)")
    check(abs(ratio - 1) <= BENCH_GEO_GRAPH_REL,
          f"bench's geometric graph rate {geo['graph_iters_per_s']:.2f} is "
          f"not within {BENCH_GEO_GRAPH_REL:.0%} of phase 7's {graph:.2f}")
    print(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def value_curve_phase(pipe, finished, seq, cost10: float, device,
                      card: str) -> dict:
    """Phase 16: ``pba_value_curve.run_ladder`` on phase 9's map as its run
    left it (``finished``; phase 10 refined ``pipe`` in place), scored
    against the rendered poses.  ``cost10`` is phase 10's final cost.
    Returns the kernels' launches in the phase and the bf16 tier's
    max_abs_err against its plain version."""
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.models import (
        photometric_ba as pba,
    )
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        pba_value_curve as vc,
    )

    # everything phase 10 started from: the map, and no affine brightness
    interop.set_map_state(pipe, finished)
    for name in ("photometric_affine", "photometric_levels"):
        pipe.__dict__.pop(name, None)
    print(f"phase 16: the value curve on phase 9's map ({len(pipe.cameras)} "
          f"cameras, {len(pipe.landmarks)} landmarks): rungs "
          f"{[100 * r for r in VC_RUNGS]} cm in f32, then 0 cm in bf16; "
          f"{LEVELS} levels, {MAX_ITERATIONS} iterations, Huber {HUBER}")
    # the bf16 tier on this map's problem at each level (each level's first
    # build of the 0 cm rung), outside the counted run.  The rendered
    # images hold 8-bit values, which bf16 keeps exactly: only the
    # pyramid's averaged levels round
    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device=device)
    model = pipe.calib.cam_types[0]
    pyramid = pba.build_pyramid(images_flat.reshape(-1, H, W), LEVELS)
    err16 = 0.0
    for level in range(LEVELS - 1, -1, -1):
        imgs = pyramid[level][0]
        prob = pba_refine.level_problem(problem, pyramid, level)
        _, rows = pba_mega.build_chunk_mega_plan(prob)
        c = pba_mega.make_mega_consts(model, prob, rows)
        bf = imgs.to(torch.bfloat16).contiguous()
        rest = (prob.cam_states, prob.inv_depth, c, HUBER)
        out = pba_mega.mega_fused(model, bf, *rest)
        ref = pba_mega.mega_fused_reference(model, bf.float(), *rest)
        torch.cuda.synchronize()
        ux, uy, _, GA, GB = pba_mega.warp_slabs(model, prob.cam_states,
                                                prob.inv_depth, c)
        rounded = float((bf.float() != imgs).float().mean())
        print(f"  bf16 kernel vs plain at level {level} "
              f"({imgs.shape[2]}x{imgs.shape[1]}): model {model}, "
              f"{int((c.timg >= 0).sum())} observations in "
              f"{c.cols.shape[1]} columns, {rounded:.1%} of the texels "
              f"rounded by bf16")
        label = f"phase 9's map, bf16, level {level}"
        err16 = max(err16, compare_payloads(out, ref, bf.float(), label,
                                            (ux, uy, GA, GB, c)))
        check(bool((out[:, c.timg < 0] == 0).all()),
              f"{label}: a zero column is not zero")
        del prob, c, bf, rest, out, ref, ux, uy, GA, GB
    del problem, images_flat, pyramid
    score = vc.room_score(seq)
    # the main path, counts from 0
    reset_counts()
    t0 = time.perf_counter()
    rows = [(False, r) for r in vc.run_ladder(
        pipe, VC_RUNGS, score, device=device, max_iterations=MAX_ITERATIONS,
        huber_delta=HUBER, levels=LEVELS)]
    rows += [(True, r) for r in vc.run_ladder(
        pipe, [0.0], score, bf16=True, device=device,
        max_iterations=MAX_ITERATIONS, huber_delta=HUBER, levels=LEVELS)]
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    for bf16, row in rows:
        print(json.dumps({"bf16": bf16, **row}))
        tag = f"{row['sigma_cm']:g} cm{' bf16' if bf16 else ''}"
        for lv in row["levels"]:
            check(math.isfinite(lv["cost"]) and lv["cost"] <= lv["initial_cost"],
                  f"rung {tag}: the cost rose at level {lv['level']}: "
                  f"{lv['initial_cost']:.6e} -> {lv['cost']:.6e}")
        print(f"  rung {tag}: ATE {row['ate_init_se3_cm']:.4f} -> "
              f"{row['ate_pba_se3_cm']:.4f} cm (SE3), "
              f"{row['ate_init_sim3_cm']:.4f} -> {row['ate_pba_sim3_cm']:.4f}"
              f" cm (Sim3); baseline median {row['baseline_init_m'][0]:.6f} "
              f"-> {row['baseline_pba_m'][0]:.6f} m; cost "
              f"{row['initial_cost']:.6e} -> {row['cost']:.6e} in "
              f"{row['iterations']} iterations, {row['seconds']:.3f} s")
    T = np.asarray(seq.calib.T_i_c)
    print(f"  calibrated baseline "
          f"{float(np.linalg.norm(T[1, :3] - T[0, :3])):.6f} m")
    cost0 = rows[0][1]["cost"]
    print(f"  the 0 cm rung's final cost {cost0:.9e} against phase 10's "
          f"{cost10:.9e} (rel {abs(cost0 - cost10) / abs(cost10):.3e}, bound "
          f"{VC_REPEAT_RTOL})")
    check(abs(cost0 - cost10) <= VC_REPEAT_RTOL * abs(cost10),
          f"the 0 cm rung's cost {cost0:.9e} is not phase 10's {cost10:.9e}")
    cost16 = rows[-1][1]["cost"]
    rel16 = abs(cost16 - cost0) / abs(cost0)
    print(f"  the bf16 0 cm rung's final cost {cost16:.9e} against the f32 "
          f"rung's (rel {rel16:.3e}, bound {VC_BF16_RTOL})")
    check(rel16 <= VC_BF16_RTOL,
          f"the bf16 0 cm rung's cost {cost16:.9e} is not within "
          f"{VC_BF16_RTOL} of the f32 rung's {cost0:.9e}")
    others = {k: v for k, v in counts.items()
              if k not in ("pba_mega", "pba_mega_bf16") and v}
    check(counts["pba_mega"] > 0 and counts["pba_mega_bf16"] > 0,
          f"the ladder did not launch #1 in both tiers: {counts}")
    check(not others, f"the ladder launched other kernels: {others}")
    print(f"  wall {wall:.3f} s; kernel launches in phase 16: {counts}")
    print(card)
    return counts, err16


def multiprocess_phase(card: str):
    """Phase 17: ``scripts/multiprocess_smoke.py`` as a subprocess at each
    process count of MP_PROCS; each must exit 0 and print OK on the
    backend and device the host rule gives."""
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    print(f"phase 17: the multi-process smoke on {card}")
    for procs, where in MP_PROCS.items():
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m",
             "photometric_bundle_adjustment_tpu_torch.scripts.multiprocess_smoke",
             "--procs", str(procs), "--timeout", str(MP_TIMEOUT)],
            capture_output=True, text=True, timeout=MP_TIMEOUT + 60, cwd=root)
        wall = time.perf_counter() - t0
        for line in out.stdout.splitlines():
            print(f"  {line}")
        check(out.returncode == 0 and f"-> OK; ranks_bit_equal True; {where}"
              in out.stdout, f"--procs {procs} failed (rc {out.returncode}): "
              f"{out.stdout[-1000:]}{out.stderr[-2000:]}")
        print(f"  --procs {procs}: wall {wall:.3f} s")
    print(card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.core import se3
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import _build
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        EUROC,
        SEED,
    )

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_all()
    build_s = time.perf_counter() - t0
    print(f"phase 0: built {', '.join(_build.SOURCES)} in {build_s:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}")
    hamming_resources()
    mega_resources()
    rates = mma_rates(device, log=print)

    t0 = time.perf_counter()
    pipe = synthetic.synth_pba_pipe(seed=SEED, **EUROC)
    pipe0 = copy.deepcopy(pipe)       # phases 4-5 start from the initial map
    pipe5 = copy.deepcopy(pipe)
    print(f"synthetic map in {time.perf_counter() - t0:.1f} s")
    max_err, ms, plain_ms, bound_ms = kernel_phase(pipe, device)
    launches = slice_phase(pipe, device, se3)
    front, seq_pipe, seq, ring_ref = front_end_phase(device, rates["b1"])
    sampler = sampler_phase(pipe0, device, se3)
    bf16 = dense_phase(pipe5, device, se3)
    grid, window = probe_phase(device)
    geo_rate = geo_phase(device, card, se3)
    # phase 15 next to phase 7, whose rates it is compared with
    n_bench = bench_phase(device, card, geo_rate)
    launches += n_bench["pba_mega"]
    bf16["launches"] += n_bench["pba_mega_bf16"]
    front["launches"] += n_bench["hamming"]
    front["launches"] += ransac_phase(seq_pipe, seq, device, se3)
    n_ham, sfm_pipe, sfm_seq = sfm_phase(device, card)
    front["launches"] += n_ham
    finished = interop.map_state_to_numpy(sfm_pipe)
    n_mega, (err10, _, _, _), cost10 = refine_phase(sfm_pipe, sfm_seq, device,
                                                    card)
    launches += n_mega
    front["launches"] += global_init_phase(sfm_seq, device, card)
    calibration_phase(device, card)
    front["launches"] += dist_phase(sfm_pipe, finished, sfm_seq, ring_ref,
                                    device, card)
    n_scale, err14 = scale_phase(device, card)
    launches += n_scale
    n_curve, err16 = value_curve_phase(sfm_pipe, finished, sfm_seq, cost10,
                                       device, card)
    launches += n_curve["pba_mega"]
    bf16["launches"] += n_curve["pba_mega_bf16"]
    bf16["max_abs_err"] = max(bf16["max_abs_err"], err16)
    multiprocess_phase(card)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "pba_mega_fused",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/pba_mega.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/pba_mega.py:456",
        "launches": launches,
        "max_abs_err": max(max_err, err10, err14),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "pba_mega_fused_bf16",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/pba_mega.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/pba_mega.py:456",
        **bf16,
    }, {
        "name": "hamming_best_two",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/hamming.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/hamming.py:34",
        **front,
    }, {
        "name": "patch_sample",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/patch_sample.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/patch_sample.py:61",
        **sampler,
    }, {
        "name": "grid_overhead",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/grid_overhead.cu",
        "replaces": "scripts/grid_overhead.py:48,101,133",
        **grid,
    }, {
        "name": "exp_roll",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/exp_roll.cu",
        "replaces": "scripts/exp_roll.py:32",
        **window,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
