#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build every CUDA kernel from csrc/ with nvcc, one process per source,
     all started together;
  3. compare kernels 1-5, 3b and 7-11 with their plain torch twins on the card, at the
     shapes of the main path (PlaneScene seed 1, VGA, 8 levels, 1024
     keypoints, the trained 16384-word vocabulary), and time both with
     CUDA events: kernel 1 (a frame's whole pyramid, blur, FAST, NMS and
     margin) on frame 0, all four stacks; kernel 2 (a frame's selection,
     angle and BRIEF, two launches) from kernel 1's stacks of frames 0 and
     4, keypoints exact, angles and descriptors within the tolerances;
     kernel 3 with every gate kind:
     window + octave band at B = 1 (4096 x 1024 and 1024 x 1024), the
     initialization window, a dense mask, the epipolar gate at B = 20
     (frame 0 against frames 1-20) and validity only at B = 8 with a shared
     desc2; kernel 3b (each map point's distinctive descriptor) exactly, on
     random tables at Q = 4096 and on counts 0, 1, 2, 31, 32, tied medians
     and repeated descriptors; kernel 4 (the whole pose LM) on 1024
     synthetic edges, once mono and once half stereo, at 8 start poses, at
     N = 4096 with every edge valid, with no valid edge, with one (held to
     its mask and count: two rows leave the pose undetermined), with every
     edge stereo, at N = 1021, at B = 64 and at B = 0, two calls bit for
     bit and one device kernel a call, and its division and square root
     bit for bit IEEE's on random operands; kernel 5 exactly on
     the trained vocabulary, on the vocabulary with every word duplicated
     and at N = 1000, W = 16383; kernel 7 (the whole Sim3 RANSAC after its
     draw) with every output bit for bit, at 1024 x 1024 with 25% outliers,
     a near-collinear triple, 2 valid pairs, no valid pair and a zero-inlier
     best, scale free and fixed, a refined fit that counts fewer (the best
     kept), N = 4096 and H = 4096; kernel 8 (the whole Sim3 LM) at 1024
     pairs scale free and fixed, 4096 pairs all valid and 3 valid pairs
     (and, reported but not held, on tests/data/k8_closure_routed.pt, an
     open fault: ROADMAP §3); kernel 9 (a stereo frame's match, SAD refinement, depth and
     acceptance) with every output bit for bit, on the VGA pair of frame 0
     (the right camera 0.3 m along +x) at 1024 x 1024 keypoints and on
     random uint8 pairs shifted by 6 px: distances 0-255, ties (every right
     keypoint twice), x.5 centres, patches on the border, rows without a
     candidate, every row accepted (the median gate bites), no valid
     left keypoint, and what the row bands reach: partners exactly a row
     tolerance apart (and one float step further), the top octave's widest
     band, crowded rows (~256 candidates, more than a ballot or the warp's
     list holds), rows at 0, H - 1 and outside the image, M = 1000, M = 1,
     N = 1021 and M at the shared-memory capacity (one more is refused
     before the launch); kernel 10 (a pair's bilinear remap) bit for bit on a
     real distortion map and on identity maps, where it returns the images,
     and through a StereoRectifier, beside one grid_sample call; both
     wrappers' checks on the host (time.perf_counter_ns over 10,000 calls a
     part; tools/stereo_host_parts.py splits the whole call) and the 100-call
     times of stereo_match, remap_pair, StereoRectifier.__call__ and
     grid_sample in turns; kernel 11 (a segment sum in one fixed order) bit
     for bit its twin on the CPU, on the rows of phase 6's closure (the pose
     graph's g and H) and phase 15's map (the global BA's Hcc, gc, Hpp, gp
     and build_normal_eqs' B over 2,097,152 pairs) and on edge cases (a
     5,000-row segment, every row in one segment, S = 1, D = 1 and 64, E = 0,
     every row dropped, B's S with no live row, rows 4 bytes off 16), its
     plan equal to the CPU's, two calls equal, beside one index_add and
     torch.segment_reduce (100 calls, a CUDA-graph replay, host ns a call),
     with its bound and chain floor (the longest segment's dependent adds,
     at a probed add's time) and its launches in one solve of each solver
     (run after phase 6, whose inputs it takes); kernels 12b and 12c (the
     dense BA's Cholesky and the distributed BA's LU, each in one fixed
     order) bit for bit their twins on the CPU on phase 15's reduced system
     and its leading 130 and 6 rows, 12b all NaN on a system that is not
     positive definite, 12c on an indefinite system and on pivot ties, two
     calls equal, their device kernels a call by graph capture, beside their
     twins on the card and torch.linalg.cholesky_ex with
     torch.cholesky_solve / torch.linalg.solve_ex; then random systems at
     n 384 and 3,840, 12c also at 12,288 (a cluster of 12 CTAs);
  4. run the monocular System (``mono_slice_config``: relocalization and
     keyframe culling on) through ``System.track_mono`` on 48 frames at
     VGA / 1024 features / 8 levels, with every launch counter reset just
     before, and check tracking state, keyframes, map points, ATE, that
     kernels 1-5 were launched, kernels 1 and 2 once per frame, kernel 3 once per
     matcher call and once per keyframe-chain triangulation, kernel 3b once
     per map-point stats refresh, and kernel 4 once per ``optimize_pose``
     call; then compare kernel 3b with its twin on the table of one
     keyframe-chain refresh, and kernel 4 on the edges of one real
     local-map call, and time both;
  5. a kidnapped run at the same width: a 64-frame sweep, then a jump back
     to frame 4 and three frames from there, counters reset just before;
     check that the jump frame is tracked after a relocalization, that all
     kernels were launched (kernels 1 and 2 once per frame, kernel 3 once per
     matcher call and once per relocalization attempt, kernel 4 once per
     ``optimize_pose`` call plus once per relocalization polish, kernel 6
     once per relocalization attempt), the final state and the ATE;
     then compare kernels 6 and 4 with their twins on the inputs the
     relocalization gave them (8 candidates x 256 hypotheses x 1024 points:
     every output of kernel 6 bit for bit, so counts and each candidate's
     best equal and the best R and t within 1e-5; the batch of polished
     candidates) and time kernel 6 and its twin; print the observation
     counts kernel 3b saw in the refreshes of phases 4 and 5;
  6. a loop: ``SlamConfig()``'s own defaults (loop closing on, keyframe
     culling off) through ``System.track_mono`` on RoomScene seed 2 along
     ``circle_trajectory(180, radius=1.8, turns=1.04)`` at 320x240, 512
     features, 4 levels (tests/test_e2e_loop.py's setting: the JAX System
     closes no loop at the VGA width, tools/jax_loop_reference.py), counters
     reset just before; check that a loop closes, that a global BA is
     dispatched and folded, the tracked fraction, the final state, the ATE
     against the JAX System's on the same cell, and the launches (kernel 7
     once a Sim3 RANSAC, kernel 8 once an optimize_sim3, kernel 3 once a
     guided match / projection count / SearchAndFuse), and that the plain
     Horn, Jacobi and score were never called; then compare kernels 7 and 8
     with their twins on the inputs the loop gave them (the run's first
     launch of each, and the closing attempt's last), count the device
     kernels of a whole ``sim3_from_samples`` on them (one), and print the
     per-frame wall times and each loop stage's, with totals and medians;
     then the same cell in a second System of the process, its trajectory,
     map and global BA bit for bit the first run's (the card drained after
     each global BA's dispatch in both, so both fold at the closing
     keyframe); then the circle with phase 12's rendered depth through the
     RGB-D System (``th_depth`` 100): state OK, >= 80% tracked, the JAX
     System's two closures and folded global BAs, every kernel 7 and 8
     launch with the scale fixed, the SE3 ATE within max(1.5 x, +0.05 m) of
     the JAX System's worst over seeds 0-9 (tools/jax_loop_reference.py
     --qvga --depth --seed S);
  7. RGB-D on bench.py's cell (bench.py:151-196: the slice's 48 VGA frames
     with their rendered depth, bf = 500 x 0.3, th_depth 100, SlamConfig()'s
     other defaults) through ``System.track_rgbd``, counters reset just
     before: state, tracked >= 80%, >= 3 keyframes, > 200 map points, the
     SE3-aligned ATE within max(1.5 x, +0.01 m) of the JAX System's on the
     same cell (tools/jax_depth_reference.py), the end-to-end displacement
     within 5%, kernels 1 and 2 once a frame, kernel 9 never; then kernel 4
     against its twin on a local-map call with stereo rows;
  8. stereo on the same cell (the right image rendered at t - [0.3, 0, 0])
     through ``System.track_stereo``, every pair through a StereoRectifier
     of the rectified rig (identity maps), whose output must equal its input
     bit for bit: the same bounds with the path length within 15% instead of
     the displacement, kernels 1 and 2 twice a frame, kernels 9 and 10 once
     a frame; kernel 4 again on a local-map call with stereo rows;
  9. fuse in the keyframe chain (``enable_fuse=True``, so the stats refresh
     in triangulation too): the slice (under the CPU profiler, whose
     ``mapping/*`` spans give the chain's stages) and the RGB-D cell of
     phase 7, counters reset before each: state, tracked >= 70% (mono) /
     80% (RGB-D), the ATE within max(1.5 x, +0.01 m) of the JAX System's
     with fuse on (tools/jax_depth_reference.py mono --fuse | rgbd --fuse)
     and < 0.08 m (mono), kernel 3 once a ``fuse_neighbors`` (all its
     targets in one launch), kernel 3b twice a keyframe chain; then the
     fuse core on the card against its CPU result on one captured
     keyframe's inputs and on a point that loses two merges to two winners
     (``double_loser_case`` of tests/_fuse_cases.py): observations and
     validity exactly equal, and the later pair's winner kept, as the
     reference's CPU scatter keeps it;
  10. pipelined tracking (``async_depth=2``) on the slice, each frame timed
     to the return of ``track_mono`` and the run ended by ``flush()``: the
     same outcome bounds against phase 4's ATE and the JAX System's
     pipelined run (tools/jax_depth_reference.py mono --async-depth 2), a
     record for every frame, and the launches of each host-read-free step
     (``tracking.track_frame_device``: kernels 3 and 4 four times each with
     a velocity, twice without); the median frame and frames/s against
     phase 4's and against a synchronous run just before, timed the same way;
     then phase 6's loop cell pipelined with SlamConfig()'s own defaults
     (keyframe culling on as well), held to the JAX System's pipelined run
     on the cell (tools/jax_loop_reference.py --qvga --async-depth 2
     --kf-culling; it loses the map a third of the way round and closes
     nothing): state OK, tracked >= 0.8 x its count, ATE within max(1.5 x,
     +0.05 m) of its, each keyframe's loop detection resolved once through
     the deferred read, the keyframe cull applied through it too, a
     relocalization on the pipelined path (kernel 6), and the host's mirror
     of the valid keyframes equal to the map's.  In both pipelined runs every step, its host bundle and
     every prefetch run under torch's sync debug mode at "error", which
     raises on any call that synchronizes with the card; each run prints how
     many frames late each frame was resolved and how often the ready test
     found a copy still in flight;
  11. the free runner (``pipeline/device_loop.FreeRunner``) on bench.py's
     mono cell (bench.py:132-198: VGA, 1024 features, loop closing and live
     global BA on, auto_grow off): ``warmup()`` and ``warmup_sequence(48)``,
     112 orbit frames one by one, then 48 frames bouncing back over the map
     through ``track_mono_sequence(chunk=48)`` (scan mode): mode OK,
     tracked >= 70%, the ATE within max(1.5 x, +0.01 m) of the JAX
     FreeRunner's on the same frames (tools/jax_free_reference.py bench),
     keyframes and map points within 0.5-1.5 x its; frames/s per frame and
     in scan mode, the frame times beside phase 4's, and the synchronizing
     calls of each frame (torch's sync debug mode "warn", the warnings
     counted);
  12. the free runner on the loop cell (phase 6's circle, max_kf 128):
     mono must close live with a live global BA per closure, a closure record
     with >= 15 entry matches, >= 6 pair inliers and the GBA flag, no loop
     edge dropped, >= 70% tracked and the ATE within max(1.5 x, +0.05 m) of
     the JAX FreeRunner's; the closure's stages timed; then with rendered
     depth (bf 250 x 0.08): held to the JAX FreeRunner's outcome there (it
     closes twice), every Sim3 launch with the scale fixed, the ATE within
     max(1.5 x, +0.05 m) of the JAX runner's worst over its seeds 0-9 (the
     draws decide the second closure's correction: 0.035-0.220 m there);
     the mono loop runs twice, rings and map bit for bit;
  13. the free runner on phases 7-8's depth cell, RGB-D and stereo (through
     phase 8's rectifier), with phases 7-8's bounds against the JAX
     FreeRunner's ATE; scan mode against per-frame mode on phase 11's first
     48 frames (the rings equal, poses within 1e-5); localization mode from
     phase 11's state after frame 47: 12 frames, a blank frame that loses
     tracking, then frames 4-7, which only relocalization (kernel 6) can
     recover: no keyframe made.  In phases 11-13 every verified loop
     candidate must launch kernels 7 and 8 twice and kernel 3 four times,
     every loop stage kernel 5 once, every relocalization attempt kernel 6
     once and kernel 4 at most once;
  14. map I/O, the merge and the dataset drivers: a System over phase 5's
     64-frame sweep saved (``save_map``) and loaded into a fresh one
     (``load_map``): every field
     bit for bit, the keyframe database rows it had written within 1e-6,
     then frames 4-7 relocalized (kernels 5, 6 and 4) with each camera
     centre within 0.30 m of the truth once the saved run is Sim3-aligned
     to it; the same through ``FreeRunner.save_map`` / ``load_map`` on
     phase 11's finished map, and the System's file loaded into a runner;
     two RGB-D sessions of phases 7-8's cell (frames 0-27 and 20-47) merged
     by ``worldmap/merge.merge_maps(fix_scale=True)``: success, the scale
     within 0.1 of 1 and the median merged-keyframe centre error below
     0.15 m (tests/test_merge.py's bounds), kernels 3a, 3b, 5, 7, 8 and 11
     launched, each stage timed; the drivers on VGA fixtures written here
     (tools/driver_fixtures.py: the port's renderer, PNGs of numpy and
     zlib): ``run_tum`` mono on a distorted capture (ATE < 0.12 m) and
     rgbd on 16-bit depth, ``run_euroc`` stereo on distorted, yawed raw
     pairs rectified by kernel 10 (>= 12 rows, ATE < 0.2 m), ``run_kitti``
     mono as a subprocess, ``run_synthetic --free``, each ATE within
     max(1.5 x, +0.01 m) of the JAX driver's on the same fixture
     (tools/jax_io_reference.py); and the first RGB-D frames of a fresh
     process timed without and with ``System.warmup()``;
  15. the global BA beyond the CG solver, on phase 6's map at its closure
     padded to bench.py's mono capacities (K = 128, P = 16,384, N = 1,024):
     (a) the dense ``ba_core.bundle_adjust`` and the distributed BA at a
     world of one (an NCCL group of one) over (b)'s two blocks, summed in
     block order, against the same functions on the
     CPU (the dense BA, kernel 12b once a step, on its returned state; the
     distributed BA kernel 12c once a step; the distributed BA's 10
     steps on its returned cost, its state after 4 steps on the state's
     cost and each edge's residual: the comments of DIST_TOL and
     DIST_FULL_TOL say why), with the reprojection RMSE before and after, the
     normal equations', the Schur solve's and one LM step's times and the
     dense BA's peak memory; (b) two gloo ranks on the one card, as
     subprocesses (``python3 chip_smoke.py --dist-rank RANK PORT DIR``, each
     with a time limit): the distributed BA and the LoopCloser's distributed
     branch with its fold after ``load_map``, both ranks equal bit for bit
     each other and the world-one run over the same blocks, and within
     tolerance of the world-one run and fold, as in (a);
     ``--keep-ba DIR`` keeps the BA problem (tests/_ba_spread.py reads
     it); (c) ``shard_points=True`` on
     phase 4's slice at a world of one, the trajectory and map bit for bit
     phase 4's; (d) phase 4's ``System.telemetry.report()``, a
     frontend/extract a frame, a tracking/step a tracking step, a
     mapping/keyframe a keyframe after initialization; (e)
     ``train_vocabulary`` (4,096 words, 8 iterations) on phase 4's frames'
     descriptors, kernel 5 once a chunk an iteration, words and IDF equal
     to the CPU twin's bit for bit; in (a) also ``bundle_adjust_cg``, the
     dense BA and the world-one distributed BA each called twice on the same
     problem, bit for bit;
  16. the live map's point axis split over two gloo ranks on the one card
     (``shard_points=True``; subprocesses ``python3 chip_smoke.py
     --shard-rank MODE RANK PORT DIR``, each with a time limit and every
     collective with one): (a) phase 4's slice (8,192 point rows a rank),
     its trajectory and gathered map bit for bit phase 4's and both ranks'
     keyframe state equal, each rank's launches, frames/s and peak memory
     beside phase 4's; then, at once, (b) phase 6's loop cell with the
     global BA on the live shards: a closure and a folded global BA, both
     ranks folding at the same frames, >= 60% tracked, ATE within phase 6's
     bound, the BA's returned cost within DIST_FULL_TOL of a world-one
     distributed BA over the ranks' two live blocks of the map it was
     dispatched on; (c) the FreeRunner on phase 11's first 48 frames, its
     state (rings, poses, gathered map) bit for bit phase 11's after frame
     47; with them (d) phase 6's loop cell on a replicated map
     (``shard_points`` off, every rank running the whole cell): with the
     matrix-free BA (d1, the loop closer's ``use_dist_gba`` off) both ranks'
     trajectory and map bit for bit phase 6's, with its default
     ``use_dist_gba`` (d2, the BA re-laid out over the ranks, whose
     cross-rank sums differ from one rank's) the ranks
     bit for bit each other and phase 6's ATE bound; then at once (d3) as
     d1 but undrained, the ranks bit for bit each other and phase 6's ATE
     bound, (e) phase 6's loop cell split with the matrix-free BA on the
     gathered map (phase 6's own), trajectory and gathered map bit for bit
     phase 6's, (f) phases 7 and 8's RGB-D and stereo cells split, bit for
     bit their unsplit runs, and (g) phase 13's RGB-D FreeRunner split, its
     state bit for bit phase 13's; in every run both ranks' keyframe state
     equal.  (d1) and (e) drain the card after each global BA's dispatch, as
     phase 6 does, so they fold where phase 6 folded; (b), (d2) and (d3) run
     as a user's runs do, each global BA folded at the first keyframe where
     it is done on both ranks, and print the frames of each dispatch and
     fold beside phase 6's.  The viewer (viz/viewer.py)
     has no phase: it needs matplotlib, which the GPU machine lacks.
Kernel times are one CUDA-event pair around 100 back-to-back calls after a
warm-up, divided by the count; kernels 3b and 6 also give ``graph_us``, the
device time a call in a replay of 50 calls captured into one CUDA graph (as
do kernels 7 and 8);
the device kernels of one call (kernel 2:
two, every other: one) are counted in a CUDA-graph capture of the call.  Each
kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations over the card's peak for
their type (the H100 SXM data sheet):
67 T/s for f32 outside the tensor cores, 32-bit integer work counted at the
same rate; the AND-popcounts of kernels 5 and 3b at the 1,979 T/s int8 dense
tensor rate (no 1-bit rate is published), from the shapes and data of this
run.
``library_ms`` is one PyTorch call (two where stated) computing the same
function on the same inputs, where there is one.  The line before the last
is a JSON object with per-kernel results; the last line is the device
summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import json
import math
import os
import runpy
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

N_FRAMES = 48
ATE_BOUND = 0.08   # m, Sim3-aligned; tests/test_e2e_mono.py's bound
# phase 5: sweep, then jump back (the JAX System relocalizes on this sequence)
KIDNAP_SWEEP, KIDNAP_STEP, KIDNAP_JUMP = 64, 0.08, 4
RELOC_MIN_INLIERS = 15   # the PnP gate of pipeline/tracking.py relocalize_candidates
# phase 6: tests/test_e2e_loop.py's loop at its own 320x240 setting
LOOP_FRAMES = 180
# the JAX System on the same cell: closes one loop (frame 167), tracks 176/180,
# ATE 0.043950252591681414 m over frame_trajectory() after the final fold
# (python3 tools/jax_loop_reference.py --qvga, a CPU run)
LOOP_ATE_JAX = 0.043950252591681414
# and pipelined (async_depth 2) with keyframe culling on: it loses the map
# at frame 61, relocalizes at 167, closes nothing; frames with a pose in
# frame_trajectory() and their ATE (tools/jax_loop_reference.py --qvga
# --async-depth 2 --kf-culling, a CPU run)
LOOP_ASYNC_TRACKED_JAX = 69
LOOP_ASYNC_ATE_JAX = 0.08619519865638416
# kernel name: (source, the JAX code it replaces, its wrapper's __name__)
SOURCES = {
    "fast_nms": ("orb_slam2_annotate_tpu_torch/csrc/fast_nms.cu",
                 "orb_slam2_annotate_tpu/ops/fast.py:40", "fast_nms"),
    "orb_describe": ("orb_slam2_annotate_tpu_torch/csrc/orb_describe.cu",
                     "orb_slam2_annotate_tpu/ops/orb.py:256", "orb_describe"),
    "hamming_match": ("orb_slam2_annotate_tpu_torch/csrc/hamming.cu",
                      "orb_slam2_annotate_tpu/ops/matching.py:77", "hamming_match"),
    "distinctive_descriptors": ("orb_slam2_annotate_tpu_torch/csrc/hamming.cu",
                                "orb_slam2_annotate_tpu/worldmap/map_state.py:397",
                                "distinctive_descriptors"),
    "pose_lm_solve": ("orb_slam2_annotate_tpu_torch/csrc/pose_lm.cu",
                      "orb_slam2_annotate_tpu/solvers/pose_opt.py:134", "optimize_pose_batched"),
    "assign_words": ("orb_slam2_annotate_tpu_torch/csrc/assign_words.cu",
                     "orb_slam2_annotate_tpu/worldmap/vocabulary.py:81", "assign_words"),
    "pnp_hypotheses": ("orb_slam2_annotate_tpu_torch/csrc/pnp_score.cu",
                       "orb_slam2_annotate_tpu/solvers/pnp.py:87", "pnp_hypotheses"),
    "sim3_ransac_solve": ("orb_slam2_annotate_tpu_torch/csrc/sim3.cu",
                          "orb_slam2_annotate_tpu/solvers/sim3.py:101", "sim3_ransac_solve"),
    "sim3_lm_solve": ("orb_slam2_annotate_tpu_torch/csrc/sim3.cu",
                      "orb_slam2_annotate_tpu/solvers/sim3.py:172", "sim3_lm_solve"),
    "stereo_match": ("orb_slam2_annotate_tpu_torch/csrc/stereo.cu",
                     "orb_slam2_annotate_tpu/pipeline/frame.py:147", "stereo_match"),
    "remap_pair": ("orb_slam2_annotate_tpu_torch/csrc/remap.cu",
                   "orb_slam2_annotate_tpu/geometry/rectify.py:64", "remap_pair"),
    "segment_sum": ("orb_slam2_annotate_tpu_torch/csrc/segment_sum.cu",
                    "orb_slam2_annotate_tpu/solvers/ba_cg.py:88", "segment_sum"),
    "grid_ba": ("orb_slam2_annotate_tpu_torch/csrc/grid_ba.cu",
                "orb_slam2_annotate_tpu/solvers/ba_core.py:473", "grid_ba_solve"),
    "chol_solve": ("orb_slam2_annotate_tpu_torch/csrc/chol_solve.cu",
                   "orb_slam2_annotate_tpu/solvers/ba_core.py:205", "chol_solve"),
    "lu_solve": ("orb_slam2_annotate_tpu_torch/csrc/lu_solve.cu",
                 "orb_slam2_annotate_tpu/parallel/dist_ba.py:190", "lu_solve"),
}
LOOP_ONLY = ("sim3_ransac_solve", "sim3_lm_solve")   # launched only with loop closing on
STEREO_ONLY = ("stereo_match", "remap_pair")         # launched only by the stereo sensor
# launched only by a closure's pose graph and global BA (and the merge, the dense and the
# distributed BA): kernel 11's segment sums
SOLVE_ONLY = ("segment_sum",)
# launched only by the dense BA and the distributed BA (phases 15-16, phase 3's solves)
DENSE_ONLY = ("chol_solve", "lu_solve")
# phases 7 and 8: bench.py's RGB-D / stereo cell (bench.py:151-196) on the
# slice's frames: bf = 500 x 0.3, th_depth 100, SlamConfig()'s other defaults
BASELINE = 0.3
# the JAX System on the same cells (python3 tools/jax_depth_reference.py rgbd|stereo,
# a CPU run): SE3-aligned ATE over frame_trajectory(), all 48 frames tracked
RGBD_ATE_JAX = 0.0028807614141597984
STEREO_ATE_JAX = 0.003443945486205791
# phases 9 and 10: the JAX System on the slice with fuse on, on the RGB-D cell
# with fuse on (SE3) and on the slice pipelined at async_depth 2, all 48
# frames (python3 tools/jax_depth_reference.py mono --fuse | rgbd --fuse |
# mono --async-depth 2, CPU runs): tracked 41 / 48 / 41
FUSE_ATE_JAX = 0.003769911996766967
RGBD_FUSE_ATE_JAX = 0.016868081563778278
ASYNC_ATE_JAX = 0.003582911634125806
ASYNC_DEPTH = 2
# phases 11-13: the free runner's cells.  Phase 11 is bench.py's mono cell
# (bench.py:132-198): the slice's width and orbit for 112 frames, then 48
# frames bouncing back over it (frames 110 down to 63), with loop closing and
# live global BA on; phase 12 the loop cell at max_kf 128 / max_mp 16384 /
# max_frames_between_kf 4 (tests/test_free_running.py:168-209), mono and
# with rendered depth (bf 250 x 0.08, th_depth 100); phase 13 phases 7-8's
# depth cell.  The JAX FreeRunner on them (python3 tools/jax_free_reference.py
# bench | loop | loop_rgbd | rgbd | stereo, CPU runs): tracked frames,
# keyframes, map points, closures, ATE (Sim3 mono, SE3 with depth)
FREE_BENCH_ORBIT, FREE_BENCH_BOUNCE = 112, 48
FREE_BENCH_JAX = dict(tracked=153, keyframes=30, map_points=5490, ate=0.19209366891089696)
FREE_LOOP_JAX = dict(tracked=176, keyframes=66, loops=1, ate=0.07542532429859167)
FREE_LOOP_RGBD_JAX = dict(tracked=180, keyframes=64, loops=2, ate=0.04468715610689028)
# with depth the runner's draws decide the second closure's correction in both
# packages: the JAX FreeRunner's SE3 ATE over SlamConfig.seed 0-9 (all close
# twice, track 180/180; tools/jax_free_reference.py loop_rgbd --seed S, CPU
# runs); the port is held to the worst of them
FREE_LOOP_RGBD_JAX_SEEDS = (0.04468715610689028, 0.09881848608167484, 0.034537973528983024,
                            0.046201322201953166, 0.10208444135878096, 0.04363240713791778,
                            0.21978905092479564, 0.055770558606931975, 0.05970467373767481,
                            0.05492065771191613)
FREE_RGBD_ATE_JAX = 0.0028807529139862663
FREE_STEREO_ATE_JAX = 0.003443949556563205
LOOP_DEPTH_BF = 250.0 * 0.08
# phase 6 with that depth through the RGB-D System (th_depth 100): the JAX System over
# seeds 0-9 (python3 tools/jax_loop_reference.py --qvga --depth --seed S, CPU runs; a
# seed S > 0 is folded into the loop closer's Sim3 RANSAC keys, which the System keys by
# the keyframe count alone, so the seeds sample the draws' spread).  Seed 0, the
# reference's own keys: closures at frames 61 and 157, both global BAs folded, 180/180
# tracked, 63 keyframes; over the seeds 1-2 closures (seed 7: one, at 155) and an SE3 ATE
# over frame_trajectory() of 0.0405-0.1810 m.  The port, whose draws are its own, is held
# to the worst, as phase 12 holds the runner
LOOP_RGBD_JAX = dict(loops=2, tracked=180, keyframes=63, closure_frames=(61, 157))
LOOP_RGBD_JAX_SEEDS = (0.04052827772598643, 0.04814573340381607, 0.056814387733908796,
                       0.04878219077625667, 0.07407888051714501, 0.06055296393460234,
                       0.05983351689497685, 0.062093365772005284, 0.06828622143878017,
                       0.1810271444826317)
# phase 14: map I/O relocalizes frames 4-7 of phase 5's sweep into the map a
# System saved after the sweep, each camera centre within
# tests/test_checkpoint.py:57's bound once the saved run's trajectory is
# Sim3-aligned to the truth; the merge runs two
# RGB-D sessions of phases 7-8's cell (tests/test_merge.py's bounds); the
# drivers run on tools/driver_fixtures.py's VGA cells of 32 frames and
# run_synthetic --free on 40.  The JAX package on the same cells
# (python3 tools/jax_io_reference.py, a CPU run): the merge's outcome, and
# each driver's Sim3-aligned ATE over its trajectory file (KITTI: the
# keyframe trajectory)
RELOC_FRAMES = (4, 5, 6, 7)
RELOC_BOUND = 0.30
MERGE_A, MERGE_B = range(0, 28), range(20, 48)
DRIVER_FRAMES, SYNTHETIC_FRAMES, FIRST_FRAMES = 32, 40, 4
MERGE_JAX = dict(success=True, scale=1.0, median_kf_err_m=0.012890535163916542, keyframes_a=6,
                 keyframes_b=6)
DRIVER_ATE_JAX = {"tum_mono": 0.008611342531422888, "tum_rgbd": 0.004566327891771606,
                  "kitti_mono": 0.002335408708058427, "euroc_stereo": 0.010501911240129799,
                  "synthetic_free": 0.012052084054321609}
# phase 15: phase 6's map at its closure, padded to bench.py's mono capacities
# (bench.py:153-180: 128 keyframe slots, 16,384 point slots, 1,024 features)
DIST_K, DIST_P, DIST_N = 128, 16384, 1024
DIST_ITERS = 10                    # LoopCloserConfig.global_ba_iters
DIST_RANK_TIMEOUT_S = 300          # a rank of phase 15(b); every rendezvous and collective: 120 s
# card against CPU, two ranks against one (chip_smoke.ba_agreement).  Float32
# runs whose sums add in another order end apart along the map's flat
# directions (its scale, a weakly triangulated point's depth), where the
# objective hardly moves.  The dense BA (a Cholesky, each step's new cost
# tested) is held on the returned state's cost (relative) and the
# reprojection RMSE (px); its arithmetic is the same on the card and the CPU
# (ba_core.bundle_adjust), so the two agree bit for bit: on phase 6's closure
# map one float32 ulp of its input moves its 10-step state's cost by 1e-5 to
# 3e-5.  Its returned cost is the last step's, kept or
# not (the reference's ``costs[-1]``), and a step whose Cholesky refuses the
# damped system (lambda <= ~1e-6 on this map, up to 3 of 10 steps in both
# packages) costs the barrier of a NaN state (16,245,795 here).  On which
# step a solve fails follows rounding (tests/_ba_spread.py --dense-steps):
# 1 of 13 CPU edge orders ends on one in the port; JAX's 4 steps on the
# given order do, where the port's do not.
# So the two runs' returned costs are printed, not compared, and each is
# held to be its last step's: not below its returned state's cost.
DIST_TOL = dict(state_cost=1e-5, rmse_px=5e-3, cost_below_state=1e-5)
# The distributed BA copies the reference's LM (ROADMAP.md §3): an LU of a
# camera system whose scale direction, once the damping has fallen (x 0.5 a
# kept step), is float32 rounding, and a last step applied untested.  Its
# 10-step state is then a draw: on phase 6's closure map, over 16 edge
# orders on the CPU, JAX's 1-device runs ended at states costing up to 27%
# more than the best and the port's up to 1.6% more, while their returned
# costs agreed within 4e-6 (tests/_ba_spread.py).  So its 10-step
# run is held on the returned cost, and its state after DIST_SHORT_ITERS
# steps, before the draw starts, on the state's cost and each valid edge's
# residual (px): there 8 edge orders spread them by 3.1e-7 and 0.0024 px,
# and one step fewer moves them by 2.7e-5 and 0.051 px.
DIST_FULL_TOL = dict(cost=1e-5)
# The distributed BA sums its camera system block by block in block order
# (parallel/dist_ba.py), so phase 15's world-one runs take the blocks of its
# two ranks, and phase 16(b)'s reference the split map's two live blocks.
DIST_BLOCKS = 2
DIST_SHORT_ITERS = 4
DIST_SHORT_TOL = dict(cost=1e-5, state_cost=4e-6, residual_px=0.012)
# ``python3 chip_smoke.py --keep-ba DIR`` also keeps phase 15's BA problem
# and camera (DIR/phase15_ba_problem.npz), for tests/_ba_spread.py
KEEP_BA = None
VOCAB_WORDS, VOCAB_ITERS = 4096, 8  # phase 15(e): train_vocabulary on phase 4's descriptors
SHARD_RANK_TIMEOUT_S = 300  # a rank of phase 16; every rendezvous and collective: 120 s
PEAK_OPS = 67e12      # /s: f32 outside the tensor cores (H100 SXM); 32-bit integer work alike
PEAK_INT8_TC = 1.979e15  # /s: int8 dense tensor cores (H100 SXM); kernel 5's 1-bit products
PEAK_BYTES = 3.35e12  # /s: HBM3
# operations per unit of work, counted from each kernel's source
FAST_OPS_PER_PIXEL = 605       # 16 differences, 2 arcs x 16 starts x (1 + 8 x 2) + 16 maxima, NMS
DESCRIBE_OPS_PER_KP = 10150    # 961 x 6 moment terms, 961 x 4 variance terms, 512 compares
DESCRIBE_BYTES_PER_KP = 7940   # 961-float patch, 1024 blurred samples
SLOT_BYTES = 85                # a keypoint out: xy, response, octave, angle, desc, valid
SELECT_OPS_PER_PIXEL = 4       # the bonus add, s > 0, the select, the running maximum
HAMMING_OPS_PER_PAIR = 48      # 16 x (xor, popcount, add)
WINDOW_GATE_OPS = 9            # 2 differences, 2 products, a sum, a compare, 2 octave compares, and
EPIPOLAR_GATE_OPS = 7          # 2 products, 2 sums, a square, a division, a compare
BLUR_OPS_PER_PIXEL = 28        # 7 + 7 multiply-adds
PNP_OPS_PER_REPROJECTION = 33  # 18 for R x + t, 2 divisions, 13 for the residual and the test
# a DLT hypothesis, counted from the function and not from the kernel's Jacobi
# schedule: the 48 products of A's -u X and -v X entries; Sigma and V of the 13 x 12
# A (Golub and Van Loan's 4 m n^2 + 8 n^3); det M (17), the cube root (10), the
# scaling of P (12); U, Sigma, V of the 3 x 3 M (4 m^2 n + 8 m n^2 + 9 n^3 = 567),
# R = U V^T (45), det R and the sign (26)
PNP_DLT_OPS = 48 + (4 * 13 * 12 ** 2 + 8 * 12 ** 3) + 17 + 10 + 12 + 567 + 45 + 26
DD_OPS_PER_PAIR = 4            # distinctive descriptor: the distance from the popcounts, a compare
DD_BYTES_PER_ROW = 72          # an observed row read (64 B) and its two indices
DD_BYTES_PER_POINT = 72        # the count in, the descriptor and its slot out
POSE_OPS_PROJECT, POSE_OPS_ROW, POSE_OPS_COST, POSE_OPS_RECLASS = 45, 66, 35, 30
# kernel 7: a 3-point Horn counted from the function, not the Jacobi schedule:
# centroids (18), M (27), Q (16), the 4x4 symmetric eigenproblem at SVD-level
# work (9 n^3 = 576), R from q (30), scale and t (45); both reprojections of
# a valid pair (33 operations each, as kernel 6's); the weighted Horn's
# terms of an inlier of the best: its weight and the two weighted points
# (7 products, 7 sums), the centred points (6), M's 9 products, weights and
# sums (27), R a (15), the two dot products (10), their weights and sums (4)
SIM3_HORN_OPS = 18 + 27 + 16 + 9 * 4 ** 3 + 30 + 45
SIM3_OPS_PER_REPROJECTION = 33
SIM3_WEIGHTED_OPS_PER_INLIER = 14 + 6 + 27 + 15 + 10 + 4
SIM3_PAIR_BYTES = 49             # x1, x2, uv1, uv2, both inverse sigma^2 (f32), valid
SIM3_HYP_BYTES = 24 + 4          # the sampled triple in, its count out
SIM3_RANSAC_OUT_BYTES = 52 + 4 + 1 + 8   # s, R, t; n; success; best (and a byte a pair's mask)
# kernel 8, a valid pair in one LM iteration: both projections (66), 4
# Jacobian rows of 7 (4 x 20) and their 28 + 7 products and sums (4 x 70),
# the cost (20), three candidate costs (3 x 86), the inlier refresh (70)
SIM3_LM_OPS_PER_PAIR = 66 + 4 * 20 + 4 * 70 + 20 + 3 * 86 + 70
# kernel 9: the row-band gate of a pair (2 differences, 2 absolutes, a product,
# 5 compares, the octave difference; ~12), a candidate's 512-bit distance (as
# kernel 3's 48) and its packed minimum (2); an accepted row's 9 x 81 SAD terms
# (a difference, an absolute, a sum: 3) and its parabola and depth (~40)
STEREO_GATE_OPS = 12
STEREO_CAND_OPS = HAMMING_OPS_PER_PAIR + 2
SAD_OPS_PER_TERM, SAD_TERMS = 3, 9 * 81
STEREO_ROW_OPS = 40
STEREO_KP_BYTES = 8 + 4 + 1 + 64          # a keypoint: xy, octave, valid, descriptor
STEREO_ROW_BYTES = 4 + 17                 # x_und in; ur, depth, best, bestd, ok out
SAD_PIXELS = 81 + 9 * 17                  # an accepted row's left patch and right band
# kernel 10 per output pixel: floor x 2, 2 fractions, 4 tap tests, 6 products,
# 3 sums, 3 complements
REMAP_OPS_PER_PIXEL = 20
REMAP_BYTES_PER_PIXEL = 4 + 8 + 4         # the image read once, the map, the output


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 100) -> float:
    """CUDA-event time of one call: one event pair around `reps`
    back-to-back calls after a warm-up call, divided by `reps`."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_us(fn, reps: int = 50) -> float:
    """Device time of one call in microseconds: a warm-up call, then `reps`
    calls captured into one CUDA graph, replayed once, then one CUDA-event
    pair around a second replay, divided by `reps`.  No host work runs
    between the kernels; the graph's gaps between launches are included."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def host_ns(fn, calls: int = 10_000, batch: int = 200) -> float:
    """Host time of one call in ns: time.perf_counter_ns around batches of
    `batch` back-to-back calls, `calls` in all, after a warm-up call; the
    card is drained between batches, outside the timed part, so a launch
    never waits for a full queue."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(calls // batch):
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
    return total / (calls // batch * batch)


def host_parts(name: str, parts: dict) -> dict:
    """Each part's host ns a call (host_ns), printed on one line."""
    out = {k: round(host_ns(fn), 1) for k, fn in parts.items()}
    print(f"{name} host parts, ns a call over 10,000 calls: {json.dumps(out)}")
    return out


def device_kernels(fn, expected: int) -> dict:
    """The device kernels that one call of `fn` launches: a warm-up call,
    then one call captured into a CUDA graph, whose kernel nodes the CUDA
    driver API's graph calls count and name (a short profiler trace can
    lose every kernel in it; a capture records each launch and runs none).
    Fails unless there are exactly `expected`.  Memory copies and sets are
    listed but are not kernels."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            fail(f"device_kernels: {what} returned CUresult {err}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kernels, others = [], []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                      # CU_GRAPH_NODE_TYPE_KERNEL
            others.append(kind.value)
            continue
        params = (ctypes.c_void_p * 16)()        # CUDA_KERNEL_NODE_PARAMS: the function first
        check(cu.cuGraphKernelNodeGetParams(ctypes.c_void_p(node), params),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])), "cuFuncGetName")
        kernels.append(name.value.decode())
    if len(kernels) != expected:
        fail(f"{expected} device kernels a call expected, the captured call holds {kernels} "
             f"(and {len(others)} other nodes)")
    return {"device_launches_per_call": len(kernels), "device_ops": kernels,
            "other_graph_nodes": others}


def bound(nbytes: float, ops: float, tc_ops: float = 0.0):
    """(least time in ms, what bounds it) for this work on the card: `ops` on
    the CUDA cores, `tc_ops` on the int8 tensor cores (the two overlap)."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    t_ops = max(1e3 * ops / PEAK_OPS, 1e3 * tc_ops / PEAK_INT8_TC)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pose_lm_work(xw, ur, valid, rounds: int = 4, iters: int = 5):
    """(bytes, operations) of one optimize_pose_batched call on these edges:
    every pass runs over the valid edges (the mask is a subset)."""
    B, N = valid.shape
    n_valid = float(valid.sum())
    stereo = float(((ur >= 0) & valid).sum())
    rows = 2 * n_valid + stereo
    lin = POSE_OPS_PROJECT * n_valid + POSE_OPS_ROW * rows + POSE_OPS_COST * n_valid
    ops = rounds * iters * (lin + 3 * POSE_OPS_COST * n_valid) + rounds * POSE_OPS_RECLASS * n_valid
    shared = 1 if ur.dim() == 1 else B
    nbytes = B * N * (12 + 1) + shared * N * (8 + 4 + 4) + B * (48 + N + 48 + 4)
    return nbytes, ops


def pose_lm_synthetic(cam, f0, depth0, pose0, noise):
    """Kernel 4's synthetic problems on frame 0's features `f0`: its 1024
    keypoints back-projected with the exact depth (`depth0`, the rendered map)
    from the true pose `pose0`, `noise` [1024, 3] added to uv and to the right
    coordinates.  Returns {"b1": one start pose, "b8": 8 start poses around the
    truth, "half stereo": b1 with every other edge stereo (0.08 m baseline)},
    each optimize_pose_batched's arguments."""
    import torch

    from orb_slam2_annotate_tpu_torch.geometry import lie

    dev = f0.xy.device
    dep = torch.from_numpy(depth0).to(dev)
    xi = f0.xy[:, 0].round().long().clamp(0, dep.shape[1] - 1)
    yi = f0.xy[:, 1].round().long().clamp(0, dep.shape[0] - 1)
    z = dep[yi, xi]
    R_gt = torch.from_numpy(pose0[0]).to(dev)
    t_gt = torch.from_numpy(pose0[1]).to(dev)
    xc = torch.stack([(f0.xy[:, 0] - cam.cx) / cam.fx * z, (f0.xy[:, 1] - cam.cy) / cam.fy * z, z], 1)
    xw = ((xc - t_gt) @ R_gt).contiguous()
    uv = (f0.xy + noise[:, :2]).contiguous()
    isg = (1.0 / 1.2 ** (2.0 * f0.octave.float())).contiguous()
    valid = (f0.valid & (z > 0)).contiguous()
    xi_pert = torch.tensor([0.01, -0.02, 0.015, 0.002, -0.003, 0.001], device=dev)
    scales = torch.tensor([1.0, 0.5, 2.0, -1.0, 1.5, -0.5, 0.75, -2.0], device=dev)
    R8, t8 = lie.se3_retract(R_gt.expand(8, 3, 3), t_gt.expand(8, 3), scales[:, None] * xi_pert)
    R8, t8 = R8.contiguous(), t8.contiguous()
    n = xw.shape[0]
    cam_st = dataclasses.replace(cam, bf=cam.fx * 0.08)
    ur_mono = torch.full((n,), -1.0, device=dev)
    ur_st = torch.where(torch.arange(n, device=dev) % 2 == 0,
                        uv[:, 0] - cam_st.bf / z.clamp_min(1e-3) + noise[:, 2], ur_mono)
    ur_all = uv[:, 0] - cam_st.bf / z.clamp_min(1e-3) + noise[:, 2]
    b1 = (cam, R8[:1], t8[:1], xw[None], uv, ur_mono, isg, valid[None])
    return {"b1": b1,
            "b8": (cam, R8, t8, xw.expand(8, -1, -1).contiguous(), uv, ur_mono, isg,
                   valid.expand(8, -1).contiguous()),
            "half stereo": (cam_st, *b1[1:5], ur_st, *b1[6:]),
            "every edge stereo": (cam_st, *b1[1:5], ur_all.contiguous(), *b1[6:]),
            "truth": (R_gt, t_gt)}


def pose_lm_cases(syn, seed: int = 18):
    """Kernel 4's edge cases beside the synthetic problems `syn`
    (pose_lm_synthetic), their draws from their own generator, each
    optimize_pose_batched's arguments: N = 4096
    slots, every edge valid (points 2-8 m ahead of the true camera, 1 px of
    noise, 10% of them 30 px off, octaves 0-7), from b1's start pose; b1
    with no valid edge, with one (its first valid slot), with every edge
    stereo, cut to N = 1021 slots; B = 64 start poses around b8's (a CTA
    a problem: about what a wave of the card holds); B = 0."""
    import torch

    from orb_slam2_annotate_tpu_torch.geometry import lie

    cam, R1, t1, xw1, uv1, ur1, is1, v1 = syn["b1"]
    R_gt, t_gt = syn["truth"]
    dev = xw1.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 4096
    lo = torch.tensor([-3.0, -2.0, 2.0], device=dev)
    hi = torch.tensor([3.0, 2.0, 8.0], device=dev)
    xc = lo + (hi - lo) * torch.rand(n, 3, generator=gen, device=dev)
    uv = torch.stack([cam.fx * xc[:, 0] / xc[:, 2] + cam.cx, cam.fy * xc[:, 1] / xc[:, 2] + cam.cy], 1)
    uv = uv + torch.randn(n, 2, generator=gen, device=dev)
    off = torch.rand(n, generator=gen, device=dev) < 0.1
    uv = torch.where(off[:, None], uv + 30.0 * torch.randn(n, 2, generator=gen, device=dev), uv)
    octave = torch.randint(0, 8, (n,), generator=gen, device=dev)
    one = torch.zeros_like(v1)
    one[0, int(torch.nonzero(v1[0])[0])] = True
    R8, t8 = syn["b8"][1], syn["b8"][2]
    R64, t64 = lie.se3_retract(R8.repeat(8, 1, 1), t8.repeat(8, 1),
                               0.01 * torch.randn(64, 6, generator=gen, device=dev))
    cut = lambda a: a[..., :1021].contiguous() if a.dim() < 3 else a[:, :1021].contiguous()
    return {
        "N = 4096, every edge valid": (
            cam, R1, t1, ((xc - t_gt) @ R_gt)[None].contiguous(), uv.contiguous(),
            torch.full((n,), -1.0, device=dev), (1.0 / 1.2 ** (2.0 * octave.float())).contiguous(),
            torch.ones((1, n), dtype=torch.bool, device=dev)),
        "no valid edge": (cam, R1, t1, xw1, uv1, ur1, is1, torch.zeros_like(v1)),
        "one valid edge": (cam, R1, t1, xw1, uv1, ur1, is1, one),
        "every edge stereo": syn["every edge stereo"],
        "N = 1021": (cam, R1, t1, cut(xw1), cut(uv1.T).T.contiguous(), cut(ur1), cut(is1), cut(v1)),
        "B = 64": (cam, R64.contiguous(), t64.contiguous(), xw1.expand(64, -1, -1).contiguous(),
                   uv1, ur1, is1, v1.expand(64, -1).contiguous()),
        "B = 0": (cam, R1[:0], t1[:0], xw1[:0], uv1, ur1, is1, v1[:0]),
    }


def pose_lm_division_check(n: int = 1 << 24) -> dict:
    """Kernel 4's division (a shared refined reciprocal where both operands
    lie within [2^-60, 2^60], `/` elsewhere) and square root (the compiler's
    fast path without its branch where it applies, sqrtf elsewhere; both in
    csrc/pose_lm.cu) against IEEE `/` and sqrt (torch's CUDA division and
    square root of tensors), bit for bit, on n random pairs of each of two
    exponent spans: [-70, 70) and [-130, 130) with the signs random.  Also
    the kernel's static shared memory against the wrapper's allowance.
    Fails on any difference."""
    import ctypes

    import torch

    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import pose_lm as k4

    lib = _build.load("pose_lm")
    fn = lib.pose_lm_div_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    static = int(lib.pose_lm_static_smem())
    if static > k4.STATIC_SMEM:
        fail(f"pose_lm_solve: {static} B of static shared memory, the wrapper allows {k4.STATIC_SMEM}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    differ = 0
    for lo, hi in ((-70, 70), (-130, 130)):
        def draw():
            e = torch.randint(lo, hi, (n,), generator=gen, device="cuda").float()
            sign = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
            return (torch.rand(n, generator=gen, device="cuda") + 1.0) * torch.exp2(e) * sign
        a, b = draw(), draw()
        q, r = torch.empty_like(a), torch.empty_like(a)
        _build.check_launch(fn(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(), n,
                               _build.stream_ptr(a.device)), "pose_lm_div_check")
        differ += int((q.view(torch.int32) != (a / b).view(torch.int32)).sum())
        differ += int((r.view(torch.int32) != torch.sqrt(a.abs()).view(torch.int32)).sum())
    if differ:
        fail(f"pose_lm_solve's division or square root differs from IEEE on {differ} of {4 * n}")
    return {"division_and_sqrt_checks": 4 * n, "differ": differ, "static_smem": static}


def render_all(scene, cam, poses, h: int, w: int):
    """Each pose's (image f32, depth f32) as ``scene.render`` gives it, the
    poses rendered in a thread pool on the host's cores (the renderer is a
    pure function of its inputs, and numpy's array work releases the
    interpreter lock)."""
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return list(pool.map(lambda p: scene.render(cam, p[0], p[1], h=h, w=w), poses))


def slice_setup(n_render: int = N_FRAMES):
    """The smoke run's slice at ``bench.py``'s mono width: (camera, ground-truth
    poses, rendered uint8 frames, depth maps, slice config).  Frames are
    rendered on the host by the port's numpy PlaneScene; only the first
    `n_render` of them where fewer are asked for."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(N_FRAMES, step=0.05)
    frames, depths = [], []
    for img, dep in render_all(scene, cam, poses[:n_render], 480, 640):
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(dep)
    cfg = mono_slice_config(n_features=1024, n_levels=8, max_kf=128, max_mp=16384,
                            max_frames_between_kf=6, init_min_matches=60)
    return cam, poses, frames, depths, cfg


def k1_cases() -> dict:
    """Kernel 1's inputs (phase 3, tools/k1_stages.py): {name: (f32 image
    [H,W] in 0-255, n_levels, scale)}: the slice's frames 0 and 4 and frame
    0's stereo right image (VGA, 8 levels), the loop cell's first frame
    (QVGA, 4 levels), an integer image of flat blocks 0, 7, 8, 20 or 21
    grey levels apart (FAST strengths exactly at both thresholds, plateaus,
    NMS ties) and frame 4 cut to 250 x 333 (sides no multiple of the tile
    or of 4)."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    poses = synthetic.orbit_trajectory(N_FRAMES, step=0.05)
    shift = np.array([BASELINE, 0.0, 0.0], np.float32)
    views = [poses[0], poses[4], (poses[0][0], np.asarray(poses[0][1], np.float32) - shift)]
    f32 = lambda img: np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)
    f0, f4, r0 = (f32(img) for img, _ in render_all(synthetic.PlaneScene(seed=1), cam, views, 480, 640))
    qcam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    R, t = synthetic.circle_trajectory(LOOP_FRAMES, radius=1.8, turns=1.04)[0]
    loop0 = f32(synthetic.RoomScene(seed=2).render(qcam, R, t, h=240, w=320)[0])
    rng = np.random.default_rng(22)
    steps = np.array([-21, -20, -8, -7, 0, 7, 8, 20, 21], np.float32)
    plat = np.full((480, 640), 100.0, np.float32)
    for _ in range(4000):
        h, w = rng.integers(1, 12, 2)
        y, x = rng.integers(0, 480 - h), rng.integers(0, 640 - w)
        plat[y:y + h, x:x + w] = 100.0 + rng.choice(steps)
    vga, qvga = SlamConfig().extractor, SlamConfig(n_features=512, n_levels=4).extractor
    return {"slice frame 0": (f0, vga.n_levels, vga.scale),
            "slice frame 4": (f4, vga.n_levels, vga.scale),
            "stereo right image of frame 0": (r0, vga.n_levels, vga.scale),
            "loop frame 0 (QVGA, 4 levels)": (loop0, qvga.n_levels, qvga.scale),
            "plateaus, strengths at 7 and 20": (plat, vga.n_levels, vga.scale),
            "frame 4 cut to 250 x 333": (np.ascontiguousarray(f4[:250, :333]), vga.n_levels,
                                         vga.scale)}


def k3a_cases(feats, poses, cam, cfg, dev, k3, gen) -> dict:
    """Kernel 3's inputs (phase 3, tools/k3a_stages.py) from the slice's
    frames 0-20 as extracted (`feats`), the gates made with `k3` (the
    wrapper module of the tree under test): {name: (desc1, desc2, row_valid,
    col_valid, gate, [(max_dist, ratio, mutual)] or None for the default
    grid)}.  The main path's calls (window + octave band at B = 1, the
    initialization window, the epipolar gate at B = 20, validity at B = 8,
    a window at B = 2 and B = 11) and the edges: a dense mask, every row
    invalid, N2 = 1000, N1 = 1, repeated rows against unique columns (tied
    distances and column minima), every descriptor equal, desc1 off a 16-byte
    boundary and a column exactly on a window's circle."""
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.ops import matching
    from orb_slam2_annotate_tpu_torch.pipeline import local_mapping, tracking

    cur = feats[4]
    d1 = torch.cat([f.desc for f in feats[:4]])                       # 4096 "map points"
    xy1 = torch.cat([f.xy for f in feats[:4]])
    oc1 = torch.cat([f.octave for f in feats[:4]])
    ok1 = torch.cat([f.valid for f in feats[:4]])
    radius = (15.0 * 1.2 ** oc1.float()).contiguous()
    win_4k = k3.WindowGate(xy1, radius, cur.xy, oc1, cur.octave, -1, 1)
    win_1k = k3.WindowGate(xy1[3072:], radius[3072:], cur.xy, oc1[3072:], cur.octave, -1, 1)
    mask_1k = k3.gate_mask(win_1k).contiguous()
    f0 = feats[0]
    stack = lambda name, fs=feats[1:21]: torch.stack([getattr(f, name) for f in fs]).contiguous()
    R0, t0 = (torch.from_numpy(a).to(dev) for a in poses[0])
    Rs = torch.stack([torch.from_numpy(poses[k][0]) for k in range(1, 21)]).to(dev)
    ts = torch.stack([torch.from_numpy(poses[k][1]) for k in range(1, 21)]).to(dev)
    F12 = local_mapping._fundamental_between(cam, R0, t0, Rs, ts).contiguous()
    inv_s2 = tracking.inv_sigma2(torch.arange(cfg.n_levels, device=dev)).contiguous()
    ex1 = torch.rand(1024, generator=gen, device=dev) < 0.2
    ex2 = torch.rand(20, 1024, generator=gen, device=dev) < 0.2
    epi = k3.EpipolarGate(F12, f0.xy, stack("xy"), stack("octave"), inv_s2)
    d8 = torch.stack([f.desc for f in feats[5:13]])
    v8 = torch.stack([f.valid for f in feats[5:13]])
    fb = feats[5:16]                                                  # B = 11, as the fuse's
    rep = lambda t, n: t[None].expand(n, *t.shape).contiguous()
    win_11 = k3.WindowGate(rep(xy1[3072:], 11), rep(radius[3072:], 11), stack("xy", fb),
                           rep(oc1[3072:], 11), stack("octave", fb), -1, 1)
    win_2 = k3.WindowGate(rep(xy1[3072:], 2), 20.0, stack("xy", feats[4:6]))
    win_1000 = k3.WindowGate(xy1[3072:], radius[3072:], cur.xy[:1000].contiguous(), oc1[3072:],
                             cur.octave[:1000].contiguous(), -1, 1)
    pool = cur.desc[:8]                                              # ties: rows repeat 8 descriptors
    pick = torch.randint(0, 8, (1024,), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    cols = torch.cat([cur.desc[512:], pool, cur.desc[8:512]])[:1024].contiguous()
    same = cur.desc[:1].expand(1024, -1).contiguous()
    # desc1 4 bytes off a 16-byte boundary (the kernel stages such rows word by word)
    off = torch.empty(1024 * 16 + 1, dtype=torch.int32, device=dev)[1:].view(1024, 16)
    off.copy_(d1[3072:])
    # one warp's 32 columns, the nearest exactly on the row's circle (radius 10
    # about (100, 100)), the others a float step or more beyond
    ring = 110.0 + torch.arange(32, device=dev, dtype=torch.float32) * float(np.spacing(np.float32(110)))
    on_x = torch.stack([ring, torch.full_like(ring, 100.0)], 1)
    at100 = torch.full((1, 2), 100.0, device=dev)
    lo_hi = [(matching.TH_LOW, 0.75, False), (matching.TH_LOW, 0.75, True),
             (matching.TH_LOW, 1.0, False), (matching.TH_LOW, 1.0, True)]
    return {
        "window+octave B=1 4096x1024": (d1, cur.desc, ok1, cur.valid, win_4k, None),
        "window+octave B=1 1024x1024": (d1[3072:], cur.desc, ok1[3072:], cur.valid, win_1k, None),
        "initialization window B=1": (f0.desc, cur.desc, f0.valid & (f0.octave == 0),
                                      cur.valid & (cur.octave == 0),
                                      k3.WindowGate(f0.xy, 100.0, cur.xy), [(matching.TH_LOW, 0.9, False)]),
        "dense mask B=1 1024x1024": (d1[3072:], cur.desc, None, None, k3.MaskGate(mask_1k), None),
        "epipolar B=20": (f0.desc, stack("desc"), f0.valid & ~ex1, stack("valid") & ~ex2, epi,
                          [(matching.TH_LOW, 1.0, False), (matching.TH_LOW, 1.0, True)]),
        "validity B=8 shared desc2": (d8, cur.desc, v8, cur.valid, None,
                                      [(matching.TH_LOW, 0.75, False), (matching.TH_LOW, 0.75, True)]),
        "window+octave B=11 1024x1024": (rep(d1[3072:], 11), stack("desc", fb), rep(ok1[3072:], 11),
                                         stack("valid", fb), win_11, None),
        "window B=2 1024x1024": (rep(d1[3072:], 2), stack("desc", feats[4:6]), None,
                                 stack("valid", feats[4:6]), win_2, None),
        "every row invalid": (d1[3072:], cur.desc, torch.zeros_like(ok1[3072:]), cur.valid, win_1k,
                              None),
        "N2 = 1000": (d1[3072:], cur.desc[:1000].contiguous(), ok1[3072:],
                      cur.valid[:1000].contiguous(), win_1000, None),
        "N1 = 1": (d1[3100:3101].contiguous(), cur.desc, None, cur.valid, None, lo_hi),
        "ties: rows repeat 8 descriptors, each in one column": (pool[pick].contiguous(), cols, None,
                                                               None, None, lo_hi),
        "every descriptor equal": (same, same, None, None, None, lo_hi),
        "desc1 off 16-byte alignment": (off, cur.desc, ok1[3072:], cur.valid, win_1k, None),
        "window, the nearest column on the circle": (cur.desc[:1], cur.desc[:32].contiguous(), None, None,
                                                     k3.WindowGate(at100, 10.0, on_x), lo_hi),
    }


def kidnap_setup(cam):
    """Phase 5's sequence: (ground-truth poses of the sweep, the frame index
    of each image, the rendered uint8 images).  A 64-frame sweep, then a
    jump back to frame 4 and three frames from there."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.io import synthetic

    scene = synthetic.PlaneScene(seed=1)
    gt = synthetic.orbit_trajectory(KIDNAP_SWEEP, step=KIDNAP_STEP)
    seq = list(range(KIDNAP_SWEEP)) + [KIDNAP_JUMP + i for i in range(4)]
    images = [np.clip(img, 0, 255).astype(np.uint8)
              for img, _ in render_all(scene, cam, [gt[f] for f in seq], 480, 640)]
    return gt, seq, images


def loop_setup():
    """Phase 6's cell: (camera, ground-truth poses, rendered uint8 frames,
    their depth maps, config): SlamConfig()'s own defaults (loop closing on)
    at tests/test_e2e_loop.py's sizes, keyframe culling off."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig

    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = synthetic.RoomScene(seed=2)
    poses = synthetic.circle_trajectory(LOOP_FRAMES, radius=1.8, turns=1.04)
    rendered = render_all(scene, cam, poses, 240, 320)
    frames = [np.clip(img, 0, 255).astype(np.uint8) for img, _ in rendered]
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=4,
                     init_min_matches=60, enable_kf_culling=False)
    return cam, poses, frames, [dep for _, dep in rendered], cfg


def depth_setup(poses):
    """Phases 7 and 8's cell: (camera with bf = 500 x 0.3, the stereo right
    images rendered at t - [0.3, 0, 0] as uint8, config for a sensor):
    bench.py's RGB-D / stereo settings, SlamConfig()'s other defaults (8
    levels; loop closing, relocalization and keyframe culling on)."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                             bf=500.0 * BASELINE)
    scene = synthetic.PlaneScene(seed=1)
    shift = np.array([BASELINE, 0.0, 0.0], np.float32)
    rights = [np.clip(img, 0, 255).astype(np.uint8) for img, _ in render_all(
        scene, cam, [(R, np.asarray(t, np.float32) - shift) for R, t in poses], 480, 640)]
    config = lambda sensor: SlamConfig(sensor=sensor, n_features=1024, max_kf=128, max_mp=16384,
                                       max_frames_between_kf=6, init_min_matches=60,
                                       th_depth=100.0)
    return cam, rights, config


def bench_setup(frames):
    """Phase 11's cell: (camera, ground-truth poses, uint8 frames, config):
    bench.py's SensorBench("mono") at 112 orbit frames (the slice's 48 and 64
    more rendered) and 48 bounce frames; loop closing and live GBA on."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    scene = synthetic.PlaneScene(seed=1)
    fwd = synthetic.orbit_trajectory(FREE_BENCH_ORBIT, step=0.05)
    images = list(frames[:N_FRAMES]) + [
        np.clip(img, 0, 255).astype(np.uint8)
        for img, _ in render_all(scene, cam, fwd[N_FRAMES:], 480, 640)]
    k, d, idx = FREE_BENCH_ORBIT - 1, -1, []
    for _ in range(FREE_BENCH_BOUNCE):
        k += d
        if k < 0:
            k, d = 1, 1
        idx.append(k)
    cfg = SlamConfig(n_features=1024, max_kf=128, max_mp=16384, max_frames_between_kf=6,
                     init_min_matches=60)
    return cam, fwd + [fwd[j] for j in idx], images + [images[j] for j in idx], cfg


def free_ate(out, gt, with_scale=True):
    """(ATE over a FreeRunner's finish() trajectory, tracked frames)."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.io import evaluation

    ids = [k for k, T in out["trajectory"] if T is not None]
    if len(ids) < 3:
        fail(f"only {len(ids)} tracked frames")
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in out["trajectory"] if T is not None])
    g = np.stack([-gt[k][0].T @ gt[k][1] for k in ids])
    return float(evaluation.ate_rmse(est.astype(np.float64), g.astype(np.float64),
                                     with_scale=with_scale)[0]), len(ids)


def stereo_work(args, out):
    """(bytes, operations) of one kernel-9 call on these inputs: every pair
    through the gate, each candidate's distance, each accepted row's SAD."""
    from orb_slam2_annotate_tpu_torch.kernels import stereo as k9

    xy_l, oct_l, valid_l, _, xy_r, oct_r, valid_r, _, _, _, _, scales, fx = args[:13]
    N, M = xy_l.shape[0], xy_r.shape[0]
    cand = float(k9.stereo_candidates(xy_l, oct_l, valid_l, xy_r, oct_r, valid_r, scales, fx).sum())
    rows = float((out[3] < args[14]).sum())            # rows that run the SAD
    return (STEREO_KP_BYTES * (N + M) + STEREO_ROW_BYTES * N + 4 * SAD_PIXELS * rows,
            STEREO_GATE_OPS * N * M + STEREO_CAND_OPS * cand
            + (SAD_OPS_PER_TERM * SAD_TERMS + STEREO_ROW_OPS) * rows)


SIM3_RANSAC_OUTS = ("s", "R", "t", "inliers", "n", "success", "counts", "best")


def check_sim3_ransac(what, args):
    """Kernel 7 against its twin: every output bit for bit (s, R, t, the
    mask, n, success, each hypothesis's count, best).  args as
    sim3_ransac_solve's.  Returns (max |ds|, |dR|, |dt|, whether the
    refined Sim3 was kept, the outputs)."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k7

    got = k7.sim3_ransac_solve(*args)
    ref = k7.sim3_ransac_solve_plain(*args)
    torch.cuda.synchronize()
    moved = [n for n, a, b in zip(SIM3_RANSAC_OUTS, got, ref) if not torch.equal(a, b)]
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3]))
    if moved:
        fail(f"sim3_ransac_solve ({what}): {moved} differ from the twin (max |ds|,|dR|,|dt| "
             f"{err:.3g}, counts differ on {int((got[6] != ref[6]).sum())} hypotheses, best "
             f"{int(got[7])} vs {int(ref[7])}, n {int(got[4])} vs {int(ref[4])})")
    # the refined Sim3 was kept unless the outputs are the best triple's own fit
    samples, x1, x2, fix_scale = args[0], args[1], args[2], args[13]
    idx = samples[got[7]].long()
    s_b, R_b, t_b = k7.horn3_plain(x1[idx][None], x2[idx][None], fix_scale)
    refined = not (torch.equal(got[0], s_b[0]) and torch.equal(got[1], R_b[0])
                   and torch.equal(got[2], t_b[0]))
    print(f"sim3_ransac_solve vs twin, {what}: H {samples.shape[0]}, N {x1.shape[0]}, valid "
          f"{int(args[5].sum())}, fix_scale {fix_scale}: every output bit-exact (best {int(ref[7])}, "
          f"{int(ref[6].max())} inliers; n {int(ref[4])}, success {bool(ref[5])}, refined kept "
          f"{refined}, s {float(ref[0]):.6f})")
    return err, refined, got


# kernel 8's rule by the conditioning of its problem: where cond(J^T W J) x
# 2^-24 (the LM normal matrix at the CPU twin's solution, float64) is at most
# K8_COND_LIMIT, float32 resolves the step and s, R, t are held within 1e-4 of
# the twin's; above it they are printed, not held, and the kernel's float64
# robust cost at its own solution must be at most the CPU twin's at the CPU
# twin's solution x (1 + m), plus the cost of residuals at float32's resolution
# of the pixels (4 n_valid (2^-24 max |uv|)^2 max inv_sigma2: what a problem
# whose residuals vanish costs), the twin run on the card too, with m the larger
# of K8_COST_MARGIN and twice the twin's own card-against-CPU cost spread on the
# same input (1.5e-8 on the routed closure's input, a float32 sum of its 46
# terms resolving ~46 x 2^-24 = 2.7e-6): the cost is what the LM minimizes, and
# a flat valley leaves its parameters to rounding
K8_COND_LIMIT = 1e-3
K8_COST_MARGIN = 1e-7


def k8_conditioning(args_cpu, sol) -> float:
    """The 2-norm condition number of the LM normal matrix J^T W J (float64,
    6 x 6 with the scale fixed) at the solution `sol` (s, R, t, inlier) over
    its inliers, the robust weights of the twin."""
    import torch

    from orb_slam2_annotate_tpu_torch.geometry import lie
    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k8

    x1, x2, uv1, uv2, valid = args_cpu[:5]
    fx, fy, cx, cy, fix_scale, th = args_cpu[10:16]
    pairs = [v.double() for v in (x1, x2, uv1, uv2, *k8.inv_sigma2_or_ones(x1, *args_cpu[5:7]))]
    s, R, t = (v.double() for v in sol[:3])
    _, c_f, c_i, dok = k8.project_residuals(fx, fy, cx, cy, s, R, t, *pairs)
    chi2 = c_f + c_i
    w = (torch.sqrt(torch.where(chi2 > th, torch.sqrt(th / chi2.clamp_min(1e-12)), 1.0))
         * (valid & sol[3] & dok))

    def resid(xi):
        s1, R1, t1 = lie.sim3_retract(s[None], R[None], t[None], xi[None])
        r, *_ = k8.project_residuals(fx, fy, cx, cy, s1, R1[0], t1[0], *pairs)
        return (r * w[:, None]).reshape(-1)

    J = torch.func.jacfwd(resid)(torch.zeros(7, dtype=torch.float64))
    J = J[:, :6] if fix_scale else J
    return float(torch.linalg.cond(J.T @ J))


def k8_cost(args_cpu, sol) -> float:
    """The float64 robust (Huber) cost the LM minimizes, over the valid pairs, at
    the solution `sol` (s, R, t)."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k8

    x1, x2, uv1, uv2, valid = args_cpu[:5]
    fx, fy, cx, cy, _, th = args_cpu[10:16]
    pairs = [v.double() for v in (x1, x2, uv1, uv2, *k8.inv_sigma2_or_ones(x1, *args_cpu[5:7]))]
    s, R, t = (v.cpu().double() for v in sol[:3])
    _, c_f, c_i, dok = k8.project_residuals(fx, fy, cx, cy, s, R, t, *pairs)
    chi2 = c_f + c_i
    hub = torch.where(chi2 > th, 2.0 * torch.sqrt(th * chi2.clamp_min(0.0)) - th, chi2)
    return float((torch.where(dok, hub, 100.0 * th) * valid).sum())


def check_sim3_lm(what, args):
    """Kernel 8 against its twin: inlier masks differ on <= 1% of pairs, only
    within 1% of the chi2 gate, n within 1% (kernel 4's tolerances); then by
    the problem's conditioning (K8_COND_LIMIT, computed for every case): s, R,
    t within 1e-4, or the float64 robust cost rule (K8_COST_MARGIN) for the
    kernel and for the twin run on the card, the latter also held to the
    mask and count rules against the CPU twin.  args as sim3_lm_solve's.
    Returns (max |ds|,|dR|,|dt| against the twin on the card, the case's
    numbers)."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k8

    got = k8.sim3_lm_solve(*args)
    ref = k8.sim3_lm_solve_plain(*args)
    a_cpu = tuple(v.cpu() if torch.is_tensor(v) else v for v in args)
    cpu = k8.sim3_lm_solve_plain(*a_cpu)
    torch.cuda.synchronize()
    x1, x2, uv1, uv2, valid = args[:5]
    is1, is2 = k8.inv_sigma2_or_ones(x1, *args[5:7])
    fx, fy, cx, cy, fix_scale, th = args[10:16]
    gap = lambda p, q: max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(p[:3], q[:3]))

    def masks(a, b):
        """Where the inlier masks of a and b break the rules (empty: none)."""
        _, c_f, c_i, _ = k8.project_residuals(fx, fy, cx, cy, a[0], a[1], a[2], x1, x2, uv1, uv2,
                                              is1, is2)
        near = ((c_f / th - 1.0).abs() < 0.01) | ((c_i / th - 1.0).abs() < 0.01)
        diff = a[3].to(x1.device) != b[3].to(x1.device)
        n_a, n_b = int(a[4]), int(b[4])
        bad = []
        if float(diff.float().mean()) > 0.01 or bool((diff & ~near).any()):
            bad.append(f"masks differ on {float(diff.float().mean()):.4f} "
                       f"({int((diff & ~near).sum())} away from the gate)")
        if abs(n_a - n_b) > math.ceil(0.01 * n_b):
            bad.append(f"n {n_a} vs {n_b}")
        return bad

    err = gap(got, ref)
    cond = k8_conditioning(a_cpu, cpu)
    well = cond * 2.0 ** -24 <= K8_COND_LIMIT
    out = {"N": int(x1.shape[0]), "valid": int(valid.sum()), "fix_scale": bool(fix_scale),
           "s": float(got[0]), "n": [int(got[4]), int(ref[4]), int(cpu[4])],
           "cond_normal_matrix": cond, "cond_x_2^-24": cond * 2.0 ** -24,
           "rule": "s, R, t within 1e-4" if well else "robust cost",
           "kernel_vs_twin_on_card": err, "kernel_vs_twin_on_cpu": gap(got, cpu),
           "twin_card_vs_cpu": gap(ref, cpu), "limit": 1e-4}
    bad = masks(got, ref)
    if well:
        bad += [f"max |ds|,|dR|,|dt| {err:.3g}"] if err > 1e-4 else []
    else:
        c_k, c_t, c_c = k8_cost(a_cpu, got), k8_cost(a_cpu, ref), k8_cost(a_cpu, cpu)
        spread = c_t / c_c - 1.0
        m = max(K8_COST_MARGIN, 2.0 * abs(spread))
        # the cost of residuals at float32's resolution of the pixels (four a pair): the
        # floor under which no float32 LM tells two solutions apart (a problem whose
        # residuals vanish, as exact pixels give, has a cost of that size)
        v = valid.cpu()
        px = max(float(a_cpu[2][v].abs().max()), float(a_cpu[3][v].abs().max())) if bool(v.any()) else 0.0
        w_max = max(float(k8.inv_sigma2_or_ones(a_cpu[0], *a_cpu[5:7])[j][v].max()) for j in (0, 1)) \
            if bool(v.any()) else 0.0
        floor = 4.0 * int(v.sum()) * (2.0 ** -24 * px) ** 2 * w_max
        out.update({"cost_kernel": c_k, "cost_twin_on_card": c_t, "cost_twin_on_cpu": c_c,
                    "cost_kernel_over_cpu_twin": c_k / c_c - 1.0, "twin_spread": spread,
                    "margin": m, "cost_floor": floor})
        for who, c in (("kernel", c_k), ("twin on the card", c_t)):
            if c > c_c * (1.0 + m) + floor:
                bad.append(f"the {who}'s robust cost {c!r} > the CPU twin's {c_c!r} x (1 + {m:.3g}) + "
                           f"{floor:.3g}")
        bad += [f"twin on the card against the CPU twin: {b}" for b in masks(ref, cpu)]
    print(f"sim3_lm_solve vs twin, {what}: {json.dumps(out)}")
    if bad:
        fail(f"sim3_lm_solve ({what}): {bad}")
    return err, out


# kernel 8 on the closure's optimize_sim3 input of phase 6 (the closing attempt's
# second optimize_sim3, captured with the scale-power sites read through
# map_state.scale_power, as the tree now reads them): sim3_lm_solve's arguments,
# saved with torch.save.  Its LM normal matrix is ill-conditioned (cond x 2^-24 ~
# 0.5), so check_sim3_lm holds it by the robust cost
K8_CLOSURE_CASE = os.path.join(ROOT, "tests", "data", "k8_closure_routed.pt")


def k8_closure_case(dev: str = "cuda") -> dict:
    """Kernel 8 on K8_CLOSURE_CASE through check_sim3_lm (held)."""
    import torch

    args = torch.load(K8_CLOSURE_CASE, weights_only=True)
    _, out = check_sim3_lm("the routed closure's input (tests/data/k8_closure_routed.pt)",
                           tuple(v.to(dev) if torch.is_tensor(v) else v for v in args))
    return out


def sim3_hyp_work(samples, valid, n_best):
    """(bytes, operations) of one kernel-7 call: every triple's Horn and its
    count over the valid pairs; the best's rescore over them; the weighted
    Horn's terms over the best's n_best inliers and its one Horn; the refined
    Sim3's rescore."""
    H, N = samples.shape[0], valid.shape[0]
    n_valid = float(valid.sum())
    reproj = 2 * SIM3_OPS_PER_REPROJECTION * n_valid
    return (H * SIM3_HYP_BYTES + N * (SIM3_PAIR_BYTES + 1) + SIM3_RANSAC_OUT_BYTES,
            (H + 1) * SIM3_HORN_OPS + (H + 2) * reproj + SIM3_WEIGHTED_OPS_PER_INLIER * n_best)


def sim3_lm_work(valid, iters):
    """(bytes, operations) of one kernel-8 call."""
    return valid.shape[0] * (SIM3_PAIR_BYTES + 1) + 64, iters * SIM3_LM_OPS_PER_PAIR * float(valid.sum())


def k11_case(seed, E, S, D, live, longest):
    """(index [E], rows [E, D]) on the card from tests/_segment_cases.py: an
    index over S segments with `live` kept rows, one segment of `longest`
    rows, and rows whose sums depend on the order of addition."""
    import numpy as np
    import torch

    cases = runpy.run_path(os.path.join(ROOT, "tests", "_segment_cases.py"))
    idx = cases["shape_case"](seed, E, S, live, longest)
    vals = cases["order_sensitive"](np.random.default_rng(seed), E, D)
    return torch.from_numpy(idx).cuda(), torch.from_numpy(vals).cuda()


def fadd_chain_ns() -> dict:
    """The card's time for one dependent float add: kernel 11's probe
    (csrc/segment_sum.cu fadd_chain_probe, one thread, 2^20 dependent
    __fadd_rn, %globaltimer and clock64), the better of three runs after a
    warm-up.  The chain floor of a segment sum is its longest segment's
    rows times this."""
    import ctypes

    import torch

    from orb_slam2_annotate_tpu_torch.kernels import _build

    probe = _build.load("segment_sum").fadd_chain_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    n, best = 1 << 20, None
    for _ in range(4):
        _build.check_launch(probe(out.data_ptr(), 1.0, n, _build.stream_ptr(out.device)),
                            "fadd_chain_probe")
        ns, cycles, _ = out.tolist()
        if best is None or ns < best[0]:
            best = (ns, cycles)
    return {"ns_per_add": best[0] / n, "cycles_per_add": best[1] / n,
            "clock_ghz": best[1] / best[0]}


def k11_shape(k11, name, idx, S, vals, add_ns) -> dict:
    """Kernel 11 at one call shape: bit for bit its CPU twin, its plan equal
    to the CPU's (key, perm, offsets), two calls equal (fails otherwise);
    timed on the 100-call clock (ms) and in a CUDA-graph replay (graph_us),
    beside the same function's library calls on the rows the plan keeps, as
    the kernel gets them: one index_add (float atomics) and
    torch.segment_reduce on the sorted rows (library_ms the faster on the
    100-call clock; each also replayed, a refused capture recorded), the
    wrapper's and index_add's host time a call (host_ns), the bytes bound
    and the chain floor (the longest segment's dependent adds)."""
    import numpy as np
    import torch

    vals = vals.contiguous()
    E, D = vals.shape[0], vals[0].numel() if vals.shape[0] else math.prod(vals.shape[1:])
    plan = k11.segment_plan(idx, S)
    plan_c = k11.segment_plan(idx.cpu(), S)
    got = k11.segment_sum(plan, vals)
    again = k11.segment_sum(plan, vals)
    want = k11.segment_sum_plain(plan_c, vals.cpu())
    g32, w32 = got.cpu().numpy().view(np.int32), want.numpy().view(np.int32)
    err = float((got.cpu() - want).abs().max()) if got.numel() else 0.0
    live = int(plan.offsets[-1])
    longest = int((plan.offsets[1:] - plan.offsets[:-1]).max()) if S else 0
    row = {"E": E, "S": S, "D": D, "rows_live": live, "longest_segment": longest}
    if hasattr(plan, "G"):                 # (a tree before the tiles: tools/k11_shapes.py --root)
        row.update({"path": "walk" if D <= plan.walk_d else "tiles", "G": plan.G,
                    "tiles": -(-S // plan.G) if S else 0,
                    "stage_rows": k11.stage_rows(max(D, 1), plan.hint)})
    row.update({"bit_for_bit_the_cpu_twin": bool(np.array_equal(g32, w32)), "max_abs_err": err,
                "plan_equals_the_cpu_plan": all(
                    torch.equal(getattr(plan, f).cpu(), getattr(plan_c, f))
                    for f in ("key", "perm", "offsets")),
                "two_calls_equal": bool(torch.equal(got.view(torch.int32),
                                                    again.view(torch.int32)))})
    if not (row["bit_for_bit_the_cpu_twin"] and row["plan_equals_the_cpu_plan"]
            and row["two_calls_equal"]):
        fail(f"segment_sum ({name}) differs from its twin or from itself: {row}")
    if add_ns is None:                     # an edge case: checked, not timed
        return row
    card_twin = [k11.segment_sum_plain(plan, vals) for _ in range(2)]
    row.update({"card_twin_runs_equal": bool(torch.equal(card_twin[0].view(torch.int32),
                                                         card_twin[1].view(torch.int32))),
                "card_twin_max_abs_diff": float((card_twin[0] - got).abs().max()),
                "ms": time_ms(lambda: k11.segment_sum(plan, vals)),
                "graph_us": graph_us(lambda: k11.segment_sum(plan, vals)),
                "plain_ms": time_ms(lambda: k11.segment_sum_plain(plan, vals)),
                "plan_ms": time_ms(lambda: k11.segment_plan(idx, S), reps=20)})
    kept = idx >= 0
    idx_k, vals_k = idx[kept], vals[kept]
    z = torch.zeros((S,) + tuple(vals.shape[1:]), device=vals.device)

    def index_add():
        return z.index_add(0, idx_k, vals_k)

    row["index_add_ms"] = time_ms(index_add)
    row["index_add_graph_us"] = graph_us(index_add)
    srt = vals.reshape(E, D)[plan.perm[:live].long()]
    offs = plan.offsets.long()

    def segment_reduce():
        return torch.segment_reduce(srt, "sum", offsets=offs, axis=0)

    try:
        row["segment_reduce_ms"] = time_ms(segment_reduce)
    except RuntimeError as e:              # a yardstick only: the port never calls it
        row["segment_reduce_ms"], row["segment_reduce_refused"] = None, str(e)[:200]
    if row["segment_reduce_ms"] is not None:
        try:
            row["segment_reduce_graph_us"] = graph_us(segment_reduce)
        except RuntimeError as e:          # a capture that the call refuses
            torch.cuda.synchronize()
            row["segment_reduce_graph_us"] = None
            row["segment_reduce_graph_refused"] = str(e)[:200]
    row["library_ms"] = min(t for t in (row["index_add_ms"], row["segment_reduce_ms"])
                            if t is not None)
    row["library_graph_us"] = min(t for t in (row["index_add_graph_us"],
                                              row.get("segment_reduce_graph_us"))
                                  if t is not None)
    row["host_ns"] = round(host_ns(lambda: k11.segment_sum(plan, vals)), 1)
    row["index_add_host_ns"] = round(host_ns(index_add), 1)
    # the rows the plan keeps are read once (values and index), each output
    # written once with its offset; the chain floor is the longest segment's
    # dependent adds
    row["bound_ms"], row["bound_by"] = bound(live * (4 * D + 4) + S * (4 * D + 4), live * D)
    row["chain_floor_ms"] = 1e-6 * longest * add_ns
    row["target_ms"] = max(row["bound_ms"], row["chain_floor_ms"])
    row["graph_over_target"] = 1e-3 * row["graph_us"] / row["target_ms"]
    row["graph_over_library_graph"] = row["graph_us"] / row["library_graph_us"]
    return row


# kernel 11's edge cases on the card: (E, S, D, live rows, longest segment)
K11_EDGES = {
    "one segment of 5,000 rows": (131072, 16384, 36, 27117, 5000),
    "every row in one segment": (131072, 128, 36, 131072, 131072),
    "S = 1": (27117, 1, 9, 27117, 27117),
    "D = 1": (131072, 16384, 1, 27117, 10),
    "D = 64": (27117, 128, 64, 27117, 461),
    "E = 0": (0, 128, 36, 0, 0),
    "every row dropped": (131072, 16384, 9, 0, 0),
    "B's S with no live row": (131072, 16384 * 128, 18, 0, 0),
}


def segment_sum_checks(cam6, pg_prob, gba_map, anchor) -> dict:
    """Phase 3's check of kernel 11, on the inputs of phase 6's closure and
    phase 15's map (so it runs after phase 6): each call shape of the
    solvers, its rows from the closure's essential graph (the pose graph's g
    and its four H blocks as one sum) and from phase 6's closure map padded
    to K 128 / P 16,384 / N 1,024 (the global BA's Hcc, Hpp, gc and gp, whose
    shape the PCG product's two sums share, and build_normal_eqs' B over the
    P x C pairs), through ``k11_shape`` (bit for bit the CPU twin, whose
    order, serial in ascending row, is the one fixed order: the twin's
    index_add on the card adds by float atomics, whose bits are printed
    beside, not held; the plan equal to the CPU's; two calls equal; times
    beside the library's, the bound and the chain floor); then the edge
    cases of K11_EDGES on order-sensitive rows (and Hcc's rows from a view 4
    bytes off 16, which takes the 4-byte copies), each bit for bit its CPU
    twin and a second call; one call is one device kernel (the headline
    shape and B); the launches of one solve of each solver counted against
    their loops.  Returns the kernels line's entry (headline: the global
    BA's point sum, the PCG product's most launched shape)."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import segment_sum as k11
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.solvers import ba_cg, ba_core
    from orb_slam2_annotate_tpu_torch.solvers import pose_graph as pg_mod

    ein = torch.einsum
    p = pg_prob
    K = p.s.shape[0]
    ei, ej = p.e_i.long(), p.e_j.long()
    w = p.e_weight * p.e_valid
    r, Ji, Jj = pg_mod._residuals_and_jacs(p, p.s, p.R, p.t)
    Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
    # the solvers' indices: an edge of weight 0 (its terms ±0) has -1, which
    # the plans drop
    cases = {"pose graph g": (torch.where(p.e_valid, ei, -1), K, ein("eij,ei->ej", Jiw, r)),
             "pose graph H (four blocks)": (
                 torch.where(p.e_valid.repeat(4),
                             torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]), -1),
                 K * K,
                 torch.cat([ein("eij,eik->ejk", Ja, Jb)
                            for Ja, Jb in ((Jiw, Ji), (Jjw, Jj), (Jiw, Jj), (Jjw, Ji))]))}
    m = pad_map(gba_map, DIST_K, DIST_P, DIST_N)
    prob = loop_mod.full_map_ba_problem(m, anchor)
    C, P = prob.R.shape[0], prob.points.shape[0]
    ci, pi = prob.cam_idx.long(), prob.pt_idx.long()
    rb, Jc, Jp, st, dok = ba_core.edge_residual_jac(cam6, prob)
    wb, _ = ba_cg._edge_weights(prob, rb, st, dok)
    Jcw, Jpw = Jc * wb[:, None, None], Jp * wb[:, None, None]
    ok = prob.edge_valid
    ci, pi, pci = (torch.where(ok, x, -1) for x in (ci, pi, pi * C + ci))
    cases.update({"global BA Hcc": (ci, C, ein("eij,eik->ejk", Jcw, Jc)),
                  "global BA gc": (ci, C, ein("eij,ei->ej", Jcw, rb)),
                  "global BA Hpp": (pi, P, ein("eij,eik->ejk", Jpw, Jp)),
                  "global BA gp and the PCG point sum": (pi, P, ein("eij,ei->ej", Jpw, rb)),
                  "normal equations B": (pci, P * C, ein("eij,eik->ejk", Jcw, Jp))})
    add = fadd_chain_ns()
    print(f"kernel segment_sum, one dependent float add: {json.dumps(add)}")
    shapes = {}
    for name, (idx, S, vals) in cases.items():
        shapes[name] = k11_shape(k11, name, idx, S, vals, add["ns_per_add"])
        print(f"kernel segment_sum, {name}: {json.dumps(shapes[name])}")
    worst = max(v["max_abs_err"] for v in shapes.values())
    edges = {}
    for i, (name, (E, S, D, live, longest)) in enumerate(K11_EDGES.items()):
        idx, vals = k11_case(i, E, S, D, live, longest)
        edges[name] = k11_shape(k11, name, idx, S, vals, None)
    idx, S, vals = cases["global BA Hcc"]
    off = torch.empty(vals.numel() + 1, device=vals.device)[1:].view(vals.shape)
    off.copy_(vals)
    edges["Hcc from a view 4 bytes off 16"] = k11_shape(k11, "Hcc, a view 4 bytes off", idx, S,
                                                        off, None)
    print(f"kernel segment_sum, edge cases (bit for bit the CPU twin, two calls equal): "
          f"{json.dumps(edges)}")
    head = shapes["global BA gp and the PCG point sum"]
    idx, S, vals = cases["global BA gp and the PCG point sum"]
    plan_h, vals_h = k11.segment_plan(idx, S), vals.contiguous()
    idx, S, vals = cases["normal equations B"]
    plan_b, vals_b = k11.segment_plan(idx, S), vals.contiguous()
    kernels_b = device_kernels(lambda: k11.segment_sum(plan_b, vals_b), 1)
    # wrapper calls of one solve of each solver on these inputs
    per_solve = {}
    for name, fn, expected in (
            ("optimize_pose_graph (15 steps)", lambda: pg_mod.optimize_pose_graph(p, 15), 15 * 3),
            ("optimize_pose_graph_cg (15 steps, 60 PCG)",
             lambda: pg_mod.optimize_pose_graph_cg(p, 15, 60), 15 * (4 + 2 * 60)),
            ("bundle_adjust_cg (10 steps, 25 PCG)",
             lambda: ba_cg.bundle_adjust_cg(cam6, prob, 10, 25), 10 * (4 + 1 + 2 * 25 + 1)),
            # the dense LM: the five blocks, the cost, the Schur complement over the
            # co-observing pairs, its right-hand side, B^T dc and the step's cost
            ("bundle_adjust (dense, 10 steps)", lambda: ba_core.bundle_adjust(cam6, prob, 10),
             10 * (5 + 1 + 3 + 1))):
        n0 = k11.segment_sum.launches
        fn()
        per_solve[name] = {"launches": k11.segment_sum.launches - n0, "expected": expected}
    print(f"kernel segment_sum launches a solve: {json.dumps(per_solve)}")
    if any(v["launches"] != v["expected"] for v in per_solve.values()):
        fail(f"segment_sum launches a solve: {per_solve}")
    return {"max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "chain_floor_ms": head["chain_floor_ms"],
            "library_ms": head["library_ms"], "graph_us": head["graph_us"],
            "headline": "global BA gp and the PCG point sum", "shapes": shapes,
            "fadd": add, "edge_cases": list(edges), "launches_per_solve": per_solve,
            "device_launches_per_call_B": kernels_b["device_launches_per_call"],
            **device_kernels(lambda: k11.segment_sum(plan_h, vals_h), 1)}


# kernels 12b and 12c (the dense BA's Cholesky, the distributed BA's LU): the
# factor's n^3 / 6 (Cholesky) or n^3 / 3 (LU) multiply-subtracts and the two
# solves' n^2, two operations each; the matrix (the Cholesky: its lower
# triangle) and rf read once, x written once
def dense_solve_work(n: int, lu: bool):
    return (4.0 * ((n * n if lu else n * (n + 1) / 2) + 2 * n),
            (2 * n ** 3 / 3 if lu else n ** 3 / 3) + 2.0 * n * n)


def phase15_reduced_system(cam6, gba_map, anchor):
    """Phase 15's dense BA's reduced camera system at lambda 1e-5 (n = 6 x
    DIST_K) on phase 6's closure map, on the card."""
    import torch

    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    prob = loop_mod.full_map_ba_problem(pad_map(gba_map, DIST_K, DIST_P, DIST_N), anchor)
    plans, pairs = ba_core.dense_setup(prob)
    blocks = ba_core.build_normal_eqs(cam6, prob, True, plans)
    free = prob.cam_valid & ~prob.cam_fixed
    Sf, rf, _, _ = ba_core.dense_reduced_system(*blocks[:5], torch.tensor(1e-5, device="cuda"),
                                                free, pairs)
    return Sf, rf


# kernels 12b and 12c at other system sizes: phase 3's n / 2 and the
# distributed BA's system at the long run's max_kf 640 (n = 6 x 640)
DENSE_SIZES = (384, 3840)
DENSE_LU_SIZES = (12288,)     # 12c alone: its MAX_N, the panel a cluster of 12 CTAs
DENSE_BIG_REPS = 3            # timed calls at DENSE_LU_SIZES (a solve takes ~0.1 s or more)
DENSE_CPU_TWIN_MAX_N = 1000   # above, the twin runs on the card (a torch loop; same bits)


def dense_random_system(n: int, seed: int, spd: bool):
    """A float32 system made from a seed with numpy: SPD (A A^T / n + 0.5 I)
    or general (a Gaussian matrix + 3 I), with a Gaussian right-hand side."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if spd:
        a = rng.standard_normal((n, n + 8)).astype(np.float32)
        S = (a @ a.T / n + 0.5 * np.eye(n)).astype(np.float32)
    else:
        S = (rng.standard_normal((n, n)) + 3 * np.eye(n)).astype(np.float32)
    return S, rng.standard_normal(n).astype(np.float32)


def dense_library(name: str, S, r):
    """The one PyTorch solve that computes kernel `name`'s function."""
    import torch

    if name == "chol_solve":
        return (lambda: torch.cholesky_solve(r[:, None], torch.linalg.cholesky_ex(S)[0]),
                "torch.linalg.cholesky_ex, then torch.cholesky_solve (two calls)")
    return lambda: torch.linalg.solve_ex(S, r), "torch.linalg.solve_ex"


def dense_solve_checks(Sf, rf, label: str) -> dict:
    """Kernels 12b (``chol_solve``) and 12c (``lu_solve``) against their CPU
    twins, bit for bit (NaN where the twin's is): the system (Sf, rf) (phase
    15's dense BA's reduced system at lambda 1e-5, n = 6 x DIST_K, in the
    full run), its leading 130 and 6 rows (n not a multiple of the 32-column
    panel); for 12b also the system with a negative entry on its diagonal
    (the step refused, all NaN); for 12c also the system less 0.8 x its mean
    diagonal (indefinite: LU still gives a step) and a 70 x 70 system of
    small integers (ties for the pivot).  Two calls equal; the device kernels
    a call, by graph capture; the kernel's and the library's times (100
    calls, CUDA-graph replay).  Then a random SPD (12b) and general (12c)
    system at each of DENSE_SIZES, and for 12c also at DENSE_LU_SIZES (with
    the clusters of its panel's width the card holds at once), bit for bit
    the twin (on the CPU up to DENSE_CPU_TWIN_MAX_N, on the card above),
    both timed beside the library.  Speed fails nothing; bits do.  Returns
    {"chol_solve": ..., "lu_solve": ...}."""
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import chol_solve as k12b
    from orb_slam2_annotate_tpu_torch.kernels import lu_solve as k12c

    n = Sf.shape[0]
    lead = lambda k: (Sf[:k, :k].contiguous(), rf[:k].contiguous())
    neg = Sf.clone()
    neg[40, 40] = -1.0
    rng = np.random.default_rng(12)
    ints = torch.from_numpy(rng.integers(-3, 4, (70, 70)).astype(np.float32)
                            + 4 * np.eye(70, dtype=np.float32)).cuda()
    base = {f"{label} (n {n})": (Sf, rf), "its leading 130 rows": lead(130),
            "its leading 6 rows": lead(6)}
    indefinite = Sf - 0.8 * Sf.diagonal().mean() * torch.eye(n, device="cuda")
    kinds = {"chol_solve": (k12b, {**base, "a negative diagonal entry (refused)": (neg, rf)}),
             "lu_solve": (k12c, {**base, "less 0.8 x its mean diagonal (indefinite)": (indefinite, rf),
                                 "70 x 70 small integers (pivot ties)":
                                     (ints, rf[:70].contiguous())})}

    def compare(solve, plain, S, r, on_card: bool):
        got, again = solve(S, r).cpu(), solve(S, r).cpu()
        want = (plain(S, r) if on_card else plain(S.cpu(), r.cpu())).cpu()
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        fin = ~nan_w
        return {"n": S.shape[0], "nan": int(nan_g.sum()), "twin_on": "card" if on_card else "cpu",
                "bit_for_bit": bool(torch.equal(nan_g, nan_w) and torch.equal(
                    got[fin].view(torch.int32), want[fin].view(torch.int32))),
                "two_calls_equal": bool(torch.equal(got.view(torch.int32), again.view(torch.int32))),
                "max_abs_err": float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0}

    def times(name, solve, S, r, reps=(100, 50)):
        lib_fn, lib_name = dense_library(name, S, r)
        return {"ms": time_ms(lambda: solve(S, r), reps[0]),
                "graph_us": graph_us(lambda: solve(S, r), reps[1]),
                "library_ms": time_ms(lib_fn, reps[0]), "library_graph_us": graph_us(lib_fn, reps[1]),
                "library": lib_name}

    out = {}
    for name, (mod, cases) in kinds.items():
        solve, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        rows = {case: compare(solve, plain, S, r, False) for case, (S, r) in cases.items()}
        worst = max(v["max_abs_err"] for v in rows.values())
        print(f"kernel {name} against its CPU twin: {json.dumps(rows)}")
        if not all(v["bit_for_bit"] and v["two_calls_equal"] for v in rows.values()):
            fail(f"{name} differs from its CPU twin or from itself: {rows}")
        b_ms, b_by = bound(*dense_solve_work(n, name == "lu_solve"))
        t = times(name, solve, Sf, rf)
        out[name] = {"max_abs_err": worst, "ms": t["ms"],
                     "plain_ms": time_ms(lambda: plain(Sf, rf), 2), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t["library_ms"], "library": t["library"],
                     "graph_us": t["graph_us"], "library_graph_us": t["library_graph_us"], "n": n,
                     "cases": rows, **device_kernels(lambda: solve(Sf, rf), mod.launches_per_solve(n))}
        print(f"kernel {name} at n {n}: "
              f"{json.dumps({k: v for k, v in out[name].items() if k != 'cases'})}")
        sizes = {}
        for n2 in DENSE_SIZES + (DENSE_LU_SIZES if name == "lu_solve" else ()):
            S2, r2 = (torch.from_numpy(a).cuda()
                      for a in dense_random_system(n2, 20 + n2, name == "chol_solve"))
            row = compare(solve, plain, S2, r2, n2 > DENSE_CPU_TWIN_MAX_N)
            big = n2 in DENSE_LU_SIZES
            row.update(times(name, solve, S2, r2, (DENSE_BIG_REPS,) * 2 if big else (100, 50)))
            row["bound_ms"] = bound(*dense_solve_work(n2, name == "lu_solve"))[0]
            if name == "lu_solve":
                row["max_active_clusters"] = k12c.max_clusters(n2)
            sizes[n2] = row
            print(f"kernel {name} on a random {'SPD' if name == 'chol_solve' else 'general'} "
                  f"system at n {n2}: {json.dumps(row)}")
            if not (row["bit_for_bit"] and row["two_calls_equal"] and row["nan"] == 0):
                fail(f"{name} at n {n2} differs from its twin or from itself, or gave NaN: {row}")
            del S2, r2
        out[name]["sizes"] = sizes
    if not all(v["nan"] == 0 for k, v in out["lu_solve"]["cases"].items()):
        fail(f"lu_solve gave NaN: {out['lu_solve']['cases']}")
    if out["chol_solve"]["cases"]["a negative diagonal entry (refused)"]["nan"] != n:
        fail(f"chol_solve took a step on a system that is not positive definite: "
             f"{out['chol_solve']}")
    return out


def scale_power_sites(k):
    """Each site that reads map_state.scale_power, through the helper it calls,
    at the bases it uses, for the octaves `k` (int32, any device): {site:
    value}."""
    import torch

    from orb_slam2_annotate_tpu_torch.pipeline import tracking
    from orb_slam2_annotate_tpu_torch.worldmap import map_state as ms

    sp, rad = ms.scale_power, ms.scaled_radius
    r0 = torch.where(k % 2 == 0, 2.5, 4.0)
    max_dist = torch.linspace(0.5, 40.0, k.shape[0], device=k.device)
    return {
        "tracking.inv_sigma2 (pose LM; local BA's and the keyframe chain's inv_sigma2)":
            tracking.inv_sigma2(k),
        "tracking.track_with_motion_model radius (th 15, 30)":
            torch.stack([rad(th, k, tracking.SCALE) for th in (15.0, 30.0)]),
        "tracking.track_local_map radius (th 1, 3; r0 2.5 / 4)":
            torch.stack([rad(th * r0, k, tracking.SCALE) for th in (1.0, 3.0)]),
        "loop_closing.sim3_guided_match radius (radius_scale 1, 1.5, 3)":
            torch.stack([rad(rs * 7.5, k) for rs in (1.0, 1.5, 3.0)]),
        "loop_closing.loop_projection_count radius": rad(20.0, k),
        "loop_closing.full_map_ba_problem inv_sigma2": ms.inv_level_sigma2(k),
        "local_mapping.create_new_mappoints gate sigma^2": sp(k, 1.2, twice=True),
        "local_mapping.create_new_mappoints scale ratio (every octave pair)":
            sp(k[:, None], 1.2) / sp(k[None, :], 1.2),
        "map_state depth band scale": sp(k),
        "map_state depth band min_dist (n_levels - 1 = k)": max_dist / sp(k),
    }


def scale_power_check() -> dict:
    """Phase 3's held check of the scale powers: every site reading
    map_state.scale_power (scale_power_sites) for octaves 0..63 on the card
    and on the CPU, bit for bit; fails on any differing bit.  Also lists the
    octaves at which the card's own float32 ``1.2 ** k`` and ``1.2 ** (2 k)``
    (torch.pow, the sites' expressions before they read the table) part from
    the CPU's bits, which the table keeps off the card's path."""
    import torch

    from orb_slam2_annotate_tpu_torch.worldmap import map_state

    k = torch.arange(64, dtype=torch.int32)
    card, cpu = scale_power_sites(k.cuda()), scale_power_sites(k)
    bad = [name for name in cpu if not torch.equal(card[name].cpu().view(torch.int32),
                                                   cpu[name].view(torch.int32))]
    kf = k.cuda().to(torch.float32)
    pow_diff = {}
    for name, got, twice in (("1.2 ** k", 1.2 ** kf, False), ("1.2 ** (2 k)", 1.2 ** (2.0 * kf), True)):
        want = map_state.scale_power(k, 1.2, twice).cuda()
        pow_diff[name] = [int(i) for i in torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
                          .flatten()]
    out = {"sites": list(cpu), "sites_differing": bad, "card_pow_differs_at": pow_diff}
    print(f"scale powers, octaves 0..63, card against CPU at every site: {json.dumps(out)}")
    if bad:
        fail(f"scale powers: the card's bits differ from the CPU's at {bad}")
    return out


def k12bc_alone():
    """``python3 chip_smoke.py --k12bc``: phase 3's checks of kernels 12b and
    12c alone (only they and kernel 8 are built), on a random SPD system at
    phase 15's n (768) in place of its reduced system: the quick run for
    work on them.  First phase 3's held checks of the scale-power sites and
    of kernel 8 on the routed closure's input."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0].strip())
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import orb_slam2_annotate_tpu_torch  # noqa: F401  (sets TF32 off)
    from orb_slam2_annotate_tpu_torch.kernels import _build

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.load, ("chol_solve", "lu_solve", "sim3")))
    print(f"build: {json.dumps(_build.BUILD_SECONDS)}")
    scale_power_check()
    k8_closure_case()
    Sf, rf = (torch.from_numpy(a).cuda() for a in dense_random_system(6 * DIST_K, 15, True))
    out = dense_solve_checks(Sf, rf, "a random SPD system")
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk not in ("cases", "sizes")}
                      for k, v in out.items()}) + f", card {smi[0].strip()}")


# kernel 12 (local BA's grid LM): operations per unit of work, counted from
# the function (ba_core.bundle_adjust_grid_plain), not from the kernel's
# schedule.  A slot's linearization: projection (15), residual rows and the
# Jacobian rows (~60), the weight (~10), its 3 rows' 21 + 6 Hcc / gc
# products and sums (162); an inverse-index observation's Hpp / gp (54) and
# B (108) products and sums; a point's three damped 3x3 inverses (3 x 40);
# per ladder value: B H^-1 of a (point, free camera) pair (90), an S block of
# a pair of free cameras both seeing the point (6 x 6 x 6 = 216), the
# right-hand side (36); the Cholesky of the system of the free cameras
# (n = 6 x free: n^3 / 3; the fixed cameras' identity rows need none) and its
# two solves (2 n^2); a point's step (a free observer's 36, then 15); a
# slot's try cost (~40, over edge_valid as the twin's grid_cost); the final
# mask (~40 a slot).  The slot terms count the valid slots (base_valid) only
GBA_OPS_SLOT, GBA_OPS_OBS, GBA_OPS_POINT = 250, 162, 120
GBA_OPS_BH, GBA_OPS_PAIR, GBA_OPS_RHS, GBA_OPS_DP = 90, 216, 36, 36
GBA_OPS_COST = 40
GBA_BYTES_SLOT = 21       # pt_loc, uv, ur, inv_sigma2 (f32 / int32), edge_valid in; 1 B of mask out
# kernel 12 against its twin on the card (phase 3): one linearization within
# GBA_TOL_LIN of each output's largest sum of absolute terms (the scale of a
# float32 sum's rounding: a gradient near a minimum cancels to near 0, where
# the twin's own CPU and card runs part by ~3e-3 of its largest entry); S and dc
# at one lambda against the twin's from the kernel's linearization (so each
# stage is held alone: from its own, a near-singular damped point block, as a
# negative damping leaves, turns the linearization's rounding into S's), S
# within GBA_TOL_SOLVE and dc within the larger of GBA_TOL_SOLVE and 10 x the
# system's condition number x 2^-24, its backward error within GBA_TOL_LIN;
# whole solves: poses within GBA_TOL_POSE, points within
# GBA_TOL_POINT of their distance to camera 0's centre (the tolerances
# tests/test_torch_pipeline.py holds the twin to against JAX), inlier masks
# apart on at most 1% of the valid slots, each within 1% of its chi2 gate
GBA_TOL_LIN, GBA_TOL_SOLVE, GBA_TOL_POSE, GBA_TOL_POINT = 1e-5, 1e-4, 1e-3, 1e-2
GBA_CASE_SIZE = (32, 1024, 2048)     # C, N, P_BA of local_mapping.local_bundle_adjustment


def grid_ba_cases():
    """tests/_grid_ba_cases.py as a module namespace."""
    return runpy.run_path(os.path.join(ROOT, "tests", "_grid_ba_cases.py"))


def grid_on(p: dict, dev):
    """A numpy grid problem (tests/_grid_ba_cases.py) as a GridBA on `dev`."""
    import torch

    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    return ba_core.GridBA(**{k: torch.from_numpy(v).to(dev) for k, v in p.items()})


def grid_clone(g, dev=None):
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    return ba_core.GridBA(**{k: getattr(g, k).clone().to(dev or getattr(g, k).device)
                             for k in ("R", "t", "points", "cam_fixed", "cam_valid", "pt_valid",
                                       "pt_loc", "uv", "ur", "inv_sigma2", "edge_valid")})


def grid_ba_work(g, iters: int):
    """(bytes, operations) of one solve of this problem: inputs read once,
    outputs written once; the operations this data needs (GBA_OPS_*)."""
    import torch

    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    C, N = g.pt_loc.shape
    P = g.points.shape[0]
    base_valid, selT = ba_core.grid_inverse_index(g)
    slots, tried = float(base_valid.sum()), float(g.edge_valid.sum())
    seen = (selT % (N + 1)) != N                                   # [C, P]
    free = g.cam_valid & ~g.cam_fixed
    obs, k_free = float(seen.sum()), (seen & free[:, None]).sum(0).double()
    pairs = float((k_free * (k_free + 1) / 2).sum())
    n = 6 * float(free.sum())
    per_try = (GBA_OPS_BH * float(k_free.sum()) + GBA_OPS_PAIR * pairs
               + GBA_OPS_RHS * float(k_free.sum()) + n ** 3 / 3 + 2 * n * n + GBA_OPS_DP * float(k_free.sum()) + 15 * P
               + GBA_OPS_COST * tried)
    per_iter = GBA_OPS_SLOT * slots + GBA_OPS_OBS * obs + GBA_OPS_POINT * P + 3 * per_try
    nbytes = GBA_BYTES_SLOT * C * N + 2 * (48 * C + 12 * P) + 2 * C + P + 4
    return nbytes, iters * per_iter + GBA_OPS_COST * slots


def grid_abs_sums(cam, g, robust: bool):
    """The first linearization's sums of absolute terms: Hcc, Hpp, B, gc, gp
    as ``ba_core.grid_linearize`` forms them from |sqrt(w) J| and |sqrt(w) r|:
    the scale of each sum's float32 rounding (a gradient near a minimum is a
    sum of large terms that cancel)."""
    import torch

    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    C, N = g.pt_loc.shape
    bv, selT = ba_core.grid_inverse_index(g)
    r, Jc, Jp, _, depth_ok = ba_core.grid_residual_jac(cam, g.R, g.t, g.points, g)
    chi2 = torch.sum(r * r, dim=0) * g.inv_sigma2
    delta2 = ba_core._delta2(g.ur)
    w_h = torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)) if robust else torch.ones_like(chi2)
    w_h = torch.where(chi2 > delta2, w_h, torch.ones_like(chi2))
    sw = torch.sqrt(g.inv_sigma2 * w_h * (bv & depth_ok).to(chi2.dtype))[None, None]
    Jc = torch.where(g.cam_fixed[None, None, :, None], torch.zeros_like(Jc), Jc)
    Jcw, Jpw, rw = (Jc * sw).abs(), (Jp * sw).abs(), (r * sw[0]).abs()

    def take(a):
        ap = torch.nn.functional.pad(a, (0, 1))
        return ap.reshape(a.shape[:-2] + (-1,))[..., selT]

    Jp_pc, Jc_pc, r_pc = take(Jpw), take(Jcw), take(rw)
    return (torch.einsum("ricn,rjcn->cij", Jcw, Jcw), torch.einsum("rjcp,rkcp->jkp", Jp_pc, Jp_pc),
            torch.einsum("ricp,rkcp->ikcp", Jc_pc, Jp_pc), torch.einsum("ricn,rcn->ci", Jcw, rw),
            torch.einsum("rjcp,rcp->jp", Jp_pc, r_pc))


def grid_ba_check(what: str, cam, g, iters: int, robust: bool = True, lam0: float = 1e-5,
                  ladder: tuple = (1.0, 8.0, 64.0)) -> dict:
    """Kernel 12 against its twin on the card on one problem: the first
    linearization (Hcc, gc, Hpp, gp, B, the cost, the cameras a point has),
    S and dc at the first ladder value (from a 1-iteration call's workspace),
    then the whole `iters`-iteration solve, two calls bit for bit, and the
    twin's own spread (the same solve on the CPU) beside it.  Returns the
    errors, and under "breaches" what exceeds the GBA_TOL_* tolerances
    (grid_ba_require fails on them)."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    dev = g.points.device
    C, N = g.pt_loc.shape
    P = g.points.shape[0]
    free = g.cam_valid & ~g.cam_fixed
    work = torch.empty(k12.work_bytes(C, P), dtype=torch.uint8, device=dev)
    k12.grid_ba_solve(cam, g, 1, robust, lam0, ladder, work=work)
    torch.cuda.synchronize()
    v = k12.work_views(work, C, P)
    bv, selT = ba_core.grid_inverse_index(g)
    Hcc, Hpp, B, gc, gp, cost = ba_core.grid_linearize(cam, g, g.R, g.t, g.points, robust, bv, selT)
    seen = (selT % (N + 1)) != N
    bits = ((v["mask"][None, :] >> torch.arange(C, device=dev, dtype=torch.int32)[:, None]) & 1) == 1
    if not torch.equal(bits, seen):
        fail(f"grid_ba ({what}): the points' camera masks differ from the twin's inverse index "
             f"({int((bits != seen).sum())} (camera, point) pairs)")
    iu = torch.triu_indices(6, 6, device=dev)
    Hk = torch.zeros(C, 6, 6, device=dev)
    Hk[:, iu[0], iu[1]] = v["Hcc"]
    Hk[:, iu[1], iu[0]] = v["Hcc"]
    i3 = torch.triu_indices(3, 3, device=dev)
    Hppk = torch.zeros(3, 3, P, device=dev)
    Hppk[i3[0], i3[1]] = v["Hpp"]
    Hppk[i3[1], i3[0]] = v["Hpp"]
    Bk = torch.where(seen[None, None], v["B"].reshape(C, 6, 3, P).permute(1, 2, 0, 3), 0.0)
    rel = lambda a, b, scale=None: float((a - b).abs().max() / (b if scale is None else scale)
                                         .abs().max().clamp_min(1e-30))
    Ha, Hpa, Ba, gca, gpa = grid_abs_sums(cam, g, robust)
    lin = {"Hcc": rel(Hk, Hcc, Ha), "gc": rel(v["gc"], gc, gca), "Hpp": rel(Hppk, Hpp, Hpa),
           "gp": rel(v["gp"], gp, gpa), "B": rel(Bk, B, Ba), "cost": rel(v["cost_lin"].sum(), cost)}
    lin_of_own_max = {"gc": rel(v["gc"], gc), "gp": rel(v["gp"], gp)}
    # the twin's own spread: the same linearization on the CPU
    gh = grid_clone(g, "cpu")
    lin_cpu = ba_core.grid_linearize(cam, gh, gh.R, gh.t, gh.points, robust,
                                     *ba_core.grid_inverse_index(gh))
    lin_spread = {k: rel(a.to(dev), b) for k, a, b in zip(("Hcc", "Hpp", "B", "gc", "gp", "cost"),
                                                         lin_cpu, (Hcc, Hpp, B, gc, gp, cost))}
    # the reduced system and step of the first ladder value: the twin's from the kernel's
    # linearization (held: the Schur blocks and the solve alone), and from its own (printed)
    lams = torch.tensor(lam0, device=dev) * torch.tensor(ladder, device=dev)
    pair = free[:, None] & free[None, :] & torch.ones(C, C, dtype=torch.bool, device=dev).tril()
    blocks = torch.where(pair[:, :, None], v["S"][0].reshape(C, C, 36), 0.0)
    Sk = blocks.reshape(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    low = (pair[:, :, None, None].expand(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
           & torch.ones(6 * C, 6 * C, dtype=torch.bool, device=dev).tril())
    dc_k = v["dc"][0].reshape(C, 6)

    def step(lin5):
        Sf, rf, _ = ba_core.schur_system_planes(*lin5, lams[0], free)
        return Sf, torch.where(free[:, None], ba_core._cholesky_solve(Sf, rf, C), 0.0)

    def against(Sf, dc):
        nan_k, nan_t = torch.isnan(dc_k), torch.isnan(dc)
        fin = ~nan_t
        return {"S": rel(Sk[low], Sf[low]), "dc": rel(dc_k[fin], dc[fin]) if bool(fin.any()) else 0.0,
                "dc_nan_equal": bool(torch.equal(nan_k, nan_t))}

    Sf_k, dc_tk = step((Hk, Hppk, Bk, v["gc"], v["gp"]))
    sol = {**against(Sf_k, dc_tk), "refused_tries": [int(x) for x in v["fail"].tolist()]}
    # the kernel's step on the system the twin forms from its linearization: its
    # backward error (relative residual, float64) and the system's condition number
    rf_k = ba_core.schur_system_planes(Hk, Hppk, Bk, v["gc"], v["gp"], lams[0], free)[1].double()
    if not bool(torch.isnan(dc_k).any()):
        S64, x64 = Sf_k.double(), dc_k.reshape(-1).double()
        sol["backward_error"] = float((S64 @ x64 - rf_k).abs().max()
                                      / (S64.abs().sum(1).max() * x64.abs().max() + rf_k.abs().max()))
        f6 = free.repeat_interleave(6)        # the free cameras' block (the rest: identity rows)
        ev = torch.linalg.eigvalsh(S64[f6][:, f6]) if bool(f6.any()) else torch.ones(1)
        sol["condition"] = float(ev.abs().max() / ev.abs().min().clamp_min(1e-300))
    sol_own = against(*step((Hcc, Hpp, B, gc, gp)))
    # the whole solve, twice, beside the twin on the card and on the CPU
    got = k12.grid_ba_solve(cam, g, iters, robust, lam0, ladder)
    again = k12.grid_ba_solve(cam, g, iters, robust, lam0, ladder)
    ref = ba_core.bundle_adjust_grid_plain(cam, g, iters, robust, lam0, ladder)
    cpu = ba_core.bundle_adjust_grid_plain(cam, grid_clone(g, "cpu"), iters, robust, lam0, ladder)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"grid_ba ({what}): two calls differ")

    def solve_err(a, b):
        centre = -b[0][0].T @ b[1][0]
        dist = (b[2] - centre).norm(dim=1)
        ok = torch.isfinite(b[2]).all(1)
        return {"R": float((a[0] - b[0]).abs().max()), "t": float((a[1] - b[1]).abs().max()),
                "X_over_dist": float(((a[2] - b[2]).norm(dim=1)[ok] / dist[ok]).max()),
                "cost_rel": abs(float(a[4]) - float(b[4])) / max(abs(float(b[4])), 1e-30),
                "masks_differ": int((a[3] != b[3]).sum())}

    whole = solve_err(got, ref)
    spread = solve_err([x.to(dev) for x in cpu], ref)
    base = g.edge_valid & (g.pt_loc >= 0)
    diff = got[3] != ref[3]
    _, chi2, delta2, _ = ba_core.grid_cost(cam, got[0], got[1], got[2], g, chi2_out=True)
    near = ((chi2 / delta2) - 1.0).abs() < 0.01
    out = {"C": C, "N": N, "P": P, "iters": iters, "valid_slots": int(base.sum()),
           "linearization": lin, "linearization_of_own_max": lin_of_own_max, "solve": sol,
           "whole": whole,
           "solve_from_the_twins_linearization": sol_own,
           "twin_cpu_vs_card": {"linearization": lin_spread, "whole": spread}}
    print(f"grid_ba vs twin, {what}: {json.dumps(out)}")
    bad = [k for k, e in lin.items() if e > GBA_TOL_LIN]
    # dc: within GBA_TOL_SOLVE, or within what float32 allows the system (its condition
    # number x 2^-24, x 10) with a backward error below GBA_TOL_LIN
    dc_tol = max(GBA_TOL_SOLVE, 10 * sol.get("condition", 0.0) * 2.0 ** -24)
    bad += ["S"] if sol["S"] > GBA_TOL_SOLVE else []
    bad += ["dc"] if sol["dc"] > dc_tol or sol.get("backward_error", 0.0) > GBA_TOL_LIN else []
    if not sol["dc_nan_equal"]:
        bad.append("the step's NaN pattern")
    bad += [k for k, tol in (("R", GBA_TOL_POSE), ("t", GBA_TOL_POSE), ("X_over_dist", GBA_TOL_POINT))
            if whole[k] > tol]
    if int(diff.sum()) > 0.01 * int(base.sum()) or bool((diff & ~near).any()):
        bad.append(f"inlier masks ({int(diff.sum())} apart, {int((diff & ~near).sum())} away "
                   f"from the gate)")
    out["breaches"] = bad
    return out


def grid_ba_require(outs: dict):
    """Fail unless every grid_ba_check in `outs` held its tolerances."""
    bad = {k: o["breaches"] for k, o in outs.items() if o["breaches"]}
    if bad:
        fail(f"grid_ba differs from its twin beyond the tolerances: {bad}")


def grid_ba_synthetic(dev, seed: int = 12) -> dict:
    """Phase 3's synthetic kernel-12 cases (tests/_grid_ba_cases.py) at full
    width, each through grid_ba_check; returns {case: its errors}."""
    import torch

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

    cases = grid_ba_cases()
    cam = CameraModel.create(**cases["CAM"])
    out = {}
    for name, (p, iters, robust, lam0, ladder) in cases["problem_cases"](*GBA_CASE_SIZE, seed).items():
        g = grid_on(p, dev)
        out[name] = grid_ba_check(name, cam, g, iters, robust, lam0, ladder)
        if name.startswith("not positive definite (every"):
            R, t, X, _, _ = k12.grid_ba_solve(cam, g, iters, robust, lam0, ladder)
            if not (torch.equal(R, g.R) and torch.equal(t, g.t) and torch.equal(X, g.points)):
                fail("grid_ba: a solve whose every try is refused moved the state")
    # fewer cameras than the slice's 32 (half of them free), the seeds of
    # tools/k12_stages.py --against
    for C, seed in ((5, 13), (11, 14), (16, 15)):
        name = f"synthetic C {C}, N {GBA_CASE_SIZE[1]}, P {GBA_CASE_SIZE[2]}"
        g = grid_on(cases["grid_problem"](seed, C, *GBA_CASE_SIZE[1:]), dev)
        out[name] = grid_ba_check(name, cam, g, 4)
    grid_ba_require(out)
    return out


def grid_ba_times(cam, g, iters: int) -> dict:
    """A whole solve on the 100-call clock and in a CUDA-graph replay, the
    twin's beside it (10 calls), its device kernels in a capture, its bound."""
    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    fn = lambda: k12.grid_ba_solve(cam, g, iters)
    nb, ops = grid_ba_work(g, iters)
    b_ms, b_by = bound(nb, ops)
    return {"ms": time_ms(fn), "graph_us": graph_us(fn),
            "plain_ms": time_ms(lambda: ba_core.bundle_adjust_grid_plain(cam, g, iters), 10),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "ops": ops,
            **device_kernels(fn, k12.launches_per_solve(iters))}


def ate_of(slam, gt, seq):
    """Sim3-aligned ATE over the tracked frames; gt[seq[k]] is frame k's pose."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.io import evaluation

    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    if len(ids) < 3:
        fail(f"only {len(ids)} tracked frames")
    est_c = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt_c = np.stack([-gt[seq[k]][0].T @ gt[seq[k]][1] for k in ids])
    return evaluation.ate_rmse(est_c.astype(np.float64), gt_c.astype(np.float64),
                               with_scale=True)[0], len(ids)


def free_phases(ctx):
    """Phases 11-13, the free runner (pipeline/device_loop.FreeRunner), on
    what phases 1-10 set up (`ctx`: the card's line, the slice's frames,
    depths and poses, phase 4's frame times, phase 6's loop cell, phases
    7-8's depth camera, right images, config and rectifier, and the launch
    counters).  Each frame's decisions are read in one small copy each; the
    launches inside each verified loop candidate, each loop stage and each
    relocalization attempt are counted per call.  Returns {"launches": each
    run's launches, "outcomes": each run's outcome}."""
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import assign_words as k5
    from orb_slam2_annotate_tpu_torch.kernels import hamming as k3
    from orb_slam2_annotate_tpu_torch.kernels import pnp_score as k6
    from orb_slam2_annotate_tpu_torch.kernels import pose_lm as k4
    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k7
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.pipeline import tracking
    from orb_slam2_annotate_tpu_torch.solvers import sim3 as sim3_mod

    card, frames, depths, poses, frame_s = ctx.card, ctx.frames, ctx.depths, ctx.poses, ctx.frame_s4
    cam6, gt6, images6, loop_cfg = ctx.cam6, ctx.gt6, ctx.images6, ctx.loop_cfg
    cam_d, rights, depth_config, rect = ctx.cam_d, ctx.rights, ctx.depth_config, ctx.rect
    zero_launches, read_launches = ctx.zero_launches, ctx.read_launches
    import warnings

    from orb_slam2_annotate_tpu_torch import convert
    from orb_slam2_annotate_tpu_torch.pipeline import device_loop as dl

    per_call = {"candidate": [], "loop_stage": [], "reloc": []}
    fix_scales = {"sim3_ransac_solve": [], "sim3_lm_solve": []}

    def launch_deltas(fn, key, wrappers):
        def run(*a, **kw):
            n0 = [w.launches for w in wrappers]
            out = fn(*a, **kw)
            per_call[key].append(tuple(w.launches - n for w, n in zip(wrappers, n0)))
            return out
        return run

    def fix_scale_of(name, fn, pos):
        def run(*a, **kw):
            fix_scales[name].append(bool(a[pos]))
            return fn(*a, **kw)
        return run

    free_saved = (loop_mod._free_sim3, dl.free_loop_stage, tracking.relocalize_candidates,
                  sim3_mod.sim3_ransac_solve, sim3_mod.sim3_lm_solve)
    loop_mod._free_sim3 = launch_deltas(free_saved[0], "candidate", (
        k7.sim3_ransac_solve, k7.sim3_lm_solve, k3.hamming_match))
    dl.free_loop_stage = launch_deltas(free_saved[1], "loop_stage", (k5.assign_words,))
    tracking.relocalize_candidates = launch_deltas(free_saved[2], "reloc", (
        k6.pnp_hypotheses, k4.optimize_pose_batched))
    sim3_mod.sim3_ransac_solve = fix_scale_of("sim3_ransac_solve", free_saved[3], 13)
    sim3_mod.sim3_lm_solve = fix_scale_of("sim3_lm_solve", free_saved[4], 14)

    def synced(fn):
        """fn() under torch's sync debug mode "warn": (its result, how many
        synchronizing calls it made)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, sum("synchroniz" in str(w.message) for w in caught)

    def free_drive(name, runner, feeds, counted):
        """One free-runner run: counters zeroed just before, read after the
        final block(); every feed (a callable: one frame, or one sequence
        call) timed on the host clock and its synchronizing calls counted.
        Fails unless every kernel in `counted` was launched.  Returns
        (feed seconds, syncs per feed, launches, the per-call launch lists)."""
        zero_launches()
        for v in per_call.values():
            v.clear()
        for v in fix_scales.values():
            v.clear()
        runner.block()
        secs, syncs = [], []
        for feed in feeds:
            t = time.perf_counter()
            _, n = synced(feed)
            secs.append(time.perf_counter() - t)
            syncs.append(n)
        t = time.perf_counter()
        runner.block()
        secs[-1] += time.perf_counter() - t
        launches = read_launches()
        calls = {k: list(v) for k, v in per_call.items()}
        print(f"launches in the {name} run: {json.dumps(launches)}")
        idle = [n for n in counted if launches[n] == 0]
        if idle:
            fail(f"{name}: kernels never launched: {idle}")
        return secs, syncs, launches, calls

    def per_call_checks(calls, reloc_polish_max=1):
        """Each verified candidate: kernels 7 and 8 twice, kernel 3 four times;
        each loop stage: kernel 5 once (its BoW row); each relocalization
        attempt: kernel 6 once, kernel 4 at most once (the polish)."""
        return {"each verified loop candidate: 2 x K7, 2 x K8, 4 x K3a":
                    all(c == (2, 2, 4) for c in calls["candidate"]),
                "each loop stage: one K5 launch": all(c == (1,) for c in calls["loop_stage"]),
                "each relocalization attempt: one K6, at most one K4":
                    all(c[0] == 1 and c[1] <= reloc_polish_max for c in calls["reloc"])}

    def free_outcome(out, runner, gt, with_scale=True):
        a, n = free_ate(out, gt, with_scale)
        return {"ate_m": a, "tracked": n, "frames": runner.frame_id + 1,
                "mode": int(runner.state.mode), "keyframes": out["n_keyframes"],
                "map_points": out["n_mappoints"], "loops_closed": out["n_loops_closed"],
                "gba": out["n_gba"], "resets": out["n_resets"],
                "kf_skipped_full": out["n_kf_skipped_full"],
                "loop_edges_dropped": out["n_loop_edges_dropped"],
                "closure_records": out["closure_records"].tolist()}

    try:
        # phase 11: bench.py's mono cell through FreeRunner, per frame then scan mode
        t0 = time.perf_counter()
        cam11, gt11, images11, cfg11 = bench_setup(frames)
        n_pf = FREE_BENCH_ORBIT
        print(f"render: {len(images11) - N_FRAMES} frames in {time.perf_counter() - t0:.1f} s "
              f"(host numpy)")
        runner11 = dl.FreeRunner(cam11, cfg11, max_frames=len(images11), auto_grow=False,
                                 device="cuda")
        t0 = time.perf_counter()
        runner11.warmup()
        runner11.warmup_sequence(FREE_BENCH_BOUNCE)
        warm_s = time.perf_counter() - t0
        kept11 = {}

        def frame_feed(k):
            def feed():
                runner11.track_mono(images11[k], k / 30.0)
                if k == N_FRAMES - 1:
                    kept11["state"] = copy.deepcopy(runner11.state)   # for phase 13
            return feed

        bounce = np.stack(images11[n_pf:])
        feeds = [frame_feed(k) for k in range(n_pf)] + [
            lambda: runner11.track_mono_sequence(bounce, [k / 30.0 for k in range(n_pf, len(images11))],
                                                 chunk=FREE_BENCH_BOUNCE)]
        counted11 = ["fast_nms", "orb_describe", "hamming_match", "distinctive_descriptors",
                     "optimize_pose_batched", "assign_words", "grid_ba_solve"]
        secs11, syncs11, launches11, calls11 = free_drive("free bench", runner11, feeds, counted11)
        out11 = runner11.finish()
        # phase 11's state after frame 47 as it stood (phase 13 tracks on from it)
        kept11["numpy"] = convert.free_state_to_numpy(kept11["state"])
        o11 = free_outcome(out11, runner11, gt11)
        jx = FREE_BENCH_JAX
        bound11 = max(1.5 * jx["ate"], jx["ate"] + 0.01)
        o11.update({
            "ate_bound_m": bound11, "jax": jx, "warmup_s": warm_s,
            "frames_per_s_per_frame": n_pf / sum(secs11[:-1]),
            "frames_per_s_scan": FREE_BENCH_BOUNCE / secs11[-1],
            "frames_per_s_per_frame_first_48": N_FRAMES / sum(secs11[:N_FRAMES]),
            "frame_ms_median": 1e3 * statistics.median(secs11[:-1]),
            "frame_ms_max": 1e3 * max(secs11[:-1]),
            "frame_ms_median_system_phase4": 1e3 * statistics.median(frame_s),
            "syncs_per_frame_median": statistics.median(syncs11[:-1]),
            "syncs_per_frame_max": max(syncs11[:-1]),
            "syncs_per_frame_scan": syncs11[-1] / FREE_BENCH_BOUNCE,
            "verified_candidates": len(calls11["candidate"]),
            "loop_stages": len(calls11["loop_stage"]), "reloc_attempts": len(calls11["reloc"]),
            "launches": launches11})
        print(f"free bench: {json.dumps(o11)}, card {card}")
        checks = {"mode OK": o11["mode"] == dl.MODE_OK,
                  "tracked >= 70%": o11["tracked"] >= 0.7 * len(images11),
                  f"ATE <= {bound11:.5f}": o11["ate_m"] <= bound11,
                  "keyframes within 0.5-1.5 x the JAX run's":
                      0.5 * jx["keyframes"] <= o11["keyframes"] <= 1.5 * jx["keyframes"],
                  "map points within 0.5-1.5 x the JAX run's":
                      0.5 * jx["map_points"] <= o11["map_points"] <= 1.5 * jx["map_points"],
                  "one fast_nms and one orb_describe launch per frame":
                      launches11["fast_nms"] == launches11["orb_describe"] == len(images11),
                  "a loop stage per keyframe after the bootstrap":
                      len(calls11["loop_stage"]) == int(runner11.state.m.n_kf) - 2,
                  **per_call_checks(calls11)}
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"free bench checks failed: {bad}")

        # phase 12: the loop cell through FreeRunner, mono then RGB-D (scale
        # fixed); the stages of a closure timed on the host, the card drained
        # around each
        stage12 = {"loop/sim3 (a candidate)": [], "loop/pose_graph": [], "loop/fuse (seam)": [],
                   "loop/gba (live)": []}

        def staged(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                stage12[name].append(1e3 * (time.perf_counter() - t))
                return out
            return run

        stage_saved = (loop_mod._free_sim3, loop_mod.optimize_pose_graph_cg, loop_mod._seam_fuse,
                       dl.global_ba_cg)
        loop_mod._free_sim3 = staged("loop/sim3 (a candidate)", loop_mod._free_sim3)
        loop_mod.optimize_pose_graph_cg = staged("loop/pose_graph", stage_saved[1])
        loop_mod._seam_fuse = staged("loop/fuse (seam)", stage_saved[2])
        dl.global_ba_cg = staged("loop/gba (live)", stage_saved[3])
        cfg12 = dataclasses.replace(loop_cfg, max_kf=128, max_mp=16384)
        runner12 = dl.FreeRunner(cam6, cfg12, max_frames=LOOP_FRAMES, device="cuda")
        counted12 = counted11 + list(LOOP_ONLY + SOLVE_ONLY)
        feeds = [(lambda k: lambda: runner12.track_mono(images6[k], k / 30.0))(k)
                 for k in range(LOOP_FRAMES)]
        try:
            secs12, syncs12, launches12, calls12 = free_drive("free loop", runner12, feeds, counted12)
        finally:
            (loop_mod._free_sim3, loop_mod.optimize_pose_graph_cg, loop_mod._seam_fuse,
             dl.global_ba_cg) = stage_saved
        out12 = runner12.finish()
        o12 = free_outcome(out12, runner12, gt6)
        bound12 = max(1.5 * FREE_LOOP_JAX["ate"], FREE_LOOP_JAX["ate"] + 0.05)
        rec12 = out12["closure_records"]
        closure_frames = [int(r[0]) for r in rec12]
        o12.update({"ate_bound_m": bound12, "jax": FREE_LOOP_JAX,
                    "frame_ms_median": 1e3 * statistics.median(secs12),
                    "frame_ms_max": 1e3 * max(secs12),
                    "closure_frame_ms": [1e3 * secs12[f] for f in closure_frames],
                    "stage_ms": {k: {"calls": len(v), "total": sum(v),
                                     "median": statistics.median(v) if v else None}
                                 for k, v in stage12.items()},
                    "syncs_per_frame_median": statistics.median(syncs12),
                    "verified_candidates": len(calls12["candidate"]),
                    "loop_stages": len(calls12["loop_stage"]), "launches": launches12})
        print(f"free loop: {json.dumps(o12)}, card {card}")
        checks = {"a live closure": o12["loops_closed"] >= 1,
                  "a live global BA per closure": o12["gba"] == o12["loops_closed"],
                  "closure record: entry matches >= 15, pair inliers >= 6, live GBA flag":
                      len(rec12) > 0 and rec12[0, 3] >= 15 and rec12[0, 6] >= 6
                      and rec12[0, 10] == 1.0,
                  "no loop edge dropped": o12["loop_edges_dropped"] == 0,
                  "tracked >= 70%": o12["tracked"] >= 0.7 * LOOP_FRAMES,
                  f"ATE <= {bound12:.5f}": o12["ate_m"] <= bound12,
                  "scale free in every Sim3 launch": not any(fix_scales["sim3_ransac_solve"])
                                                     and not any(fix_scales["sim3_lm_solve"]),
                  **per_call_checks(calls12)}
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"free loop checks failed: {bad}")
        # the mono loop again in a second runner: its rings and map bit for bit
        runner12r = dl.FreeRunner(cam6, cfg12, max_frames=LOOP_FRAMES, device="cuda")
        feeds = [(lambda k: lambda: runner12r.track_mono(images6[k], k / 30.0))(k)
                 for k in range(LOOP_FRAMES)]
        secs12r, _, launches12r, _ = free_drive("free loop repeat", runner12r, feeds, counted12)
        runner12r.finish()

        def state_bits(st):
            flat = {}
            for k, v in convert.free_state_to_numpy(st).items():
                for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
                    v2 = np.asarray(v2)
                    flat[k if k2 is None else f"{k}.{k2}"] = (
                        v2.view(np.int32) if v2.dtype == np.float32 else v2)
            return flat

        a12, b12 = state_bits(runner12.state), state_bits(runner12r.state)
        o12r = {"state_fields_not_equal": [k for k in a12 if not np.array_equal(a12[k], b12[k])],
                "loops_closed": int(runner12r.state.n_loops),
                "frames_per_s": LOOP_FRAMES / sum(secs12r)}
        o12["repeat"] = o12r
        print(f"free loop repeat, a second runner: {json.dumps(o12r)}, card {card}")
        if o12r["state_fields_not_equal"]:
            fail(f"phase 12's mono loop is not bit for bit on a second run: {o12r}")

        from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam

        cam12d = TCam.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                             bf=LOOP_DEPTH_BF)
        depths12 = ctx.depths6           # rendered with phase 6's frames (no bf is read)
        runner12d = dl.FreeRunner(cam12d, dataclasses.replace(cfg12, sensor="rgbd", th_depth=100.0),
                                  max_frames=LOOP_FRAMES, device="cuda")
        feeds = [(lambda k: lambda: runner12d.track_rgbd(images6[k], depths12[k], k / 30.0))(k)
                 for k in range(LOOP_FRAMES)]
        jd = FREE_LOOP_RGBD_JAX
        secs12d, syncs12d, launches12d, calls12d = free_drive(
            "free loop rgbd", runner12d, feeds,
            counted11 + (list(LOOP_ONLY + SOLVE_ONLY) if jd["loops"] else []))
        out12d = runner12d.finish()
        o12d = free_outcome(out12d, runner12d, gt6, with_scale=False)
        worst = max(FREE_LOOP_RGBD_JAX_SEEDS)
        bound12d = max(1.5 * worst, worst + 0.05)
        o12d.update({"ate_se3_bound_m": bound12d, "jax": jd,
                     "jax_ate_se3_over_seeds_0_9": FREE_LOOP_RGBD_JAX_SEEDS,
                     "frame_ms_median": 1e3 * statistics.median(secs12d),
                     "closure_frame_ms": [1e3 * secs12d[int(r[0])] for r in out12d["closure_records"]],
                     "syncs_per_frame_median": statistics.median(syncs12d),
                     "verified_candidates": len(calls12d["candidate"]),
                     "fix_scale_launches": {k: [sum(v), len(v)] for k, v in fix_scales.items()},
                     "launches": launches12d})
        print(f"free loop rgbd: {json.dumps(o12d)}, card {card}")
        checks = {"tracked >= 70%": o12d["tracked"] >= 0.7 * LOOP_FRAMES,
                  f"SE3 ATE <= {bound12d:.5f} (the JAX runner's worst seed {worst:.5f})":
                      o12d["ate_m"] <= bound12d,
                  "every Sim3 launch with the scale fixed":
                      all(fix_scales["sim3_ransac_solve"]) and all(fix_scales["sim3_lm_solve"]),
                  **per_call_checks(calls12d)}
        if jd["loops"]:
            checks.update({"a live closure, as the JAX runner's": o12d["loops_closed"] >= 1,
                           "kernels 7 and 8 launched with the scale fixed":
                               len(fix_scales["sim3_ransac_solve"]) > 0
                               and len(fix_scales["sim3_lm_solve"]) > 0,
                           "a live global BA per closure": o12d["gba"] == o12d["loops_closed"]})
        else:
            print("free loop rgbd: the JAX FreeRunner closes no loop on this cell; tracking and "
                  "ATE held only")
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"free loop rgbd checks failed: {bad}")

        # phase 13: the depth cell through FreeRunner, RGB-D and stereo (the
        # pairs through phase 8's identity rectifier)
        def free_depth(name, sensor, feed_of, ate_jax, counted):
            runner = dl.FreeRunner(cam_d, depth_config(sensor), max_frames=N_FRAMES, device="cuda")
            feeds = [(lambda k: lambda: feed_of(runner, k))(k) for k in range(N_FRAMES)]
            secs, syncs, launches, calls = free_drive(name, runner, feeds, counted)
            out = free_outcome(runner.finish(), runner, poses, with_scale=False)
            traj = runner.finish()["trajectory"]
            est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in traj if T is not None])
            g = np.stack([-poses[k][0].T @ poses[k][1] for k, T in traj if T is not None])
            path = lambda c: float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
            bound_d = max(1.5 * ate_jax, ate_jax + 0.01)
            out.update({"ate_se3_bound_m": bound_d, "ate_se3_jax_m": ate_jax,
                        "displacement_ratio": float(np.linalg.norm(est[-1] - est[0])
                                                    / np.linalg.norm(g[-1] - g[0])),
                        "path_ratio": path(est) / path(g),
                        "frame_ms_median": 1e3 * statistics.median(secs),
                        "syncs_per_frame_median": statistics.median(syncs), "launches": launches})
            print(f"{name}: {json.dumps(out)}, card {card}")
            checks = {"mode OK": out["mode"] == dl.MODE_OK,
                      "tracked >= 80%": out["tracked"] >= 0.8 * N_FRAMES,
                      "keyframes >= 3": out["keyframes"] >= 3, "map points > 200": out["map_points"] > 200,
                      f"SE3 ATE <= {bound_d:.5f}": out["ate_m"] <= bound_d, **per_call_checks(calls)}
            return out, launches, checks, runner

        counted13 = counted11
        o13r, launches13r, checks, runner13r = free_depth(
            "free rgbd", "rgbd", lambda r, k: r.track_rgbd(frames[k], depths[k], k / 30.0),
            FREE_RGBD_ATE_JAX, counted13)
        checks.update({"displacement within 5%": abs(o13r["displacement_ratio"] - 1.0) < 0.05,
                       "one fast_nms launch per frame": launches13r["fast_nms"] == N_FRAMES,
                       "no stereo_match or remap_pair launch":
                           launches13r["stereo_match"] == launches13r["remap_pair"] == 0})
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"free rgbd checks failed: {bad}")
        o13s, launches13s, checks, _ = free_depth(
            "free stereo", "stereo", lambda r, k: r.track_stereo(*rect(frames[k], rights[k]), k / 30.0),
            FREE_STEREO_ATE_JAX, counted13 + list(STEREO_ONLY))
        checks.update({"path length within 15%": abs(o13s["path_ratio"] - 1.0) < 0.15,
                       "two fast_nms and two orb_describe launches per frame":
                           launches13s["fast_nms"] == launches13s["orb_describe"] == 2 * N_FRAMES,
                       "one stereo_match and one remap_pair launch per frame":
                           launches13s["stereo_match"] == launches13s["remap_pair"] == N_FRAMES})
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"free stereo checks failed: {bad}")

        # scan mode == per-frame on the card: phase 11's first 48 frames again
        # through track_mono_sequence (two chunks of 24), against the state
        # phase 11's per-frame run held after them
        ref13 = kept11["state"]
        runner13 = dl.FreeRunner(cam11, cfg11, max_frames=len(images11), auto_grow=False,
                                 device="cuda")
        secs13c, syncs13c, launches13c, calls13c = free_drive(
            "free scan", runner13, [lambda: runner13.track_mono_sequence(
                np.stack(images11[:N_FRAMES]), [k / 30.0 for k in range(N_FRAMES)], chunk=24)],
            counted11)
        a, b = runner13.state, ref13
        ring_diff = [f for f in ("traj_ref", "traj_ok", "ring_mode", "ring_nlocal")
                     if not torch.equal(getattr(a, f)[:N_FRAMES], getattr(b, f)[:N_FRAMES])]
        pose_err = max(float((a.traj[:N_FRAMES] - b.traj[:N_FRAMES]).abs().max()),
                       float((a.R - b.R).abs().max()), float((a.t - b.t).abs().max()),
                       float((a.m.kf_R - b.m.kf_R).abs().max()), float((a.m.kf_t - b.m.kf_t).abs().max()))
        same_kf = torch.equal(a.m.kf_valid, b.m.kf_valid) and int(a.m.n_kf) == int(b.m.n_kf)
        o13c = {"rings_that_differ": ring_diff, "max_pose_diff": pose_err, "same_keyframes": same_kf,
                "frames_per_s_scan": N_FRAMES / sum(secs13c), "syncs_per_frame": syncs13c[0] / N_FRAMES}
        print(f"free scan vs per-frame: {json.dumps(o13c)}, card {card}")
        if ring_diff or pose_err > 1e-5 or not same_kf:
            fail(f"free scan != per-frame: {o13c}")

        # localization mode: phase 11's runner as it stood after frame 47,
        # 12 more frames, then back to frames 4-7: no keyframe is made
        runner13l = dl.FreeRunner(cam11, cfg11, max_frames=len(images11), auto_grow=False,
                                  device="cuda")
        runner13l.state, runner13l.frame_id = ref13, N_FRAMES - 1
        runner13l._timestamps = [k / 30.0 for k in range(N_FRAMES)]
        kf_before = (runner13l.state.m.kf_valid.clone(), int(runner13l.state.m.n_kf))
        runner13l.activate_localization_mode()
        # a blank frame (no keypoint) loses tracking; a LOST tracker recovers
        # only by relocalization, so frames 4-7 drive it (kernel 6)
        blank = np.zeros_like(images11[0])
        seq13 = list(range(N_FRAMES, N_FRAMES + 12)) + [-1] + [KIDNAP_JUMP + i for i in range(4)]
        feeds = [(lambda i, k: lambda: runner13l.track_mono(blank if k < 0 else images11[k],
                                                            (N_FRAMES + i) / 30.0))(i, k)
                 for i, k in enumerate(seq13)]
        _, _, launches13l, calls13l = free_drive("free localization", runner13l, feeds,
                                                 counted11[:2] + ["pnp_hypotheses"])
        traj13l = runner13l.finish()["trajectory"][N_FRAMES:]
        o13l = {"frames": len(seq13), "tracked": sum(T is not None for _, T in traj13l),
                "blank_then_jump_tracked": [T is not None for _, T in traj13l[12:]],
                "reloc_attempts": len(calls13l["reloc"]),
                "keyframes_before": int(kf_before[0].sum()),
                "keyframes_after": int(runner13l.state.m.kf_valid.sum()),
                "launches": launches13l}
        print(f"free localization: {json.dumps(o13l)}, card {card}")
        checks = {"no keyframe made": torch.equal(runner13l.state.m.kf_valid, kf_before[0])
                                      and int(runner13l.state.m.n_kf) == kf_before[1],
                  "tracked before the blank frame": all(T is not None for _, T in traj13l[:12]),
                  "the blank frame lost": traj13l[12][1] is None,
                  "relocalization attempted after it": len(calls13l["reloc"]) >= 1,
                  **per_call_checks(calls13l)}
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"free localization checks failed: {bad}")
    finally:
        (loop_mod._free_sim3, dl.free_loop_stage, tracking.relocalize_candidates,
         sim3_mod.sim3_ransac_solve, sim3_mod.sim3_lm_solve) = free_saved

    return {"launches": {"11 free bench": launches11, "12 free loop": launches12,
                         "12 free loop repeat": launches12r,
                         "12 free loop rgbd": launches12d, "13 free rgbd": launches13r,
                         "13 free stereo": launches13s, "13 free scan": launches13c,
                         "13 free localization": launches13l},
            "outcomes": {"bench": o11, "loop": o12, "loop_rgbd": o12d, "rgbd": o13r,
                         "stereo": o13s, "scan": o13c, "localization": o13l},
            "bench_runner": (runner11, cam11, gt11, images11, cfg11), "kept11": kept11["numpy"],
            # phase 13's RGB-D runner as it ended, for phase 16
            "kept13r": convert.free_state_to_numpy(runner13r.state)}


def first_frames(mode: str, settings: str, seq: str, assoc: str):
    """``python3 chip_smoke.py --first-frames cold|warm <settings> <seq>
    <associations>``: in a fresh process, an RGB-D System on the TUM
    fixture's first frames, each timed to a device synchronize, after
    ``warmup()`` when `mode` is warm.  Prints one JSON line."""
    import torch

    sys.path.insert(0, ROOT)
    from orb_slam2_annotate_tpu_torch.io import config, datasets
    from orb_slam2_annotate_tpu_torch.pipeline import System

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    st = config.load_settings(settings, sensor="rgbd")
    samples = datasets.read_tum_rgbd(seq, assoc)[:FIRST_FRAMES]
    images = [datasets.load_image_gray(s.rgb_path) for s in samples]
    depths = [datasets.load_image_gray(s.depth_path) / st.depth_map_factor for s in samples]
    slam = System(st.cam, st.slam, device="cuda")
    torch.cuda.synchronize()
    warm_s = None
    if mode == "warm":
        t0 = time.perf_counter()
        slam.warmup()
        warm_s = time.perf_counter() - t0
    frame_s = []
    for k, (img, dep) in enumerate(zip(images, depths)):
        t0 = time.perf_counter()
        slam.track_rgbd(img, dep, samples[k].timestamp)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    print(json.dumps({"mode": mode, "warmup_s": warm_s, "frame_s": frame_s, "state": slam.state,
                      "keyframes": slam.n_keyframes}))


def io_phases(ctx):
    """Phase 14: map I/O, the multi-session merge and the dataset drivers,
    on what phases 1-13 left (`ctx`: the card's line, the slice's camera,
    poses, frames, depths and config, phase 5's sweep and its poses, phases
    7-8's depth camera and config, phase 11's runner, and the launch
    counters).
    Returns {"launches": each part's launches, "outcomes": each part's}."""
    import contextlib
    import io as io_mod
    import shutil
    import tempfile

    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.drivers import run_euroc, run_synthetic, run_tum
    from orb_slam2_annotate_tpu_torch.io import evaluation, synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import System, local_mapping
    from orb_slam2_annotate_tpu_torch.pipeline import device_loop as dl
    from orb_slam2_annotate_tpu_torch.solvers import ba_cg
    from orb_slam2_annotate_tpu_torch.worldmap import map_state, merge

    fx = types.SimpleNamespace(**runpy.run_path(os.path.join(ROOT, "tools", "driver_fixtures.py")))
    card, cam, poses, frames = ctx.card, ctx.cam, ctx.poses, ctx.frames
    zero_launches, read_launches = ctx.zero_launches, ctx.read_launches
    fields = [f.name for f in dataclasses.fields(map_state.MapState)]
    centre = lambda T: -np.asarray(T[:3, :3], np.float64).T @ np.asarray(T[:3, 3], np.float64)
    true_centre = lambda R, t: -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)

    def alignment(traj, gt):
        """The Sim3 taking a run's camera centres onto the truth."""
        ids = [k for k, T in traj if T is not None]
        est = np.stack([centre(T) for _, T in traj if T is not None])
        return evaluation.umeyama_alignment(est, np.stack([true_centre(*gt[k]) for k in ids]))

    def reloc_errors(traj, sim, gt, frame_ids):
        s, R, t = sim
        return [None if T is None else float(np.linalg.norm(s * R @ centre(T) + t
                                                            - true_centre(*gt[k])))
                for T, k in zip(traj, frame_ids)]

    def db_rows_err(old, new, kf_valid):
        """(max difference on the rows the live run wrote, every row of an
        invalid slot zero)."""
        written = old.abs().sum(1) > 0
        return float((new[written] - old[written]).abs().max()), not new[~kf_valid].any()

    def added(a, b):
        return {k: a.get(k, 0) + b[k] for k in b}

    def check(name, checks):
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"{name} checks failed: {bad}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        # ---- (a) map I/O: a System over phase 5's sweep (before its jump),
        # then phase 11's runner.  (On phase 4's shorter slice a loaded
        # System tracks frames 4-7 through its reference keyframe and never
        # relocalizes; after the sweep they are out of that keyframe's view.)
        gt5, sweep = ctx.gt5, ctx.sweep
        slam = System(cam, ctx.slice_cfg, device="cuda")
        for k, img in enumerate(sweep):
            slam.track_mono(img, k / 30.0)
        path = os.path.join(tmp, "system_map.npz")
        t0 = time.perf_counter()
        slam.save_map(path)
        save_s = time.perf_counter() - t0
        sim4 = alignment(slam.frame_trajectory(), gt5)
        zero_launches()
        torch.cuda.synchronize()
        slam_l = System(cam, ctx.slice_cfg, device="cuda")
        t0 = time.perf_counter()
        slam_l.load_map(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        differ = [f for f in fields if not torch.equal(getattr(slam.map, f), getattr(slam_l.map, f))]
        db_err, db_zero = db_rows_err(slam.loop_closer.db.bows, slam_l.loop_closer.db.bows,
                                      slam.map.kf_valid)
        traj, frame_s = [], []
        for i, k in enumerate(RELOC_FRAMES):
            t0 = time.perf_counter()
            traj.append(slam_l.track_mono(sweep[k], (len(sweep) + i) / 30.0))
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        launches_io = read_launches()
        errs = reloc_errors(traj, sim4, gt5, RELOC_FRAMES)
        o_sys = {"sweep_frames": len(sweep), "keyframes_saved": slam.n_keyframes, "save_s": save_s, "load_s": load_s, "file_bytes": os.path.getsize(path),
                 "fields_that_differ": differ, "db_written_rows_max_err": db_err,
                 "db_invalid_rows_zero": db_zero, "keyframes": slam_l.n_keyframes,
                 "reloc_frames": list(RELOC_FRAMES), "reloc_centre_err_m": errs,
                 "reloc_frame_ms": [1e3 * x for x in frame_s], "state": slam_l.state,
                 "launches": launches_io}
        print(f"map io, System: {json.dumps(o_sys)}, card {card}")
        check("map io, System", {
            "every field bit for bit": not differ, "database rows within 1e-6": db_err <= 1e-6,
            "invalid slots' rows zero": db_zero, "state OK after the frames": slam_l.state == "OK",
            f"each frame relocalized within {RELOC_BOUND} m":
                all(e is not None and e < RELOC_BOUND for e in errs),
            "kernels 5, 6 and 4 launched": all(launches_io[w] > 0 for w in (
                "assign_words", "pnp_hypotheses", "optimize_pose_batched"))})

        def free_load(name, file, cam_r, cfg_r, images, gt, frame_ids, ref_map, ref_bows, sim):
            zero_launches()
            torch.cuda.synchronize()
            runner = dl.FreeRunner(cam_r, cfg_r, max_frames=len(frame_ids), auto_grow=False,
                                   device="cuda")
            t0 = time.perf_counter()
            runner.load_map(file)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            m = runner.state.m
            differ = [f for f in fields if not torch.equal(getattr(ref_map, f), getattr(m, f))]
            err, zero = db_rows_err(ref_bows, runner.state.bows, ref_map.kf_valid)
            for i, k in enumerate(frame_ids):
                runner.track_mono(images[k], i / 30.0)
            runner.block()
            launches = read_launches()
            traj = [T for _, T in runner.finish()["trajectory"]]
            errs = reloc_errors(traj, sim, gt, frame_ids)
            out = {"load_s": load_s, "fields_that_differ": differ, "bows_written_rows_max_err": err,
                   "bows_invalid_rows_zero": zero, "reloc_frames": list(frame_ids),
                   "reloc_centre_err_m": errs, "mode": int(runner.state.mode),
                   "launches": launches}
            print(f"map io, {name}: {json.dumps(out)}, card {card}")
            check(f"map io, {name}", {
                "every field bit for bit": not differ, "BoW rows within 1e-6": err <= 1e-6,
                "invalid slots' rows zero": zero, "mode OK after the frames": out["mode"] == dl.MODE_OK,
                f"each frame relocalized within {RELOC_BOUND} m":
                    all(e is not None and e < RELOC_BOUND for e in errs),
                "kernel 6 launched": launches["pnp_hypotheses"] > 0})
            return out, launches

        runner11, cam11, gt11, images11, cfg11 = ctx.bench_runner
        out11 = runner11.finish()
        free_path = os.path.join(tmp, "free_map.npz")
        t0 = time.perf_counter()
        runner11.save_map(free_path)
        free_save_s = time.perf_counter() - t0
        o_free, l_free = free_load("FreeRunner (phase 11's map)", free_path, cam11, cfg11,
                                   images11, gt11, RELOC_FRAMES, out11["map"], runner11.state.bows,
                                   alignment(out11["trajectory"], gt11))
        o_free.update(save_s=free_save_s, file_bytes=os.path.getsize(free_path))
        o_cross, l_cross = free_load("FreeRunner (the System's file)", path, cam, ctx.slice_cfg,
                                     sweep, gt5, RELOC_FRAMES, slam.map,
                                     slam.loop_closer.db.bows, sim4)
        launches_io = added(added(launches_io, l_free), l_cross)

        # ---- (b) merge: two RGB-D sessions of phases 7-8's depth cell
        cfg_d = ctx.depth_config("rgbd")

        def session(span):
            s_ = System(ctx.cam_d, cfg_d, device="cuda")
            for k in span:
                s_.track_rgbd(frames[k], ctx.depths[k], k / 30.0)
            s_.flush()
            return s_

        sess_a, sess_b = session(MERGE_A), session(MERGE_B)
        stage_s = collections.defaultdict(float)
        stage_n = collections.Counter()

        def timed(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                stage_s[name] += time.perf_counter() - t
                stage_n[name] += 1
                return out
            return run

        saved = (merge.find_cross_map_pair, merge.solve_inter_map_sim3, merge.place_session,
                 map_state.update_mappoint_stats, local_mapping.fuse_points_into,
                 ba_cg.bundle_adjust_cg)
        merge.find_cross_map_pair = timed("bow", saved[0])
        merge.solve_inter_map_sim3 = timed("sim3", saved[1])
        merge.place_session = timed("reindex", saved[2])
        map_state.update_mappoint_stats = timed("stats", saved[3])
        local_mapping.fuse_points_into = timed("seam_fuse", saved[4])
        ba_cg.bundle_adjust_cg = timed("joint_ba", saved[5])
        zero_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = merge.merge_maps(sess_a.map, sess_b.map, ctx.cam_d, vocab=sess_a.loop_closer.vocab,
                                   fix_scale=True)
            torch.cuda.synchronize()
            merge_s = time.perf_counter() - t0
        finally:
            (merge.find_cross_map_pair, merge.solve_inter_map_sim3, merge.place_session,
             map_state.update_mappoint_stats, local_mapping.fuse_points_into,
             ba_cg.bundle_adjust_cg) = saved
        launches_merge = read_launches()
        m = res.map
        fid = m.kf_frame_id.cpu().numpy()
        kf_R, kf_t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
        errs = []
        for s_ in np.nonzero(m.kf_valid.cpu().numpy())[0]:
            f = int(fid[s_])
            f = f - merge.FRAME_ID_OFFSET + MERGE_B[0] if f >= merge.FRAME_ID_OFFSET else f
            errs.append(float(np.linalg.norm(centre(np.c_[kf_R[s_], kf_t[s_]])
                                             - true_centre(*poses[f]))))
        o_merge = {"success": res.success, "scale": res.scale, "kf_a": res.kf_a, "kf_b": res.kf_b,
                   "median_kf_err_m": float(np.median(errs)), "jax": MERGE_JAX,
                   "keyframes_a": sess_a.n_keyframes, "keyframes_b": sess_b.n_keyframes,
                   "keyframe_slots_used": f"{int(m.kf_valid.sum())} / {m.K}",
                   "point_slots_used": f"{int(m.mp_valid.sum())} / {m.P}",
                   "merge_ms": 1e3 * merge_s,
                   "stage_ms": {k: 1e3 * v for k, v in stage_s.items()},
                   "stage_calls": dict(stage_n), "launches": launches_merge}
        print(f"merge: {json.dumps(o_merge)}, card {card}")
        check("merge", {"success": res.success, "scale within 0.1 of 1": abs(res.scale - 1.0) < 0.1,
                        "median merged-keyframe error < 0.15 m": o_merge["median_kf_err_m"] < 0.15,
                        "kernels 3a, 3b, 5, 7, 8 and 11 launched": all(launches_merge[w] > 0 for w in (
                            "hamming_match", "distinctive_descriptors", "assign_words",
                            "sim3_ransac_solve", "sim3_lm_solve", "segment_sum"))})

        # ---- (c) the drivers on fixtures written here (VGA, numpy + zlib PNGs)
        root = os.path.join(tmp, "fixtures")
        cells = fx.build_cells(root, synthetic, DRIVER_FRAMES)
        launches_drv, o_drv = {}, {}

        def in_dir(name, fn):
            d = os.path.join(root, "out_" + name)
            os.makedirs(d, exist_ok=True)
            cwd, buf = os.getcwd(), io_mod.StringIO()
            os.chdir(d)
            try:
                with contextlib.redirect_stdout(buf):
                    out = fn()
            finally:
                os.chdir(cwd)
            return out, buf.getvalue(), d

        def driver_ate(name, d, traj_file):
            cell = cells[name]
            est, gt = fx.matched_centres(np.loadtxt(os.path.join(d, traj_file)), cell["times"],
                                         cell["centres"])
            return float(evaluation.ate_rmse(est, gt, with_scale=True)[0]), len(est)

        for name, mod in (("tum_mono", run_tum), ("tum_rgbd", run_tum), ("euroc_stereo", run_euroc)):
            zero_launches()
            out, stdout, d = in_dir(name, lambda: mod.main(cells[name]["args"]))
            launches = read_launches()
            launches_drv = added(launches_drv, launches)
            ate, rows = driver_ate(name, d, "CameraTrajectory.txt")
            o_drv[name] = {"ate_m": ate, "rows": rows, "frames": out["frames"],
                           "tracked": out["tracked"], "frames_per_s": out["frames_per_s"],
                           "frame_ms_median": out["frame_ms_median"],
                           "rectified": "rectifying with LEFT./RIGHT." in stdout,
                           "launches": launches}
        # KITTI mono as a user runs it: a process of its own (its launches are
        # not in this one's counters)
        d = os.path.join(root, "out_kitti_mono")
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "orb_slam2_annotate_tpu_torch.drivers.run_kitti",
                            *cells["kitti_mono"]["args"]], cwd=d, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
        if r.returncode != 0:
            fail(f"run_kitti as a subprocess: rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        ate, rows = driver_ate("kitti_mono", d, "KeyFrameTrajectory.txt")
        med = [ln for ln in r.stdout.splitlines() if ln.startswith("median tracking time")]
        o_drv["kitti_mono"] = {"ate_m": ate, "keyframe_rows": rows, "process_s": time.perf_counter() - t0,
                               "camera_rows": len(np.loadtxt(os.path.join(d, "CameraTrajectory.txt"))),
                               "frames": DRIVER_FRAMES, "stdout_timing": med[-1] if med else None}
        zero_launches()
        out, _, d = in_dir("synthetic_free",
                           lambda: run_synthetic.main([str(SYNTHETIC_FRAMES), "--free"]))
        launches = read_launches()
        launches_drv = added(launches_drv, launches)
        o_drv["synthetic_free"] = {**out, "launches": launches}
        for name, o in o_drv.items():
            jx = DRIVER_ATE_JAX[name]
            o.update(ate_jax_m=jx, ate_bound_m=max(1.5 * jx, jx + 0.01))
            print(f"driver {name}: {json.dumps(o)}, card {card}")
        # first-frame times in fresh processes, without and with warmup()
        rgbd = cells["tum_rgbd"]["args"]
        first = {}
        for mode in ("cold", "warm"):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-frames", mode,
                                *rgbd[1:]], cwd=ROOT, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                fail(f"--first-frames {mode}: rc {r.returncode}\n{r.stderr[-2000:]}")
            first[mode] = json.loads(r.stdout.strip().splitlines()[-1])
        o_drv["first_frames"] = first
        print(f"first RGB-D frames in a fresh process, s: {json.dumps(first)}, card {card}")
        within = lambda name: o_drv[name]["ate_m"] <= o_drv[name]["ate_bound_m"]
        check("drivers", {
            "TUM distorted mono ATE < 0.12 m": o_drv["tum_mono"]["ate_m"] < 0.12,
            "EuRoC stereo rectified": o_drv["euroc_stereo"]["rectified"],
            "EuRoC stereo >= 12 rows, ATE < 0.2 m":
                o_drv["euroc_stereo"]["rows"] >= 12 and o_drv["euroc_stereo"]["ate_m"] < 0.2,
            "kernels 9 and 10 once a stereo frame": o_drv["euroc_stereo"]["launches"]["stereo_match"]
                == o_drv["euroc_stereo"]["launches"]["remap_pair"] == DRIVER_FRAMES,
            "synthetic --free tracks > 60%": o_drv["synthetic_free"]["tracked"] > 0.6 * SYNTHETIC_FRAMES,
            **{f"{n} ATE within max(1.5 x, +0.01 m) of the JAX driver's": within(n) for n in o_drv
               if n != "first_frames"},
            "both first-frame runs OK": all(v["state"] == "OK" for v in first.values())})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": {"14 map io": launches_io, "14 merge": launches_merge,
                         "14 drivers": launches_drv},
            "outcomes": {"system_io": o_sys, "free_io": o_free, "free_io_system_file": o_cross,
                         "merge": o_merge, "drivers": o_drv}}


def pad_map(m, K: int, P: int, N: int):
    """`m` with K keyframe slots, P point slots and N feature slots a
    keyframe, every new slot empty (map_state's fill values)."""
    import torch

    from orb_slam2_annotate_tpu_torch.worldmap import map_state

    m = map_state.grow_map(m, new_K=K, new_P=P)
    n0 = m.N
    out = {}
    for f in dataclasses.fields(map_state.MapState):
        a = getattr(m, f.name)
        if f.name.startswith("kf_") and a.dim() >= 2 and a.shape[1] == n0 and N > n0:
            pad = torch.full((a.shape[0], N - n0) + tuple(a.shape[2:]), map_state._FILL[f.name],
                             dtype=a.dtype, device=a.device)
            a = torch.cat([a, pad], 1)
        out[f.name] = a
    return map_state.MapState(**out)


def ba_agreement(cam, prob, a: dict, b: dict) -> dict:
    """How far two global-BA results a, b ({R, t, X, cost} as numpy) of the
    BA problem `prob` (on the CPU) agree: the returned costs and the costs
    of the returned states (relative), how far either returned cost lies
    below its own state's (relative), the largest differences of R, t and
    the valid points X, of each valid edge's residual (px, the largest and
    the RMS) and of the reprojection RMSE over the valid edges (px), and of
    the points and camera centres after a Sim3 alignment of a onto b (m),
    which move along the map's flat directions (a monocular map with one
    fixed keyframe keeps a free scale; a weakly triangulated point, its
    depth).  The callers hold some of these (DIST_TOL, DIST_FULL_TOL,
    DIST_SHORT_TOL) and print all."""
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.io import evaluation
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    pv, kv = prob.pt_valid.numpy(), prob.cam_valid.numpy()
    out = {k: float(np.abs(np.asarray(a[k], np.float64)[m] - np.asarray(b[k], np.float64)[m]).max())
           for k, m in (("R", kv), ("t", kv), ("X", pv))}
    out["cost"] = float(abs(float(a["cost"]) - float(b["cost"])) / abs(float(b["cost"])))

    def state(r):
        return prob.replace(R=torch.from_numpy(np.array(r["R"])),
                            t=torch.from_numpy(np.array(r["t"])),
                            points=torch.from_numpy(np.array(r["X"])))

    # the cost of the returned states (the returned cost may be another state's)
    ca, cb = (float(ba_core.edge_cost(cam, state(r))) for r in (a, b))
    out["state_cost"] = abs(ca - cb) / abs(cb)
    # a returned cost below its own state's (relative; <= 0 when it is a
    # kept last step's or above, a refused one's)
    out["cost_below_state"] = max((ca - float(a["cost"])) / abs(ca), (cb - float(b["cost"])) / abs(cb))

    def residuals(r):
        return ba_core.edge_residual_jac(cam, state(r))[0][prob.edge_valid].numpy().astype(np.float64)

    ra, rb = residuals(a), residuals(b)
    out["residual_px"] = float(np.abs(ra - rb).max())
    out["residual_rms_px"] = float(np.sqrt(((ra - rb) ** 2).sum(1).mean()))
    out["rmse_px"] = float(abs(np.sqrt((ra[:, :2] ** 2).sum(1).mean())
                               - np.sqrt((rb[:, :2] ** 2).sum(1).mean())))

    def geometry(r):
        R, t = np.asarray(r["R"], np.float64)[kv], np.asarray(r["t"], np.float64)[kv]
        centres = -np.einsum("kji,kj->ki", R, t)
        return np.concatenate([centres, np.asarray(r["X"], np.float64)[pv]])

    ga, gb = geometry(a), geometry(b)
    sc, Rs, ts = evaluation.umeyama_alignment(ga, gb)
    out["aligned_m"] = float(np.abs(sc * ga @ Rs.T + ts - gb).max())
    out["aligned_scale"] = float(sc)
    return out


def agrees(d: dict, tol: dict) -> bool:
    """The measures of ba_agreement that `tol` holds, within it."""
    return all(d[k] <= tol[k] for k in tol)


def dist_rank(rank: str, port: str, d: str):
    """``python3 chip_smoke.py --dist-rank RANK PORT DIR``: one of phase
    15(b)'s two ranks, both on cuda:0 in a gloo group at localhost:PORT.
    Reads DIR/in.npz (the full-map BA problem, the camera, the anchor) and
    DIR/map.npz; runs the distributed BA on the problem sharded over the two
    ranks (DIST_ITERS steps, then DIST_SHORT_ITERS), then a System that
    loads the map (``load_map``), dispatches the loop closer's global BA
    through its distributed branch and folds it
    (``maybe_fold_gba(force=True)``); writes DIR/out<RANK>.npz."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from orb_slam2_annotate_tpu_torch import convert
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.parallel import dist_ba, mesh
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig, System

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    rank = int(rank)
    mesh.init_multi_host(f"localhost:{port}", 2, rank, device="cuda", backend="gloo",
                         timeout_s=120)
    z = dict(np.load(os.path.join(d, "in.npz")))
    cam = CameraModel(**{f.name: float(z["cam_" + f.name]) for f in dataclasses.fields(CameraModel)})
    prob = convert.ba_problem_from_numpy({k[5:]: v for k, v in z.items() if k.startswith("prob_")},
                                         device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, perm = dist_ba.shard_ba_problem(prob, DIST_BLOCKS, return_perm=True)
    R, t, Xs, cost = dist_ba.make_distributed_ba(mesh.map_mesh(), iters=DIST_ITERS)(cam, sp)
    X = Xs[torch.from_numpy(perm).cuda()]
    torch.cuda.synchronize()
    ba_s = time.perf_counter() - t0
    R5, t5, X5, cost5 = dist_ba.make_distributed_ba(mesh.map_mesh(), iters=DIST_SHORT_ITERS)(cam, sp)
    X5 = X5[torch.from_numpy(perm).cuda()]
    slam = System(cam, SlamConfig(n_features=DIST_N, n_levels=4, max_kf=DIST_K, max_mp=DIST_P),
                  device="cuda")
    slam.load_map(os.path.join(d, "map.npz"))
    lc = slam.loop_closer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc._dispatch_global_ba(slam.map, anchor=int(z["anchor"]))
    g = lc._gba_pending
    m = lc.maybe_fold_gba(slam.map, force=True)
    torch.cuda.synchronize()
    gba_s = time.perf_counter() - t0
    np.savez(os.path.join(d, f"out{rank}.npz"), R=R.cpu().numpy(), t=t.cpu().numpy(),
             X=X.cpu().numpy(), cost=cost.cpu().numpy(), short_R=R5.cpu().numpy(),
             short_t=t5.cpu().numpy(), short_X=X5.cpu().numpy(), short_cost=cost5.cpu().numpy(),
             gba_R=g["R"].cpu().numpy(),
             gba_t=g["t"].cpu().numpy(), gba_X=g["X"].cpu().numpy(), gba_cost=g["cost"].cpu().numpy(),
             world=mesh.world_size(), ba_s=ba_s, gba_s=gba_s, folded=lc.n_gba_folded,
             **{"fold_" + k: v for k, v in convert.map_state_to_numpy(m).items()})
    torch.distributed.destroy_process_group()


def dist_phases(ctx):
    """Phase 15: the dense BA and the distributed BA (world of one, then two
    ranks on the card), shard_points at a world of one, System.telemetry,
    and train_vocabulary, on what phases 4 and 6 left (`ctx`: the card's
    line; phase 4's camera, frames, config, System, tracking-step calls,
    trajectory and map; phase 6's camera and its closure's map and anchor;
    the launch counters and phase 4's drive).  Returns {"launches": the
    main-path runs' launches, "outcomes": each part's}."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch import convert
    from orb_slam2_annotate_tpu_torch.io import checkpoint
    from orb_slam2_annotate_tpu_torch.ops import extractor
    from orb_slam2_annotate_tpu_torch.ops.orb import OrbTables
    from orb_slam2_annotate_tpu_torch.parallel import dist_ba, mesh
    from orb_slam2_annotate_tpu_torch.pipeline import System
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.solvers import ba_cg, ba_core
    from orb_slam2_annotate_tpu_torch.worldmap import map_state, vocabulary

    card, cam6 = ctx.card, ctx.cam6
    out, launches = {}, {}

    def check(name, checks):
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"{name} checks failed: {bad}")

    def free_port():
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            return sk.getsockname()[1]

    def wall(fn, reps=1):
        """(result of the last call, median host seconds a call, the card
        drained before and after each)."""
        ts, r = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return r, statistics.median(ts)

    def on_cpu(p):
        return ba_core.BAProblem(**{f.name: getattr(p, f.name).cpu()
                                    for f in dataclasses.fields(ba_core.BAProblem)})

    def rmse(p, R, t, X):
        """Reprojection RMSE (px) over the valid edges."""
        r = ba_core.edge_residual_jac(cam6, p.replace(R=R, t=t, points=X))[0][:, :2]
        return float(torch.sqrt((r[p.edge_valid] ** 2).sum(1).mean()))

    def as_np(R, t, X, cost):
        return {"R": R.cpu().numpy(), "t": t.cpu().numpy(), "X": X.cpu().numpy(),
                "cost": float(cost)}

    # ---- (a) the dense BA and the distributed BA at a world of one, at full width
    m = pad_map(ctx.gba_map, DIST_K, DIST_P, DIST_N)
    anchor = ctx.gba_anchor
    prob = loop_mod.full_map_ba_problem(m, anchor)
    prob_c = on_cpu(prob)
    valid_pts = prob_c.pt_valid.numpy()
    n_edges = int(prob.edge_valid.sum())
    free = prob.cam_valid & ~prob.cam_fixed
    lam = torch.tensor(1e-5, device="cuda")
    blocks, t_normal = wall(lambda: ba_core.build_normal_eqs(cam6, prob, True), 5)
    _, t_schur = wall(lambda: ba_core.schur_solve_dense(*blocks[:5], lam, free), 5)
    del blocks
    _, t_step = wall(lambda: ba_core.bundle_adjust(cam6, prob, 1), 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ctx.zero_launches()
    dense, t_dense = wall(lambda: ba_core.bundle_adjust(cam6, prob, DIST_ITERS))
    launches["15 dense BA"] = ctx.read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    dense_c = ba_core.bundle_adjust(cam6, prob_c, DIST_ITERS)
    t_dense_cpu = time.perf_counter() - t0
    d_dense = ba_agreement(cam6, prob_c, as_np(*dense[:3], dense[4]), as_np(*dense_c[:3], dense_c[4]))
    inlier_diff = int((dense[3].cpu() != dense_c[3]).sum())
    mesh.init_multi_host(f"localhost:{free_port()}", 1, 0, device="cuda", timeout_s=120)
    mesh1 = mesh.map_mesh()
    (sp, perm), t_shard = wall(lambda: dist_ba.shard_ba_problem(prob, DIST_BLOCKS,
                                                                 return_perm=True))
    step1 = dist_ba.make_distributed_ba(mesh1, iters=DIST_ITERS, shards=DIST_BLOCKS)
    ctx.zero_launches()
    _, t_dist_first = wall(lambda: step1(cam6, sp))      # with NCCL's first-call setup
    launches["15 distributed BA"] = ctx.read_launches()
    (R1, t1, X1, c1), t_dist = wall(lambda: step1(cam6, sp), 3)
    # two calls on the same problem: bit for bit (kernel 11's fixed order)
    same = lambda a, b: all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                        y.view(torch.int32) if y.dtype == torch.float32 else y)
                            for x, y in zip(a, b))
    cg_a, t_cg = wall(lambda: ba_cg.bundle_adjust_cg(cam6, prob, DIST_ITERS, 25))
    repeat15 = {"bundle_adjust_cg": same(cg_a, ba_cg.bundle_adjust_cg(cam6, prob, DIST_ITERS, 25)),
                "bundle_adjust (dense)": same(dense, ba_core.bundle_adjust(cam6, prob, DIST_ITERS)),
                "distributed BA (world of one)": same((R1, t1, X1, c1), step1(cam6, sp))}
    R5, t5, X5, c5 = dist_ba.make_distributed_ba(mesh1, iters=DIST_SHORT_ITERS,
                                                 shards=DIST_BLOCKS)(cam6, sp)
    torch.distributed.destroy_process_group()
    world1 = as_np(R1, t1, X1[torch.from_numpy(perm).cuda()], c1)
    world1_short = as_np(R5, t5, X5[torch.from_numpy(perm).cuda()], c5)
    t0 = time.perf_counter()
    R1c, t1c, X1c, c1c = dist_ba.make_distributed_ba(mesh.Mesh(None, 1, 0), iters=DIST_ITERS,
                                                     shards=DIST_BLOCKS)(cam6, on_cpu(sp))
    t_dist_cpu = time.perf_counter() - t0
    d_dist = ba_agreement(cam6, prob_c, world1, as_np(R1c, t1c, X1c[torch.from_numpy(perm)], c1c))
    R5c, t5c, X5c, c5c = dist_ba.make_distributed_ba(mesh.Mesh(None, 1, 0),
                                                     iters=DIST_SHORT_ITERS,
                                                     shards=DIST_BLOCKS)(cam6, on_cpu(sp))
    d_dist_short = ba_agreement(cam6, prob_c, world1_short,
                                as_np(R5c, t5c, X5c[torch.from_numpy(perm)], c5c))
    out["a"] = {"K": m.K, "P": m.P, "N": m.N, "live_keyframes": int(m.kf_valid.sum()),
                "live_points": int(valid_pts.sum()), "valid_edges": n_edges, "anchor": int(anchor),
                "rmse_px": {"before": rmse(prob, prob.R, prob.t, prob.points),
                            "dense": rmse(prob, *dense[:3]), "distributed": rmse(prob, R1, t1, X1[
                                torch.from_numpy(perm).cuda()])},
                "normal_eqs_ms": 1e3 * t_normal, "schur_solve_ms": 1e3 * t_schur,
                "lm_step_ms": 1e3 * t_step, "dense_ba_ms": 1e3 * t_dense,
                "bundle_adjust_cg_ms": 1e3 * t_cg, "two_calls_bit_for_bit": repeat15,
                "distributed_ba_ms": 1e3 * t_dist, "distributed_first_call_ms": 1e3 * t_dist_first,
                "shard_ba_problem_ms": 1e3 * t_shard, "dense_cpu_s": t_dense_cpu,
                "distributed_cpu_s": t_dist_cpu, "dense_peak_mb": peak / 2**20,
                "dense_vs_cpu": d_dense, "dense_inlier_mask_differs": inlier_diff,
                "distributed_vs_cpu": d_dist,
                f"distributed_{DIST_SHORT_ITERS}_steps_vs_cpu": d_dist_short,
                "cost": {"dense": float(dense[4]), "distributed": world1["cost"]}}
    print(f"phase 15(a) global BA at K {m.K}, P {m.P}, N {m.N} ({out['a']['live_keyframes']} "
          f"keyframes, {out['a']['live_points']} points, {n_edges} edges live): "
          f"{json.dumps(out['a'])}, card {card}")
    check("phase 15(a)", {"dense BA within tolerance of the CPU's": agrees(d_dense, DIST_TOL),
                          "dense inlier masks within 0.1% of the edges": inlier_diff <= 1e-3 * n_edges,
                          "world-one distributed BA's cost within tolerance of the CPU's":
                              agrees(d_dist, DIST_FULL_TOL),
                          f"world-one distributed BA after {DIST_SHORT_ITERS} steps within "
                          "tolerance of the CPU's": agrees(d_dist_short, DIST_SHORT_TOL),
                          "the dense BA lowered the reprojection error":
                              out["a"]["rmse_px"]["dense"] < out["a"]["rmse_px"]["before"],
                          "the dense BA launched kernel 12b once a step":
                              launches["15 dense BA"]["chol_solve"] == DIST_ITERS,
                          "the distributed BA launched kernel 12c once a step":
                              launches["15 distributed BA"]["lu_solve"] == DIST_ITERS,
                          **{f"{k}: two calls bit for bit": v for k, v in repeat15.items()}})

    # ---- (b) two ranks on the one card (gloo), as subprocesses
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        np.savez(os.path.join(tmp, "in.npz"), anchor=np.int32(anchor),
                 **{"cam_" + f.name: np.float32(getattr(cam6, f.name))
                    for f in dataclasses.fields(type(cam6))},
                 **{"prob_" + k: v for k, v in convert.ba_problem_to_numpy(prob).items()})
        checkpoint.save_map(os.path.join(tmp, "map.npz"), m, extra={})
        if KEEP_BA is not None:
            os.makedirs(KEEP_BA, exist_ok=True)
            shutil.copy(os.path.join(tmp, "in.npz"), os.path.join(KEEP_BA, "phase15_ba_problem.npz"))
        port = str(free_port())
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                   "--dist-rank", str(r), port, tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, PYTHONPATH=ROOT)) for r in range(2)]
        logs, t0 = [], time.perf_counter()
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(1.0, DIST_RANK_TIMEOUT_S
                                                      - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            fail(f"phase 15(b): a rank did not finish in {DIST_RANK_TIMEOUT_S} s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"phase 15(b): rank {r} exited {p.returncode}:\n{log[-3000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"out{r}.npz"))) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = [k for k in ranks[0] if k not in ("ba_s", "gba_s")
            and not np.array_equal(ranks[0][k], ranks[1][k])]
    d_two = ba_agreement(cam6, prob_c, {k: ranks[0][k] for k in ("R", "t", "X", "cost")}, world1)
    d_two_short = ba_agreement(cam6, prob_c, {k: ranks[0]["short_" + k]
                                              for k in ("R", "t", "X", "cost")}, world1_short)
    d_gba = ba_agreement(cam6, prob_c, {k: ranks[0]["gba_" + k] for k in ("R", "t", "X", "cost")},
                         world1)
    # the world of one over the ranks' blocks sums what they sum, in their order
    not_world1 = [p + k for p, w in (("", world1), ("short_", world1_short), ("gba_", world1))
                  for k in ("R", "t", "X", "cost")
                  if not np.array_equal(np.asarray(ranks[0][p + k]), np.asarray(w[k]))]
    # the fold writes the branch's result into every slot live at the dispatch
    kv, pv = prob_c.cam_valid.numpy(), valid_pts
    fold_holds_ba = all(np.array_equal(ranks[0]["fold_" + f][m], ranks[0]["gba_" + g][m])
                        for f, g, m in (("kf_R", "R", kv), ("kf_t", "t", kv), ("mp_pos", "X", pv)))
    # and its integer and boolean fields are the world-one fold's
    fold1 = convert.map_state_to_numpy(loop_mod.fold_gba_device(
        m, *(torch.from_numpy(world1[k]).cuda() for k in ("R", "t", "X")), m.kf_valid,
        m.mp_valid, m.kf_R, m.kf_t))
    fold_exact = [k for k, v in fold1.items() if v.dtype.kind != "f"
                  and not np.array_equal(ranks[0]["fold_" + k], v)]
    out["b"] = {"world": int(ranks[0]["world"]), "ranks_differ_in": same,
                "two_ranks_vs_world_one": d_two,
                f"two_ranks_vs_world_one_{DIST_SHORT_ITERS}_steps": d_two_short,
                "loop_closer_branch_vs_world_one": d_gba,
                "not_bit_for_bit_world_one": not_world1,
                "fold_holds_the_branch_result": fold_holds_ba, "fold_fields_not_equal": fold_exact,
                "ba_s": [float(r["ba_s"]) for r in ranks], "gba_s": [float(r["gba_s"]) for r in ranks],
                "rmse_px": rmse(prob, *(torch.from_numpy(ranks[0][k]).cuda() for k in ("R", "t", "X")))}
    print(f"phase 15(b) two ranks on the card: {json.dumps(out['b'])}, card {card}")
    check("phase 15(b)", {"world of two": out["b"]["world"] == 2,
                          "both ranks equal bit for bit (BA, branch, fold)": not same,
                          "two ranks bit for bit the world of one over their blocks "
                          "(BA, its 4 steps, the branch)": not not_world1,
                          "two ranks' cost within tolerance of one's": agrees(d_two, DIST_FULL_TOL),
                          f"two ranks after {DIST_SHORT_ITERS} steps within tolerance of one":
                              agrees(d_two_short, DIST_SHORT_TOL),
                          "the LoopCloser's distributed branch's cost within tolerance of one's":
                              agrees(d_gba, DIST_FULL_TOL),
                          "a global BA folded on each rank": all(int(r["folded"]) == 1 for r in ranks),
                          "the fold holds the branch's result": fold_holds_ba,
                          "the fold's integer and boolean fields are the world-one fold's":
                              not fold_exact})

    # ---- (c) shard_points=True on phase 4's slice at a world of one
    slam_c = System(ctx.cam, dataclasses.replace(ctx.slice_cfg, shard_points=True), device="cuda")
    _, frame_s_c, launches["15 shard slice"] = ctx.drive("shard_points slice", slam_c, ctx.frames,
                                                         ctx.slice_kernels)
    traj_c = slam_c.frame_trajectory()
    traj_same = len(traj_c) == len(ctx.traj4) and all(
        k == k0 and ((T is None and T0 is None) or (T is not None and T0 is not None
                                                    and np.array_equal(T, T0)))
        for (k, T), (k0, T0) in zip(traj_c, ctx.traj4))
    map_c = convert.map_state_to_numpy(slam_c.map)
    map_differs = [k for k, v in map_c.items() if not np.array_equal(v, ctx.map4[k])]
    out["c"] = {"trajectory_equal": traj_same, "map_fields_not_equal": map_differs,
                "frames_per_s": len(ctx.frames) / sum(frame_s_c)}
    print(f"phase 15(c) shard_points=True at a world of one: {json.dumps(out['c'])}")
    check("phase 15(c)", {"trajectory bit for bit phase 4's": traj_same,
                          "map bit for bit phase 4's": not map_differs})

    # ---- (d) System.telemetry after phase 4
    tel = ctx.slam4.telemetry
    report = tel.report()
    print("phase 15(d) phase 4's System.telemetry.report():\n" + report)
    st = tel.stages
    out["d"] = {k: {"n": v.count, "median_ms": 1e3 * v.median, "mean_ms": 1e3 * v.mean,
                    "worst_ms": 1e3 * v.worst} for k, v in st.items()}
    check("phase 15(d)", {
        "the three stages": set(st) == {"frontend/extract", "tracking/step", "mapping/keyframe"},
        "frontend/extract once a frame": st["frontend/extract"].count == len(ctx.frames),
        "tracking/step once a tracking step": st["tracking/step"].count == ctx.track_calls4 > 0,
        "mapping/keyframe once a keyframe after initialization":
            st["mapping/keyframe"].count == int(ctx.slam4.map.n_kf) - 2 > 0,
        "one report line a stage": len(report.splitlines()) == 3})

    # ---- (e) train_vocabulary on the card: phase 4's frames' descriptors
    tab = OrbTables().to("cuda")
    descs, docs = [], []
    for k, img in enumerate(ctx.frames):
        f = extractor.extract(torch.from_numpy(img).cuda(), tab, ctx.slice_cfg.extractor)
        descs.append(f.desc[f.valid])
        docs.append(np.full(int(f.valid.sum()), k))
    D, doc = torch.cat(descs).contiguous(), np.concatenate(docs)
    ctx.zero_launches()
    voc_card, t_voc = wall(lambda: vocabulary.train_vocabulary(D, VOCAB_WORDS, VOCAB_ITERS, seed=0,
                                                               doc_ids=doc, device="cuda"))
    launches["15 vocabulary"] = ctx.read_launches()
    t0 = time.perf_counter()
    voc_cpu = vocabulary.train_vocabulary(D.cpu(), VOCAB_WORDS, VOCAB_ITERS, seed=0, doc_ids=doc,
                                          device="cpu")
    t_voc_cpu = time.perf_counter() - t0
    chunk = max(1, min(D.shape[0], (1 << 28) // VOCAB_WORDS))
    k5_expected = (VOCAB_ITERS + 1) * -(-D.shape[0] // chunk)
    words_equal = torch.equal(voc_card.words.cpu(), voc_cpu.words)
    idf_equal = torch.equal(voc_card.idf.cpu(), voc_cpu.idf)
    out["e"] = {"descriptors": int(D.shape[0]), "words": VOCAB_WORDS, "iters": VOCAB_ITERS,
                "card_s": t_voc, "cpu_s": t_voc_cpu, "k5_launches": launches["15 vocabulary"][
                    "assign_words"], "k5_expected": k5_expected, "words_equal": words_equal,
                "idf_equal": idf_equal, "words_used": int((voc_card.idf > 0).sum())}
    print(f"phase 15(e) train_vocabulary: {json.dumps(out['e'])}, card {card}")
    check("phase 15(e)", {"centroids equal the CPU twin's bit for bit": words_equal,
                          "IDF exact": idf_equal,
                          "kernel 5 once a chunk an iteration (and the IDF's)":
                              launches["15 vocabulary"]["assign_words"] == k5_expected,
                          "no other kernel": all(v == 0 for k, v in launches["15 vocabulary"].items()
                                                 if k != "assign_words")})
    return {"launches": launches, "outcomes": out}


def shard_rank(mode: str, rank: str, port: str, d: str):
    """``python3 chip_smoke.py --shard-rank MODE RANK PORT DIR``: one of a
    phase-16 run's two ranks, both on cuda:0 in a gloo group at
    localhost:PORT, the live map's point axis split over them
    (``shard_points=True``).  Reads DIR/in.npz (the frames, the camera, the
    config as JSON, whether the point axis is split: ``shard``, and
    optionally the loop closer's ``use_dist_gba`` and ``drain``); MODE
    ``slice`` or ``loop`` drives a mono System over the frames, ``rgbd`` /
    ``stereo`` a depth System (the depth maps or right images in
    ``frames2``), ``free`` / ``free_rgbd`` a FreeRunner.  With ``drain`` the
    card is drained after each global BA's dispatch, so the BA folds at the
    keyframe that closed the loop, as in phase 6; without it the BA folds
    once it is done on both ranks, as a user's run does.  Writes
    DIR/out<RANK>.npz: the trajectory (or the runner's state) and the
    gathered map, the rank's keyframe fields and point rows, each kernel's
    launches, the frame times and the peak memory (above what the card held
    before the System was made, as phase 4's); a System with loop closing
    also the frames of its closures and folds, the first global BA's
    returned cost, anchor and (rank 0) the gathered map it was dispatched
    on."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from orb_slam2_annotate_tpu_torch import convert, kernels
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.parallel import mesh
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig, System
    from orb_slam2_annotate_tpu_torch.pipeline import device_loop as dl
    from orb_slam2_annotate_tpu_torch.worldmap import map_state

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    rank = int(rank)
    mesh.init_multi_host(f"localhost:{port}", 2, rank, device="cuda", backend="gloo",
                         timeout_s=120)
    z = dict(np.load(os.path.join(d, "in.npz")))
    cam = CameraModel(**{f.name: float(z["cam_" + f.name]) for f in dataclasses.fields(CameraModel)})
    cfg = SlamConfig(**json.loads(str(z["cfg"])), shard_points=bool(z["shard"]))
    frames = z["frames"]
    frames2 = z["frames2"] if "frames2" in z else None
    out = {}
    base = torch.cuda.memory_allocated()
    free = mode.startswith("free")
    if free:
        runner = dl.FreeRunner(cam, cfg, max_frames=int(z["max_frames"]),
                               auto_grow=bool(z["auto_grow"]), device="cuda")
        track = runner.track_rgbd if mode == "free_rgbd" else runner.track_mono
    else:
        slam = System(cam, cfg, device="cuda")
        track = {"rgbd": slam.track_rgbd, "stereo": slam.track_stereo}.get(mode, slam.track_mono)
        lc = slam.loop_closer
        if lc is not None and "use_dist_gba" in z:
            lc.cfg = dataclasses.replace(lc.cfg, use_dist_gba=bool(z["use_dist_gba"]))
        if lc is not None:
            real_gba, real_fold = lc._dispatch_global_ba, lc.maybe_fold_gba
            drain = bool(z["drain"]) if "drain" in z else False
            gba_frames, fold_frames, gba_cost = [], [], []

            def keep_gba(m, anchor):
                # the first global BA: the map it runs on (gathered: every rank
                # calls this) and its returned cost, copied on the card and read
                # after the run, so that reading it does not drain the card
                first = not gba_frames
                whole = convert.map_state_to_numpy(m) if first else None
                real_gba(m, anchor)
                gba_frames.append(slam.frame_id)
                if drain:
                    torch.cuda.synchronize()
                if first:
                    gba_cost.append(lc._gba_pending["cost"].clone())
                    out.update(gba_anchor=int(anchor))
                    if rank == 0:
                        np.savez(os.path.join(d, "gba_map.npz"), **whole)

            def keep_fold(m, force=False):
                n0 = lc.n_gba_folded
                m = real_fold(m, force)
                if lc.n_gba_folded > n0:
                    fold_frames.append(slam.frame_id)
                return m

            lc._dispatch_global_ba, lc.maybe_fold_gba = keep_gba, keep_fold
    for w in kernels.WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for k, img in enumerate(frames):
        t0 = time.perf_counter()
        if frames2 is None:
            track(img, k / 30.0)
        else:
            track(img, frames2[k], k / 30.0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    peak = torch.cuda.max_memory_allocated() - base
    if free:
        m = runner.state.m
        for k, v in convert.free_state_to_numpy(runner.state).items():
            for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
                out["st_" + k + ("" if k2 is None else "__" + k2)] = v2
    else:
        traj = slam.frame_trajectory()          # flushes: folds a pending global BA
        m = slam.map
        out.update(traj=np.stack([np.full((4, 4), np.nan, np.float32) if T is None else T
                                  for _, T in traj]),
                   **{"m_" + k: v for k, v in convert.map_state_to_numpy(m).items()})
        if lc is not None:
            if gba_cost:
                out["gba_cost"] = gba_cost[0].cpu().numpy()
            out.update(loops=lc.n_loops_closed, gba_dispatched=lc.n_gba_dispatched,
                       gba_folded=lc.n_gba_folded, gba_frames=np.array(gba_frames, np.int64),
                       fold_frames=np.array(fold_frames, np.int64))
    out.update({"kf_" + f.name: getattr(m, f.name).cpu().numpy()
                for f in dataclasses.fields(map_state.MapState) if not f.name.startswith("mp_")})
    out.update(world=mesh.world_size(), P=m.P, P_local=m.P_local, secs=np.array(secs),
               peak_mb=peak / 2**20, launches=json.dumps(launches),
               point_mb=sum(getattr(m, k).numel() * getattr(m, k).element_size()
                            for k in map_state.POINT_FIELDS) / 2**20)
    np.savez(os.path.join(d, f"out{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def shard_phases(ctx):
    """Phase 16: the live map's point axis split over two gloo ranks on the
    one card, each a subprocess (``shard_rank``): (a) phase 4's slice
    alone, then (b)-(d2) and (d3)-(g) in two batches of runs at once, as the
    module's docstring lists them (`ctx`: the card's line; phases 4, 6-8,
    11 and 13's cameras, frames, configs and results).  Returns {"launches":
    rank 0's and rank 1's per run, "outcomes": each run's}."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch import convert
    from orb_slam2_annotate_tpu_torch.io import evaluation
    from orb_slam2_annotate_tpu_torch.parallel import dist_ba, mesh
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod

    card = ctx.card
    out, launches = {}, {}

    def check(name, checks):
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"{name} checks failed: {bad}")

    def free_port():
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            return sk.getsockname()[1]

    def start(tag, mode, cam, cfg, frames, shard=True, **extra):
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_shard_{tag}_")
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                  if f.name != "shard_points"}
        np.savez(os.path.join(tmp, "in.npz"), frames=np.stack(frames), cfg=json.dumps(fields),
                 shard=np.bool_(shard), **{"cam_" + f.name: np.float32(getattr(cam, f.name))
                                           for f in dataclasses.fields(type(cam))}, **extra)
        port = str(free_port())
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                   "--shard-rank", mode, str(r), port, tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, PYTHONPATH=ROOT)) for r in range(2)]
        return tag, tmp, procs, time.perf_counter()

    def wait(started):
        mode, tmp, procs, t0 = started
        try:
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=max(1.0, SHARD_RANK_TIMEOUT_S
                                                          - (time.perf_counter() - t0)))[0])
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                    p.communicate()
                fail(f"phase 16 ({mode}): a rank did not finish in {SHARD_RANK_TIMEOUT_S} s")
            for r, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    fail(f"phase 16 ({mode}): rank {r} exited {p.returncode}:\n{log[-3000:]}")
            ranks = [dict(np.load(os.path.join(tmp, f"out{r}.npz"))) for r in range(2)]
            gba = os.path.join(tmp, "gba_map.npz")
            whole = dict(np.load(gba)) if os.path.exists(gba) else None
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for r, o in enumerate(ranks):
            launches[f"16 shard {mode} rank {r}"] = json.loads(str(o["launches"]))
        return ranks, whole, time.perf_counter() - t0

    def bits(a):
        a = np.asarray(a)
        return a.view(np.int32) if a.dtype == np.float32 else a

    def differ(got: dict, ref: dict, prefix: str):
        return [k for k, v in ref.items() if not np.array_equal(bits(got[prefix + k]), bits(v))]

    def rank_common(ranks):
        """Per rank: launches, frames/s, frame median, peak memory, point rows;
        and the fields where the ranks' keyframe state differs."""
        kf_differ = [k for k in ranks[0] if k.startswith("kf_")
                     and not np.array_equal(bits(ranks[0][k]), bits(ranks[1][k]))]
        per = [{"world": int(o["world"]), "P": int(o["P"]), "P_local": int(o["P_local"]),
                "point_mb": float(o["point_mb"]), "peak_mb": float(o["peak_mb"]),
                "frames_per_s": len(o["secs"]) / float(o["secs"].sum()),
                "frame_ms_median": 1e3 * float(np.median(o["secs"])),
                "launches": json.loads(str(o["launches"]))} for o in ranks]
        return per, kf_differ

    def traj_same(a, ref):
        return len(a) == len(ref) and all(
            (T0 is None and not np.isfinite(T).any()) or (T0 is not None and np.array_equal(T, T0))
            for T, (_, T0) in zip(a, ref))

    # ---- (a) phase 4's slice at a world of two
    ranks, _, wall_a = wait(start("slice", "slice", ctx.cam, ctx.slice_cfg, ctx.frames))
    per, kf_differ = rank_common(ranks)
    map_differs = [differ(o, ctx.map4, "m_") for o in ranks]
    out["a"] = {"ranks": per, "trajectory_equal": [traj_same(o["traj"], ctx.traj4) for o in ranks],
                "map_fields_not_equal": map_differs, "kf_fields_differ_between_ranks": kf_differ,
                "frames_per_s_phase4": ctx.fps4, "peak_mb_phase4": ctx.peak4_mb,
                "point_mb_phase4": ctx.point_mb4, "wall_s": wall_a}
    print(f"phase 16(a) phase 4's slice on two ranks: {json.dumps(out['a'])}, card {card}")
    check("phase 16(a)", {
        "world of two": all(p["world"] == 2 for p in per),
        "each rank holds P / 2 point rows": all(2 * p["P_local"] == p["P"] == ctx.slice_cfg.max_mp
                                                for p in per),
        "trajectory bit for bit phase 4's on both ranks": all(out["a"]["trajectory_equal"]),
        "gathered map bit for bit phase 4's on both ranks": not any(map_differs),
        "both ranks' keyframe state equal": not kf_differ,
        "every slice kernel launched on each rank": all(
            p["launches"][w] > 0 for p in per for w in ctx.slice_kernels)})

    # ---- at once: (b) phase 6's loop cell with the global BA on the live
    # shards, (c) phase 11's first 48 frames, and (d) phase 6's loop cell on a
    # replicated map (shard_points off: every rank runs the whole cell), with
    # the matrix-free BA (d1: the loop closer's use_dist_gba off) and with its
    # own default, use_dist_gba on (d2: the BA re-laid out over the ranks).
    # (d1) drains the card after each global BA's dispatch, as phase 6's runs
    # do, so that it folds where phase 6 folded; (b) and (d2) run as a user's
    # do, each BA folded once it is done on both ranks
    b_started = start("loop", "loop", ctx.cam6, ctx.loop_cfg, ctx.images6)
    c_started = start("free", "free", ctx.cam11, ctx.cfg11, ctx.images11[:N_FRAMES],
                      max_frames=np.int32(len(ctx.images11)), auto_grow=np.bool_(False))
    d1_started = start("loop_replicated_cg", "loop", ctx.cam6, ctx.loop_cfg, ctx.images6,
                       shard=False, use_dist_gba=np.bool_(False), drain=np.bool_(True))
    d2_started = start("loop_replicated_dist", "loop", ctx.cam6, ctx.loop_cfg, ctx.images6,
                       shard=False)
    ranks_b, whole, wall_b = wait(b_started)
    ranks_c, _, wall_c = wait(c_started)
    ranks_d1, _, wall_d1 = wait(d1_started)
    ranks_d2, _, wall_d2 = wait(d2_started)
    # then at once: (d3) (d1) undrained, each rank's matrix-free BA folded
    # once it is done on both; (e) phase 6's loop cell split with phase 6's
    # own global BA (the matrix-free BA on the gathered map, drained as d1);
    # (f) phases 7 and 8's RGB-D and stereo cells split, (g) phase 13's RGB-D
    # cell through the FreeRunner split
    d3_started = start("loop_replicated_cg_undrained", "loop", ctx.cam6, ctx.loop_cfg,
                       ctx.images6, shard=False, use_dist_gba=np.bool_(False))
    e_started = start("loop_split_cg", "loop", ctx.cam6, ctx.loop_cfg, ctx.images6,
                      use_dist_gba=np.bool_(False), drain=np.bool_(True))
    f1_started = start("rgbd", "rgbd", ctx.cam_d, ctx.depth_config("rgbd"), ctx.frames,
                       frames2=np.stack(ctx.depths))
    f2_started = start("stereo", "stereo", ctx.cam_d, ctx.depth_config("stereo"), ctx.frames,
                       frames2=np.stack(ctx.rights))
    g_started = start("free_rgbd", "free_rgbd", ctx.cam_d, ctx.depth_config("rgbd"), ctx.frames,
                      frames2=np.stack(ctx.depths), max_frames=np.int32(N_FRAMES),
                      auto_grow=np.bool_(True))
    ranks_d3, _, wall_d3 = wait(d3_started)
    ranks_e, _, wall_e = wait(e_started)
    ranks_f1, _, wall_f1 = wait(f1_started)
    ranks_f2, _, wall_f2 = wait(f2_started)
    ranks_g, _, wall_g = wait(g_started)

    def loop_ate(o):
        """A rank's Sim3-aligned ATE on phase 6's loop cell, and its tracked frames."""
        ok = np.isfinite(o["traj"][:, 0, 0])
        ids = np.nonzero(ok)[0]
        if len(ids) < 3:
            return float("inf"), int(ok.sum())
        est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in o["traj"][ok]])
        gt = np.stack([-ctx.gt6[k][0].T @ ctx.gt6[k][1] for k in ids])
        return float(evaluation.ate_rmse(est.astype(np.float64), gt.astype(np.float64),
                                         with_scale=True)[0]), int(ok.sum())

    def frames_of(ranks, key):
        return [[int(x) for x in r[key]] for r in ranks]

    per, kf_differ = rank_common(ranks_b)
    o = ranks_b[0]
    ate_b, tracked_b = loop_ate(o)
    # the global BA at a world of one on the map the ranks dispatched it on
    gba_rel = float("inf")
    if whole is not None:
        m_w = convert.map_state_from_numpy(whole, device="cuda")
        # each rank's live block, built from the whole map as the rank holds it
        blocks = [loop_mod.full_map_ba_problem(mesh.shard_map_state(m_w, mesh.Mesh(None, 2, r)),
                                               int(o["gba_anchor"])) for r in range(2)]
        cost1 = float(dist_ba.make_distributed_ba(mesh.Mesh(None, 1, 0), iters=DIST_ITERS,
                                                  live=True, shards=2)(ctx.cam6, blocks)[3])
        gba_rel = abs(float(o["gba_cost"]) - cost1) / abs(cost1)
    out["b"] = {"ranks": per, "kf_fields_differ_between_ranks": kf_differ,
                "tracked": tracked_b, "frames": len(o["traj"]), "ate_m": ate_b,
                "ate_bound_m": ctx.ate_bound6, "ate_phase6_m": ctx.ate6,
                "loops": [int(r["loops"]) for r in ranks_b],
                "gba_dispatched": [int(r["gba_dispatched"]) for r in ranks_b],
                "gba_folded": [int(r["gba_folded"]) for r in ranks_b],
                "gba_frames": frames_of(ranks_b, "gba_frames"),
                "fold_frames": frames_of(ranks_b, "fold_frames"),
                "gba_cost": float(o["gba_cost"]) if "gba_cost" in o else None,
                "gba_cost_rel_vs_world_one": gba_rel, "wall_s": wall_b}
    print(f"phase 16(b) phase 6's loop cell on two ranks: {json.dumps(out['b'])}, card {card}")
    check("phase 16(b)", {
        "both ranks' keyframe state equal": not kf_differ,
        "both ranks fold at the same frames": out["b"]["fold_frames"][0]
        == out["b"]["fold_frames"][1],
        "a loop closed": min(out["b"]["loops"]) >= 1,
        "a global BA folded": min(out["b"]["gba_folded"]) >= 1,
        "tracked >= 60%": out["b"]["tracked"] >= 0.6 * LOOP_FRAMES,
        f"ATE <= {ctx.ate_bound6:.5f}": ate_b <= ctx.ate_bound6,
        "the global BA's cost within tolerance of a world of one's":
            gba_rel <= DIST_FULL_TOL["cost"]})

    per, kf_differ = rank_common(ranks_c)
    ref = ctx.kept11
    state_differs = []
    for k, v in ref.items():
        for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = "st_" + k + ("" if k2 is None else "__" + k2)
            if any(not np.array_equal(bits(r[key]), bits(v2)) for r in ranks_c):
                state_differs.append(key[3:])
    out["c"] = {"ranks": per, "kf_fields_differ_between_ranks": kf_differ,
                "state_fields_not_equal": state_differs,
                "frames_per_s_phase11_first_48": ctx.fps11_48, "wall_s": wall_c}
    print(f"phase 16(c) the FreeRunner on phase 11's first 48 frames on two ranks: "
          f"{json.dumps(out['c'])}, card {card}")
    check("phase 16(c)", {
        "state bit for bit phase 11's after frame 47 on both ranks": not state_differs,
        "both ranks' keyframe state equal": not kf_differ,
        "each rank holds P / 2 point rows": all(2 * p["P_local"] == p["P"] for p in per)})

    def same_bits(a, b):
        return np.array_equal(bits(a), bits(b))

    def system_run(name, ranks, wall, traj_ref=None, map_ref=None):
        """A System's run on two ranks: each rank's trajectory and gathered
        map against `traj_ref` / `map_ref` (or against rank 0's)."""
        per, kf_differ = rank_common(ranks)
        traj_ref = ranks[0]["traj"] if traj_ref is None else traj_ref
        map_ref = ({k[2:]: v for k, v in ranks[0].items() if k.startswith("m_")}
                   if map_ref is None else map_ref)
        o = {"ranks": per, "kf_fields_differ_between_ranks": kf_differ,
             "trajectory_equal": [same_bits(r["traj"], traj_ref) for r in ranks],
             "map_fields_not_equal": [differ(r, map_ref, "m_") for r in ranks],
             "tracked": int(np.isfinite(ranks[0]["traj"][:, 0, 0]).sum()), "wall_s": wall}
        if "loops" in ranks[0]:
            o.update(loops=[int(r["loops"]) for r in ranks],
                     gba_folded=[int(r["gba_folded"]) for r in ranks],
                     gba_frames=frames_of(ranks, "gba_frames"),
                     fold_frames=frames_of(ranks, "fold_frames"))
        print(f"phase 16({name}) on two ranks: {json.dumps(o)}, card {card}")
        return o

    def equal_checks(o, against):
        return {f"trajectory bit for bit {against} on both ranks": all(o["trajectory_equal"]),
                f"map bit for bit {against} on both ranks": not any(o["map_fields_not_equal"]),
                "both ranks' keyframe state equal": not o["kf_fields_differ_between_ranks"]}

    def loop_checks(o):
        return {"a loop closed on each rank": min(o["loops"]) >= 1,
                "a global BA folded on each rank": min(o["gba_folded"]) >= 1,
                "both ranks fold at the same frames": o["fold_frames"][0] == o["fold_frames"][1]}

    def undrained_checks(name, o, ranks):
        # rank against rank, and phase 6's ATE bound
        o["ate_m"], _ = loop_ate(ranks[0])
        print(f"phase 16({name}) ATE {o['ate_m']:.5f} m (phase 6's bound {ctx.ate_bound6:.5f}), "
              f"phase 6's global BAs at frames {ctx.gba_frames6} folded at {ctx.fold_frames6}")
        check(f"phase 16({name})", {**equal_checks(o, "rank 0's"), **loop_checks(o),
                                    f"ATE <= {ctx.ate_bound6:.5f}": o["ate_m"] <= ctx.ate_bound6,
                                    "tracked >= 60%": o["tracked"] >= 0.6 * LOOP_FRAMES})

    out["d1"] = system_run("d1) phase 6's loop cell, replicated, the matrix-free BA", ranks_d1,
                           wall_d1, ctx.traj6, ctx.map6)
    check("phase 16(d1)", {**equal_checks(out["d1"], "phase 6's"), **loop_checks(out["d1"])})
    out["d2"] = system_run("d2) phase 6's loop cell, replicated, the BA re-laid out over "
                           "the ranks", ranks_d2, wall_d2)
    undrained_checks("d2", out["d2"], ranks_d2)
    out["d3"] = system_run("d3) phase 6's loop cell, replicated, the matrix-free BA, undrained",
                           ranks_d3, wall_d3)
    undrained_checks("d3", out["d3"], ranks_d3)
    out["e"] = system_run("e) phase 6's loop cell split, the matrix-free BA on the gathered map",
                          ranks_e, wall_e, ctx.traj6, ctx.map6)
    check("phase 16(e)", {**equal_checks(out["e"], "phase 6's"), **loop_checks(out["e"])})
    out["f_rgbd"] = system_run("f) phase 7's RGB-D cell split", ranks_f1, wall_f1, ctx.traj7,
                               ctx.map7)
    check("phase 16(f) rgbd", equal_checks(out["f_rgbd"], "phase 7's"))
    out["f_stereo"] = system_run("f) phase 8's stereo cell split", ranks_f2, wall_f2, ctx.traj8,
                                 ctx.map8)
    check("phase 16(f) stereo", equal_checks(out["f_stereo"], "phase 8's"))
    per, kf_differ = rank_common(ranks_g)
    state_differs = []
    for k, v in ctx.kept13r.items():
        for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = "st_" + k + ("" if k2 is None else "__" + k2)
            if any(not same_bits(r[key], v2) for r in ranks_g):
                state_differs.append(key[3:])
    out["g"] = {"ranks": per, "kf_fields_differ_between_ranks": kf_differ,
                "state_fields_not_equal": state_differs, "wall_s": wall_g}
    print(f"phase 16(g) phase 13's RGB-D FreeRunner split on two ranks: {json.dumps(out['g'])}, "
          f"card {card}")
    check("phase 16(g)", {"state bit for bit phase 13's on both ranks": not state_differs,
                          "both ranks' keyframe state equal": not kf_differ})
    torch.cuda.synchronize()
    return {"launches": launches, "outcomes": out}


def k12_alone():
    """``python3 chip_smoke.py --k12``: phase 3's kernel-12 checks on the
    synthetic cases and a whole solve's times at full width, alone (kernel
    12 is built, nothing else), then its launch split by
    ``tools/k12_stages.py --no-slice``: the quick run for work on the
    kernel."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0].strip())
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import orb_slam2_annotate_tpu_torch  # noqa: F401  (sets TF32 off)
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.kernels import _build

    _build.load("grid_ba")
    print(f"build: {json.dumps(_build.BUILD_SECONDS)}")
    dev = torch.device("cuda:0")
    grid_ba_synthetic(dev)
    cases = grid_ba_cases()
    g = grid_on(cases["grid_problem"](12, *GBA_CASE_SIZE), dev)
    cam = CameraModel.create(**cases["CAM"])
    for iters in (4, 6):
        print(f"grid_ba synthetic, {iters} iterations: {json.dumps(grid_ba_times(cam, g, iters))}, "
              f"card {smi[0].strip()}")
    # the launch split and the Cholesky's phases (tools/k12_stages.py, an instrumented copy)
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "k12_stages.py"), "--no-slice"],
                   check=True)


def main():
    t_main = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import orb_slam2_annotate_tpu_torch  # noqa: F401  (sets TF32 off)
    from orb_slam2_annotate_tpu_torch import kernels
    from orb_slam2_annotate_tpu_torch.kernels import _build

    def zero_launches():
        for w in kernels.WRAPPERS:
            w.launches = 0

    def read_launches():
        return {w.__name__: w.launches for w in kernels.WRAPPERS}

    zero_launches()
    from orb_slam2_annotate_tpu_torch.kernels import assign_words as k5
    from orb_slam2_annotate_tpu_torch.kernels import fast_nms as k1
    from orb_slam2_annotate_tpu_torch.kernels import hamming as k3
    from orb_slam2_annotate_tpu_torch.kernels import orb_describe as k2
    from orb_slam2_annotate_tpu_torch.kernels import pnp_score as k6
    from orb_slam2_annotate_tpu_torch.kernels import pose_lm as k4
    from orb_slam2_annotate_tpu_torch.ops import extractor, matching, orb, pyramid
    from orb_slam2_annotate_tpu_torch.ops import hamming as hamming_ops
    from orb_slam2_annotate_tpu_torch.ops.orb import N_BITS
    from orb_slam2_annotate_tpu_torch.pipeline import System, local_mapping, tracking
    from orb_slam2_annotate_tpu_torch.pipeline.loop_closing import TRAINED_VOCAB
    from orb_slam2_annotate_tpu_torch.solvers import pnp as pnp_mod
    from orb_slam2_annotate_tpu_torch.solvers import pose_opt
    from orb_slam2_annotate_tpu_torch.worldmap import map_state, vocabulary

    if "jax" in sys.modules:
        fail("the port imported jax")
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    launches1 = read_launches()

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 2", flush=True)
    # ---- phase 2: build
    zero_launches()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.load, _build.SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f} s  per source {json.dumps(_build.BUILD_SECONDS)}")
    launches2 = read_launches()

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 3", flush=True)
    # ---- phase 3: kernels vs plain twins at main-path shapes; the counts
    # read at its end are the wrapper calls of its checks and timings (a
    # CUDA-graph replay calls no wrapper)
    zero_launches()
    t0 = time.perf_counter()
    cam, poses, frames, depths, slice_cfg = slice_setup()
    print(f"render: {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s (host numpy)")
    cfg = slice_cfg.extractor
    tab = orb.OrbTables().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, err, ms, plain_ms, nbytes, ops, tc_ops=0.0, **extra):
        bound_ms, bound_by = bound(nbytes, ops, tc_ops)
        results[name] = {"max_abs_err": float(err), "ms": float(ms), "plain_ms": float(plain_ms),
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, **extra}
        print(f"kernel {name}: max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes:.4g} B, {ops:.4g} ops, "
              f"{tc_ops:.4g} tensor-core ops) {extra or ''}")

    # kernel 1: a frame's whole pyramid, all four stacks bit for bit the
    # twin's (torch.equal, no tolerance) on every input of k1_cases
    fast_args = (cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
    names1 = ("pyr3", "pyr3_blur", "score", "is_hi")
    cases1 = {}
    for name, (img_np, n_lev, scale) in k1_cases().items():
        img = torch.from_numpy(img_np).to(dev)
        lt_c = pyramid.level_tables(*img.shape, n_lev, scale, dev)
        got, ref = k1.fast_nms(img, lt_c, *fast_args), k1.fast_nms_frame_plain(img, lt_c, *fast_args)
        torch.cuda.synchronize()
        differ = [n for n, x, y in zip(names1, got, ref) if not torch.equal(x, y)]
        if differ:
            fail(f"fast_nms differs from its twin on {name} in {differ}: max abs err "
                 f"{[float((x.float() - y.float()).abs().max()) for x, y in zip(got, ref)]}")
        cases1[name] = {"shape": list(img.shape), "levels": n_lev,
                        "kept": int((ref[2] > 0).sum()), "hi": int(ref[3].sum())}
    print(f"fast_nms vs twin, all four stacks bit for bit: {json.dumps(cases1)}")
    image = torch.from_numpy(frames[0]).to(dev).float()
    lt = pyramid.level_tables(480, 640, cfg.n_levels, cfg.scale, dev)
    got1 = k1.fast_nms(image, lt, *fast_args)
    H0, W0 = 480, 640
    pixels = sum(h * w for h, w in lt.shapes)
    resize_ops = sum(2 * (h * W0 * ty + h * w * tx)
                     for l, ((h, w), (ty, tx)) in enumerate(zip(lt.shapes, lt.taps)) if l > 0)
    record("fast_nms", 0.0, time_ms(lambda: k1.fast_nms(image, lt, *fast_args)),
           time_ms(lambda: k1.fast_nms_frame_plain(image, lt, *fast_args), 10),
           4 * H0 * W0 + cfg.n_levels * H0 * W0 * (3 * 4 + 1),
           resize_ops + (BLUR_OPS_PER_PIXEL + FAST_OPS_PER_PIXEL) * pixels, bit_exact=True,
           cases=cases1, graph_us=graph_us(lambda: k1.fast_nms(image, lt, *fast_args)),
           host_ns=round(host_ns(lambda: k1.fast_nms(image, lt, *fast_args)), 1),
           **device_kernels(lambda: k1.fast_nms(image, lt, *fast_args), 1))

    # kernel 2: a frame's selection, angles and descriptors from kernel 1's
    # stacks, frames 0 and 4: keypoints exact, angles and descriptors at the
    # tolerances tests/test_torch_frontend.py holds the twin to against JAX
    dt = k2.describe_tables(H0, W0, cfg.n_levels, cfg.scale, cfg.n_features, dev)
    names2 = ("xy", "response", "octave", "angle", "desc", "valid")
    ang_err, frac2 = 0.0, 1.0
    for f in (0, 4):
        stacks = got1 if f == 0 else k1.fast_nms(torch.from_numpy(frames[f]).to(dev).float(), lt,
                                                 *fast_args)
        got2 = k2.orb_describe(*stacks, dt, tab)
        ref2 = k2.orb_describe_plain(*stacks, dt, tab)
        torch.cuda.synchronize()
        moved = [n for n, a, b in zip(names2, got2, ref2) if n not in ("angle", "desc")
                 and not torch.equal(a, b)]
        if moved:
            fail(f"orb_describe, frame {f}: keypoints differ from the twin's in {moved}")
        a_k, a_p = got2[3], ref2[3]
        same_bin = orb.angle_bins(a_k) == orb.angle_bins(a_p)
        frac = float(same_bin[ref2[5]].float().mean())
        err = float((a_k - a_p).abs().max())
        if err > 1e-4 or frac < 0.995 or not torch.equal(got2[4][same_bin], ref2[4][same_bin]):
            fail(f"orb_describe, frame {f}: angle err {err}, same-bin fraction {frac}")
        ang_err, frac2 = max(ang_err, err), min(frac2, frac)
        print(f"orb_describe vs twin, frame {f}: keypoints exact, {int(ref2[5].sum())} valid, "
              f"max angle err {err:.3g}, same bin {frac:.4f}")
    sel_pixels = sum(gh * gw * cs * cs for (gh, gw), cs in zip(dt.grids, dt.cell_sizes))
    n_valid2 = float(ref2[5].sum())
    record("orb_describe", ang_err, time_ms(lambda: k2.orb_describe(*stacks, dt, tab)),
           time_ms(lambda: k2.orb_describe_plain(*stacks, dt, tab), 10),
           5 * sel_pixels + DESCRIBE_BYTES_PER_KP * n_valid2 + SLOT_BYTES * cfg.n_features,
           SELECT_OPS_PER_PIXEL * sel_pixels + DESCRIBE_OPS_PER_KP * n_valid2,
           keypoints_exact=True, same_bin_fraction=frac2,
           **device_kernels(lambda: k2.orb_describe(*stacks, dt, tab), 2))

    # kernel 3: every gate kind and the edge cases (k3a_cases), integer
    # outputs exactly equal to the twin
    feats = [extractor.extract(torch.from_numpy(f).to(dev), tab, cfg) for f in frames[:21]]
    cur = feats[4]
    cases3 = k3a_cases(feats, poses, cam, cfg, dev, k3, gen)
    f0 = feats[0]
    default3 = [(mx, ratio, mutual) for mutual in (False, True)
                for mx, ratio in ((matching.TH_HIGH, 0.9), (matching.TH_LOW, 1.0))]
    err3, n_matched3 = 0, {}
    for name, (da, db, rva, cva, gate, params) in cases3.items():
        for mx, ratio, mutual in params or default3:
            ik, sk = k3.hamming_match(da, db, rva, cva, mx, ratio, mutual, gate)
            ip, sp = k3.hamming_match_plain(da, db, rva, cva, mx, ratio, mutual, gate)
            torch.cuda.synchronize()
            if ik.shape != ip.shape or not (torch.equal(ik, ip) and torch.equal(sk, sp)):
                fail(f"hamming_match differs from its twin: {name}, max_dist {mx}, ratio {ratio}, "
                     f"mutual {mutual} ({int((ik != ip).sum())} rows)")
            err3 = max(err3, int((ik - ip).abs().max()), int((sk - sp).abs().max()))
            n_matched3[f"{name}, {mx}/{ratio}/{'mutual' if mutual else 'dedup'}"] = int((ik >= 0).sum())
    print(f"hamming_match vs twin, matched rows per case: {json.dumps(n_matched3)}")

    def match_work(da, db, rva, cva, gate):
        """(bytes, operations) of one call: inputs read once, outputs written once, no mask."""
        B = da.shape[0] if da.dim() == 3 else (db.shape[0] if db.dim() == 3 else 1)
        N1, N2 = da.shape[-2], db.shape[-2]
        rvv = torch.ones(N1, dtype=torch.bool, device=dev) if rva is None else rva
        cvv = torch.ones(N2, dtype=torch.bool, device=dev) if cva is None else cva
        valid_pairs = (rvv[..., :, None] & cvv[..., None, :]).expand(B, N1, N2)
        gated = float((valid_pairs & k3.gate_mask(gate)).sum()) if gate is not None \
            else float(valid_pairs.sum())
        per_gate = WINDOW_GATE_OPS if isinstance(gate, k3.WindowGate) else (
            EPIPOLAR_GATE_OPS if isinstance(gate, k3.EpipolarGate) else 0)
        gate_bytes = sum(t.numel() * t.element_size() for t in (gate or ())
                         if torch.is_tensor(t) and not isinstance(gate, k3.MaskGate))
        nbytes = sum(t.numel() * t.element_size() for t in (da, db, rva, cva) if t is not None) \
            + gate_bytes + 8 * B * N1
        return nbytes, HAMMING_OPS_PER_PAIR * gated + per_gate * float(valid_pairs.sum()) + B * N1 * N2

    def match_ms(name, reps=100):
        da, db, rva, cva, gate, _ = cases3[name]
        return time_ms(lambda: k3.hamming_match(da, db, rva, cva, matching.TH_HIGH, 0.8, False, gate),
                       reps)

    extra3 = {}
    for key, name in (("1k", "window+octave B=1 1024x1024"), ("b20_epipolar", "epipolar B=20"),
                      ("b8_shared", "validity B=8 shared desc2")):
        extra3[f"ms_{key}"] = match_ms(name)
        extra3[f"bound_ms_{key}"] = bound(*match_work(*cases3[name][:5]))[0]
    # graph replays at each batch size of the main path, and the wrapper's
    # host time by part at B = 1 (the arguments and checks, the two outputs,
    # the whole call)
    for key, name in (("b1", "window+octave B=1 4096x1024"), ("b2", "window B=2 1024x1024"),
                      ("b8", "validity B=8 shared desc2"), ("b11", "window+octave B=11 1024x1024"),
                      ("b20", "epipolar B=20")):
        da, db, rva, cva, gate, _ = cases3[name]
        extra3[f"graph_us_{key}"] = graph_us(
            lambda: k3.hamming_match(da, db, rva, cva, matching.TH_HIGH, 0.8, False, gate))
    main3 = cases3["window+octave B=1 4096x1024"]
    call3 = (*main3[:4], matching.TH_HIGH, 0.8, False, main3[4])
    extra3["host_ns_b1"] = host_parts("hamming_match, B = 1", {
        "args and checks": lambda: k3._match_args(*call3),
        "two outputs": lambda: (torch.empty(4096, dtype=torch.int32, device=dev),
                                torch.empty(4096, dtype=torch.int32, device=dev)),
        "whole call": lambda: k3.hamming_match(*call3)})
    record("hamming_match", err3, match_ms("window+octave B=1 4096x1024"),
           time_ms(lambda: k3.hamming_match_plain(*main3[:4], matching.TH_HIGH, 0.8, False, main3[4]),
                   10),
           *match_work(*main3[:5]), **extra3,
           **device_kernels(lambda: k3.hamming_match(*main3[:4], matching.TH_HIGH, 0.8, False,
                                                     main3[4]), 1))
    # kernel 3b: each point's distinctive descriptor, equal to the twin
    # (descriptor and slot) on random tables at Q = 4096 (MAX_TOUCHED) over
    # frames 0-20 as keyframes, and on the edge cases: every count from 0 to
    # 32, medians all tied, descriptors repeated within a point
    kf_desc3 = torch.stack([f.desc for f in feats]).contiguous()      # [21,1024,16]
    K3, N3 = kf_desc3.shape[:2]
    Q3 = 4096
    rand_tab = (torch.randint(0, K3, (Q3, 32), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, N3, (Q3, 32), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, 33, (Q3,), generator=gen, device=dev, dtype=torch.int32))
    e_kf = torch.randint(0, K3, (8, 32), generator=gen, device=dev, dtype=torch.int32)
    e_ft = torch.randint(0, N3, (8, 32), generator=gen, device=dev, dtype=torch.int32)
    e_kf[5], e_ft[5] = 3, 7                                           # one row 32 times: all tied
    e_kf[6, :6] = e_kf[6, :3].repeat_interleave(2)                    # three rows twice each
    e_ft[6, :6] = e_ft[6, :3].repeat_interleave(2)
    e_kf[7, 1:], e_ft[7, 1:] = e_kf[7, :1], e_ft[7, :1]               # slot 0 repeated: all tied
    edge_tab = (e_kf, e_ft, torch.tensor([0, 1, 2, 31, 32, 9, 6, 5], dtype=torch.int32, device=dev))

    def check_distinctive(what, kf_desc, tab):
        got = k3.distinctive_descriptors(kf_desc, *tab)
        ref = k3.distinctive_descriptors_plain(kf_desc, *tab)
        torch.cuda.synchronize()
        bad = int((got[0] != ref[0]).any(1).sum()) + int((got[1] != ref[1]).sum())
        if bad:
            fail(f"distinctive_descriptors differs from its twin, {what}: {bad} differences")
        print(f"distinctive_descriptors vs twin, {what}: Q {tab[0].shape[0]}, equal (descriptor "
              f"and slot), slots used {int(ref[1].max())}")
        return max(int((got[0] - ref[0]).abs().max()), int((got[1] - ref[1]).abs().max()))

    def distinctive_work(tab):
        """(bytes, CUDA-core operations, tensor-core operations) this table needs:
        max(cnt, 1) observed rows a point, cnt^2 distances of 512 AND-popcounts."""
        c = tab[2].double()
        return (DD_BYTES_PER_POINT * c.numel() + DD_BYTES_PER_ROW * float(c.clamp_min(1).sum()),
                DD_OPS_PER_PAIR * float((c * c).sum()), 2 * N_BITS * float((c * c).sum()))

    err3b = max(check_distinctive("random tables", kf_desc3, rand_tab),
                check_distinctive("counts 0, 1, 2, 31, 32, tied medians, repeated rows", kf_desc3,
                                  edge_tab))
    nb3, ops3, tc3 = distinctive_work(rand_tab)
    record("distinctive_descriptors", err3b,
           time_ms(lambda: k3.distinctive_descriptors(kf_desc3, *rand_tab)),
           time_ms(lambda: k3.distinctive_descriptors_plain(kf_desc3, *rand_tab), 10),
           nb3, ops3, tc3, graph_us=graph_us(lambda: k3.distinctive_descriptors(kf_desc3, *rand_tab)),
           **device_kernels(lambda: k3.distinctive_descriptors(kf_desc3, *rand_tab), 1))

    # kernel 4: the whole pose LM against its twin, at the tolerances
    # tests/test_torch_pose_opt.py holds the twin to against JAX
    def check_pose_lm(what, args, min_inliers=0):
        """R and t within 1e-4; inlier masks differ on <= 1% of edges, only
        where chi2 is within 1% of its gate; n within 1%.  A problem that both
        leave below `min_inliers` inliers (a relocalization candidate the PnP
        gate rejects, whose pose is never used and whose LM has no determined
        optimum) is held to the mask and count checks only.  Returns max
        |dR|, |dt| over the other problems."""
        got = k4.optimize_pose_batched(*args)
        again = k4.optimize_pose_batched(*args)
        ref = k4.optimize_pose_batched_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"pose_lm_solve ({what}): two calls differ")
        c4, xw4, uv4, ur4, is4 = args[0], args[3], args[4], args[5], args[6]
        pose_err = torch.maximum((got[0] - ref[0]).abs().amax((1, 2)), (got[1] - ref[1]).abs().amax(1))
        held = (got[3] >= min_inliers) | (ref[3] >= min_inliers)
        err = float(pose_err[held].max()) if bool(held.any()) else 0.0
        if not bool(held.all()):
            loose = [(int(got[3][b]), int(ref[3][b]), float(pose_err[b]))
                     for b in torch.nonzero(~held).flatten().tolist()]
            print(f"pose_lm_solve vs plain, {what}: (n kernel, n twin, max |dR|,|dt|) of the "
                  f"problems below {min_inliers} inliers in both: {loose}")
        worst_frac, worst_dn = 0.0, 0
        for b in range(xw4.shape[0]):
            per = lambda a, shared_dim: a if a.dim() == shared_dim else a[b]
            diff = got[2][b] != ref[2][b]
            r, _, _, _ = k4.residual_jac(c4, got[0][b], got[1][b], xw4[b], per(uv4, 2), per(ur4, 1))
            gate = torch.where(per(ur4, 1) >= 0, k4.CHI2_STEREO, k4.CHI2_MONO)
            near = ((r * r).sum(0) * per(is4, 1) / gate - 1.0).abs() < 0.01
            frac = float(diff.float().mean())
            n_k, n_p = int(got[3][b]), int(ref[3][b])
            worst_frac, worst_dn = max(worst_frac, frac), max(worst_dn, abs(n_k - n_p))
            if frac > 0.01 or bool((diff & ~near).any()) or abs(n_k - n_p) > math.ceil(0.01 * n_p):
                fail(f"pose_lm_solve ({what}, problem {b}): masks differ on {frac:.4f} of edges "
                     f"({int((diff & ~near).sum())} away from the gate), n {n_k} vs {n_p}")
        if err > 1e-4:
            fail(f"pose_lm_solve ({what}): R or t differs from the plain twin by {err:.3g}")
        print(f"pose_lm_solve vs plain, {what}: B {xw4.shape[0]}, max |dR|,|dt| {err:.3g}, "
              f"masks differ on {worst_frac:.4f} of edges at most, n by {worst_dn}")
        return err

    # 1024 edges from frame 0's keypoints back-projected with the exact depth,
    # 8 start poses around the truth; mono, and every other edge stereo
    syn = pose_lm_synthetic(cam, f0, depths[0], poses[0],
                            torch.randn(1024, 3, generator=gen, device=dev))
    args_b1, args_b8 = syn["b1"], syn["b8"]
    from orb_slam2_annotate_tpu_torch.geometry import lie
    ur_mono = args_b1[5]
    err4 = max(check_pose_lm("synthetic mono", args_b1),
               check_pose_lm("synthetic half stereo", syn["half stereo"]),
               check_pose_lm("synthetic mono, 8 start poses", args_b8))
    # the edge cases of the compaction and the launch; the one-edge problem
    # has no determined pose (two residual rows, six unknowns: the twin and
    # JAX part by 2e-3 m on the CPU), so it is held to its mask and count, as
    # a candidate below the PnP gate is, and to its edge's chi2 under the
    # gate at the kernel's pose (tests/test_torch_pose_lm_design.py holds
    # the twin's and JAX's poses to the same)
    cases4 = {}
    for name, a4 in pose_lm_cases(syn).items():
        err4 = max(err4, check_pose_lm(name, a4, min_inliers=3 if name == "one valid edge" else 0))
        cases4[name] = {"B": a4[7].shape[0], "N": a4[7].shape[1], "edges": int(a4[7].sum()),
                        **(device_kernels(lambda: k4.optimize_pose_batched(*a4), 1)
                           if a4[7].shape[0] else {})}
        if name == "one valid edge":
            R1e, t1e = k4.optimize_pose_batched(*a4)[:2]
            e = a4[7][0]
            per = lambda a, shared_dim: a if a.dim() == shared_dim else a[0]
            ur_e = per(a4[5], 1)[e]
            r, _, _, ok = k4.residual_jac(a4[0], R1e[0], t1e[0], a4[3][0][e], per(a4[4], 2)[e], ur_e)
            chi2 = float((r * r).sum() * per(a4[6], 1)[e][0])
            gate = k4.CHI2_STEREO if bool((ur_e >= 0).all()) else k4.CHI2_MONO
            cases4[name].update(chi2_at_kernel_pose=chi2, gate=gate)
            if not (bool(ok.all()) and chi2 <= gate):
                fail(f"pose_lm_solve (one valid edge): the edge's chi2 {chi2:.4g} at the kernel's "
                     f"pose is not under its gate {gate} (depth ok: {bool(ok.all())})")
    print(f"pose_lm_solve edge cases: {json.dumps(cases4)}")
    div4 = pose_lm_division_check()
    print(f"pose_lm_solve division: {json.dumps(div4)}")
    pose_b8 = {"ms_b1_synthetic": time_ms(lambda: k4.optimize_pose_batched(*args_b1)),
               "ms_b8": time_ms(lambda: k4.optimize_pose_batched(*args_b8)),
               "graph_us_b8": graph_us(lambda: k4.optimize_pose_batched(*args_b8)),
               "bound_ms_b8": bound(*pose_lm_work(args_b8[3], ur_mono, args_b8[7]))[0],
               "edge_cases": {k: v["B"] for k, v in cases4.items()}, **div4}
    print(f"pose_lm_solve synthetic: {json.dumps(pose_b8)}")

    # kernel 5: exact against its twin on the 1024 descriptors of frame 4 and
    # the trained vocabulary, on that vocabulary with every word twice (the
    # lower of two equal words must win) and at ragged N = 1000, W = 16383
    vocab = vocabulary.load_vocabulary(TRAINED_VOCAB, device=dev)
    if vocab.n_words != 16384:
        fail(f"trained vocabulary of {vocab.n_words} words")
    cases5 = {"trained 1024 x 16384": (cur.desc, vocab.words, cur.valid),
              "duplicated words 1024 x 32768": (cur.desc, vocab.words.repeat_interleave(2, 0),
                                                cur.valid),
              "ragged 1000 x 16383": (cur.desc[:1000].contiguous(), vocab.words[:16383].contiguous(),
                                      cur.valid[:1000].contiguous())}
    err5 = 0
    for name, args in cases5.items():
        w_k = k5.assign_words(*args)
        w_p = k5.assign_words_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(w_k, w_p):
            fail(f"assign_words differs from its plain twin, {name} ({int((w_k != w_p).sum())} rows)")
        err5 = max(err5, int((w_k - w_p).abs().max()))
    print(f"assign_words vs twin: equal on {list(cases5)}")
    args5 = cases5["trained 1024 x 16384"]
    n_desc, n_words = float(cur.valid.sum()), vocab.words.shape[0]
    # one PyTorch formulation: the +-1 forms' product (TF32 off), then the argmin
    sd, neg_sw = hamming_ops.unpack_signs(cur.desc), -vocab.signs.T.contiguous()
    library5 = lambda: torch.argmin(sd @ neg_sw, 1)
    if not torch.equal(torch.where(cur.valid, library5(), -1).to(torch.int32),
                       k5.assign_words(*args5)):
        fail("assign_words: the library formulation disagrees with the kernel")
    record("assign_words", err5, time_ms(lambda: k5.assign_words(*args5)),
           time_ms(lambda: k5.assign_words_plain(*args5, vocab.signs), 20),
           64 * (cur.desc.shape[0] + n_words) + 5 * cur.desc.shape[0],
           2 * n_desc * n_words, tc_ops=2 * N_BITS * n_desc * n_words,
           **device_kernels(lambda: k5.assign_words(*args5), 1), cases=list(cases5),
           library="torch.matmul of the +-1 forms [1024,512] x [512,16384], then torch.argmin "
                   "(two calls, TF32 off)")
    results["assign_words"]["library_ms"] = time_ms(library5)

    # kernel 7: the whole Sim3 RANSAC after its draw; 1024 hypotheses x 1024
    # pairs with 25% outliers (tests/test_loop_components.py's case at full
    # size), once with a near-collinear triple, once with 2 valid pairs (the
    # draws from all N), once with no valid pair and once with no inlier at
    # all (th = 0: a zero-inlier best), once with 30% of the pairs' x2 at
    # 1.5-2 x their depth along their rays (the refined fit counts fewer, so
    # the best is kept); then N = 4096 and H = 4096; every output bit for bit
    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k7
    N7 = H7 = 1024
    ones7 = torch.ones(N7, device=dev)
    lo7 = torch.tensor([-2.0, -2.0, 3.0], device=dev)
    hi7 = torch.tensor([2.0, 2.0, 8.0], device=dev)
    box = lambda n: lo7 + (hi7 - lo7) * torch.rand(n, 3, generator=gen, device=dev)
    proj7 = lambda x: torch.stack([cam.fx * x[:, 0] / x[:, 2] + cam.cx,
                                   cam.fy * x[:, 1] / x[:, 2] + cam.cy], 1)
    R7 = lie.so3_exp(torch.tensor([0.1, 0.3, -0.2], device=dev))
    t7 = torch.tensor([0.5, -0.2, 0.8], device=dev)

    def pair_set(n, fix, depth_err=0.0, exact=False):
        """(x1, x2, uv1, uv2, is1) of n pairs with 25% outliers (or, with
        depth_err, 30% of x2 moved along their rays instead; exact: no
        outlier and no pixel noise)."""
        x1 = box(n)
        x2t = (1.0 if fix else 1.4) * x1 @ R7.T + t7
        if exact:
            return x1, x2t.contiguous(), proj7(x1).contiguous(), proj7(x2t).contiguous(), ones7
        if depth_err:
            far = (torch.rand(n, generator=gen, device=dev) < 0.3)[:, None]
            moved = x2t * (1 + depth_err * (0.5 + 0.5 * torch.rand(n, 1, generator=gen, device=dev)))
            x2 = torch.where(far, moved, x2t)
        else:
            x2 = torch.where((torch.rand(n, generator=gen, device=dev) < 0.25)[:, None], box(n), x2t)
        uv1 = proj7(x1) + 0.5 * torch.randn(n, 2, generator=gen, device=dev)
        is1 = 1.2 ** (-2.0 * torch.randint(0, 8, (n,), generator=gen, device=dev).float())
        return x1, x2.contiguous(), uv1.contiguous(), proj7(x2t).contiguous(), is1.contiguous()

    def draws(valid, H):
        return torch.multinomial(valid.float().expand(H, -1), 3, generator=gen)

    consts7 = (cam.fx, cam.fy, cam.cx, cam.cy, 100.0)    # the loop closer's chi2 gate
    valid7 = torch.ones(N7, dtype=torch.bool, device=dev)
    samples7 = draws(valid7, H7)
    samples_c = samples7.clone()
    samples_c[0] = torch.tensor([1, 2, 3], device=dev)
    pairs7 = {fix: pair_set(N7, fix) for fix in (False, True)}
    err7, kept7 = 0.0, {}
    for fix in (False, True):
        x1f, x2f, uv1f, uv2f, is1f = pairs7[fix]
        x1c = x1f.clone()
        x1c[2] = x1f[1] + 0.5 * (x1f[3] - x1f[1]) + 1e-4          # on the segment, 0.1 mm off
        two = torch.arange(N7, device=dev) < 2
        for what, smp, a1, v, th in (
                ("25% outliers", samples7, x1f, valid7, consts7[4]),
                ("a near-collinear triple", samples_c, x1c, valid7, consts7[4]),
                ("fewer than 3 valid: 2 valid pairs", samples7, x1f, two, consts7[4]),
                ("no valid pair", samples7, x1f, ~valid7, consts7[4]),
                ("a zero-inlier best (th = 0)", samples7, x1f, valid7, 0.0)):
            e, kept7[f"{what}, fix_scale {fix}"], _ = check_sim3_ransac(
                f"{what}, fix_scale {fix}",
                (smp, a1, x2f, uv1f, uv2f, v, is1f, ones7, *consts7[:4], th, fix, 20))
            err7 = max(err7, e)
    depth7 = pair_set(N7, False, depth_err=1.0)
    e, refined, _ = check_sim3_ransac("30% of the depths 1.5-2 x (refined counts fewer)",
                                      (samples7, *depth7[:4], valid7, depth7[4], ones7, *consts7,
                                       False, 20))
    if refined:
        fail("sim3_ransac_solve: the depth-error case kept the refined Sim3; it must exercise the best")
    err7 = max(err7, e)
    N4k = 4096
    valid4k = torch.ones(N4k, dtype=torch.bool, device=dev)
    big = {"N = 4096": (draws(valid4k, H7), *pair_set(N4k, False)[:4], valid4k),
           "H = 4096": (draws(valid7, 4096), *pairs7[False][:4], valid7)}
    for what, (smp, x1b, x2b, uv1b, uv2b, vb) in big.items():
        e, _, _ = check_sim3_ransac(what, (smp, x1b, x2b, uv1b, uv2b, vb, None, None, *consts7,
                                           False, 20))
        err7 = max(err7, e)
    args7 = (samples7, *pairs7[False][:4], valid7, pairs7[False][4], ones7, *consts7, False, 20)
    out7 = k7.sim3_ransac_solve(*args7)
    record("sim3_ransac_solve", err7, time_ms(lambda: k7.sim3_ransac_solve(*args7)),
           time_ms(lambda: k7.sim3_ransac_solve_plain(*args7), 3),
           *sim3_hyp_work(samples7, valid7, float(out7[6][out7[7]])), bit_exact=True,
           refined_kept=kept7, graph_us=graph_us(lambda: k7.sim3_ransac_solve(*args7)),
           **device_kernels(lambda: k7.sim3_ransac_solve(*args7), 1))

    # kernel 8: the whole Sim3 LM on the same 1024 pairs from a start 0.1 in
    # scale, ~0.03 rad and 5 cm off, scale free and fixed; then 4096 pairs
    # all valid, and 3 valid pairs with exact pixels (with noisy ones 8
    # iterations can stop short on a flat cost, where any two LM
    # implementations part beyond the tolerance)
    err8 = 0.0
    R0_8 = lie.so3_exp(torch.tensor([0.02, -0.02, 0.01], device=dev)) @ R7
    start8 = lambda fix: (torch.tensor(1.0 if fix else 1.3, device=dev), R0_8, t7 + 0.05)
    for fix in (False, True):
        args8 = (*pairs7[fix][:4], valid7, pairs7[fix][4], ones7, *start8(fix), *consts7[:4], fix,
                 100.0)
        err8 = max(err8, check_sim3_lm(f"synthetic, fix_scale {fix}", args8)[0])
    for what, (x1b, x2b, uv1b, uv2b, is1b), vb in (
            ("4096 pairs all valid", pair_set(N4k, False), valid4k),
            ("3 valid pairs", pair_set(N7, False, exact=True), torch.arange(N7, device=dev) < 3)):
        err8 = max(err8, check_sim3_lm(what, (x1b, x2b, uv1b, uv2b, vb, is1b, None, *start8(False),
                                              *consts7[:4], False, 100.0))[0])
    args8 = (*pairs7[False][:4], valid7, pairs7[False][4], ones7, *start8(False), *consts7[:4],
             False, 100.0)
    record("sim3_lm_solve", err8, time_ms(lambda: k7.sim3_lm_solve(*args8)),
           time_ms(lambda: k7.sim3_lm_solve_plain(*args8), 3), *sim3_lm_work(valid7, k7.LM_ITERS),
           graph_us=graph_us(lambda: k7.sim3_lm_solve(*args8)),
           **device_kernels(lambda: k7.sim3_lm_solve(*args8), 1))
    results["sim3_lm_solve"]["closure_case_routed"] = k8_closure_case()
    # the scale powers: every site reading map_state.scale_power, card == CPU
    scale_power_check()

    # kernel 9: a stereo frame's match, SAD refinement, depth and acceptance,
    # every output (ur, depth, best, bestd, ok) bit for bit against its twin:
    # the VGA pair of frame 0 (the right camera 0.3 m along +x) at 1024 x 1024
    # keypoints, then constructed cases on a random uint8 pair shifted by 6 px
    import types

    from orb_slam2_annotate_tpu_torch.geometry.camera import undistort_pixels
    from orb_slam2_annotate_tpu_torch.kernels import remap as k10
    from orb_slam2_annotate_tpu_torch.kernels import stereo as k9
    from orb_slam2_annotate_tpu_torch.pipeline.frame import TH_STEREO

    t0 = time.perf_counter()
    cam_d, rights, depth_config = depth_setup(poses)
    print(f"render: {N_FRAMES} right frames in {time.perf_counter() - t0:.1f} s (host numpy)")
    scales9 = pyramid.level_scales(cfg.n_levels, cfg.scale, device=dev)
    names9 = ("ur", "depth", "best", "bestd", "ok")

    def k9_args(fl, fr, il, ir, th=TH_STEREO):
        x_und = undistort_pixels(cam_d, fl.xy)[:, 0].contiguous()
        return (fl.xy, fl.octave, fl.valid, fl.desc, fr.xy, fr.octave, fr.valid, fr.desc, x_und,
                il, ir, scales9, cam_d.fx, cam_d.bf, th)

    def check_stereo(what, args):
        got = k9.stereo_match(*args)
        ref = k9.stereo_match_plain(*args)
        torch.cuda.synchronize()
        moved = [n for n, a, b in zip(names9, got, ref) if not torch.equal(a, b)]
        if moved:
            fail(f"stereo_match ({what}): {moved} differ from the twin "
                 f"({int((got[4] != ref[4]).sum())} rows' ok, {int((got[2] != ref[2]).sum())} best)")
        print(f"stereo_match vs twin, {what}: N {args[0].shape[0]}, M {args[4].shape[0]}, every "
              f"output bit-exact; accepted {int(ref[4].sum())}, matched below th "
              f"{int((ref[3] < TH_STEREO).sum())}, no candidate {int((ref[3] == k9.NO_MATCH).sum())}")
        return ref

    il9 = torch.from_numpy(frames[0]).to(dev).float()
    ir9 = torch.from_numpy(rights[0]).to(dev).float()
    args9 = k9_args(extractor.extract(il9, tab, cfg), extractor.extract(ir9, tab, cfg), il9, ir9)
    out9 = check_stereo("the VGA pair of frame 0", args9)
    if int(out9[4].sum()) < 300:
        fail(f"stereo_match: only {int(out9[4].sum())} rows accepted on the VGA pair")

    def words(bits):
        """[n, 512] bool -> [n, 16] int32 words, bit k of word w at 32 w + k."""
        w = (bits.view(-1, 16, 32).long() << torch.arange(32, device=dev)).sum(-1)
        return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)

    def stereo_case(n, flips, xy_l=None, shift=6):
        """A random uint8 pair, the right image the left one shifted `shift` px
        left; n left keypoints (random, or xy_l), each with a right partner
        `shift` px left whose descriptor differs in flips[i] bits."""
        il = torch.randint(0, 256, (480, 640), generator=gen, device=dev).float()
        ir = torch.roll(il, -shift, 1)
        if xy_l is None:
            xy_l = torch.stack([10 + 620 * torch.rand(n, generator=gen, device=dev),
                                10 + 460 * torch.rand(n, generator=gen, device=dev)], 1)
        octv = torch.randint(0, cfg.n_levels, (n,), generator=gen, device=dev, dtype=torch.int32)
        desc = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 16), generator=gen, device=dev,
                             dtype=torch.int32)
        order = torch.rand(n, 512, generator=gen, device=dev).argsort(1)
        flip = words(order < flips[:, None])
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        fl = types.SimpleNamespace(xy=xy_l.contiguous(), octave=octv, valid=ones, desc=desc)
        fr = types.SimpleNamespace(xy=(xy_l - torch.tensor([float(shift), 0.0], device=dev))
                                   .contiguous(), octave=octv.clone(), valid=ones.clone(),
                                   desc=desc ^ flip)
        return fl, fr, il, ir

    rand_flips = lambda n, hi: torch.randint(0, hi, (n,), generator=gen, device=dev)
    cases9 = {}
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 256))
    cases9["random 1024 x 1024, distances 0-255"] = (fl, fr, il, ir)
    fl, fr, il, ir = stereo_case(512, rand_flips(512, 200))
    dup = types.SimpleNamespace(**{k: torch.cat([getattr(fr, k)] * 2).contiguous()
                                   for k in ("xy", "octave", "valid", "desc")})
    cases9["ties: every right keypoint twice (the first wins)"] = (fl, dup, il, ir)
    u = torch.rand(1024, 2, generator=gen, device=dev)
    half = torch.floor(torch.stack([10 + 620 * u[:, 0], 10 + 460 * u[:, 1]], 1)) + 0.5
    cases9["x.5 and y.5 centres"] = stereo_case(1024, rand_flips(1024, 200), half)
    side = lambda hi: torch.where(torch.rand(1024, generator=gen, device=dev) < 0.5,
                                  3 * torch.rand(1024, generator=gen, device=dev),
                                  hi - 3 * torch.rand(1024, generator=gen, device=dev))
    cases9["patches on the border"] = stereo_case(1024, rand_flips(1024, 200),
                                                  torch.stack([side(639.0), side(479.0)], 1))
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    fl.xy[:64, 1] = 2.0                                   # above every other keypoint's band
    fr.xy[:64, 1] = 400.0                                 # and their partners moved away
    cases9["64 rows without a candidate"] = (fl, fr, il, ir)
    # th 300 with rows not accepted: the median is the reference's 80, and
    # accepted rows above 2.1 x 80 = 168 go
    th_hi = (300, "th 300, 64 rows without a candidate: rows above 168 dropped")
    rows64 = torch.stack([10 + 600 * torch.rand(64, generator=gen, device=dev),
                          10 + 7 * torch.arange(64, device=dev).float()], 1)
    flips64 = rand_flips(64, 40)
    flips64[5] = 120
    cases9["every row accepted: the median gate bites"] = stereo_case(64, flips64, rows64)
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    fl.valid = torch.zeros_like(fl.valid)
    cases9["no valid left keypoint"] = (fl, fr, il, ir)
    # the row bands: partners exactly a row tolerance above or below, and a
    # quarter one float step further (not candidates); at octave 0 (tol 2)
    # y +- tol is exact in f32
    tol9 = 2.0 * scales9
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    fl.octave[:] = 0
    fr.octave[:] = 0
    t_r = tol9[fr.octave.long()]
    sign = torch.where(torch.rand(1024, generator=gen, device=dev) < 0.5, 1.0, -1.0)
    y_edge = fl.xy[:, 1] + sign * t_r
    y_out = torch.nextafter(y_edge, y_edge + sign)
    fr.xy[:, 1] = torch.where(torch.arange(1024, device=dev) % 4 == 3, y_out, y_edge)
    n_edge9 = int(((fl.xy[:, 1] - fr.xy[:, 1]).abs() == t_r).sum())
    cases9["partners exactly a row tolerance apart"] = (fl, fr, il, ir)
    # every keypoint at the top octave, partners spread over its whole band
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    fl.octave[:] = cfg.n_levels - 1
    fr.octave[:] = cfg.n_levels - 1
    fr.xy[:, 1] += (2 * torch.rand(1024, generator=gen, device=dev) - 1) * tol9[-1]
    cases9["the top octave: the widest band"] = (fl, fr, il, ir)
    # 64 left rows on 4 image rows, 1024 right keypoints on the same rows to
    # their left: ~256 candidates a row, more than a ballot's 32 and the
    # warp's list of 64
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    rows9 = torch.tensor([100.0, 200.0, 300.0, 400.0], device=dev)
    fl = types.SimpleNamespace(**{k: getattr(fl, k)[:64].clone() for k in ("xy", "octave", "valid",
                                                                          "desc")})
    fl.xy[:, 0], fl.xy[:, 1] = 600.0, rows9.repeat(16)
    fl.octave[:] = 0
    fr.xy[:, 0] = 100 + 490 * torch.rand(1024, generator=gen, device=dev)
    fr.xy[:, 1] = rows9.repeat(256) + torch.rand(1024, generator=gen, device=dev) - 0.5
    fr.octave[:] = 0
    fr.desc[:64] = fl.desc ^ words(torch.rand(64, 512, generator=gen, device=dev) < 0.1)
    cases9["crowded rows: ~256 candidates each"] = (fl, fr, il, ir)
    # keypoints on the first and last image rows and outside [0, H)
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    edge9 = torch.tensor([0.0, 479.0, -0.5, -3.0, 479.99, 480.0, 483.5, -1e6, 1e6], device=dev)
    fl.xy[:, 1] = edge9[torch.randint(0, len(edge9), (1024,), generator=gen, device=dev)]
    fr.xy[:, 1] = fl.xy[:, 1] + 3 * (torch.rand(1024, generator=gen, device=dev) - 0.5)
    cases9["rows at 0, H - 1 and outside the image"] = (fl, fr, il, ir)
    # ragged sizes: M not a multiple of 32, M = 1, N not a multiple of a CTA's rows
    fl, fr, il, ir = stereo_case(1024, rand_flips(1024, 200))
    cut = lambda f, n: types.SimpleNamespace(**{k: getattr(f, k)[:n].contiguous()
                                                for k in ("xy", "octave", "valid", "desc")})
    cases9["M = 1000"] = (fl, cut(fr, 1000), il, ir)
    triple = types.SimpleNamespace(**{k: torch.cat([getattr(fr, k)] * 3).contiguous()
                                      for k in ("xy", "octave", "valid", "desc")})
    cases9["M = 3072: each right keypoint three times (staging rounds, the first wins)"] = (
        fl, triple, il, ir)
    cases9["M = 1"] = (fl, cut(fr, 1), il, ir)
    cases9["N = 1021"] = (cut(fl, 1021), fr, il, ir)
    # the most right keypoints the CTA's shared memory stages (each partner
    # nine times over, the first wins), after its fixed part is held to the
    # built kernel's; one more is refused before the launch
    smem9 = _build.load("stereo").stereo_match_static_smem()
    if smem9 != k9.FIXED_SMEM:
        fail(f"stereo_match: the kernel's static shared memory is {smem9} B, "
             f"kernels/stereo.py FIXED_SMEM says {k9.FIXED_SMEM}")
    m9 = k9.max_right_keypoints(480, cfg.n_levels)
    fill = types.SimpleNamespace(**{k: torch.cat([getattr(fr, k)] * -(-m9 // 1024))[:m9 + 1]
                                    .contiguous() for k in ("xy", "octave", "valid", "desc")})
    cases9[f"M = {m9}, the shared-memory capacity at VGA"] = (fl, cut(fill, m9), il, ir)
    try:
        k9.stereo_match(*k9_args(fl, fill, il, ir))
    except ValueError:
        print(f"stereo_match: M = {m9 + 1} refused before the launch (capacity {m9} at VGA)")
    else:
        fail(f"stereo_match took M = {m9 + 1}, beyond its shared memory")
    for what, (fl, fr, il, ir) in cases9.items():
        ref = check_stereo(what, k9_args(fl, fr, il, ir))
        if what.startswith("64 rows"):
            hi = check_stereo(th_hi[1], k9_args(fl, fr, il, ir, th_hi[0]))
            above = (hi[3] > 168) & (hi[3] < th_hi[0])
            if bool((hi[4] & (hi[3] > 168)).any()) or not bool(above.any()):
                fail(f"stereo_match at th {th_hi[0]}: {int(above.sum())} rows in (168, "
                     f"{th_hi[0]}), {int((hi[4] & (hi[3] > 168)).sum())} of them accepted")
        if what.startswith("ties") and not bool((ref[2][ref[3] < k9.NO_MATCH] < 512).all()):
            fail("stereo_match: a tie in distance did not take the first index")
        if what.startswith("64 rows") and not (bool((ref[3][:64] == k9.NO_MATCH).all())
                                                and bool((ref[2][:64] == 0).all())):
            fail("stereo_match: a row without a candidate must give best 0, bestd 2048")
        if what.startswith("every row") and not (bool((ref[3] < TH_STEREO).all())
                                                  and 0 < int(ref[4].sum()) < 64):
            fail(f"stereo_match: the all-accepted case kept {int(ref[4].sum())} of 64 rows")
        if what.startswith("no valid") and bool(ref[4].any()):
            fail("stereo_match: a row without a valid keypoint was accepted")
        if (what.startswith(("M = 3072", f"M = {m9},"))
                and not bool((ref[2][ref[3] < k9.NO_MATCH] < 1024).all())):
            fail("stereo_match: a tie across staging rounds did not take the first index")
        if what.startswith("crowded") and int((ref[3] < TH_STEREO).sum()) < 32:
            fail("stereo_match: the crowded rows found too few matches")
    if n_edge9 < 500:
        fail(f"stereo_match: only {n_edge9} partners exactly a row tolerance apart")
    # the wrapper's host time by part: its checks (the rest of the call,
    # part by part, is tools/stereo_host_parts.py)
    host9 = host_parts("stereo_match", {
        "check_inputs": lambda: k9.check_inputs(*args9[:12], TH_STEREO, dev)})
    record("stereo_match", 0.0, time_ms(lambda: k9.stereo_match(*args9)),
           time_ms(lambda: k9.stereo_match_plain(*args9), 10), *stereo_work(args9, out9),
           bit_exact=True, cases=["the VGA pair of frame 0", *cases9, th_hi[1]],
           graph_us=graph_us(lambda: k9.stereo_match(*args9)), host_ns=host9,
           **device_kernels(lambda: k9.stereo_match(*args9), 1))

    # kernel 10: both images of a pair remapped in one launch, bit for bit
    # against its twin on a real distortion map (tests/test_rectify.py's K and
    # D at 640x480) and on identity maps, where it returns the images
    from orb_slam2_annotate_tpu_torch.geometry import rectify
    K10 = np.array([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]], np.float32)
    D10 = np.array([-0.28, 0.07, 1e-4, -2e-5, 0.0], np.float32)
    dist_map = rectify.rectify_map(K10, D10, np.eye(3), K10, 480, 640, dev)
    id_map = rectify.rectify_map(np.eye(3), np.zeros(5), np.eye(3), np.eye(3), 480, 640, dev)
    for what, maps in (("distortion map", (dist_map, dist_map + 0.37)),
                       ("identity maps", (id_map, id_map))):
        got = k10.remap_pair(il9, ir9, *maps)
        ref = k10.remap_pair_plain(il9, ir9, *maps)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"remap_pair ({what}) differs from its twin")
        if what == "identity maps" and not (torch.equal(got[0], il9) and torch.equal(got[1], ir9)):
            fail("remap_pair at identity maps does not return the images")
        print(f"remap_pair vs twin, {what}: bit-exact")
    args10 = (il9, ir9, dist_map, dist_map + 0.37)
    # a rectifier over the same distortion: its maps checked once, at construction
    eye10 = np.eye(3, dtype=np.float32)
    rect10 = rectify.StereoRectifier(K10, D10, eye10, K10, K10, D10, eye10, K10, 480, 640,
                                     device="cuda")
    if not all(torch.equal(a, b) for a, b in zip(
            rect10(il9, ir9), k10.remap_pair_plain(il9, ir9, rect10.map_l, rect10.map_r))):
        fail("StereoRectifier differs from kernel 10's twin on its own maps")
    # one PyTorch call: grid_sample of both images on the maps normalised to [-1, 1]
    scale10 = torch.tensor([2.0 / 639, 2.0 / 479], device=dev)
    grid10 = torch.stack([args10[2], args10[3]]) * scale10 - 1.0
    img10 = torch.stack([il9, ir9])[:, None]
    library10 = lambda: torch.nn.functional.grid_sample(img10, grid10, mode="bilinear",
                                                        padding_mode="zeros", align_corners=True)
    lib_err = float((library10()[:, 0] - torch.stack(k10.remap_pair(*args10))).abs().max())
    record("remap_pair", 0.0, time_ms(lambda: k10.remap_pair(*args10)),
           time_ms(lambda: k10.remap_pair_plain(*args10), 10),
           2 * 480 * 640 * REMAP_BYTES_PER_PIXEL, 2 * 480 * 640 * REMAP_OPS_PER_PIXEL,
           bit_exact=True, graph_us=graph_us(lambda: k10.remap_pair(*args10)),
           library="torch.nn.functional.grid_sample, bilinear, zeros, align_corners=True, both "
                   "images as a batch of two", library_max_abs_diff=lib_err,
           **device_kernels(lambda: k10.remap_pair(*args10), 1))
    # the wrapper's host time by part: its checks (tools/stereo_host_parts.py
    # times the rest)
    host10 = host_parts("remap_pair", {
        "check_maps": lambda: k10.check_maps(args10[2], args10[3], dev),
        "check_images": lambda: k10.check_images(il9, ir9, dev)})
    results["remap_pair"].update(library_ms=time_ms(library10), library_graph_us=graph_us(library10),
                                 rectifier_ms=time_ms(lambda: rect10(il9, ir9)), host_ns=host10)
    r10 = results["remap_pair"]
    print(f"remap_pair against grid_sample on the 100-call clock, same run: remap_pair "
          f"{r10['ms']:.4f} ms, StereoRectifier.__call__ {r10['rectifier_ms']:.4f} ms, "
          f"grid_sample {r10['library_ms']:.4f} ms a call; replayed {r10['graph_us']:.2f} us "
          f"against {r10['library_graph_us']:.2f} us")
    # the same clock in turns, 7 rounds: the host is shared, so one round is noisy
    turns = {"remap_pair": lambda: k10.remap_pair(*args10),
             "StereoRectifier.__call__": lambda: rect10(il9, ir9), "grid_sample": library10,
             "stereo_match": lambda: k9.stereo_match(*args9)}
    rounds = {k: [] for k in turns}
    for _ in range(7):
        for k, fn in turns.items():
            rounds[k].append(time_ms(fn))
    r10["ms_in_turns"] = {k: statistics.median(v) for k, v in rounds.items()}
    results["stereo_match"]["ms_in_turns"] = r10["ms_in_turns"]["stereo_match"]
    print(f"100-call ms a call, median of 7 rounds in turns: "
          f"{json.dumps({k: round(v, 5) for k, v in r10['ms_in_turns'].items()})}; all rounds "
          f"{json.dumps({k: [round(x, 5) for x in v] for k, v in rounds.items()})}")

    # kernel 12 (local BA's grid LM) on the synthetic cases of tests/_grid_ba_cases.py at
    # full width, and a whole solve's times on the first; the local-BA problems captured
    # in phases 4 and 7 follow their runs
    gba_cases = grid_ba_synthetic(dev)
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as _Cam
    gba_syn = grid_ba_cases()
    g_syn, cam_syn = grid_on(gba_syn["grid_problem"](12, *GBA_CASE_SIZE), dev), _Cam.create(
        **gba_syn["CAM"])
    gba_syn_times = {f"{iters} iterations": grid_ba_times(cam_syn, g_syn, iters) for iters in (4, 6)}
    print(f"grid_ba on the synthetic grid (C, N, P = {GBA_CASE_SIZE}): {json.dumps(gba_syn_times)}, "
          f"card {card}")

    launches3 = read_launches()
    print(f"launches in phase 3's checks and timings: {json.dumps(launches3)}")

    def drive(name, slam, images, counted, track=lambda slam, img, ts: slam.track_mono(img, ts),
              sync=True):
        """One main-path run: counters zeroed just before, read just after;
        fails unless every kernel in `counted` was launched.  A frame's time
        ends in a device synchronize, or, with `sync` off, when its call
        returns (the run then ends in ``flush()`` and a synchronize)."""
        zero_launches()
        torch.cuda.synchronize()
        out, frame_s = [], []
        for k, img in enumerate(images):
            t0 = time.perf_counter()
            out.append(track(slam, img, k / 30.0))
            if sync:
                torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        if not sync:
            t0 = time.perf_counter()
            slam.flush()
            torch.cuda.synchronize()
            frame_s[-1] += time.perf_counter() - t0
        launches = read_launches()
        print(f"launches in the {name} run: {json.dumps(launches)}")
        print(f"{name}: frame wall time median {1e3 * statistics.median(frame_s):.2f} ms, "
              f"max {1e3 * max(frame_s):.2f} ms (frame {frame_s.index(max(frame_s))})")
        idle = [n for n in counted if launches[n] == 0]
        if idle:
            fail(f"{name}: kernels never launched: {idle}")
        return out, frame_s, launches

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 4", flush=True)
    # ---- phase 4: the mono System through System.track_mono
    base4 = torch.cuda.memory_allocated()     # what earlier phases still hold
    slam = System(cam, slice_cfg, device="cuda")
    real_opt = pose_opt.optimize_pose
    lm_calls, captured_lm = [0], {}

    def count_opt(c_, R0, t0, obs, *a, **kw):
        # counts optimize_pose calls; keeps the edges of one local-map call
        # from the second half of the slice for the comparison below
        lm_calls[0] += 1
        if (sys._getframe(1).f_code.co_name == "track_local_map" and "args" not in captured_lm
                and slam.frame_id >= N_FRAMES // 2):
            captured_lm["args"] = (c_, R0[None].clone(), t0[None].clone(), obs.xw[None].clone(),
                                   obs.uv.clone(), obs.ur.clone(), obs.inv_sigma2.clone(),
                                   obs.valid[None].clone())
        return real_opt(c_, R0, t0, obs, *a, **kw)

    # matcher calls, and the matcher launches inside each keyframe-chain
    # triangulation and each relocalization attempt
    real_match, real_tri = matching.match_gated, local_mapping.create_new_mappoints
    real_reloc = tracking.relocalize_candidates
    match_calls, tri_launches, reloc_launches = [0], [], []

    def count_match(*a, **kw):
        match_calls[0] += 1
        return real_match(*a, **kw)

    def matcher_launches_in(fn, into):
        def run(*a, **kw):
            n0 = k3.hamming_match.launches
            out = fn(*a, **kw)
            into.append(k3.hamming_match.launches - n0)
            return out
        return run

    # map-point stats refreshes (one kernel-3b launch each); the table of one
    # from the second half of the slice is kept for the comparison below
    real_stats, stats_calls, refresh_counts = map_state._stats_from_table, [0], []

    def count_stats(m, pos, obs_kf, obs_ft, obs_cnt, obs_mask):
        stats_calls[0] += 1
        refresh_counts.append(obs_cnt.clone())
        if "table" not in captured_lm and slam.frame_id >= N_FRAMES // 2:
            captured_lm["table"] = (m.kf_desc.clone(), obs_kf.clone(), obs_ft.clone(), obs_cnt.clone())
        return real_stats(m, pos, obs_kf, obs_ft, obs_cnt, obs_mask)

    # local BA's solves (one kernel-12 launch each); the two of one keyframe from the
    # second half of the slice are kept for the checks below
    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12
    from orb_slam2_annotate_tpu_torch.solvers import ba_core
    real_gba, gba_calls, kept_gba = ba_core.bundle_adjust_grid, [0], {}

    def keep_grid_ba(frame_min, into, stereo=False):
        def run(c_, g, iters=10, *a, **kw):
            gba_calls[0] += 1
            frame = into.get("slam").frame_id if into.get("slam") else 0
            want = (iters not in into and frame >= frame_min and (iters == 4 or 4 in into)
                    and (not stereo or bool(((g.ur >= 0) & g.edge_valid).any())))
            if want:
                into[iters] = (c_, grid_clone(g))
            return real_gba(c_, g, iters, *a, **kw)
        return run

    # tracking steps, for phase 15(d)'s telemetry counts
    real_track, track_calls = tracking.track_frame, [0]

    def count_track(*a, **kw):
        track_calls[0] += 1
        return real_track(*a, **kw)

    pose_opt.optimize_pose = count_opt
    matching.match_gated = count_match
    map_state._stats_from_table = count_stats
    kept_gba["slam"] = slam
    ba_core.bundle_adjust_grid = keep_grid_ba(N_FRAMES // 2, kept_gba)
    local_mapping.create_new_mappoints = matcher_launches_in(real_tri, tri_launches)
    tracking.relocalize_candidates = matcher_launches_in(real_reloc, reloc_launches)
    tracking.track_frame = count_track
    lm_calls[0] = 0
    slice_kernels = [w for n, (_, _, w) in SOURCES.items()
                     if n not in ("pnp_hypotheses",) + LOOP_ONLY + STEREO_ONLY + SOLVE_ONLY + DENSE_ONLY]
    torch.cuda.reset_peak_memory_stats()
    try:
        _, frame_s, launches4 = drive("slice", slam, frames, slice_kernels)
    finally:
        tracking.track_frame = real_track
        ba_core.bundle_adjust_grid = real_gba
    gba4 = gba_calls[0]
    peak4 = torch.cuda.max_memory_allocated() - base4
    from orb_slam2_annotate_tpu_torch import convert
    traj4, map4 = slam.frame_trajectory(), convert.map_state_to_numpy(slam.map)
    calls4, match_calls4, tri4 = lm_calls[0], match_calls[0], list(tri_launches)
    stats4 = stats_calls[0]
    counts4 = list(refresh_counts)
    print(f"slice: matcher calls {match_calls4}, matcher launches per triangulation {tri4}")
    wall = sum(frame_s)
    ate, n_tracked = ate_of(slam, poses, range(N_FRAMES))
    print(f"slice: {N_FRAMES} frames in {wall:.2f} s = {N_FRAMES / wall:.2f} frames/s, "
          f"ATE {ate:.5f} m, tracked {n_tracked}/{N_FRAMES}, keyframes {slam.n_keyframes} "
          f"(culled {int(slam.map.n_kf) - slam.n_keyframes}), "
          f"map points {slam.n_mappoints}, state {slam.state}, optimize_pose calls {calls4}, "
          f"card {card}")
    checks = {"state OK": slam.state == "OK", "tracked >= 70%": n_tracked >= 0.7 * N_FRAMES,
              "keyframes >= 3": slam.n_keyframes >= 3, "map points > 100": slam.n_mappoints > 100,
              f"ATE < {ATE_BOUND}": ate < ATE_BOUND,
              "one pose_lm_solve launch per optimize_pose": launches4["optimize_pose_batched"] == calls4,
              "one fast_nms launch per frame": launches4["fast_nms"] == N_FRAMES,
              "one orb_describe call per frame": launches4["orb_describe"] == N_FRAMES,
              "one hamming_match launch per matcher call": launches4["hamming_match"] == match_calls4,
              "one matcher launch per triangulation": len(tri4) > 0 and set(tri4) == {1},
              "one distinctive_descriptors launch per stats refresh":
                  stats4 > 0 and launches4["distinctive_descriptors"] == stats4,
              "one grid_ba_solve launch per bundle_adjust_grid call":
                  gba4 > 0 and launches4["grid_ba_solve"] == gba4,
              "a keyframe's two local-BA solves captured": 4 in kept_gba and 6 in kept_gba,
              "a local-map call captured": "args" in captured_lm,
              "a stats table captured": "table" in captured_lm}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"slice checks failed: {bad}")
    slice_out = {"frames_per_s": N_FRAMES / wall, "peak_mb": peak4 / 2**20, "ate_m": ate,
                 "tracked": n_tracked,
                 "keyframes": slam.n_keyframes, "map_points": slam.n_mappoints,
                 "optimize_pose_calls": calls4, "matcher_calls": match_calls4,
                 "triangulations": len(tri4), "stats_refreshes": stats4, "local_ba_solves": gba4}
    kf_desc_c, *table_c = captured_lm["table"]
    err3b = max(err3b, check_distinctive("table of a keyframe-chain refresh", kf_desc_c, table_c))
    results["distinctive_descriptors"]["max_abs_err"] = float(err3b)
    results["distinctive_descriptors"]["captured"] = {
        "Q": table_c[0].shape[0],
        "ms": time_ms(lambda: k3.distinctive_descriptors(kf_desc_c, *table_c)),
        "graph_us": graph_us(lambda: k3.distinctive_descriptors(kf_desc_c, *table_c)),
        "bound_ms": bound(*distinctive_work(table_c))[0],
        "counts_histogram": torch.bincount(table_c[2].long(), minlength=33).tolist()}
    args_lm = captured_lm["args"]
    err4 = max(err4, check_pose_lm("captured local-map call", args_lm))
    record("pose_lm_solve", err4, time_ms(lambda: k4.optimize_pose_batched(*args_lm)),
           time_ms(lambda: k4.optimize_pose_batched_plain(*args_lm), 10),
           *pose_lm_work(args_lm[3], args_lm[5], args_lm[7]), **pose_b8,
           graph_us=graph_us(lambda: k4.optimize_pose_batched(*args_lm)),
           **device_kernels(lambda: k4.optimize_pose_batched(*args_lm), 1))
    # kernel 12 on the keyframe's two captured local-BA solves, then timed on them
    cam_g, g4 = kept_gba[4]
    cam_g6, g6 = kept_gba[6]
    gba_cases["phase 4 slice, 4 iterations"] = grid_ba_check("phase 4 slice, 4 iterations", cam_g,
                                                             g4, 4)
    gba_cases["phase 4 slice, 6 iterations"] = grid_ba_check("phase 4 slice, 6 iterations", cam_g6,
                                                             g6, 6)
    grid_ba_require(gba_cases)
    t4, t6 = grid_ba_times(cam_g, g4, 4), grid_ba_times(cam_g6, g6, 6)
    err12 = max(max(o["whole"]["R"], o["whole"]["t"]) for o in gba_cases.values())
    record("grid_ba", err12, t4["ms"], t4["plain_ms"], t4["bytes"], t4["ops"],
           graph_us=t4["graph_us"], device_launches_per_call=t4["device_launches_per_call"],
           device_ops=t4["device_ops"], six_iterations=t6, synthetic=gba_syn_times,
           captured={"C": int(g4.pt_loc.shape[0]), "N": int(g4.pt_loc.shape[1]),
                     "P": int(g4.points.shape[0]), "valid_slots": gba_cases[
                         "phase 4 slice, 4 iterations"]["valid_slots"]},
           cases={k: {"whole": o["whole"], "linearization": o["linearization"],
                      "solve": o["solve"]} for k, o in gba_cases.items()})
    print(f"grid_ba on the slice's local BA: 4 iterations {json.dumps(t4)}; 6 iterations "
          f"{json.dumps(t6)}, card {card}")

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 5", flush=True)
    # ---- phase 5: kidnapped run; the jump frame must relocalize
    t0 = time.perf_counter()
    gt5, seq, images5 = kidnap_setup(cam)
    print(f"render: {len(seq)} frames in {time.perf_counter() - t0:.1f} s (host numpy)")
    slam5 = System(cam, slice_cfg, device="cuda")
    relocs, captured, polish_sizes = [], {}, []
    try_reloc = slam5._try_relocalize
    slam5._try_relocalize = lambda f: relocs.append((slam5.frame_id, try_reloc(f))) or relocs[-1][1]
    real_hyp, real_polish = pnp_mod.pnp_hypotheses, pnp_mod.optimize_pose_batched

    def keep_inputs(*a):
        # the relocalization's own kernel-6 inputs, for the comparison below
        captured.setdefault("args", tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real_hyp(*a)

    def keep_polish(*a):
        # the relocalization's batch of polished candidates (one kernel-4 call)
        polish_sizes.append(a[1].shape[0])
        captured.setdefault("polish", tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real_polish(*a)

    pnp_mod.pnp_hypotheses, pnp_mod.optimize_pose_batched = keep_inputs, keep_polish
    lm_calls[0], match_calls[0] = 0, 0
    reloc_launches.clear()
    try:
        out5, frame_s5, launches5 = drive("kidnap", slam5, images5,
                                          [w for n, (_, _, w) in SOURCES.items()
                                           if n not in LOOP_ONLY + STEREO_ONLY + SOLVE_ONLY + DENSE_ONLY])
    finally:
        pnp_mod.pnp_hypotheses, pnp_mod.optimize_pose_batched = real_hyp, real_polish
        pose_opt.optimize_pose = real_opt
        map_state._stats_from_table = real_stats
        matching.match_gated, local_mapping.create_new_mappoints = real_match, real_tri
        tracking.relocalize_candidates = real_reloc
    calls5, match_calls5 = lm_calls[0], match_calls[0]
    # the observation counts kernel 3b saw on the main path, summed over the
    # refreshes of each run (the median's cost grows with the count)
    seen = {}
    for run, tabs in (("slice", counts4), ("kidnap", refresh_counts[len(counts4):])):
        hist = torch.stack([torch.bincount(c.long(), minlength=33) for c in tabs]).sum(0).tolist()
        seen[run] = {"refreshes": len(tabs), "counts_histogram": hist,
                     "max_count": max(i for i, n in enumerate(hist) if n) if any(hist) else 0}
        print(f"{run}: distinctive_descriptors counts over {len(tabs)} refreshes: {hist}")
    results["distinctive_descriptors"]["main_path_counts"] = seen
    print(f"kidnap: matcher calls {match_calls5}, matcher launches per relocalization attempt "
          f"{reloc_launches}")
    ate5, n5 = ate_of(slam5, gt5, seq)
    print(f"kidnap: {len(seq)} frames in {sum(frame_s5):.2f} s = {len(seq) / sum(frame_s5):.2f} "
          f"frames/s, jump frame {1e3 * frame_s5[KIDNAP_SWEEP]:.2f} ms, relocalizations "
          f"(frame, success) {relocs}, polished batches {polish_sizes}, ATE {ate5:.5f} m, tracked "
          f"{n5}/{len(seq)}, keyframes {slam5.n_keyframes} "
          f"(culled {int(slam5.map.n_kf) - slam5.n_keyframes}), optimize_pose calls {calls5}, "
          f"state {slam5.state}, observation overflow {slam5.observation_overflow}, card {card}")
    checks = {"jump frame relocalized": (KIDNAP_SWEEP, True) in relocs,
              "jump frame returns a pose": out5[KIDNAP_SWEEP] is not None,
              "state OK": slam5.state == "OK", f"ATE < {ATE_BOUND}": ate5 < ATE_BOUND,
              "a relocalization polish ran": len(polish_sizes) > 0,
              "one fast_nms launch per frame": launches5["fast_nms"] == len(seq),
              "one orb_describe call per frame": launches5["orb_describe"] == len(seq),
              "one hamming_match launch per matcher call": launches5["hamming_match"] == match_calls5,
              "one matcher launch per relocalization attempt":
                  len(reloc_launches) > 0 and set(reloc_launches) == {1},
              "one pnp_hypotheses launch per relocalization attempt":
                  launches5["pnp_hypotheses"] == len(reloc_launches),
              "one pose_lm_solve launch per optimize_pose and per polish":
                  launches5["optimize_pose_batched"] == calls5 + len(polish_sizes)}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"kidnap checks failed: {bad}")
    # kernel 6 on the relocalization's own inputs: counts equal on every
    # hypothesis, so each candidate's first best is equal too; the best R and
    # t within 1e-5; and, as the kernel and its twin sum in one order, every
    # output bit for bit
    args6 = captured["args"]
    samples6, xw6, uv6, v6 = args6[:4]
    C6, S6 = samples6.shape[:2]
    if (C6, S6) != (8, 256) or xw6.shape[1] != slice_cfg.n_features:
        fail(f"pnp_hypotheses inputs of shape {tuple(samples6.shape)} / {tuple(xw6.shape)}")
    got6 = k6.pnp_hypotheses(*args6)
    ref6 = k6.pnp_hypotheses_plain(*args6)
    torch.cuda.synchronize()
    if not torch.equal(got6[2], ref6[2]):
        fail(f"pnp_hypotheses counts differ from the twin's on {int((got6[2] != ref6[2]).sum())} "
             f"hypotheses")
    top2 = torch.topk(ref6[2], 2, dim=1).values
    if not torch.equal(got6[3], ref6[3]):
        fail(f"pnp_hypotheses best differs: {got6[3].tolist()} vs {ref6[3].tolist()}")
    cr6 = torch.arange(C6, device=dev)
    err6 = max(float((got6[0][cr6, got6[3]] - ref6[0][cr6, ref6[3]]).abs().max()),
               float((got6[1][cr6, got6[3]] - ref6[1][cr6, ref6[3]]).abs().max()))
    if err6 > 1e-5:
        fail(f"pnp_hypotheses: the best R or t differs from the twin's by {err6:.3g}")
    if not all(torch.equal(a, b) for a, b in zip(got6, ref6)):
        fail("pnp_hypotheses: R, t, counts or best not bit for bit the twin's")
    print(f"pnp_hypotheses vs twin: every output bit-exact, best {got6[3].tolist()}, top two "
          f"counts {top2.tolist()}")
    record("pnp_hypotheses", err6, time_ms(lambda: k6.pnp_hypotheses(*args6)),
           time_ms(lambda: k6.pnp_hypotheses_plain(*args6), 3),
           8 * samples6.numel() + 4 * (xw6.numel() + uv6.numel()) + v6.numel()
           + C6 * S6 * 4 * (9 + 3 + 1) + 8 * C6,
           PNP_DLT_OPS * C6 * S6 + PNP_OPS_PER_REPROJECTION * S6 * float(v6.sum()),
           graph_us=graph_us(lambda: k6.pnp_hypotheses(*args6)),
           **device_kernels(lambda: k6.pnp_hypotheses(*args6), 1))
    err_polish = check_pose_lm("relocalization polish batch", captured["polish"],
                               min_inliers=RELOC_MIN_INLIERS)
    results["pose_lm_solve"]["max_abs_err"] = max(results["pose_lm_solve"]["max_abs_err"], err_polish)
    results["pose_lm_solve"]["reloc_batch"] = polish_sizes
    args_polish = captured["polish"]
    results["pose_lm_solve"]["polish"] = {
        "edges": int(args_polish[7].sum()),
        "ms": time_ms(lambda: k4.optimize_pose_batched(*args_polish)),
        "graph_us": graph_us(lambda: k4.optimize_pose_batched(*args_polish)),
        "bound_ms": bound(*pose_lm_work(args_polish[3], args_polish[5], args_polish[7]))[0]}
    print(f"pose_lm_solve on the polish batch: {json.dumps(results['pose_lm_solve']['polish'])}")

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 6", flush=True)
    # ---- phase 6: a loop with SlamConfig()'s own defaults (loop closing on)
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.solvers import sim3 as sim3_mod

    t0 = time.perf_counter()
    cam6, gt6, images6, depths6, loop_cfg = loop_setup()
    print(f"render: {LOOP_FRAMES} frames in {time.perf_counter() - t0:.1f} s (host numpy)")
    slam6 = System(cam6, loop_cfg, device="cuda")
    lc6 = slam6.loop_closer
    stage_ms = {k: [] for k in ("loop/detect", "loop/sim3", "loop/correct", "loop/pose_graph",
                                "loop/gba", "loop/fold")}
    calls6 = {"sim3_ransac": 0, "optimize_sim3": 0}
    k3_in = {"sim3_guided_match": [], "loop_projection_count": [], "fuse_points_into": []}
    captured6, closures = {}, []
    # the plain Horn, Jacobi and score: the CUDA path must call none of them
    plain6 = {name: 0 for name in ("horn_sim3", "jacobi_eig4", "sim3_score_plain")}

    def timed(name, fn):
        # the stage's host wall time, the card drained before and after
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_ms[name].append(1e3 * (time.perf_counter() - t))
            return out
        return run

    def counted(name, fn):
        def run(*a, **kw):
            calls6[name] += 1
            return fn(*a, **kw)
        return run

    latest6 = {}

    def keep(name, fn):
        # the first call's inputs and the latest, for the comparison below
        def run(*a, **kw):
            latest6[name] = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
            captured6.setdefault(("first", name), latest6[name])
            return fn(*a, **kw)
        return run

    real_fold, real_resolve = lc6.maybe_fold_gba, lc6.resolve_detection

    def fold(m, force=False):
        n0 = lc6.n_gba_folded
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_fold(m, force)
        torch.cuda.synchronize()
        if lc6.n_gba_folded > n0:
            stage_ms["loop/fold"].append(1e3 * (time.perf_counter() - t))
            fold_frames6.append(slam6.frame_id)
        return out

    def resolve(m, slot, det):
        out = real_resolve(m, slot, det)
        if out[1]:
            closures.append(slam6.frame_id)
            # the closing attempt's last launch of each: its pair-set RANSAC
            # and its second optimize_sim3
            for name in (*LOOP_ONLY, "sim3_from_samples"):
                captured6.setdefault(("closure", name), latest6[name])
        return out

    real_gba6, gba6 = lc6._dispatch_global_ba, {}
    GBA_OUT = ("R", "t", "X", "cost")
    gba_frames6, fold_frames6 = [], []

    def keep_gba(m, anchor):
        # the map and anchor of the run's first global BA, for phase 15, and
        # what it returned, for the repeat below
        first = "map" not in gba6
        if first:
            gba6["map"] = map_state.MapState(**{f.name: getattr(m, f.name).clone()
                                                for f in dataclasses.fields(map_state.MapState)})
            gba6["anchor"] = int(anchor)
        real_gba6(m, anchor)
        gba_frames6.append(slam6.frame_id)
        if first:
            gba6["result"] = {k: lc6._gba_pending[k].clone() for k in GBA_OUT}

    def keep_pose_graph(fn):
        # the closure's essential graph, for kernel 11's check
        def run(prob, *a, **kw):
            gba6.setdefault("pose_graph", type(prob)(**{
                f.name: getattr(prob, f.name).clone() for f in dataclasses.fields(prob)}))
            return fn(prob, *a, **kw)
        return run

    lc6._dispatch_global_ba = keep_gba
    lc6.dispatch_detection = timed("loop/detect", lc6.dispatch_detection)
    lc6._compute_sim3 = timed("loop/sim3", lc6._compute_sim3)
    lc6._correct_loop = timed("loop/correct", lc6._correct_loop)
    lc6._dispatch_global_ba = timed("loop/gba", lc6._dispatch_global_ba)
    lc6.maybe_fold_gba, lc6.resolve_detection = fold, resolve
    saved = (sim3_mod.sim3_ransac, sim3_mod.optimize_sim3, sim3_mod.sim3_ransac_solve,
             sim3_mod.sim3_lm_solve, loop_mod.sim3_guided_match, loop_mod.loop_projection_count,
             local_mapping.fuse_points_into, matching.match_gated, loop_mod.optimize_pose_graph,
             loop_mod.optimize_pose_graph_cg, sim3_mod.sim3_from_samples)
    sim3_mod.sim3_ransac = counted("sim3_ransac", saved[0])
    sim3_mod.optimize_sim3 = counted("optimize_sim3", saved[1])
    sim3_mod.sim3_ransac_solve = keep("sim3_ransac_solve", saved[2])
    sim3_mod.sim3_lm_solve = keep("sim3_lm_solve", saved[3])
    sim3_mod.sim3_from_samples = keep("sim3_from_samples", saved[10])
    saved_plain = {name: getattr(k7, name) for name in plain6}

    def plain_counted(name, fn):
        def run(*a, **kw):
            plain6[name] += 1
            return fn(*a, **kw)
        return run

    for name, fn in saved_plain.items():
        setattr(k7, name, plain_counted(name, fn))
    loop_mod.sim3_guided_match = matcher_launches_in(saved[4], k3_in["sim3_guided_match"])
    loop_mod.loop_projection_count = matcher_launches_in(saved[5], k3_in["loop_projection_count"])
    local_mapping.fuse_points_into = matcher_launches_in(saved[6], k3_in["fuse_points_into"])
    matching.match_gated = count_match
    loop_mod.optimize_pose_graph = timed("loop/pose_graph", keep_pose_graph(saved[8]))
    loop_mod.optimize_pose_graph_cg = timed("loop/pose_graph", keep_pose_graph(saved[9]))
    match_calls[0] = 0
    try:
        _, frame_s6, launches6 = drive("loop", slam6, images6,
                                       [w for n, (_, _, w) in SOURCES.items()
                                        if n not in ("pnp_hypotheses",) + STEREO_ONLY + DENSE_ONLY])
    finally:
        (sim3_mod.sim3_ransac, sim3_mod.optimize_sim3, sim3_mod.sim3_ransac_solve,
         sim3_mod.sim3_lm_solve, loop_mod.sim3_guided_match, loop_mod.loop_projection_count,
         local_mapping.fuse_points_into, matching.match_gated, loop_mod.optimize_pose_graph,
         loop_mod.optimize_pose_graph_cg, sim3_mod.sim3_from_samples) = saved
        for name, fn in saved_plain.items():
            setattr(k7, name, fn)
    match_calls6 = match_calls[0]
    ate6, n6 = ate_of(slam6, gt6, range(LOOP_FRAMES))       # flushes: folds a pending BA
    ate_bound6 = max(1.5 * LOOP_ATE_JAX, LOOP_ATE_JAX + 0.05)
    # the correction's span without the global BA it dispatches
    correct_ms = [c - g for c, g in zip(stage_ms["loop/correct"], stage_ms["loop/gba"])]
    stage_ms["loop/correct"] = correct_ms
    closure_ms = [1e3 * frame_s6[f] for f in closures]
    print(f"loop: {LOOP_FRAMES} frames in {sum(frame_s6):.2f} s, frame wall time median "
          f"{1e3 * statistics.median(frame_s6):.2f} ms, max {1e3 * max(frame_s6):.2f} ms (frame "
          f"{frame_s6.index(max(frame_s6))}), closure frames {closures} at {closure_ms} ms; loops "
          f"closed {lc6.n_loops_closed}, global BAs dispatched {lc6.n_gba_dispatched} (frames "
          f"{gba_frames6}), folded {lc6.n_gba_folded} (frames {fold_frames6}); ATE {ate6:.5f} m (bound {ate_bound6:.5f}, JAX {LOOP_ATE_JAX}), tracked "
          f"{n6}/{LOOP_FRAMES}, keyframes {slam6.n_keyframes}, map points {slam6.n_mappoints}, state "
          f"{slam6.state}; sim3_ransac calls {calls6['sim3_ransac']}, optimize_sim3 calls "
          f"{calls6['optimize_sim3']}, matcher calls {match_calls6}, kernel-3 launches per call "
          f"{json.dumps(k3_in)}, card {card}")
    print(f"loop stage times, ms (host wall time, the card drained around each): "
          f"{json.dumps({k: [round(v, 3) for v in vs] for k, vs in stage_ms.items()})}")
    stage_sums = {k: {"calls": len(vs), "total_ms": sum(vs),
                      "median_ms": statistics.median(vs) if vs else None}
                  for k, vs in stage_ms.items()}
    print(f"loop stage totals and medians, ms: {json.dumps(stage_sums)}; plain Horn / Jacobi / "
          f"score calls in the run: {json.dumps(plain6)}")
    checks = {"a loop closed": lc6.n_loops_closed >= 1,
              "a global BA dispatched and folded": lc6.n_gba_dispatched >= 1 and lc6.n_gba_folded >= 1,
              "tracked >= 60%": n6 >= 0.6 * LOOP_FRAMES, "state OK": slam6.state == "OK",
              f"ATE <= {ate_bound6:.4f}": ate6 <= ate_bound6,
              "one sim3_ransac_solve launch per sim3_ransac":
                  calls6["sim3_ransac"] > 0 and launches6["sim3_ransac_solve"] == calls6["sim3_ransac"],
              "no plain Horn, Jacobi or score on the CUDA path": not any(plain6.values()),
              "one sim3_lm_solve launch per optimize_sim3":
                  calls6["optimize_sim3"] > 0 and launches6["sim3_lm_solve"] == calls6["optimize_sim3"],
              "one hamming_match launch per matcher call": launches6["hamming_match"] == match_calls6,
              "one matcher launch per guided match / projection count / SearchAndFuse":
                  all(len(v) > 0 and set(v) == {1} for v in k3_in.values()),
              "one fast_nms launch per frame": launches6["fast_nms"] == LOOP_FRAMES,
              "kernel inputs captured": len(captured6) == 6}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"loop checks failed: {bad}")
    # kernels 7 and 8 on the inputs the loop gave them: the run's first
    # launch of each, and the closing attempt's last
    for when in ("first", "closure"):
        a7 = captured6[(when, "sim3_ransac_solve")]
        e7, refined7, out7 = check_sim3_ransac(f"the loop's {when} Sim3 RANSAC input", a7)
        a8 = captured6[(when, "sim3_lm_solve")]
        e8, _ = check_sim3_lm(f"the loop's {when} optimize_sim3 input", a8)
        r7, r8 = results["sim3_ransac_solve"], results["sim3_lm_solve"]
        r7["max_abs_err"], r8["max_abs_err"] = max(r7["max_abs_err"], e7), max(r8["max_abs_err"], e8)
        # the whole sim3_ransac after its draw is this one device kernel
        af = captured6[(when, "sim3_from_samples")]
        r7[f"captured_{when}"] = {
            "H": a7[0].shape[0], "N": a7[1].shape[0], "valid": int(a7[5].sum()), "bit_exact": True,
            "refined_kept": refined7, "n": int(out7[4]),
            "ms": time_ms(lambda: k7.sim3_ransac_solve(*a7)),
            "graph_us": graph_us(lambda: k7.sim3_ransac_solve(*a7)),
            "bound_ms": bound(*sim3_hyp_work(a7[0], a7[5], float(out7[6][out7[7]])))[0],
            "sim3_from_samples": device_kernels(lambda: sim3_mod.sim3_from_samples(*af), 1)}
        r8[f"captured_{when}"] = {
            "N": a8[0].shape[0], "valid": int(a8[4].sum()),
            "ms": time_ms(lambda: k7.sim3_lm_solve(*a8)),
            "graph_us": graph_us(lambda: k7.sim3_lm_solve(*a8)),
            "bound_ms": bound(*sim3_lm_work(a8[4], a8[16]))[0]}
    print(f"kernels 7 and 8 on the loop's inputs: "
          f"{json.dumps({n: {k: v for k, v in results[n].items() if k.startswith('captured')} for n in LOOP_ONLY})}")

    # phase 6 again: the same cell in a second System of this process, bit for
    # bit the first run's trajectory, map and global BA.  The fold of a global
    # BA waits for the card (a BA still running folds at a later keyframe), so
    # the card is drained after each dispatch, as the first run's stage timing
    # drains it, and both fold at the closing keyframe.
    from orb_slam2_annotate_tpu_torch import convert

    def traj_bits(slam):
        return np.stack([np.full((4, 4), np.nan, np.float32) if T is None else T
                         for _, T in slam.frame_trajectory()])     # flushes: folds a pending BA

    def bits_of(a):
        a = np.asarray(a)
        return a.view(np.int32) if a.dtype == np.float32 else a

    def fields_differ(a: dict, b: dict):
        return [k for k in b if not np.array_equal(bits_of(a[k]), bits_of(b[k]))]

    traj6, map6 = traj_bits(slam6), convert.map_state_to_numpy(slam6.map)
    slam6r = System(cam6, loop_cfg, device="cuda")
    lc6r, gba6r = slam6r.loop_closer, {}
    real_gba6r = lc6r._dispatch_global_ba

    def drained_gba(m, anchor):
        real_gba6r(m, anchor)
        torch.cuda.synchronize()
        gba6r.setdefault("result", {k: lc6r._gba_pending[k].clone() for k in GBA_OUT})

    lc6r._dispatch_global_ba = drained_gba
    _, frame_s6r, launches6r = drive("loop repeat", slam6r, images6,
                                     [w for n, (_, _, w) in SOURCES.items()
                                      if n not in ("pnp_hypotheses",) + STEREO_ONLY + DENSE_ONLY])
    repeat6 = {"trajectory_equal": bool(np.array_equal(bits_of(traj_bits(slam6r)),
                                                       bits_of(traj6))),
               "map_fields_not_equal": fields_differ(convert.map_state_to_numpy(slam6r.map), map6),
               "gba_fields_not_equal": fields_differ(
                   {k: v.cpu().numpy() for k, v in gba6r.get("result", {}).items()},
                   {k: v.cpu().numpy() for k, v in gba6["result"].items()})
               if "result" in gba6r else list(GBA_OUT),
               "loops_closed": lc6r.n_loops_closed, "gba_folded": lc6r.n_gba_folded,
               "frames_per_s": LOOP_FRAMES / sum(frame_s6r)}
    print(f"loop repeat, the same cell in a second System: {json.dumps(repeat6)}, card {card}")
    if (not repeat6["trajectory_equal"] or repeat6["map_fields_not_equal"]
            or repeat6["gba_fields_not_equal"]):
        fail(f"phase 6 is not bit for bit on a second run: {repeat6}")

    # phase 3's kernel 11 on the closure's essential graph and phase 15's map
    results["segment_sum"] = segment_sum_checks(cam6, gba6["pose_graph"], gba6["map"],
                                                gba6["anchor"])
    results.update(dense_solve_checks(*phase15_reduced_system(cam6, gba6["map"], gba6["anchor"]),
                                      "phase 15's reduced system"))

    # phase 6 with depth: the circle with phase 12's rendered depth through
    # the RGB-D System (loop closing's Sim3 with the scale fixed), held to
    # the JAX System's outcome and its worst SE3 ATE over seeds 0-9
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam6
    from orb_slam2_annotate_tpu_torch.io import evaluation as eval6

    # the depth maps rendered with phase 6's frames (the renderer reads no bf)
    cam6d = TCam6.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                         bf=LOOP_DEPTH_BF)
    slam6d = System(cam6d, dataclasses.replace(loop_cfg, sensor="rgbd", th_depth=100.0),
                    device="cuda")
    fix6d = {"sim3_ransac_solve": [], "sim3_lm_solve": []}

    def fix_scale_kept(name, fn, pos):
        def run(*a, **kw):
            fix6d[name].append(bool(a[pos]))
            return fn(*a, **kw)
        return run

    saved6d = (sim3_mod.sim3_ransac_solve, sim3_mod.sim3_lm_solve)
    sim3_mod.sim3_ransac_solve = fix_scale_kept("sim3_ransac_solve", saved6d[0], 13)
    sim3_mod.sim3_lm_solve = fix_scale_kept("sim3_lm_solve", saved6d[1], 14)
    jd6, closures6d = LOOP_RGBD_JAX, []

    def track6d(slam, fd, ts):
        n0 = slam.loop_closer.n_loops_closed
        out = slam.track_rgbd(fd[0], fd[1], ts)
        if slam.loop_closer.n_loops_closed > n0:
            closures6d.append(slam.frame_id)
        return out

    try:
        _, frame_s6d, launches6d = drive(
            "loop rgbd", slam6d, list(zip(images6, depths6)),
            [w for n, (_, _, w) in SOURCES.items()
             if n not in ("pnp_hypotheses",) + STEREO_ONLY + DENSE_ONLY
             + (() if jd6["loops"] else LOOP_ONLY + SOLVE_ONLY)],
            track=track6d)
    finally:
        sim3_mod.sim3_ransac_solve, sim3_mod.sim3_lm_solve = saved6d
    lc6d = slam6d.loop_closer
    traj6d = dict(slam6d.frame_trajectory())                   # flushes: folds a pending BA
    ids6d = [k for k, T in traj6d.items() if T is not None]
    est6d = np.stack([-traj6d[k][:3, :3].T @ traj6d[k][:3, 3] for k in ids6d])
    gt6d = np.stack([-gt6[k][0].T @ gt6[k][1] for k in ids6d])
    ate6d = float(eval6.ate_rmse(est6d.astype(np.float64), gt6d.astype(np.float64),
                                 with_scale=False)[0])
    worst6d = max(LOOP_RGBD_JAX_SEEDS)
    bound6d = max(1.5 * worst6d, worst6d + 0.05)
    out6d = {"ate_se3_m": ate6d, "ate_se3_bound_m": bound6d, "jax": jd6,
             "jax_ate_se3_over_seeds_0_9": LOOP_RGBD_JAX_SEEDS, "tracked": len(ids6d),
             "frames": LOOP_FRAMES, "state": slam6d.state, "keyframes": slam6d.n_keyframes,
             "loops_closed": lc6d.n_loops_closed, "closure_frames": closures6d,
             "gba_dispatched": lc6d.n_gba_dispatched,
             "gba_folded": lc6d.n_gba_folded,
             "fix_scale_launches": {k: [sum(v), len(v)] for k, v in fix6d.items()},
             "frames_per_s": LOOP_FRAMES / sum(frame_s6d),
             "frame_ms_median": 1e3 * statistics.median(frame_s6d), "launches": launches6d}
    print(f"loop rgbd: {json.dumps(out6d)}, card {card}")
    checks = {"state OK": slam6d.state == "OK", "tracked >= 80%": len(ids6d) >= 0.8 * LOOP_FRAMES,
              f"SE3 ATE <= {bound6d:.5f} (the JAX System's worst seed {worst6d:.5f})":
                  ate6d <= bound6d,
              "every kernel 7 and 8 launch with the scale fixed":
                  all(fix6d["sim3_ransac_solve"]) and all(fix6d["sim3_lm_solve"])
                  and len(fix6d["sim3_ransac_solve"]) == launches6d["sim3_ransac_solve"]
                  and len(fix6d["sim3_lm_solve"]) == launches6d["sim3_lm_solve"]}
    if jd6["loops"]:
        checks.update({"a closure, as the JAX System's": lc6d.n_loops_closed >= 1,
                       "a global BA dispatched and folded":
                           lc6d.n_gba_dispatched >= 1 and lc6d.n_gba_folded >= 1,
                       "kernels 7 and 8 launched": len(fix6d["sim3_ransac_solve"]) > 0
                                                   and len(fix6d["sim3_lm_solve"]) > 0})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"loop rgbd checks failed: {bad}")

    # ---- phases 7 and 8: RGB-D and stereo through System.track_rgbd /
    # track_stereo on bench.py's cell (the slice's frames, bf = 500 x 0.3)
    from orb_slam2_annotate_tpu_torch.geometry.rectify import StereoRectifier
    from orb_slam2_annotate_tpu_torch.io import evaluation

    def depth_outcome(slam):
        """Over frame_trajectory(): the SE3-aligned ATE (depth makes the map
        metric), the end-to-end displacement and path-length ratios."""
        traj = dict(slam.frame_trajectory())
        ids = [k for k, T in traj.items() if T is not None]
        est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids]).astype(np.float64)
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
        path = lambda c: float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
        return {"ate_se3_m": float(evaluation.ate_rmse(est, gt, with_scale=False)[0]),
                "tracked": len(ids), "frames": N_FRAMES, "state": slam.state,
                "keyframes": slam.n_keyframes, "map_points": slam.n_mappoints,
                "displacement_ratio": float(np.linalg.norm(est[-1] - est[0])
                                            / np.linalg.norm(gt[-1] - gt[0])),
                "path_ratio": path(est) / path(gt)}

    def depth_run(name, sensor, images, track, counted, config=None):
        """One depth-sensor run with the matcher, optimize_pose and
        relocalization-polish calls counted, and the edges of one local-map
        optimize_pose with stereo rows from the second half kept."""
        slam_d = System(cam_d, config or depth_config(sensor), device="cuda")
        kept, polishes = {}, [0]
        kept_g = {"slam": slam_d}
        gba_calls[0] = 0

        def keep_stereo_rows(c_, R0, t0, obs, *a, **kw):
            lm_calls[0] += 1
            if (sys._getframe(1).f_code.co_name == "track_local_map" and "args" not in kept
                    and slam_d.frame_id >= N_FRAMES // 2 and bool(((obs.ur >= 0) & obs.valid).any())):
                kept["args"] = (c_, R0[None].clone(), t0[None].clone(), obs.xw[None].clone(),
                                obs.uv.clone(), obs.ur.clone(), obs.inv_sigma2.clone(),
                                obs.valid[None].clone())
            return real_opt(c_, R0, t0, obs, *a, **kw)

        def count_polish(*a):
            polishes[0] += 1
            return real_polish(*a)

        pose_opt.optimize_pose, matching.match_gated = keep_stereo_rows, count_match
        pnp_mod.optimize_pose_batched = count_polish
        ba_core.bundle_adjust_grid = keep_grid_ba(N_FRAMES // 2, kept_g, stereo=True)
        lm_calls[0], match_calls[0] = 0, 0
        try:
            _, frame_s_d, launches_d = drive(name, slam_d, images, counted, track)
        finally:
            pose_opt.optimize_pose, matching.match_gated = real_opt, real_match
            pnp_mod.optimize_pose_batched = real_polish
            ba_core.bundle_adjust_grid = real_gba
        kept["gba"] = kept_g.get(4)
        out = depth_outcome(slam_d)
        out.update(frames_per_s=N_FRAMES / sum(frame_s_d),
                   frame_ms_median=1e3 * statistics.median(frame_s_d),
                   optimize_pose_calls=lm_calls[0], matcher_calls=match_calls[0],
                   polishes=polishes[0])
        print(f"{name}: {json.dumps(out)}, card {card}")
        checks = {"state OK": slam_d.state == "OK", "tracked >= 80%": out["tracked"] >= 0.8 * N_FRAMES,
                  "keyframes >= 3": slam_d.n_keyframes >= 3, "map points > 200": slam_d.n_mappoints > 200,
                  "one pose_lm_solve launch per optimize_pose and per polish":
                      launches_d["optimize_pose_batched"] == lm_calls[0] + polishes[0],
                  "one hamming_match launch per matcher call":
                      launches_d["hamming_match"] == match_calls[0],
                  "one grid_ba_solve launch per bundle_adjust_grid call":
                      gba_calls[0] > 0 and launches_d["grid_ba_solve"] == gba_calls[0],
                  "a local-map call with stereo rows captured": "args" in kept}
        return slam_d, out, launches_d, kept, checks

    def outcome_bounds(out, ate_jax):
        bound_d = max(1.5 * ate_jax, ate_jax + 0.01)
        out.update(ate_bound_m=bound_d, ate_jax_m=ate_jax)
        return {f"SE3 ATE <= {bound_d:.5f} (JAX {ate_jax:.5f})": out["ate_se3_m"] <= bound_d}

    # phase 7: RGB-D, the rendered depth
    slam7, out7, launches7, kept7, checks = depth_run(
        "rgbd", "rgbd", list(zip(frames, depths)),
        lambda slam, fd, ts: slam.track_rgbd(fd[0], fd[1], ts),
        [w for n, (_, _, w) in SOURCES.items() if n not in ("pnp_hypotheses",) + LOOP_ONLY
         + STEREO_ONLY + SOLVE_ONLY + DENSE_ONLY])
    checks.update(outcome_bounds(out7, RGBD_ATE_JAX))
    checks.update({"displacement within 5%": abs(out7["displacement_ratio"] - 1.0) < 0.05,
                   "one fast_nms launch per frame": launches7["fast_nms"] == N_FRAMES,
                   "one orb_describe call per frame": launches7["orb_describe"] == N_FRAMES,
                   "no stereo_match or remap_pair launch":
                       launches7["stereo_match"] == 0 and launches7["remap_pair"] == 0})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"rgbd checks failed: {bad}")
    traj7, map7 = traj_bits(slam7), convert.map_state_to_numpy(slam7.map)     # for phase 16
    # kernel 4 on a local-map call with stereo rows (ur >= 0), phase 4's tolerances
    args7 = kept7["args"]
    err_st = check_pose_lm("captured RGB-D local-map call (stereo rows)", args7)
    r4 = results["pose_lm_solve"]
    r4["max_abs_err"] = max(r4["max_abs_err"], err_st)
    r4["captured_rgbd"] = {"stereo_rows": int(((args7[5] >= 0) & args7[7][0]).sum()),
                           "edges": int(args7[7].sum()),
                           "ms": time_ms(lambda: k4.optimize_pose_batched(*args7)),
                           "graph_us": graph_us(lambda: k4.optimize_pose_batched(*args7)),
                           "bound_ms": bound(*pose_lm_work(args7[3], args7[5], args7[7]))[0]}
    print(f"pose_lm_solve on the RGB-D call: {json.dumps(r4['captured_rgbd'])}")
    # kernel 12 on a local-BA solve of the RGB-D cell (stereo rows)
    if kept7["gba"] is None:
        fail("rgbd: no local-BA solve with stereo rows captured")
    cam7g, g7 = kept7["gba"]
    o7 = grid_ba_check("phase 7 RGB-D, 4 iterations (stereo rows)", cam7g, g7, 4)
    grid_ba_require({"phase 7": o7})
    r12 = results["grid_ba"]
    r12["max_abs_err"] = max(r12["max_abs_err"], o7["whole"]["R"], o7["whole"]["t"])
    r12["cases"]["phase 7 RGB-D, 4 iterations (stereo rows)"] = {
        k: o7[k] for k in ("whole", "linearization", "solve")}
    r12["captured_rgbd"] = {"stereo_rows": int(((g7.ur >= 0) & g7.edge_valid).sum()),
                            "valid_slots": o7["valid_slots"], **grid_ba_times(cam7g, g7, 4)}
    print(f"grid_ba on the RGB-D local BA: {json.dumps(r12['captured_rgbd'])}")

    # phase 8: stereo, every pair through a StereoRectifier of the rectified,
    # undistorted rig (zero distortion, identity rotation; unit intrinsics, so
    # the maps hold exact integers: with the camera's K the float32 inversion
    # leaves them up to 6.1e-5 px off), whose output must be the input
    eye = np.eye(3, dtype=np.float32)
    rect = StereoRectifier(eye, np.zeros(5), eye, eye, eye, np.zeros(5), eye, eye, 480, 640,
                           device="cuda")
    rectified = []

    def track8(slam, pair, ts):
        il, ir = rect(*pair)
        rectified.append((il, ir))
        return slam.track_stereo(il, ir, ts)

    slam8, out8, launches8, kept8, checks = depth_run(
        "stereo", "stereo", list(zip(frames, rights)), track8,
        [w for n, (_, _, w) in SOURCES.items()
         if n not in ("pnp_hypotheses",) + LOOP_ONLY + SOLVE_ONLY + DENSE_ONLY])
    # compared after the run, so the frame times hold only the rectifier and track_stereo
    up = lambda im: torch.from_numpy(im).to(dev).float()
    moved8 = [k for k, ((il, ir), fl_, fr_) in enumerate(zip(rectified, frames, rights))
              if not (torch.equal(il, up(fl_)) and torch.equal(ir, up(fr_)))]
    if len(rectified) != N_FRAMES:
        fail(f"stereo: {len(rectified)} rectified pairs for {N_FRAMES} frames")
    traj8, map8 = traj_bits(slam8), convert.map_state_to_numpy(slam8.map)     # for phase 16
    checks.update(outcome_bounds(out8, STEREO_ATE_JAX))
    checks.update({"path length within 15%": abs(out8["path_ratio"] - 1.0) < 0.15,
                   "rectified pairs equal the input": not moved8,
                   "two fast_nms launches per frame": launches8["fast_nms"] == 2 * N_FRAMES,
                   "two orb_describe calls per frame": launches8["orb_describe"] == 2 * N_FRAMES,
                   "one stereo_match launch per frame": launches8["stereo_match"] == N_FRAMES,
                   "one remap_pair launch per frame": launches8["remap_pair"] == N_FRAMES})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"stereo checks failed: {bad} (frames whose rectified pair moved: {moved8})")
    args8 = kept8["args"]
    err_st8 = check_pose_lm("captured stereo local-map call", args8)
    r4["max_abs_err"] = max(r4["max_abs_err"], err_st8)
    r4["captured_stereo"] = {"stereo_rows": int(((args8[5] >= 0) & args8[7][0]).sum()),
                             "edges": int(args8[7].sum()),
                             "ms": time_ms(lambda: k4.optimize_pose_batched(*args8)),
                             "graph_us": graph_us(lambda: k4.optimize_pose_batched(*args8)),
                             "bound_ms": bound(*pose_lm_work(args8[3], args8[5], args8[7]))[0]}
    print(f"pose_lm_solve on the stereo call: {json.dumps(r4['captured_stereo'])}")

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 9", flush=True)
    # ---- phase 9: fuse (SearchInNeighbors) in the keyframe chain, on the
    # slice and on the RGB-D cell; kernel 3 once a fuse_neighbors (all its
    # targets in one launch), kernel 3b twice a keyframe chain (the refresh
    # in triangulation that fuse turns on, and the chain's last)
    from torch.profiler import ProfilerActivity, profile

    real_fuse, real_chain, real_core = (local_mapping.fuse_neighbors, local_mapping.keyframe_chain,
                                        local_mapping._fuse_targets_core)
    fuse_launches, chain_stats, captured_fuse = [], [], {}
    slam9 = None

    def count_chain_stats(*a, **kw):
        n0 = k3.distinctive_descriptors.launches
        out = real_chain(*a, **kw)
        chain_stats.append(k3.distinctive_descriptors.launches - n0)
        return out

    def keep_core(m, cam_, targets, tgt_ok, src_masks, **kw):
        # the inputs of one neighbour fuse from the second half of the slice
        if "args" not in captured_fuse and slam9 is not None and slam9.frame_id >= N_FRAMES // 2:
            captured_fuse["args"] = (m, cam_, targets, tgt_ok, src_masks, kw)
        return real_core(m, cam_, targets, tgt_ok, src_masks, **kw)

    local_mapping.fuse_neighbors = matcher_launches_in(real_fuse, fuse_launches)
    local_mapping.keyframe_chain = count_chain_stats
    local_mapping._fuse_targets_core = keep_core
    counted9 = [w for n, (_, _, w) in SOURCES.items()
                if n not in ("pnp_hypotheses",) + LOOP_ONLY + STEREO_ONLY + SOLVE_ONLY + DENSE_ONLY]
    try:
        slam9 = System(cam, dataclasses.replace(slice_cfg, enable_fuse=True), device="cuda")
        with profile(activities=[ProfilerActivity.CPU]) as prof9:
            _, frame_s9, launches9m = drive("fuse", slam9, frames, counted9)
        fuse9m, stats9m = list(fuse_launches), list(chain_stats)
        fuse_launches.clear()
        chain_stats.clear()
        slam9, slam_keep = None, slam9
        _, out9r, launches9r, _, checks9r = depth_run(
            "rgbd fuse", "rgbd", list(zip(frames, depths)),
            lambda slam, fd, ts: slam.track_rgbd(fd[0], fd[1], ts), counted9,
            config=dataclasses.replace(depth_config("rgbd"), enable_fuse=True))
        fuse9r, stats9r = list(fuse_launches), list(chain_stats)
    finally:
        local_mapping.fuse_neighbors, local_mapping.keyframe_chain = real_fuse, real_chain
        local_mapping._fuse_targets_core = real_core
    slam9 = slam_keep
    spans9 = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1e3}
              for e in prof9.key_averages() if e.key.startswith("mapping/")}
    print(f"fuse: keyframe-chain spans over the run (host time under the CPU profiler): "
          f"{json.dumps(spans9)}, card {card}")
    ate9, n9 = ate_of(slam9, poses, range(N_FRAMES))
    bound9 = max(1.5 * FUSE_ATE_JAX, FUSE_ATE_JAX + 0.01)
    out9m = {"ate_m": ate9, "ate_bound_m": bound9, "ate_jax_m": FUSE_ATE_JAX, "tracked": n9,
             "frames": N_FRAMES, "state": slam9.state, "keyframes": slam9.n_keyframes,
             "map_points": slam9.n_mappoints, "fuse_neighbors_calls": len(fuse9m),
             "matcher_launches_per_fuse": sorted(set(fuse9m)),
             "stats_launches_per_chain": sorted(set(stats9m)),
             "frame_ms_median_profiled": 1e3 * statistics.median(frame_s9), "spans": spans9}
    print(f"fuse (slice): {json.dumps({k: v for k, v in out9m.items() if k != 'spans'})}, card {card}")
    checks = {"state OK": slam9.state == "OK", "tracked >= 70%": n9 >= 0.7 * N_FRAMES,
              f"ATE <= {bound9:.5f} (JAX {FUSE_ATE_JAX:.5f})": ate9 <= bound9,
              f"ATE < {ATE_BOUND}": ate9 < ATE_BOUND,
              "one hamming_match launch per fuse_neighbors": len(fuse9m) > 0 and set(fuse9m) == {1},
              "a fuse_neighbors per keyframe chain": len(fuse9m) == len(stats9m),
              "two distinctive_descriptors launches per keyframe chain": set(stats9m) == {2},
              "every chain stage span recorded": all(
                  f"mapping/{n}" in spans9 for n in ("insert", "cull_recent", "triangulate", "fuse",
                                                     "local_ba", "stats")),
              "a fuse core call captured": "args" in captured_fuse}
    checks.update({f"rgbd: {k}": v for k, v in checks9r.items()})
    checks.update({f"rgbd: {k}": v for k, v in outcome_bounds(out9r, RGBD_FUSE_ATE_JAX).items()})
    checks.update({"rgbd: one hamming_match launch per fuse_neighbors":
                       len(fuse9r) > 0 and set(fuse9r) == {1},
                   "rgbd: two distinctive_descriptors launches per keyframe chain":
                       set(stats9r) == {2}})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"fuse checks failed: {bad}")

    # the fuse core on the card against its CPU result, on the captured
    # keyframe's inputs and on a point that loses two merges to two winners:
    # observations and validity exactly equal
    def core_on(args, device):
        m, cam_, targets, tgt_ok, src_masks, kw = args
        m = map_state.MapState(**{f.name: getattr(m, f.name).to(device)
                                  for f in dataclasses.fields(m)})
        return real_core(m, cam_, targets.to(device), tgt_ok.to(device), src_masks.to(device), **kw)

    core_checks, k3_fuse = {}, {}
    real_match = matching.hamming_match

    def keep_match(*a, **kw):
        k3_fuse.setdefault("args", (a, kw))
        return real_match(*a, **kw)

    double_loser_case = runpy.run_path(os.path.join(ROOT, "tests", "_fuse_cases.py"))[
        "double_loser_case"]
    cam_dl, m_dl, *rest_dl = double_loser_case("cpu")
    for what, args in (("captured keyframe", captured_fuse["args"]),
                       ("double loser", (m_dl, cam_dl, *rest_dl, {}))):
        matching.hamming_match = keep_match
        try:
            got = core_on(args, dev)
        finally:
            matching.hamming_match = real_match
        want = core_on(args, "cpu")
        core_checks[what] = {"kf_obs": torch.equal(got.kf_obs.cpu(), want.kf_obs),
                             "mp_valid": torch.equal(got.mp_valid.cpu(), want.mp_valid),
                             "merged": int((args[0].mp_valid.cpu() & ~want.mp_valid).sum()),
                             "added": int(((args[0].kf_obs.cpu() < 0) & (want.kf_obs >= 0)).sum())}
        if what == "double loser":
            # point 0 loses to point 1 in target 0 and to point 2 in target 1:
            # keyframe 2's observation of it goes to the later pair's winner
            core_checks[what]["kept_winner"] = int(got.kf_obs[2, 1])
    print(f"fuse core on the card against its CPU result: {json.dumps(core_checks)}")
    if not all(c["kf_obs"] and c["mp_valid"] for c in core_checks.values()):
        fail(f"the fuse core on the card differs from its CPU result: {core_checks}")
    if core_checks["double loser"]["kept_winner"] != 2:
        fail(f"double loser: the later merge pair's winner (point 2) was not kept: {core_checks}")
    # kernel 3 on the captured neighbour fuse's own launch (B = 11)
    a3, kw3 = k3_fuse["args"]
    got3, want3 = real_match(*a3, **kw3), k3.hamming_match_plain(*a3, **kw3)
    if not (torch.equal(got3[0], want3[0]) and torch.equal(got3[1], want3[1])):
        fail(f"hamming_match differs from its twin on the captured fuse launch "
             f"({int((got3[0] != want3[0]).sum())} rows)")
    results["hamming_match"]["captured_fuse"] = {"equal_to_twin": True,
        "B": a3[0].shape[0], "Q": a3[0].shape[1], "N": a3[1].shape[-2],
        "ms": time_ms(lambda: real_match(*a3, **kw3)),
        "graph_us": graph_us(lambda: real_match(*a3, **kw3))}
    print(f"kernel 3 on the captured fuse launch: "
          f"{json.dumps(results['hamming_match']['captured_fuse'])}, card {card}")

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 10", flush=True)
    # ---- phase 10: pipelined tracking (async_depth 2): each frame's step
    # dispatched without a host read, resolved once its copy has landed
    real_step = tracking.track_frame_device
    step_launches = []

    def count_step(*a, **kw):
        n0 = (k3.hamming_match.launches, k4.optimize_pose_batched.launches)
        out = real_step(*a, **kw)
        step_launches.append((bool(a[9]), k3.hamming_match.launches - n0[0],
                              k4.optimize_pose_batched.launches - n0[1]))
        return out

    guarded = [0]

    def no_sync(fn):
        # fn under torch's sync debug mode "error": any call in it that
        # synchronizes with the card (.item(), a pageable copy, a stream
        # synchronize) raises
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                guarded[0] += 1
        return run

    def pipelined(name, slam, images, counted):
        """drive() a pipelined System with its dispatch (the step, its host
        bundle, every prefetch) under no_sync; also returns how many frames
        late each frame was resolved, what the ready test answered, and the
        number of guarded calls."""
        lags, ready = collections.Counter(), collections.Counter()
        real_resolve, real_ready = slam._resolve_oldest, slam._ready

        def resolve():
            lags[slam.frame_id - slam._inflight[0]["frame_id"]] += 1
            return real_resolve()

        def ready_test(e):
            out = real_ready(e)
            ready["ready" if out else "in flight"] += 1
            return out

        slam._resolve_oldest, slam._ready = resolve, ready_test
        slam._prefetch = no_sync(slam._prefetch)
        saved_step, saved_bundle = tracking.track_frame_device, tracking.TrackStep.host_bundle
        tracking.track_frame_device = no_sync(saved_step)
        tracking.TrackStep.host_bundle = no_sync(saved_bundle)
        n0 = guarded[0]
        try:
            out = drive(name, slam, images, counted, sync=False)
        except RuntimeError as e:
            if "synchroniz" in str(e):
                fail(f"{name}: the pipelined dispatch synchronized with the card: {e}")
            raise
        finally:
            tracking.track_frame_device, tracking.TrackStep.host_bundle = saved_step, saved_bundle
        lag = {"resolve_lag_frames": dict(sorted(lags.items())), "ready_test": dict(ready),
               "guarded_calls": guarded[0] - n0}
        print(f"{name}: frames resolved n frames late {json.dumps(lag['resolve_lag_frames'])}, "
              f"ready test {json.dumps(lag['ready_test'])}, calls under sync debug mode "
              f"'error' {lag['guarded_calls']}")
        return (*out, lag)

    # the synchronous System again first, timed the same way (to each call's
    # return): phase 4's run also holds the first launch of every kernel
    _, frame_s10s, _ = drive("synchronous, timed to the return", System(cam, slice_cfg, device="cuda"),
                             frames, counted9, sync=False)
    tracking.track_frame_device = count_step
    try:
        slam10 = System(cam, dataclasses.replace(slice_cfg, async_depth=ASYNC_DEPTH), device="cuda")
        out10, frame_s10, launches10, lag10 = pipelined("pipelined", slam10, frames, counted9)
    finally:
        tracking.track_frame_device = real_step
    ate10, n10 = ate_of(slam10, poses, range(N_FRAMES))
    bound10 = {"port_sync": max(1.5 * ate, ate + 0.01),
               "jax_async": max(1.5 * ASYNC_ATE_JAX, ASYNC_ATE_JAX + 0.01)}
    per_step = sorted(set(step_launches))
    out10m = {"ate_m": ate10, "ate_bounds_m": bound10, "ate_port_sync_m": ate,
              "ate_jax_async_m": ASYNC_ATE_JAX, "tracked": n10, "frames": N_FRAMES,
              "state": slam10.state, "keyframes": slam10.n_keyframes,
              "map_points": slam10.n_mappoints, "steps": len(step_launches),
              "launches_per_step (has_vel, hamming_match, pose_lm_solve)": per_step,
              "frame_ms_median": 1e3 * statistics.median(frame_s10),
              "frame_ms_median_sync_phase4": 1e3 * statistics.median(frame_s),
              "frame_ms_median_sync_to_return": 1e3 * statistics.median(frame_s10s),
              "frames_per_s": N_FRAMES / sum(frame_s10),
              "frames_per_s_sync_phase4": N_FRAMES / sum(frame_s),
              "frames_per_s_sync_to_return": N_FRAMES / sum(frame_s10s), **lag10}
    print(f"pipelined: {json.dumps(out10m)}, card {card}")
    checks = {"state OK": slam10.state == "OK", "tracked >= 70%": n10 >= 0.7 * N_FRAMES,
              f"ATE < {ATE_BOUND}": ate10 < ATE_BOUND,
              "a record for every frame, in order":
                  [r.frame_id for r in slam10.records] == list(range(N_FRAMES)),
              "drained": not slam10._inflight,
              "a device pose returned for tracked frames": any(torch.is_tensor(T) and T.is_cuda
                                                               for T in out10),
              "four matcher and four pose-LM launches a step with a velocity, two without":
                  len(per_step) > 0 and all((h, nm, nl) in ((True, 4, 4), (False, 2, 2))
                                            for h, nm, nl in per_step)}
    checks.update({f"ATE <= {b:.5f} ({k})": ate10 <= b for k, b in bound10.items()})
    checks["the dispatch ran under sync debug mode"] = lag10["guarded_calls"] >= 2 * len(step_launches)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"pipelined checks failed: {bad}")

    # phase 6's loop cell pipelined, SlamConfig()'s own defaults (keyframe
    # culling on): the loop detection and the keyframe cull are read a
    # keyframe late. Like the JAX System's pipelined run on the cell, the
    # tracker loses the map about a third of the way round (the frame after
    # a pipelined keyframe matches the step's observations only, not the
    # points just triangulated) and relocalizes near the closure; so the run
    # is held to that run, and also drives the pipelined LOST branch (kernel 6)
    slam10l = System(cam6, dataclasses.replace(loop_cfg, enable_kf_culling=True,
                                               async_depth=ASYNC_DEPTH), device="cuda")
    lc10 = slam10l.loop_closer
    deferred = {"dispatched": [], "resolved": [], "cull": [], "relocalized": []}
    real_dispatch, real_resolve10, real_cull, real_reloc = (
        lc10.dispatch_detection, lc10.resolve_detection, slam10l._apply_cull_info,
        slam10l._try_relocalize)

    def caller():
        return sys._getframe(2).f_code.co_name

    def dispatch10(m, slot):
        deferred["dispatched"].append((caller(), slot))
        return real_dispatch(m, slot)

    def resolve10(m, slot, det):
        deferred["resolved"].append((caller(), slot))
        return real_resolve10(m, slot, det)

    def cull10(info):
        deferred["cull"].append((caller(), int(info.ok.sum())))
        return real_cull(info)

    def reloc10(frame):
        ok = real_reloc(frame)
        if ok:
            deferred["relocalized"].append((caller(), slam10l.frame_id))
        return ok

    lc10.dispatch_detection, lc10.resolve_detection = dispatch10, resolve10
    slam10l._apply_cull_info, slam10l._try_relocalize = cull10, reloc10
    counted10l = [w for n, (_, _, w) in SOURCES.items()
                  if n not in ("sim3_lm_solve",) + STEREO_ONLY + SOLVE_ONLY + DENSE_ONLY]
    _, frame_s10l, launches10l, lag10l = pipelined("pipelined loop", slam10l, images6, counted10l)
    ate10l, n10l = ate_of(slam10l, gt6, range(LOOP_FRAMES))
    pipelined_dispatch = [s for f, s in deferred["dispatched"] if f == "_create_keyframe_async"]
    bound10l = max(1.5 * LOOP_ASYNC_ATE_JAX, LOOP_ASYNC_ATE_JAX + 0.05)
    out10l = {"ate_m": ate10l, "ate_bound_m": bound10l, "ate_jax_async_m": LOOP_ASYNC_ATE_JAX,
              "tracked": n10l, "tracked_jax_async": LOOP_ASYNC_TRACKED_JAX, "frames": LOOP_FRAMES,
              "state": slam10l.state, "keyframes": slam10l.n_keyframes,
              "loops_closed": lc10.n_loops_closed,
              "detections_dispatched_pipelined": len(pipelined_dispatch),
              "detections_resolved": len(deferred["resolved"]),
              "culls_applied": len(deferred["cull"]),
              "keyframes_culled": sum(n for _, n in deferred["cull"]),
              "relocalized_at_frames": deferred["relocalized"],
              "frame_ms_median": 1e3 * statistics.median(frame_s10l),
              "frames_per_s": LOOP_FRAMES / sum(frame_s10l), **lag10l}
    print(f"pipelined loop: {json.dumps(out10l)}, card {card}")
    checks = {"state OK": slam10l.state == "OK",
              f"tracked >= 0.8 x the JAX run's {LOOP_ASYNC_TRACKED_JAX}":
                  n10l >= 0.8 * LOOP_ASYNC_TRACKED_JAX,
              f"ATE <= {bound10l:.4f}": ate10l <= bound10l,
              "each pipelined detection resolved once, through the deferred read":
                  len(pipelined_dispatch) > 0
                  and deferred["resolved"] == [("_resolve_pending", s) for s in pipelined_dispatch],
              "the keyframe cull applied through the deferred read only":
                  len(deferred["cull"]) > 0 and {f for f, _ in deferred["cull"]} == {"_resolve_pending"},
              "relocalized on the pipelined path":
                  any(f in ("_track_async", "_resolve_oldest") for f, _ in deferred["relocalized"]),
              "the host's valid keyframes equal the map's":
                  np.array_equal(slam10l._kf_valid_host, slam10l.map.kf_valid.cpu().numpy()),
              "drained": not slam10l._inflight and slam10l._pending_det is None
                         and slam10l._pending_cull is None,
              "the dispatch ran under sync debug mode": lag10l["guarded_calls"] >= LOOP_FRAMES // 4}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"pipelined loop checks failed: {bad}")

    # ---- phases 11-13: the free runner
    free = free_phases(types.SimpleNamespace(
        card=card, frames=frames, depths=depths, poses=poses, frame_s4=frame_s, cam6=cam6,
        gt6=gt6, images6=images6, depths6=depths6, loop_cfg=loop_cfg, cam_d=cam_d,
        rights=rights, depth_config=depth_config, rect=rect, zero_launches=zero_launches,
        read_launches=read_launches))
    fl = free["launches"]

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 14", flush=True)
    # ---- phase 14: map I/O, the merge and the dataset drivers
    io14 = io_phases(types.SimpleNamespace(
        card=card, cam=cam, poses=poses, frames=frames, depths=depths, slice_cfg=slice_cfg,
        gt5=gt5, sweep=images5[:KIDNAP_SWEEP], cam_d=cam_d, depth_config=depth_config, bench_runner=free["bench_runner"],
        zero_launches=zero_launches, read_launches=read_launches))
    fl = {**fl, **io14["launches"]}

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 15", flush=True)
    # ---- phase 15: the dense and distributed global BA, shard_points,
    # telemetry and the vocabulary trainer
    if not gba6:
        fail("phase 6 dispatched no global BA")
    d15 = dist_phases(types.SimpleNamespace(
        card=card, cam=cam, frames=frames, slice_cfg=slice_cfg, slam4=slam,
        track_calls4=track_calls[0], traj4=traj4, map4=map4, cam6=cam6, gba_map=gba6["map"],
        gba_anchor=gba6["anchor"], drive=drive, slice_kernels=slice_kernels,
        zero_launches=zero_launches, read_launches=read_launches))
    fl = {**fl, **d15["launches"]}

    print(f"[{time.perf_counter() - t_main:.1f} s] phase 16", flush=True)
    # ---- phase 16: the live map's point axis split over two ranks
    runner11, cam11, gt11, images11, cfg11 = free["bench_runner"]
    d16 = shard_phases(types.SimpleNamespace(
        card=card, cam=cam, frames=frames, slice_cfg=slice_cfg, traj4=traj4, map4=map4,
        fps4=slice_out["frames_per_s"], peak4_mb=slice_out["peak_mb"],
        point_mb4=sum(getattr(slam.map, k).numel() * getattr(slam.map, k).element_size()
                      for k in map_state.POINT_FIELDS) / 2**20,
        slice_kernels=slice_kernels, cam6=cam6, images6=images6,
        loop_cfg=loop_cfg, gt6=gt6, ate6=ate6, ate_bound6=ate_bound6, traj6=traj6, map6=map6,
        gba_frames6=gba_frames6, fold_frames6=fold_frames6, cam_d=cam_d, depths=depths, rights=rights, depth_config=depth_config, traj7=traj7,
        map7=map7, traj8=traj8, map8=map8, kept13r=free["kept13r"], cam11=cam11,
        images11=images11, cfg11=cfg11, kept11=free["kept11"],
        fps11_48=free["outcomes"]["bench"]["frames_per_s_per_frame_first_48"]))
    fl = {**fl, **d16["launches"]}

    print(f"[{time.perf_counter() - t_main:.1f} s] phases 1-16 done", flush=True)
    kern = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
             "launches": (launches4[w] + launches5[w] + launches6[w] + launches6r[w]
                          + launches6d[w] + launches7[w] + launches8[w]
                          + launches9m[w] + launches9r[w] + launches10[w] + launches10l[w]
                          + sum(v[w] for v in fl.values())),
             "launches_by_phase": {"1 card": launches1[w], "2 build": launches2[w],
                                   "3 twins": launches3[w], "4 slice": launches4[w],
                                   "5 kidnap": launches5[w], "6 loop": launches6[w],
                                   "6 loop repeat": launches6r[w], "6 loop rgbd": launches6d[w],
                                   "7 rgbd": launches7[w], "8 stereo": launches8[w],
                                   "9 fuse slice": launches9m[w], "9 fuse rgbd": launches9r[w],
                                   "10 pipelined": launches10[w],
                                   "10 pipelined loop": launches10l[w],
                                   **{k: v[w] for k, v in fl.items()}},
             **results[n]}
            for n, (src, rep, w) in SOURCES.items()]
    print(json.dumps({"kernels": kern, "slice": slice_out,
                      "kidnap": {"ate_m": ate5, "tracked": n5, "frames": len(seq),
                                 "frames_per_s": len(seq) / sum(frame_s5),
                                 "jump_frame_ms": 1e3 * frame_s5[KIDNAP_SWEEP],
                                 "keyframes": slam5.n_keyframes, "relocalizations": relocs,
                                 "optimize_pose_calls": calls5, "matcher_calls": match_calls5},
                      "loop": {"ate_m": ate6, "ate_bound_m": ate_bound6, "ate_jax_m": LOOP_ATE_JAX,
                               "tracked": n6, "frames": LOOP_FRAMES,
                               "frames_per_s": LOOP_FRAMES / sum(frame_s6),
                               "frame_ms_median": 1e3 * statistics.median(frame_s6),
                               "frame_ms_max": 1e3 * max(frame_s6), "closure_frames": closures,
                               "closure_frame_ms": closure_ms, "loops_closed": lc6.n_loops_closed,
                               "gba_dispatched": lc6.n_gba_dispatched,
                               "gba_folded": lc6.n_gba_folded, "keyframes": slam6.n_keyframes,
                               "stage_ms": stage_ms, "sim3_ransac_calls": calls6["sim3_ransac"],
                               "optimize_sim3_calls": calls6["optimize_sim3"],
                               "repeat": repeat6},
                      "loop_rgbd": out6d,
                      "rgbd": out7, "stereo": out8,
                      "fuse": {"slice": out9m, "rgbd": out9r, "core_on_card": core_checks},
                      "pipelined": out10m, "pipelined_loop": out10l,
                      "free": free["outcomes"], "io": io14["outcomes"],
                      "dist": d15["outcomes"], "shard": d16["outcomes"], "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-frames"]:
        first_frames(*sys.argv[2:6])
    elif sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(*sys.argv[2:6])
    elif sys.argv[1:2] == ["--k12"]:
        k12_alone()
    elif sys.argv[1:2] == ["--k12bc"]:
        k12bc_alone()
    else:
        if sys.argv[1:2] == ["--keep-ba"]:
            KEEP_BA = sys.argv[2]
        main()
