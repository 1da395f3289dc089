#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build every CUDA kernel from csrc/ with nvcc, one process per source,
     all started together;
  3. compare kernels 1-5, 3b and 7-10 with their plain torch twins on the card, at the
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
     synthetic edges, once mono and once half stereo; kernel 5 exactly on
     the trained vocabulary, on the vocabulary with every word duplicated
     and at N = 1000, W = 16383; kernel 7 (the whole Sim3 RANSAC after its
     draw) with every output bit for bit, at 1024 x 1024 with 25% outliers,
     a near-collinear triple, 2 valid pairs, no valid pair and a zero-inlier
     best, scale free and fixed, a refined fit that counts fewer (the best
     kept), N = 4096 and H = 4096; kernel 8 (the whole Sim3 LM) at 1024
     pairs scale free and fixed, 4096 pairs all valid and 3 valid pairs;
     kernel 9 (a stereo frame's match, SAD refinement, depth and
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
     grid_sample in turns;
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
     a frame; kernel 4 again on a local-map call with stereo rows.
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

import concurrent.futures
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

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
}
LOOP_ONLY = ("sim3_ransac_solve", "sim3_lm_solve")   # launched only with loop closing on
STEREO_ONLY = ("stereo_match", "remap_pair")         # launched only by the stereo sensor
# phases 7 and 8: bench.py's RGB-D / stereo cell (bench.py:151-196) on the
# slice's frames: bf = 500 x 0.3, th_depth 100, SlamConfig()'s other defaults
BASELINE = 0.3
# the JAX System on the same cells (python3 tools/jax_depth_reference.py rgbd|stereo,
# a CPU run): SE3-aligned ATE over frame_trajectory(), all 48 frames tracked
RGBD_ATE_JAX = 0.0028807614141597984
STEREO_ATE_JAX = 0.003443945486205791
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


def slice_setup():
    """The smoke run's slice at ``bench.py``'s mono width: (camera, ground-truth
    poses, rendered uint8 frames, depth maps, slice config).  Frames are
    rendered on the host by the port's numpy PlaneScene."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(N_FRAMES, step=0.05)
    frames, depths = [], []
    for R, t in poses:
        img, dep = scene.render(cam, R, t, h=480, w=640)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(dep)
    cfg = mono_slice_config(n_features=1024, n_levels=8, max_kf=128, max_mp=16384,
                            max_frames_between_kf=6, init_min_matches=60)
    return cam, poses, frames, depths, cfg


def kidnap_setup(cam):
    """Phase 5's sequence: (ground-truth poses of the sweep, the frame index
    of each image, the rendered uint8 images).  A 64-frame sweep, then a
    jump back to frame 4 and three frames from there."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.io import synthetic

    scene = synthetic.PlaneScene(seed=1)
    gt = synthetic.orbit_trajectory(KIDNAP_SWEEP, step=KIDNAP_STEP)
    seq = list(range(KIDNAP_SWEEP)) + [KIDNAP_JUMP + i for i in range(4)]
    images = [np.clip(scene.render(cam, *gt[f], h=480, w=640)[0], 0, 255).astype(np.uint8)
              for f in seq]
    return gt, seq, images


def loop_setup():
    """Phase 6's cell: (camera, ground-truth poses, rendered uint8 frames,
    config): SlamConfig()'s own defaults (loop closing on) at
    tests/test_e2e_loop.py's sizes, keyframe culling off."""
    import numpy as np

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig

    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = synthetic.RoomScene(seed=2)
    poses = synthetic.circle_trajectory(LOOP_FRAMES, radius=1.8, turns=1.04)
    frames = [np.clip(scene.render(cam, R, t, h=240, w=320)[0], 0, 255).astype(np.uint8)
              for R, t in poses]
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=4,
                     init_min_matches=60, enable_kf_culling=False)
    return cam, poses, frames, cfg


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
    rights = [np.clip(scene.render(cam, R, np.asarray(t, np.float32) - shift, h=480, w=640)[0],
                      0, 255).astype(np.uint8) for R, t in poses]
    config = lambda sensor: SlamConfig(sensor=sensor, n_features=1024, max_kf=128, max_mp=16384,
                                       max_frames_between_kf=6, init_min_matches=60,
                                       th_depth=100.0)
    return cam, rights, config


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


def check_sim3_lm(what, args):
    """Kernel 8 against its twin at kernel 4's tolerances: s, R, t within
    1e-4; inlier masks differ on <= 1% of pairs, only within 1% of the chi2
    gate; n within 1%.  args as sim3_lm_solve's.  Returns max |ds|,|dR|,|dt|."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import sim3 as k8

    got = k8.sim3_lm_solve(*args)
    ref = k8.sim3_lm_solve_plain(*args)
    torch.cuda.synchronize()
    x1, x2, uv1, uv2, valid = args[:5]
    is1, is2 = k8.inv_sigma2_or_ones(x1, *args[5:7])
    fx, fy, cx, cy, fix_scale, th = args[10:16]
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3]))
    _, c_f, c_i, _ = k8.project_residuals(fx, fy, cx, cy, got[0], got[1], got[2], x1, x2, uv1, uv2,
                                          is1, is2)
    near = ((c_f / th - 1.0).abs() < 0.01) | ((c_i / th - 1.0).abs() < 0.01)
    diff = got[3] != ref[3]
    frac = float(diff.float().mean())
    n_k, n_p = int(got[4]), int(ref[4])
    if err > 1e-4 or frac > 0.01 or bool((diff & ~near).any()) or abs(n_k - n_p) > math.ceil(0.01 * n_p):
        fail(f"sim3_lm_solve ({what}): max |ds|,|dR|,|dt| {err:.3g}, masks differ on {frac:.4f} "
             f"({int((diff & ~near).sum())} away from the gate), n {n_k} vs {n_p}")
    print(f"sim3_lm_solve vs twin, {what}: N {x1.shape[0]}, fix_scale {fix_scale}, s {float(got[0]):.6f}, "
          f"max |ds|,|dR|,|dt| {err:.3g}, masks differ on {frac:.4f}, n {n_k} vs {n_p}")
    return err


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


def main():
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

    # ---- phase 2: build
    zero_launches()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.load, _build.SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f} s  per source {json.dumps(_build.BUILD_SECONDS)}")
    launches2 = read_launches()

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

    # kernel 1: the whole pyramid of frame 0, all four stacks
    fast_args = (cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
    image = torch.from_numpy(frames[0]).to(dev).float()
    lt = pyramid.level_tables(480, 640, cfg.n_levels, cfg.scale, dev)
    got1 = k1.fast_nms(image, lt, *fast_args)
    ref1 = k1.fast_nms_frame_plain(image, lt, *fast_args)
    torch.cuda.synchronize()
    names1 = ("pyr3", "pyr3_blur", "score", "is_hi")
    errs1 = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(names1, got1, ref1)}
    exact1 = all(torch.equal(a, b) for a, b in zip(got1, ref1))
    if not exact1:
        # the levels within 1e-4 (0-255 scale); the rest exact given the kernel's own levels
        own = k1.detect_stack_plain(got1[0], lt, *fast_args)
        if errs1["pyr3"] > 1e-4 or not all(torch.equal(a, b) for a, b in zip(got1[1:], own)):
            fail(f"fast_nms differs from its frame-wide twin: {errs1}")
    print(f"fast_nms vs frame-wide twin: bit-exact {exact1}, max abs err {json.dumps(errs1)}")
    H0, W0 = 480, 640
    pixels = sum(h * w for h, w in lt.shapes)
    resize_ops = sum(2 * (h * W0 * ty + h * w * tx)
                     for l, ((h, w), (ty, tx)) in enumerate(zip(lt.shapes, lt.taps)) if l > 0)
    record("fast_nms", max(errs1.values()), time_ms(lambda: k1.fast_nms(image, lt, *fast_args)),
           time_ms(lambda: k1.fast_nms_frame_plain(image, lt, *fast_args), 10),
           4 * H0 * W0 + cfg.n_levels * H0 * W0 * (3 * 4 + 1),
           resize_ops + (BLUR_OPS_PER_PIXEL + FAST_OPS_PER_PIXEL) * pixels, bit_exact=exact1,
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

    # kernel 3: every gate kind, integer outputs exactly equal to the twin
    feats = [extractor.extract(torch.from_numpy(f).to(dev), tab, cfg) for f in frames[:21]]
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
    stack = lambda name: torch.stack([getattr(f, name) for f in feats[1:21]]).contiguous()
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
    cases3 = {   # name: (desc1, desc2, row_valid, col_valid, gate, [(max_dist, ratio, mutual)])
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
    }
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
    main3 = cases3["window+octave B=1 4096x1024"]
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
        ref = k4.optimize_pose_batched_plain(*args)
        torch.cuda.synchronize()
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
    # (0.08 m baseline)
    from orb_slam2_annotate_tpu_torch.geometry import lie
    dep = torch.from_numpy(depths[0]).to(dev)
    xi = f0.xy[:, 0].round().long().clamp(0, 639)
    yi = f0.xy[:, 1].round().long().clamp(0, 479)
    z = dep[yi, xi]
    R_gt = torch.from_numpy(poses[0][0]).to(dev)
    t_gt = torch.from_numpy(poses[0][1]).to(dev)
    xc = torch.stack([(f0.xy[:, 0] - cam.cx) / cam.fx * z, (f0.xy[:, 1] - cam.cy) / cam.fy * z, z], 1)
    xw = ((xc - t_gt) @ R_gt).contiguous()
    noise = torch.randn(1024, 3, generator=gen, device=dev)
    uv = (f0.xy + noise[:, :2]).contiguous()
    isg = (1.0 / 1.2 ** (2.0 * f0.octave.float())).contiguous()
    valid = (f0.valid & (z > 0)).contiguous()
    xi_pert = torch.tensor([0.01, -0.02, 0.015, 0.002, -0.003, 0.001], device=dev)
    scales = torch.tensor([1.0, 0.5, 2.0, -1.0, 1.5, -0.5, 0.75, -2.0], device=dev)
    R8, t8 = lie.se3_retract(R_gt.expand(8, 3, 3), t_gt.expand(8, 3), scales[:, None] * xi_pert)
    R8, t8 = R8.contiguous(), t8.contiguous()
    cam_st = dataclasses.replace(cam, bf=cam.fx * 0.08)
    ur_mono = torch.full((1024,), -1.0, device=dev)
    ur_st = torch.where(torch.arange(1024, device=dev) % 2 == 0,
                        uv[:, 0] - cam_st.bf / z.clamp_min(1e-3) + noise[:, 2], ur_mono)
    args_b1 = (cam, R8[:1], t8[:1], xw[None], uv, ur_mono, isg, valid[None])
    args_b8 = (cam, R8, t8, xw.expand(8, -1, -1).contiguous(), uv, ur_mono, isg,
               valid.expand(8, -1).contiguous())
    err4 = max(check_pose_lm("synthetic mono", args_b1),
               check_pose_lm("synthetic half stereo", (cam_st, *args_b1[1:5], ur_st, *args_b1[6:])),
               check_pose_lm("synthetic mono, 8 start poses", args_b8))
    pose_b8 = {"ms_b1_synthetic": time_ms(lambda: k4.optimize_pose_batched(*args_b1)),
               "ms_b8": time_ms(lambda: k4.optimize_pose_batched(*args_b8)),
               "bound_ms_b8": bound(*pose_lm_work(args_b8[3], ur_mono, args_b8[7]))[0]}
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
        err8 = max(err8, check_sim3_lm(f"synthetic, fix_scale {fix}", args8))
    for what, (x1b, x2b, uv1b, uv2b, is1b), vb in (
            ("4096 pairs all valid", pair_set(N4k, False), valid4k),
            ("3 valid pairs", pair_set(N7, False, exact=True), torch.arange(N7, device=dev) < 3)):
        err8 = max(err8, check_sim3_lm(what, (x1b, x2b, uv1b, uv2b, vb, is1b, None, *start8(False),
                                              *consts7[:4], False, 100.0)))
    args8 = (*pairs7[False][:4], valid7, pairs7[False][4], ones7, *start8(False), *consts7[:4],
             False, 100.0)
    record("sim3_lm_solve", err8, time_ms(lambda: k7.sim3_lm_solve(*args8)),
           time_ms(lambda: k7.sim3_lm_solve_plain(*args8), 3), *sim3_lm_work(valid7, k7.LM_ITERS),
           graph_us=graph_us(lambda: k7.sim3_lm_solve(*args8)),
           **device_kernels(lambda: k7.sim3_lm_solve(*args8), 1))

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

    launches3 = read_launches()
    print(f"launches in phase 3's checks and timings: {json.dumps(launches3)}")

    def drive(name, slam, images, counted, track=lambda slam, img, ts: slam.track_mono(img, ts)):
        """One main-path run: counters zeroed just before, read just after;
        fails unless every kernel in `counted` was launched."""
        zero_launches()
        torch.cuda.synchronize()
        out, frame_s = [], []
        for k, img in enumerate(images):
            t0 = time.perf_counter()
            out.append(track(slam, img, k / 30.0))
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        launches = read_launches()
        print(f"launches in the {name} run: {json.dumps(launches)}")
        print(f"{name}: frame wall time median {1e3 * statistics.median(frame_s):.2f} ms, "
              f"max {1e3 * max(frame_s):.2f} ms (frame {frame_s.index(max(frame_s))})")
        idle = [n for n in counted if launches[n] == 0]
        if idle:
            fail(f"{name}: kernels never launched: {idle}")
        return out, frame_s, launches

    # ---- phase 4: the mono System through System.track_mono
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

    pose_opt.optimize_pose = count_opt
    matching.match_gated = count_match
    map_state._stats_from_table = count_stats
    local_mapping.create_new_mappoints = matcher_launches_in(real_tri, tri_launches)
    tracking.relocalize_candidates = matcher_launches_in(real_reloc, reloc_launches)
    lm_calls[0] = 0
    _, frame_s, launches4 = drive("slice", slam, frames,
                                  [w for n, (_, _, w) in SOURCES.items()
                                   if n not in ("pnp_hypotheses",) + LOOP_ONLY + STEREO_ONLY])
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
              "a local-map call captured": "args" in captured_lm,
              "a stats table captured": "table" in captured_lm}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"slice checks failed: {bad}")
    slice_out = {"frames_per_s": N_FRAMES / wall, "ate_m": ate, "tracked": n_tracked,
                 "keyframes": slam.n_keyframes, "map_points": slam.n_mappoints,
                 "optimize_pose_calls": calls4, "matcher_calls": match_calls4,
                 "triangulations": len(tri4), "stats_refreshes": stats4}
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
           **device_kernels(lambda: k4.optimize_pose_batched(*args_lm), 1))

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
                                           if n not in LOOP_ONLY + STEREO_ONLY])
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

    # ---- phase 6: a loop with SlamConfig()'s own defaults (loop closing on)
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.solvers import sim3 as sim3_mod

    t0 = time.perf_counter()
    cam6, gt6, images6, loop_cfg = loop_setup()
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
    loop_mod.optimize_pose_graph = timed("loop/pose_graph", saved[8])
    loop_mod.optimize_pose_graph_cg = timed("loop/pose_graph", saved[9])
    match_calls[0] = 0
    try:
        _, frame_s6, launches6 = drive("loop", slam6, images6,
                                       [w for n, (_, _, w) in SOURCES.items()
                                        if n not in ("pnp_hypotheses",) + STEREO_ONLY])
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
          f"closed {lc6.n_loops_closed}, global BAs dispatched {lc6.n_gba_dispatched}, folded "
          f"{lc6.n_gba_folded}; ATE {ate6:.5f} m (bound {ate_bound6:.5f}, JAX {LOOP_ATE_JAX}), tracked "
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
        e8 = check_sim3_lm(f"the loop's {when} optimize_sim3 input", a8)
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

    def depth_run(name, sensor, images, track, counted):
        """One depth-sensor run with the matcher, optimize_pose and
        relocalization-polish calls counted, and the edges of one local-map
        optimize_pose with stereo rows from the second half kept."""
        slam_d = System(cam_d, depth_config(sensor), device="cuda")
        kept, polishes = {}, [0]

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
        lm_calls[0], match_calls[0] = 0, 0
        try:
            _, frame_s_d, launches_d = drive(name, slam_d, images, counted, track)
        finally:
            pose_opt.optimize_pose, matching.match_gated = real_opt, real_match
            pnp_mod.optimize_pose_batched = real_polish
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
                  "a local-map call with stereo rows captured": "args" in kept}
        return slam_d, out, launches_d, kept, checks

    def outcome_bounds(out, ate_jax):
        bound_d = max(1.5 * ate_jax, ate_jax + 0.01)
        out.update(ate_bound_m=bound_d, ate_jax_m=ate_jax)
        return {f"SE3 ATE <= {bound_d:.5f} (JAX {ate_jax:.5f})": out["ate_se3_m"] <= bound_d}

    # phase 7: RGB-D, the rendered depth
    _, out7, launches7, kept7, checks = depth_run(
        "rgbd", "rgbd", list(zip(frames, depths)),
        lambda slam, fd, ts: slam.track_rgbd(fd[0], fd[1], ts),
        [w for n, (_, _, w) in SOURCES.items() if n not in ("pnp_hypotheses",) + LOOP_ONLY
         + STEREO_ONLY])
    checks.update(outcome_bounds(out7, RGBD_ATE_JAX))
    checks.update({"displacement within 5%": abs(out7["displacement_ratio"] - 1.0) < 0.05,
                   "one fast_nms launch per frame": launches7["fast_nms"] == N_FRAMES,
                   "one orb_describe call per frame": launches7["orb_describe"] == N_FRAMES,
                   "no stereo_match or remap_pair launch":
                       launches7["stereo_match"] == 0 and launches7["remap_pair"] == 0})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"rgbd checks failed: {bad}")
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

    _, out8, launches8, kept8, checks = depth_run(
        "stereo", "stereo", list(zip(frames, rights)), track8,
        [w for n, (_, _, w) in SOURCES.items() if n not in ("pnp_hypotheses",) + LOOP_ONLY])
    # compared after the run, so the frame times hold only the rectifier and track_stereo
    up = lambda im: torch.from_numpy(im).to(dev).float()
    moved8 = [k for k, ((il, ir), fl_, fr_) in enumerate(zip(rectified, frames, rights))
              if not (torch.equal(il, up(fl_)) and torch.equal(ir, up(fr_)))]
    if len(rectified) != N_FRAMES:
        fail(f"stereo: {len(rectified)} rectified pairs for {N_FRAMES} frames")
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
    err_st8 = check_pose_lm("captured stereo local-map call", kept8["args"])
    r4["max_abs_err"] = max(r4["max_abs_err"], err_st8)

    kern = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches4[w] + launches5[w] + launches6[w] + launches7[w] + launches8[w],
             "launches_by_phase": {"1 card": launches1[w], "2 build": launches2[w],
                                   "3 twins": launches3[w], "4 slice": launches4[w],
                                   "5 kidnap": launches5[w], "6 loop": launches6[w],
                                   "7 rgbd": launches7[w], "8 stereo": launches8[w]},
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
                               "optimize_sim3_calls": calls6["optimize_sim3"]},
                      "rgbd": out7, "stereo": out8, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
