#!/usr/bin/env python3
"""The loop closure's solver stages on the card, for one tree of the port.

    python3 tools/closure_times.py [--root DIR] [--reps N]

Imports ``orb_slam2_annotate_tpu_torch`` from DIR (default: this checkout),
so that two trees can be timed on one card in one sitting (run them in
turns: parent, change, change, parent), and the cells from this checkout's
``chip_smoke.py``.  On one card, the host clock with the card drained
around each timed call:

1. phase 6's loop cell (``chip_smoke.loop_setup``: ``SlamConfig()``'s
   defaults, culling off, 180 frames at 320x240) through
   ``System.track_mono``: the closure's pose graph (``loop/pose_graph``)
   and its global BA's dispatch (``loop/gba``, ``bundle_adjust_cg`` over
   the map), and the run's closures and ATE;
2. phase 14's merge (two RGB-D sessions of phases 7-8's VGA cell, frames
   0-27 and 20-47, ``merge_maps(fix_scale=True)``): its joint BA
   (``bundle_adjust_cg``);
3. phase 15's dense LM step: phase 6's closure map padded to K 128 / P
   16,384 / N 1,024, one step of the dense ``bundle_adjust``, the median
   of N calls (default 9), and the global BA there (``bundle_adjust_cg``,
   10 steps of 25 PCG iterations), the median of N.

The stages of 1 and 2 are their first call in the process; each is also
timed again on its own inputs, kept from that call, as the median of N
calls (``*_steady_ms``).

Prints one JSON line with the card's name and power limit
(``nvidia-smi``).  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)              # the tree under test's package
    import importlib.util

    import torch

    # the cells from this checkout's chip_smoke.py, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_cells",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import orb_slam2_annotate_tpu_torch as port

    if not torch.cuda.is_available():
        sys.exit("closure_times: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from orb_slam2_annotate_tpu_torch import kernels
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.pipeline import System
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as loop_mod
    from orb_slam2_annotate_tpu_torch.solvers import ba_cg, ba_core
    from orb_slam2_annotate_tpu_torch.worldmap import map_state, merge

    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    stages = {"loop/pose_graph": [], "loop/gba": [], "merge joint BA": []}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name].append(1e3 * (time.perf_counter() - t))
            return out
        return run

    # 1. phase 6's loop cell
    cam6, gt6, images6, _, loop_cfg = cs.loop_setup()
    slam = System(cam6, loop_cfg, device="cuda")
    lc = slam.loop_closer
    kept = {}
    real_gba = lc._dispatch_global_ba

    def keep_gba(m, anchor):
        if "map" not in kept:
            kept["map"] = map_state.MapState(**{f.name: getattr(m, f.name).clone()
                                                for f in dataclasses.fields(map_state.MapState)})
            kept["anchor"] = int(anchor)
        return real_gba(m, anchor)

    def keep_args(name, fn):
        def run(*a, **kw):
            kept.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return run

    lc._dispatch_global_ba = timed("loop/gba", keep_gba)
    saved = (loop_mod.optimize_pose_graph, loop_mod.optimize_pose_graph_cg)
    loop_mod.optimize_pose_graph = timed("loop/pose_graph", keep_args("pose_graph", saved[0]))
    loop_mod.optimize_pose_graph_cg = timed("loop/pose_graph", keep_args("pose_graph", saved[1]))
    t0 = time.perf_counter()
    try:
        for k, img in enumerate(images6):
            slam.track_mono(img, k / 30.0)
    finally:
        loop_mod.optimize_pose_graph, loop_mod.optimize_pose_graph_cg = saved
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    ate6, n6 = cs.ate_of(slam, gt6, range(cs.LOOP_FRAMES))

    # 2. the merge's joint BA
    cam, poses, frames, depths, _ = cs.slice_setup()
    cam_d, _, depth_config = cs.depth_setup(poses)

    def session(span):
        s_ = System(cam_d, depth_config("rgbd"), device="cuda")
        for k in span:
            s_.track_rgbd(frames[k], depths[k], k / 30.0)
        s_.flush()
        return s_

    sess_a, sess_b = session(cs.MERGE_A), session(cs.MERGE_B)
    real_cg = ba_cg.bundle_adjust_cg
    ba_cg.bundle_adjust_cg = timed("merge joint BA", keep_args("joint_ba", real_cg))
    try:
        res = merge.merge_maps(sess_a.map, sess_b.map, cam_d, vocab=sess_a.loop_closer.vocab,
                               fix_scale=True)
    finally:
        ba_cg.bundle_adjust_cg = real_cg

    # 3. phase 15's dense LM step and global BA at full width
    m = cs.pad_map(kept["map"], cs.DIST_K, cs.DIST_P, cs.DIST_N)
    prob = loop_mod.full_map_ba_problem(m, kept["anchor"])

    def median_ms(fn):
        fn()
        ts = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t))
        return statistics.median(ts), ts

    a_pg, kw_pg = kept["pose_graph"]
    solve = (loop_mod.optimize_pose_graph if a_pg[0].s.shape[0] <= 128
             else loop_mod.optimize_pose_graph_cg)
    pg_ms, pg_all = median_ms(lambda: solve(*a_pg, **kw_pg))
    gba_ms, gba_all = median_ms(lambda: loop_mod.global_ba_cg(
        cam6, kept["map"], kept["anchor"], lc.cfg.global_ba_iters, cg_iters=25))
    a_j, kw_j = kept["joint_ba"]
    joint_ms, joint_all = median_ms(lambda: real_cg(*a_j, **kw_j))
    step_ms, step_all = median_ms(lambda: ba_core.bundle_adjust(cam6, prob, 1))
    cg_ms, cg_all = median_ms(lambda: ba_cg.bundle_adjust_cg(cam6, prob, cs.DIST_ITERS, 25))
    print(json.dumps({
        "root": root, "package": os.path.dirname(port.__file__), "card": card,
        "kernel_sources": sorted(_build.SOURCES), "wrappers": [w.__name__ for w in kernels.WRAPPERS],
        "build_s": build_s, "loop_cell_s": loop_s, "loops_closed": lc.n_loops_closed,
        "gba_folded": lc.n_gba_folded, "tracked": n6, "ate_m": float(ate6),
        "loop/pose_graph_ms": stages["loop/pose_graph"], "loop/gba_ms": stages["loop/gba"],
        "merge_success": bool(res.success), "merge_joint_ba_ms": stages["merge joint BA"],
        "pose_graph_steady_ms": pg_ms, "pose_graph_steady_all_ms": pg_all,
        "gba_steady_ms": gba_ms, "gba_steady_all_ms": gba_all,
        "merge_joint_ba_steady_ms": joint_ms, "merge_joint_ba_steady_all_ms": joint_all,
        "dense_lm_step_ms": step_ms, "dense_lm_step_all_ms": step_all,
        "global_ba_full_width_ms": cg_ms, "global_ba_full_width_all_ms": cg_all,
        "padded": {"K": m.K, "P": m.P, "N": m.N, "edges_live": int(prob.edge_valid.sum())}}))


if __name__ == "__main__":
    main()
