#!/usr/bin/env python3
"""Hand one free-runner state to both packages and let each finish the run:
is a spread of outcomes the port's or the reference's?

    JAX_PLATFORMS=cpu python3 tools/free_state_handoff.py [--cell loop_rgbd] [--at 150]
                                                          [--seeds 0,1,2,3] [--threads 1]

The port's FreeRunner runs the cell (tools/port_free_cell.py's) on the CPU
up to frame `--at`; its FreeState then goes, through convert.py, to the port
and to the JAX FreeRunner (tools/jax_free_reference.py's config of the same
cell), once a value of ``SlamConfig.seed`` (the draws of the frames left).
Each prints one JSON line: package, seed, the frames of its closures and
its ATE (SE3 with depth, Sim3 mono) over the whole trajectory.  The head
run's state depends on float sums, so on torch's CPU thread count
(``--threads``, default 1): on the RGB-D loop cell one thread reaches
frame 150 ahead of a closure at 157, two threads ahead of one at 160.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import tools.jax_free_reference as jref  # noqa: E402
import tools.port_free_cell as pcell  # noqa: E402
from orb_slam2_annotate_tpu.pipeline import device_loop as jdl  # noqa: E402
from orb_slam2_annotate_tpu.pipeline.frame import Frame as JFrame  # noqa: E402
from orb_slam2_annotate_tpu.worldmap.map_state import MapState as JMapState  # noqa: E402
from orb_slam2_annotate_tpu_torch import convert  # noqa: E402
from orb_slam2_annotate_tpu_torch.io import evaluation  # noqa: E402
from orb_slam2_annotate_tpu_torch.pipeline import device_loop as tdl  # noqa: E402


def jax_state(d: dict):
    """The reference's FreeState from convert.free_state_to_numpy's dict."""
    def rec(fields, cls):
        f = dict(fields)
        for k in ("kf_desc", "mp_desc", "desc"):
            if k in f:
                f[k] = f[k].view(np.uint32)
        return cls(**{k: jnp.asarray(v) for k, v in f.items()})

    return jdl.FreeState(**{k: rec(v, JMapState) if k == "m" else rec(v, JFrame)
                            if k in ("last", "init_f") else jnp.asarray(v) for k, v in d.items()})


def ate(out, poses, with_scale):
    ids = [k for k, T in out["trajectory"] if T is not None]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in out["trajectory"]
                    if T is not None]).astype(np.float64)
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
    return float(evaluation.ate_rmse(est, gt, with_scale=with_scale)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="loop_rgbd", choices=("loop", "loop_rgbd"))
    ap.add_argument("--at", type=int, default=150)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    cam, cfg, poses, sensor, frames = pcell.cell(args.cell)
    feed = lambda r, k: (r.track_mono if sensor == "mono" else r.track_rgbd)(*frames[k], k / 30.0)
    head = tdl.FreeRunner(cam, cfg, max_frames=len(frames), auto_grow=False, device="cpu")
    for k in range(args.at):
        feed(head, k)
    state = convert.free_state_to_numpy(head.state)
    for seed in (int(s) for s in args.seeds.split(",")):
        jcam, jcfg, _, _, _ = jref.cell(args.cell, seed)
        for name, runner in (
                ("jax", jdl.FreeRunner(jcam, jcfg, max_frames=len(frames), auto_grow=False)),
                ("port", tdl.FreeRunner(cam, dataclasses.replace(cfg, seed=seed),
                                        max_frames=len(frames), auto_grow=False, device="cpu"))):
            runner.state = (jax_state(state) if name == "jax"
                            else convert.free_state_from_numpy(state, device="cpu"))
            runner.frame_id, runner._timestamps = args.at - 1, [k / 30.0 for k in range(args.at)]
            for k in range(args.at, len(frames)):
                feed(runner, k)
            out = runner.finish()
            print(json.dumps({"package": name, "seed": seed, "from_frame": args.at,
                              "threads": args.threads,
                              "closures": [int(c[0]) for c in np.asarray(out["closure_records"])],
                              "ate_m": ate(out, poses, sensor == "mono")}), flush=True)


if __name__ == "__main__":
    main()
