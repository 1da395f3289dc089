#!/usr/bin/env python3
"""Kernel 4 (the pose-only LM, ``optimize_pose_batched``) alone on the card,
at the five call shapes of the main path.

    python3 tools/k4_shapes.py [--roots DIR,DIR,...]

The shapes are kept from runs of the port's Systems on ``chip_smoke.py``'s
cells, the way its phases keep them: the first local-map ``optimize_pose``
call from the second half of the mono slice (phase 4), of the RGB-D run with
stereo rows (phase 7) and of the stereo run (phase 8, the pairs fed as they
are rendered), the relocalization's polish batch of the kidnap run (phase
5), and ``chip_smoke.pose_lm_synthetic``'s eight start poses on frame 0's
keypoints (phase 3's B = 8 call, its noise drawn here from seed 0).

Then, for each tree in ``--roots`` in turn (default: this checkout; give
``_trees/parent,.,.,_trees/parent`` to time a parent and a change on one card
in one sitting), ``orb_slam2_annotate_tpu_torch`` is imported from that tree
and its kernel is held to its own plain twin at each shape (chip_smoke's
tolerances: R and t within 1e-4 on the problems either leaves at or above the
PnP gate's 15 inliers, n within 1%, masks on <= 1% of the edges), two calls
equal bit for bit, then timed: the CUDA-graph replay (``chip_smoke.graph_us``)
and the 100-call clock (``chip_smoke.time_ms``).  One JSON line a tree and
shape, then a line with the card's name and power limit (``nvidia-smi``).
Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("local-map", "RGB-D", "stereo", "B = 8 synthetic", "polish batch")


def load(name: str, path: str):
    """The module at `path`, imported as `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def import_tree(root: str):
    """``orb_slam2_annotate_tpu_torch.kernels.pose_lm`` of the tree at `root`
    (any earlier import of the package dropped)."""
    for p in [p for p in sys.path if os.path.isdir(os.path.join(p, "orb_slam2_annotate_tpu_torch"))]:
        sys.path.remove(p)
    for mod in [m for m in sys.modules if m.startswith("orb_slam2_annotate_tpu_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, root)
    from orb_slam2_annotate_tpu_torch.kernels import pose_lm

    return pose_lm


def clone(args):
    import torch

    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


def capture(cs, names=SHAPES):
    """{shape: optimize_pose_batched's arguments} for the shapes in `names`,
    kept from runs of this checkout's Systems on the card."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from orb_slam2_annotate_tpu_torch.ops import extractor, orb
    from orb_slam2_annotate_tpu_torch.pipeline import System
    from orb_slam2_annotate_tpu_torch.solvers import pnp as pnp_mod
    from orb_slam2_annotate_tpu_torch.solvers import pose_opt

    dev = torch.device("cuda:0")
    cam, poses, frames, depths, cfg = cs.slice_setup()
    out = {}
    real_opt, real_polish = pose_opt.optimize_pose, pnp_mod.optimize_pose_batched

    def run(key, slam, images, track, stereo_rows=False):
        """Keep the first local-map call from the second half of the run (with
        stereo rows, if asked) under `key`, and the first polish batch."""
        def keep(c_, R0, t0, obs, *a, **kw):
            if (key not in out and sys._getframe(1).f_code.co_name == "track_local_map"
                    and slam.frame_id >= cs.N_FRAMES // 2
                    and (not stereo_rows or bool(((obs.ur >= 0) & obs.valid).any()))):
                out[key] = (c_, R0[None].clone(), t0[None].clone(), obs.xw[None].clone(),
                            obs.uv.clone(), obs.ur.clone(), obs.inv_sigma2.clone(),
                            obs.valid[None].clone())
            return real_opt(c_, R0, t0, obs, *a, **kw)

        def keep_polish(*a):
            out.setdefault("polish batch", clone(a))
            return real_polish(*a)

        pose_opt.optimize_pose, pnp_mod.optimize_pose_batched = keep, keep_polish
        try:
            for k, img in enumerate(images):
                track(slam, img, k / 30.0)
        finally:
            pose_opt.optimize_pose, pnp_mod.optimize_pose_batched = real_opt, real_polish
        torch.cuda.synchronize()

    if "local-map" in names:
        run("local-map", System(cam, cfg, device="cuda"), frames,
            lambda s, img, ts: s.track_mono(img, ts))
    if "polish batch" in names:
        _, _, images5 = cs.kidnap_setup(cam)
        run("kidnap", System(cam, cfg, device="cuda"), images5,
            lambda s, img, ts: s.track_mono(img, ts))
        out.pop("kidnap", None)
    if "RGB-D" in names or "stereo" in names:
        cam_d, rights, config = cs.depth_setup(poses)
        if "RGB-D" in names:
            run("RGB-D", System(cam_d, config("rgbd"), device="cuda"), list(zip(frames, depths)),
                lambda s, fd, ts: s.track_rgbd(fd[0], fd[1], ts), stereo_rows=True)
        if "stereo" in names:
            run("stereo", System(cam_d, config("stereo"), device="cuda"), list(zip(frames, rights)),
                lambda s, p, ts: s.track_stereo(p[0], p[1], ts), stereo_rows=True)
    if "B = 8 synthetic" in names:
        f0 = extractor.extract(torch.from_numpy(frames[0]).to(dev), orb.OrbTables().to(dev),
                               cfg.extractor)
        gen = torch.Generator(device=dev).manual_seed(0)
        noise = torch.randn(1024, 3, generator=gen, device=dev)
        out["B = 8 synthetic"] = cs.pose_lm_synthetic(cam, f0, np.asarray(depths[0]), poses[0],
                                                      noise)["b8"]
    missing = [n for n in names if n not in out]
    if missing:
        raise RuntimeError(f"k4_shapes: no call kept for {missing}")
    return {n: out[n] for n in names}


def check(k4, args, min_inliers: int = 15) -> dict:
    """The kernel against the tree's twin at chip_smoke's tolerances, and two
    calls bit for bit; raises on a miss."""
    import torch

    got = k4.optimize_pose_batched(*args)
    again = k4.optimize_pose_batched(*args)
    ref = k4.optimize_pose_batched_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("k4_shapes: two calls differ")
    pose_err = torch.maximum((got[0] - ref[0]).abs().amax((1, 2)), (got[1] - ref[1]).abs().amax(1))
    held = (got[3] >= min_inliers) | (ref[3] >= min_inliers)
    err = float(pose_err[held].max()) if bool(held.any()) else 0.0
    frac = float((got[2] != ref[2]).float().mean(1).max()) if got[2].numel() else 0.0
    dn = int((got[3] - ref[3]).abs().max()) if got[3].numel() else 0
    n_max = int(ref[3].max()) if ref[3].numel() else 0
    if err > 1e-4 or frac > 0.01 or dn > math.ceil(0.01 * n_max):
        raise RuntimeError(f"k4_shapes: off the twin: |dR|,|dt| {err}, masks {frac}, n by {dn}")
    return {"max_abs_err": err, "mask_frac": frac, "n_diff": dn}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", default=HERE)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k4_shapes: no CUDA device")
    cs = load("chip_smoke_k4", os.path.join(HERE, "chip_smoke.py"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    shapes = capture(cs)
    for root in [os.path.abspath(r) for r in args.roots.split(",")]:
        k4 = import_tree(root)
        for name, a in shapes.items():
            valid, ur = a[7], a[5]
            row = {"root": root, "shape": name, "B": int(valid.shape[0]), "N": int(valid.shape[1]),
                   "edges": int(valid.sum()), "stereo_rows": int(((ur >= 0) & valid).sum()),
                   **check(k4, a),
                   "graph_us": cs.graph_us(lambda: k4.optimize_pose_batched(*a)),
                   "ms": cs.time_ms(lambda: k4.optimize_pose_batched(*a)),
                   "bound_ms": cs.bound(*cs.pose_lm_work(a[3], ur, valid))[0]}
            print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
