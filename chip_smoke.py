#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build every CUDA kernel of the slice from csrc/ with nvcc;
  3. compare each kernel with its plain torch twin on the card, at the
     shapes of the main path (PlaneScene seed 1, VGA, 8 levels, 1024
     keypoints), and time both with CUDA events;
  4. run the monocular slice through ``System.track_mono`` on 48 frames at
     VGA / 1024 features / 8 levels, with every launch counter reset just
     before, and check tracking state, keyframes, map points, ATE and that
     every kernel was launched.
The line before the last is a JSON object with per-kernel results; the
last line is the device summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_FRAMES = 48
ATE_BOUND = 0.08   # m, Sim3-aligned; tests/test_e2e_mono.py's bound
SOURCES = {
    "fast_nms": ("orb_slam2_annotate_tpu_torch/csrc/fast_nms.cu",
                 "orb_slam2_annotate_tpu/ops/fast.py:40"),
    "orb_describe": ("orb_slam2_annotate_tpu_torch/csrc/orb_describe.cu",
                     "orb_slam2_annotate_tpu/ops/orb.py:256"),
    "hamming_match": ("orb_slam2_annotate_tpu_torch/csrc/hamming.cu",
                      "orb_slam2_annotate_tpu/ops/matching.py:77"),
    "hamming_pairwise_batched": ("orb_slam2_annotate_tpu_torch/csrc/hamming.cu",
                                 "orb_slam2_annotate_tpu/worldmap/map_state.py:397"),
    "pose_linearize": ("orb_slam2_annotate_tpu_torch/csrc/pose_lm.cu",
                       "orb_slam2_annotate_tpu/solvers/pose_opt.py:49"),
    "pose_costs": ("orb_slam2_annotate_tpu_torch/csrc/pose_lm.cu",
                   "orb_slam2_annotate_tpu/solvers/pose_opt.py:112"),
}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    from orb_slam2_annotate_tpu_torch.io import evaluation
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import fast_nms as k1
    from orb_slam2_annotate_tpu_torch.kernels import hamming as k3
    from orb_slam2_annotate_tpu_torch.kernels import orb_describe as k2
    from orb_slam2_annotate_tpu_torch.kernels import pose_lm as k4
    from orb_slam2_annotate_tpu_torch.ops import extractor, matching, orb, pyramid
    from orb_slam2_annotate_tpu_torch.pipeline import System

    if "jax" in sys.modules:
        fail("the port imported jax")
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build
    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s  per source {json.dumps(_build.BUILD_SECONDS)}")

    # ---- phase 3: kernels vs plain twins at main-path shapes
    t0 = time.perf_counter()
    cam, poses, frames, depths, slice_cfg = slice_setup()
    print(f"render: {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s (host numpy)")
    cfg = slice_cfg.extractor
    tab = orb.OrbTables().to(dev)
    results = {}

    def record(name, err, ms, plain_ms):
        results[name] = {"max_abs_err": float(err), "ms": float(ms), "plain_ms": float(plain_ms)}
        print(f"kernel {name}: max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")

    # kernel 1: every level of frame 0
    fast_args = (cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
    image = torch.from_numpy(frames[0]).to(dev).float()
    levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale)
    err1 = 0.0
    for lv in levels:
        s_k, h_k = k1.fast_nms(lv, *fast_args)
        s_p, h_p = k1.fast_nms_plain(lv, *fast_args)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(h_k, h_p)):
            fail(f"fast_nms differs from its plain twin at level {tuple(lv.shape)}")
        err1 = max(err1, float((s_k - s_p).abs().max()),
                   float((h_k.float() - h_p.float()).abs().max()))
    run_k = lambda: [k1.fast_nms(lv, *fast_args) for lv in levels]
    run_p = lambda: [k1.fast_nms_plain(lv, *fast_args) for lv in levels]
    record("fast_nms", err1, time_ms(run_k), time_ms(run_p))

    # kernel 2: the frame's 1024 keypoints
    budgets = pyramid.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)
    parts = [extractor.detect_level(lv, b, cfg, l) for l, (lv, b) in enumerate(zip(levels, budgets))]
    xy_l, _, octv, valid = (torch.cat([p[i] for p in parts]) for i in range(4))
    H0, W0 = levels[0].shape
    pad3 = lambda ims: torch.stack([torch.nn.functional.pad(im, (0, W0 - im.shape[1], 0, H0 - im.shape[0]))
                                    for im in ims])
    pyr3 = pad3(levels)
    pyr3b = pad3([pyramid.gaussian_blur(lv) for lv in levels])
    level_hw = torch.tensor([list(lv.shape) for lv in levels], dtype=torch.int32, device=dev)
    args2 = (pyr3, pyr3b, level_hw, xy_l.contiguous(), octv, valid, tab)
    a_k, d_k = k2.orb_describe(*args2)
    a_p, d_p = k2.orb_describe_plain(*args2)
    torch.cuda.synchronize()
    ang_err = float((a_k - a_p).abs().max())
    same_bin = orb.angle_bins(a_k) == orb.angle_bins(a_p)
    frac = float(same_bin[valid].float().mean())
    if ang_err > 1e-4 or frac < 0.995 or not torch.equal(d_k[same_bin], d_p[same_bin]):
        fail(f"orb_describe: angle err {ang_err}, same-bin fraction {frac}")
    record("orb_describe", ang_err, time_ms(lambda: k2.orb_describe(*args2)),
           time_ms(lambda: k2.orb_describe_plain(*args2)))

    # kernel 3: matches with real window masks between frames
    feats = [extractor.extract(torch.from_numpy(f).to(dev), tab, cfg) for f in frames[:5]]
    cur = feats[4]
    d1 = torch.cat([f.desc for f in feats[:4]])                       # 4096 "map points"
    xy1 = torch.cat([f.xy for f in feats[:4]])
    oc1 = torch.cat([f.octave for f in feats[:4]])
    ok1 = torch.cat([f.valid for f in feats[:4]])
    radius = 15.0 * 1.2 ** oc1.float()
    mask_4k = (matching.window_mask(xy1, cur.xy, radius) & matching.octave_mask(oc1, cur.octave)
               & ok1[:, None] & cur.valid[None, :]).contiguous()
    mask_1k = mask_4k[3072:].contiguous()
    d1k = d1[3072:].contiguous()
    err3 = 0
    for dd, mm in ((d1, mask_4k), (d1k, mask_1k)):
        for mutual in (False, True):
            for mx, ratio in ((matching.TH_HIGH, 0.9), (matching.TH_LOW, 1.0)):
                ik, sk = k3.hamming_match(dd, cur.desc, mm, mx, ratio, mutual)
                ip, sp = k3.hamming_match_plain(dd, cur.desc, mm, mx, ratio, mutual)
                torch.cuda.synchronize()
                if not (torch.equal(ik, ip) and torch.equal(sk, sp)):
                    fail(f"hamming_match differs ({dd.shape[0]}x1024, mutual={mutual})")
                err3 = max(err3, int((ik - ip).abs().max()), int((sk - sp).abs().max()))
    args3 = (d1, cur.desc, mask_4k, matching.TH_HIGH, 0.8, False)
    record("hamming_match", err3, time_ms(lambda: k3.hamming_match(*args3)),
           time_ms(lambda: k3.hamming_match_plain(*args3)))
    gen = torch.Generator(device=dev).manual_seed(0)
    pick = torch.randint(0, d1.shape[0], (4096, 32), generator=gen, device=dev)
    q = d1[pick].contiguous()                                         # [4096, 32, 16]
    pk = k3.hamming_pairwise_batched(q, q)
    pp = k3.hamming_pairwise_batched_plain(q, q)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        fail("hamming_pairwise_batched differs from its plain twin")
    record("hamming_pairwise_batched", int((pk - pp).abs().max()), time_ms(lambda: k3.hamming_pairwise_batched(q, q)),
           time_ms(lambda: k3.hamming_pairwise_batched_plain(q, q)))

    # kernel 4: 1024 edges from frame 0's keypoints back-projected with the exact depth
    f0 = feats[0]
    dep = torch.from_numpy(depths[0]).to(dev)
    xi = f0.xy[:, 0].round().long().clamp(0, 639)
    yi = f0.xy[:, 1].round().long().clamp(0, 479)
    z = dep[yi, xi]
    R_gt = torch.from_numpy(poses[0][0]).to(dev)
    t_gt = torch.from_numpy(poses[0][1]).to(dev)
    xc = torch.stack([(f0.xy[:, 0] - cam.cx) / cam.fx * z, (f0.xy[:, 1] - cam.cy) / cam.fy * z, z], 1)
    xw = ((xc - t_gt) @ R_gt).contiguous()
    noise = torch.randn(1024, 2, generator=gen, device=dev)
    uv = (f0.xy + noise).contiguous()
    ur = torch.full((1024,), -1.0, device=dev)
    isg = (1.0 / 1.2 ** (2.0 * f0.octave.float())).contiguous()
    mask = (f0.valid & (z > 0)).contiguous()
    from orb_slam2_annotate_tpu_torch.geometry import lie
    xi_pert = torch.tensor([[0.01, -0.02, 0.015, 0.002, -0.003, 0.001]], device=dev)
    Rs, ts = lie.se3_retract(R_gt.expand(3, 3, 3), t_gt.expand(3, 3),
                             xi_pert * torch.tensor([[1.0], [0.5], [2.0]], device=dev))
    # Each entry of H, g and the cost is a sum over the edges taken in another
    # order: it must agree within 1e-4 of the sum of its terms' magnitudes
    # (Huber weights <= 1, so unit weights bound them from above).
    r, J, _, _ = k4.residual_jac(cam, Rs[0], ts[0], xw, uv, ur)
    Jw = J.abs() * (isg * mask)[None, None, :]
    bounds = (torch.einsum("rin,rjn->ij", Jw, J.abs()), torch.einsum("rin,rn->i", Jw, r.abs()))
    err4, worst4 = 0.0, 0.0
    for robust in (True, False):
        Hk, gk, ck = k4.pose_linearize(cam, Rs[0], ts[0], xw, uv, ur, isg, mask, robust)
        Hp, gp, cp = k4.pose_linearize_plain(cam, Rs[0], ts[0], xw, uv, ur, isg, mask, robust)
        torch.cuda.synchronize()
        for a, b, mag in ((Hk, Hp, bounds[0]), (gk, gp, bounds[1]), (ck, cp, cp.abs())):
            diff = (a - b).abs()
            err4 = max(err4, float(diff.max()))
            worst4 = max(worst4, float((diff / mag.clamp_min(1e-12)).max()))
    print(f"pose_linearize: largest |kernel - plain| / sum of |terms| {worst4:.3g}")
    if worst4 > 1e-4:
        fail(f"pose_linearize: an entry differs by {worst4:.3g} of its terms' magnitude")
    args4 = (cam, Rs[0], ts[0], xw, uv, ur, isg, mask, True)
    record("pose_linearize", err4, time_ms(lambda: k4.pose_linearize(*args4)),
           time_ms(lambda: k4.pose_linearize_plain(*args4)))
    argsc = (cam, Rs, ts, xw, uv, ur, isg, mask)
    ck = k4.pose_costs(*argsc)
    cp = k4.pose_costs_plain(*argsc)
    torch.cuda.synchronize()
    rel = float(((ck - cp).abs() / cp.abs().clamp_min(1e-12)).max())
    if rel > 1e-4:
        fail(f"pose_costs relative error {rel}")
    record("pose_costs", float((ck - cp).abs().max()), time_ms(lambda: k4.pose_costs(*argsc)),
           time_ms(lambda: k4.pose_costs_plain(*argsc)))

    # ---- phase 4: the slice through System.track_mono
    slam = System(cam, slice_cfg, device="cuda")
    for w in kernels.WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, img in enumerate(frames):
        slam.track_mono(img, k / 30.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    if len(ids) < 3:
        fail(f"only {len(ids)} tracked frames")
    est_c = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt_c = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    ate = evaluation.ate_rmse(est_c.astype(np.float64), gt_c.astype(np.float64), with_scale=True)[0]
    print(f"slice: {N_FRAMES} frames in {wall:.2f} s = {N_FRAMES / wall:.2f} frames/s, "
          f"ATE {ate:.5f} m, tracked {len(ids)}/{N_FRAMES}, keyframes {slam.n_keyframes}, "
          f"map points {slam.n_mappoints}, state {slam.state}, card {card}")
    print(f"launches in the slice run: {json.dumps(launches)}")
    checks = {"state OK": slam.state == "OK", "tracked >= 70%": len(ids) >= 0.7 * N_FRAMES,
              "keyframes >= 3": slam.n_keyframes >= 3, "map points > 100": slam.n_mappoints > 100,
              f"ATE < {ATE_BOUND}": ate < ATE_BOUND,
              "every kernel launched": all(v > 0 for v in launches.values())}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"slice checks failed: {bad}")

    kern = [{"name": n, "route": "cuda", "source": SOURCES[n][0], "replaces": SOURCES[n][1],
             "launches": launches[n], **results[n]} for n in SOURCES]
    print(json.dumps({"kernels": kern, "slice": {"frames_per_s": N_FRAMES / wall, "ate_m": ate,
                                                  "tracked": len(ids), "keyframes": slam.n_keyframes,
                                                  "card": card}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
