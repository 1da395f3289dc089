#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build every CUDA kernel from csrc/ with nvcc, one process per source,
     all started together;
  3. compare kernels 1-5 with their plain torch twins on the card, at the
     shapes of the main path (PlaneScene seed 1, VGA, 8 levels, 1024
     keypoints, the trained 16384-word vocabulary), and time both with
     CUDA events;
  4. run the monocular System (``mono_slice_config``: relocalization and
     keyframe culling on) through ``System.track_mono`` on 48 frames at
     VGA / 1024 features / 8 levels, with every launch counter reset just
     before, and check tracking state, keyframes, map points, ATE and that
     kernels 1-5 were launched;
  5. a kidnapped run at the same width: a 64-frame sweep, then a jump back
     to frame 4 and three frames from there, counters reset just before;
     check that the jump frame is tracked after a relocalization, that all
     six kernels were launched, the final state and the ATE; then compare
     kernel 6 with its twin on the inputs the relocalization gave it
     (8 candidates x 256 hypotheses x 1024 points) and time both.
The line before the last is a JSON object with per-kernel results; the
last line is the device summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
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
    "assign_words": ("orb_slam2_annotate_tpu_torch/csrc/assign_words.cu",
                     "orb_slam2_annotate_tpu/worldmap/vocabulary.py:81"),
    "pnp_score": ("orb_slam2_annotate_tpu_torch/csrc/pnp_score.cu",
                  "orb_slam2_annotate_tpu/solvers/pnp.py:90"),
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
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import assign_words as k5
    from orb_slam2_annotate_tpu_torch.kernels import fast_nms as k1
    from orb_slam2_annotate_tpu_torch.kernels import hamming as k3
    from orb_slam2_annotate_tpu_torch.kernels import orb_describe as k2
    from orb_slam2_annotate_tpu_torch.kernels import pnp_score as k6
    from orb_slam2_annotate_tpu_torch.kernels import pose_lm as k4
    from orb_slam2_annotate_tpu_torch.ops import extractor, matching, orb, pyramid
    from orb_slam2_annotate_tpu_torch.pipeline import System
    from orb_slam2_annotate_tpu_torch.pipeline.loop_closing import TRAINED_VOCAB
    from orb_slam2_annotate_tpu_torch.solvers import pnp as pnp_mod
    from orb_slam2_annotate_tpu_torch.worldmap import vocabulary

    if "jax" in sys.modules:
        fail("the port imported jax")
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.load, _build.SOURCES))
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

    # kernel 5: the 1024 descriptors of frame 4 against the trained vocabulary
    vocab = vocabulary.load_vocabulary(TRAINED_VOCAB, device=dev)
    args5 = (cur.desc, vocab.words, cur.valid)
    w_k = k5.assign_words(*args5)
    w_p = k5.assign_words_plain(*args5, vocab.signs)
    torch.cuda.synchronize()
    if vocab.n_words != 16384 or not torch.equal(w_k, w_p):
        fail(f"assign_words differs from its plain twin ({int((w_k != w_p).sum())} rows)")
    record("assign_words", int((w_k - w_p).abs().max()), time_ms(lambda: k5.assign_words(*args5)),
           time_ms(lambda: k5.assign_words_plain(*args5, vocab.signs)))

    def drive(name, slam, images, counted):
        """One main-path run: counters zeroed just before, read just after;
        fails unless every kernel in `counted` was launched."""
        for w in kernels.WRAPPERS:
            w.launches = 0
        torch.cuda.synchronize()
        out, frame_s = [], []
        for k, img in enumerate(images):
            t0 = time.perf_counter()
            out.append(slam.track_mono(img, k / 30.0))
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        print(f"launches in the {name} run: {json.dumps(launches)}")
        print(f"{name}: frame wall time median {1e3 * statistics.median(frame_s):.2f} ms, "
              f"max {1e3 * max(frame_s):.2f} ms (frame {frame_s.index(max(frame_s))})")
        idle = [n for n in counted if launches[n] == 0]
        if idle:
            fail(f"{name}: kernels never launched: {idle}")
        return out, frame_s, launches

    # ---- phase 4: the mono System through System.track_mono
    slam = System(cam, slice_cfg, device="cuda")
    _, frame_s, launches4 = drive("slice", slam, frames, [n for n in SOURCES if n != "pnp_score"])
    wall = sum(frame_s)
    ate, n_tracked = ate_of(slam, poses, range(N_FRAMES))
    print(f"slice: {N_FRAMES} frames in {wall:.2f} s = {N_FRAMES / wall:.2f} frames/s, "
          f"ATE {ate:.5f} m, tracked {n_tracked}/{N_FRAMES}, keyframes {slam.n_keyframes} "
          f"(culled {int(slam.map.n_kf) - slam.n_keyframes}), "
          f"map points {slam.n_mappoints}, state {slam.state}, card {card}")
    checks = {"state OK": slam.state == "OK", "tracked >= 70%": n_tracked >= 0.7 * N_FRAMES,
              "keyframes >= 3": slam.n_keyframes >= 3, "map points > 100": slam.n_mappoints > 100,
              f"ATE < {ATE_BOUND}": ate < ATE_BOUND}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"slice checks failed: {bad}")
    slice_out = {"frames_per_s": N_FRAMES / wall, "ate_m": ate, "tracked": n_tracked,
                 "keyframes": slam.n_keyframes}

    # ---- phase 5: kidnapped run; the jump frame must relocalize
    t0 = time.perf_counter()
    scene = synthetic.PlaneScene(seed=1)
    gt5 = synthetic.orbit_trajectory(KIDNAP_SWEEP, step=KIDNAP_STEP)
    seq = list(range(KIDNAP_SWEEP)) + [KIDNAP_JUMP + i for i in range(4)]
    images5 = [np.clip(scene.render(cam, *gt5[f], h=480, w=640)[0], 0, 255).astype(np.uint8)
               for f in seq]
    print(f"render: {len(seq)} frames in {time.perf_counter() - t0:.1f} s (host numpy)")
    slam5 = System(cam, slice_cfg, device="cuda")
    relocs, captured = [], {}
    try_reloc = slam5._try_relocalize
    slam5._try_relocalize = lambda f: relocs.append((slam5.frame_id, try_reloc(f))) or relocs[-1][1]
    real_score = pnp_mod.pnp_score

    def keep_inputs(*a):
        # the relocalization's own kernel-6 inputs, for the comparison below
        captured.setdefault("args", tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real_score(*a)

    pnp_mod.pnp_score = keep_inputs
    try:
        out5, frame_s5, launches5 = drive("kidnap", slam5, images5, list(SOURCES))
    finally:
        pnp_mod.pnp_score = real_score
    ate5, n5 = ate_of(slam5, gt5, seq)
    print(f"kidnap: {len(seq)} frames in {sum(frame_s5):.2f} s, jump frame "
          f"{1e3 * frame_s5[KIDNAP_SWEEP]:.2f} ms, relocalizations (frame, success) {relocs}, "
          f"ATE {ate5:.5f} m, tracked {n5}/{len(seq)}, keyframes {slam5.n_keyframes} "
          f"(culled {int(slam5.map.n_kf) - slam5.n_keyframes}), "
          f"state {slam5.state}, observation overflow {slam5.observation_overflow}, card {card}")
    checks = {"jump frame relocalized": (KIDNAP_SWEEP, True) in relocs,
              "jump frame returns a pose": out5[KIDNAP_SWEEP] is not None,
              "state OK": slam5.state == "OK", f"ATE < {ATE_BOUND}": ate5 < ATE_BOUND}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"kidnap checks failed: {bad}")
    args6 = captured["args"]
    if tuple(args6[0].shape[:2]) != (8, 256) or args6[2].shape[1] != slice_cfg.n_features:
        fail(f"pnp_score inputs of shape {tuple(args6[0].shape)} / {tuple(args6[2].shape)}")
    c_k = k6.pnp_score(*args6)
    c_p = k6.pnp_score_plain(*args6)
    torch.cuda.synchronize()
    if not torch.equal(c_k, c_p):
        fail(f"pnp_score differs from its plain twin ({int((c_k != c_p).sum())} hypotheses)")
    record("pnp_score", int((c_k - c_p).abs().max()), time_ms(lambda: k6.pnp_score(*args6)),
           time_ms(lambda: k6.pnp_score_plain(*args6)))

    kern = [{"name": n, "route": "cuda", "source": SOURCES[n][0], "replaces": SOURCES[n][1],
             "launches": launches4[n] + launches5[n],
             "launches_by_phase": {"slice": launches4[n], "kidnap": launches5[n]}, **results[n]}
            for n in SOURCES]
    print(json.dumps({"kernels": kern, "slice": slice_out,
                      "kidnap": {"ate_m": ate5, "tracked": n5, "frames": len(seq),
                                 "jump_frame_ms": 1e3 * frame_s5[KIDNAP_SWEEP],
                                 "keyframes": slam5.n_keyframes, "relocalizations": relocs},
                      "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
