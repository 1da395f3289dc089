"""Seeded local-BA grid problems in numpy, for kernel 12's checks: shared by
tests/test_torch_grid_ba.py (the twin against JAX on the CPU) and
chip_smoke.py phase 3 (the kernel against the twin on the card).

A problem is a dict of the GridBA fields (float32, bool, int32 pt_loc), with
the camera in CAM: C keyframes (the first `n_free` free, the rest fixed) in
a row looking at P points in a box 5-9 m ahead, each with a random 40-80% of
its N slots holding a visible point in random slot order, the others -1 (a
point that only one slot sees is dropped: local BA's points are
triangulated);
pixel noise by octave, a fraction of outliers, a fraction of stereo rows and
of invalid slots; the free poses and the points start perturbed (`start`:
the rotation's and the translation's and the points' standard deviations,
rad and m, about what tracking and triangulation leave to local BA).
"""

from __future__ import annotations

import numpy as np

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=150.0)
FIELDS = ("R", "t", "points", "cam_fixed", "cam_valid", "pt_valid", "pt_loc", "uv", "ur",
          "inv_sigma2", "edge_valid")


def so3(w):
    """Rodrigues: the rotation of the axis-angle vector w."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(w, np.float64) / th
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * K @ K


def grid_problem(seed: int, C: int = 32, N: int = 1024, P: int = 2048, n_free: int | None = None,
                 stereo: float = 0.5, outliers: float = 0.05, invalid: float = 0.02,
                 start: tuple = (0.002, 0.005, 0.01), cam: dict = CAM) -> dict:
    rng = np.random.default_rng(seed)
    n_free = C // 2 if n_free is None else n_free
    Xt = rng.uniform([-4.0, -3.0, 5.0], [4.0, 3.0, 9.0], (P, 3))
    centres = np.stack([np.linspace(-1.5, 1.5, C), rng.normal(0, 0.2, C), rng.normal(0, 0.2, C)], 1)
    Rt = np.stack([so3(rng.normal(0, 0.05, 3)) for _ in range(C)])
    tt = -np.einsum("cij,cj->ci", Rt, centres)
    pt_loc = np.full((C, N), -1, np.int32)
    uv = np.zeros((C, N, 2))
    ur = np.full((C, N), -1.0)
    octave = rng.integers(0, 8, (C, N))
    for c in range(C):
        xc = Xt @ Rt[c].T + tt[c]
        z = xc[:, 2]
        u = cam["fx"] * xc[:, 0] / z + cam["cx"]
        v = cam["fy"] * xc[:, 1] / z + cam["cy"]
        vis = np.nonzero((z > 0.5) & (u >= 0) & (u < 640) & (v >= 0) & (v < 480))[0]
        k = min(len(vis), int(rng.integers(int(0.4 * N), int(0.8 * N) + 1)))
        pts = rng.permutation(vis)[:k]
        slots = rng.choice(N, k, replace=False)
        sig = 1.2 ** octave[c, slots]
        pt_loc[c, slots] = pts
        uv[c, slots, 0] = u[pts] + rng.normal(0, 0.7, k) * sig
        uv[c, slots, 1] = v[pts] + rng.normal(0, 0.7, k) * sig
        out = rng.random(k) < outliers
        uv[c, slots[out]] += rng.uniform(15, 40, (int(out.sum()), 2)) * rng.choice([-1, 1], (int(out.sum()), 2))
        st = rng.random(k) < stereo
        ur[c, slots[st]] = (uv[c, slots[st], 0] - cam["bf"] / z[pts[st]]
                            + rng.normal(0, 0.7, int(st.sum())) * sig[st])
    # a point local BA holds is triangulated: one seen by a single slot is dropped
    once = np.bincount(pt_loc[pt_loc >= 0], minlength=P) == 1
    pt_loc[(pt_loc >= 0) & once[np.clip(pt_loc, 0, None)]] = -1
    edge_valid = (pt_loc >= 0) & (rng.random((C, N)) >= invalid)
    R0, t0 = Rt.copy(), tt.copy()
    for c in range(n_free):
        R0[c] = so3(rng.normal(0, start[0], 3)) @ Rt[c]
        t0[c] = tt[c] + rng.normal(0, start[1], 3)
    X0 = Xt + rng.normal(0, start[2], (P, 3))
    f32 = np.float32
    return dict(R=R0.astype(f32), t=t0.astype(f32), points=X0.astype(f32),
                cam_fixed=np.arange(C) >= n_free, cam_valid=np.ones(C, bool),
                pt_valid=np.ones(P, bool), pt_loc=pt_loc, uv=uv.astype(f32), ur=ur.astype(f32),
                inv_sigma2=(1.2 ** (-2.0 * octave)).astype(f32), edge_valid=edge_valid)


def with_duplicates(prob: dict, seed: int, n: int = 8) -> dict:
    """Copy n observed slots of the free cameras into empty slots of the same
    camera (some below, some above the original), uv moved by a pixel: the
    (point, camera) pair then has two slots (fuse's duplicates)."""
    p = {k: v.copy() for k, v in prob.items()}
    rng = np.random.default_rng(seed)
    C = p["pt_loc"].shape[0]
    free = np.nonzero(~p["cam_fixed"])[0]
    for j in range(n):
        c = free[j % len(free)]
        full = np.nonzero(p["edge_valid"][c])[0]
        empty = np.nonzero(p["pt_loc"][c] < 0)[0]
        src = full[rng.integers(len(full))]
        below = empty[empty < src]
        dst = (below[-1] if j % 2 == 0 and len(below) else empty[rng.integers(len(empty))])
        for k in ("pt_loc", "ur", "inv_sigma2", "edge_valid"):
            p[k][c, dst] = p[k][c, src]
        p["uv"][c, dst] = p["uv"][c, src] + 1.0
    assert C >= 1
    return p


def with_point_behind(prob: dict, c: int = 0) -> dict:
    """Move one point that camera c observes 2 m behind it, and another to
    5e-4 m in front of it (both fail the depth test there)."""
    p = {k: v.copy() for k, v in prob.items()}
    obs = p["pt_loc"][c][p["edge_valid"][c]]
    R, t = p["R"][c].astype(np.float64), p["t"][c].astype(np.float64)
    centre = -R.T @ t
    p["points"][obs[0]] = (centre - 2.0 * R[2]).astype(np.float32)
    p["points"][obs[1]] = (centre + 5e-4 * R[2]).astype(np.float32)
    return p


def with_camera_cases(prob: dict) -> dict:
    """Every camera fixed but camera 0; camera 1 invalid and fixed, camera 2
    invalid and not fixed (its slots stay valid: its Jacobians count, its
    step is held at 0)."""
    p = {k: v.copy() for k, v in prob.items()}
    p["cam_fixed"][:] = True
    p["cam_fixed"][0] = False
    p["cam_fixed"][2] = False
    p["cam_valid"][1] = False
    p["cam_valid"][2] = False
    return p


def problem_cases(C: int, N: int, P: int, seed: int) -> dict:
    """name -> (problem, iters, robust, lam0, lam_ladder): the synthetic cases
    of kernel 12's checks at this size (P_small < P for the ragged point
    count)."""
    base = grid_problem(seed, C, N, P)
    mono = grid_problem(seed + 1, C, N, P, stereo=0.0)
    ladder = (1.0, 8.0, 64.0)
    return {
        "stereo rows, outliers": (base, 4, True, 1e-5, ladder),
        "mono, 6 iterations": (mono, 6, True, 1e-5, ladder),
        "duplicate (point, camera) slots": (with_duplicates(base, seed), 4, True, 1e-5, ladder),
        "points behind a camera": (with_point_behind(base), 4, True, 1e-5, ladder),
        "invalid and all-but-one fixed cameras": (with_camera_cases(base), 4, True, 1e-5, ladder),
        f"P = {P * 3 // 4}": (grid_problem(seed + 2, C, N, P * 3 // 4), 4, True, 1e-5, ladder),
        # a negative damping makes the damped camera system indefinite: every
        # try's factorization fails, so no step is taken
        "not positive definite (every try)": (base, 2, True, 1.0, (-2.0, -3.0, -4.0)),
        "not positive definite (the first try)": (base, 4, True, 1.0, (-2.0, 1.0, 8.0)),
        "lambda at the lower clamp": (base, 4, True, 1e-9, ladder),
        "lambda at the upper clamp": (base, 4, True, 1e6, ladder),
        "robust=False": (base, 4, False, 1e-5, ladder),
    }
