"""Kernels 7 and 8: loop closing's Sim3 RANSAC after its draw, and its Sim3 LM.

``sim3_ransac_solve`` (kernel 7) runs the reference's ``sim3_ransac`` from
the sampled triples on, in one launch: Horn's Sim3 of every triple of
matched point pairs, each hypothesis's inliers by reprojection in both
directions, the first hypothesis with the most, the weighted Horn over its
inliers, and the refined Sim3 where it counts at least as many.
``sim3_lm_solve`` (kernel 8) runs a whole ``optimize_sim3``: 8 LM
iterations over paired forward / inverse reprojection edges with a Huber
kernel, a damping ladder lambda x {1, 8, 64} and a chi2 inlier refresh, in
one launch.  Both launch ``csrc/sim3.cu`` for CUDA tensors and run their
plain twins (``sim3_ransac_solve_plain``, ``sim3_lm_solve_plain``) for CPU
tensors; each wrapper's ``launches`` counts its kernel launches.  The
inverse sigma^2 arguments may be None (all ones; the kernels then read
nothing for them).

Kernel 7's twin takes only +, -, x, / and sqrt, each rounded once, in the
kernel's order (built with ``--fmad=false``), so every output is bit-exact.
Horn's quaternion is the eigenvector of the symmetric 4x4 Q with the
largest eigenvalue, from JACOBI_SWEEPS cyclic Jacobi sweeps (a pair rotates
only while q_pq^2 > 2^-48 (q_pp^2 + q_qq^2)), the last on ties as the
reference's ``eigh`` (ascending) leaves it; q and -q give the same R, so
the result agrees with the reference to float32 accuracy.  The weighted
Horn's sums over the N pairs run as ``tree_sum``: zeros up to a power of
two, then adjacent pairs added level by level.  Every division is by a
tensor (PyTorch's CUDA division by a Python number multiplies by the
reciprocal, which rounds twice).

Kernel 8's twin is the reference's formulation: ``torch.func.jacfwd``
through ``sim3_retract`` and ``torch.linalg.solve``; the kernel uses the
analytic left-tangent Jacobian and a row-parallel elimination without
pivoting (the damped normal matrix is positive definite), and sums in
another order (tolerances in the tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..geometry import lie
from . import _build

JACOBI_SWEEPS = 6      # cyclic sweeps of the 4x4 Q (pairs 01 02 03 12 13 23)
ORTHO_TOL2 = 2.0 ** -48
MAX_N = 4096           # pairs staged in shared memory by both kernels
MAX_H = (1 << 15) - 1  # kernel 7's hypotheses a call
LM_ITERS = 8           # the reference's optimize_sim3 default
LM_LAMBDA0 = 1e-4
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


# ---- plain twins -----------------------------------------------------------

def jacobi_eig4(Q):
    """Eigen-decomposition of symmetric Q [..., 4, 4] by JACOBI_SWEEPS cyclic
    Jacobi sweeps: (eigenvalues [..., 4], eigenvectors as columns [..., 4, 4]).
    Every entry is its own tensor, updated as the kernel updates it."""
    a = [[Q[..., i, j] for j in range(4)] for i in range(4)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(4)] for i in range(4)]
    for _ in range(JACOBI_SWEEPS):
        for p, q in PAIRS:
            app, aqq, apq = a[p][p], a[q][q], a[p][q]
            rot = apq * apq > ORTHO_TOL2 * (app * app + aqq * aqq)
            theta = (aqq - app) / (apq + apq)
            sgn = torch.where(theta >= 0, one, -one)
            t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            c = one / torch.sqrt(t * t + 1.0)
            s = t * c
            keep = lambda new, old: torch.where(rot, new, old)
            for r in range(4):
                if r in (p, q):
                    continue
                arp, arq = a[r][p], a[r][q]
                a[r][p] = a[p][r] = keep(c * arp - s * arq, arp)
                a[r][q] = a[q][r] = keep(s * arp + c * arq, arq)
            a[p][p] = keep(app - t * apq, app)
            a[q][q] = keep(aqq + t * apq, aqq)
            a[p][q] = a[q][p] = keep(zero, apq)
            for r in range(4):
                vrp, vrq = v[r][p], v[r][q]
                v[r][p] = keep(c * vrp - s * vrq, vrp)
                v[r][q] = keep(s * vrp + c * vrq, vrq)
    vals = torch.stack([a[i][i] for i in range(4)], dim=-1)
    vecs = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    return vals, vecs


def horn_q(M):
    """Horn's symmetric 4x4 from M = sum a b^T [..., 3, 3]."""
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [[(Sxx + Syy) + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, (Sxx - Syy) - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, (-Sxx + Syy) - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, (-Sxx - Syy) + Szz]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def horn_rotation(Q):
    """R from the eigenvector of Q's largest eigenvalue (the last on ties)."""
    vals, vecs = jacobi_eig4(Q)
    k = 3 - torch.argmax(vals.flip(-1), dim=-1)
    q = torch.gather(vecs, -1, k[..., None, None].expand(*k.shape, 4, 1))[..., 0]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = [[1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy)],
         [2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx)],
         [2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)]]
    return torch.stack([torch.stack(r, dim=-1) for r in R], dim=-2)


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _matvec(R, x):
    """R x for R [..., 3, 3], x [..., 3], each row as _dot3."""
    return torch.stack([_dot3(R[..., i, :], x) for i in range(3)], dim=-1)


def horn3_plain(p1, p2, fix_scale: bool):
    """Horn's Sim3 of each triple, p1, p2 [H, 3, 3] (triple index, then
    coordinate), with p2 ~ s R p1 + t; every sum in the kernel's order."""
    three = torch.full_like(p1[:, 0, 0], 3.0)
    c1 = ((p1[:, 0] + p1[:, 1]) + p1[:, 2]) / three[:, None]
    c2 = ((p2[:, 0] + p2[:, 1]) + p2[:, 2]) / three[:, None]
    a = p1 - c1[:, None]
    b = p2 - c2[:, None]
    M = (a[:, 0, :, None] * b[:, 0, None, :] + a[:, 1, :, None] * b[:, 1, None, :]) \
        + a[:, 2, :, None] * b[:, 2, None, :]
    R = horn_rotation(horn_q(M))
    Ra = torch.stack([_matvec(R, a[:, k]) for k in range(3)], dim=1)
    num = (_dot3(Ra[:, 0], b[:, 0]) + _dot3(Ra[:, 1], b[:, 1])) + _dot3(Ra[:, 2], b[:, 2])
    den = torch.clamp_min((_dot3(Ra[:, 0], Ra[:, 0]) + _dot3(Ra[:, 1], Ra[:, 1]))
                          + _dot3(Ra[:, 2], Ra[:, 2]), 1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    t = c2 - s[:, None] * _matvec(R, c1)
    return s, R, t


def tree_sum(x):
    """Sum over the first axis as kernel 7's fixed tree: zeros appended up to
    a power of two, then adjacent pairs added level by level."""
    n = x.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p > n:
        x = torch.cat([x, x.new_zeros((p - n, *x.shape[1:]))])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def horn_sim3(x1, x2, w, fix_scale: bool = False):
    """Closed-form weighted Sim3 (s, R, t) with x2 ~ s R x1 + t (Horn 1987;
    the reference's ``horn_sim3``), x1, x2 [N,3], w [N]; every sum over the
    N pairs a ``tree_sum``, in kernel 7's order."""
    wsum = torch.clamp_min(tree_sum(w), 1e-9)
    c1 = tree_sum(x1 * w[:, None]) / wsum
    c2 = tree_sum(x2 * w[:, None]) / wsum
    a = x1 - c1
    b = x2 - c2
    M = tree_sum((a[:, :, None] * b[:, None, :]) * w[:, None, None])
    R = horn_rotation(horn_q(M))
    Ra = _matvec(R, a)
    num = tree_sum(_dot3(Ra, b) * w)
    den = torch.clamp_min(tree_sum(_dot3(Ra, Ra) * w), 1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    return s, R, c2 - s * _matvec(R, c1)


def inv_sigma2_or_ones(x1, is1, is2):
    """The inverse sigma^2 of both images, all ones where None."""
    ones = lambda: torch.ones(x1.shape[0], dtype=x1.dtype, device=x1.device)
    return ones() if is1 is None else is1, ones() if is2 is None else is2


def sim3_score_plain(s, R, t, x1, x2, uv1, uv2, valid, is1, is2, fx, fy, cx, cy, th):
    """[H, N] inlier masks of hypotheses s [H], R [H,3,3], t [H,3]: x1 through
    S into image 2 and x2 through S^-1 into image 1, both squared pixel
    errors (times inv_sigma2) below th and both depths positive."""
    sh, Rh, th3 = s[:, None], R[:, None], t[:, None]
    y2 = sh[..., None] * _matvec(Rh, x1[None]) + th3
    one = torch.ones_like(s)
    si = one / s
    Rt = R.transpose(-1, -2)
    ti = -(si[:, None] * _matvec(Rt, t))
    y1 = si[:, None, None] * _matvec(Rt[:, None], x2[None]) + ti[:, None]

    def err(y, uv, isg):
        z = torch.clamp_min(y[..., 2], 1e-6)
        du = (fx * y[..., 0] / z + cx) - uv[None, :, 0]
        dv = (fy * y[..., 1] / z + cy) - uv[None, :, 1]
        return (du * du + dv * dv) * isg[None]

    return (valid[None] & (err(y1, uv1, is1) < th) & (err(y2, uv2, is2) < th)
            & (y1[..., 2] > 0) & (y2[..., 2] > 0))


def sim3_ransac_solve_plain(samples, x1, x2, uv1, uv2, valid, is1, is2, fx: float, fy: float,
                            cx: float, cy: float, th: float, fix_scale: bool, min_inliers: int):
    """The reference's ``sim3_ransac`` after the draw.  samples [H,3] pair
    indices; x1, x2 [N,3] camera-frame points of the pairs; uv1, uv2 [N,2]
    their pixels; valid [N]; is1, is2 [N] inverse sigma^2 (or None) ->
    (s 0-d, R [3,3], t [3], inliers [N] bool, n 0-d int32, success 0-d
    bool, counts [H] int32: each hypothesis's inliers, best 0-d int64: the
    first hypothesis with the most)."""
    is1, is2 = inv_sigma2_or_ones(x1, is1, is2)
    consts = (x1, x2, uv1, uv2, valid, is1, is2, fx, fy, cx, cy, th)
    idx = samples.long()
    s, R, t = horn3_plain(x1[idx], x2[idx], fix_scale)
    inl = sim3_score_plain(s, R, t, *consts)
    counts = inl.sum(-1).to(torch.int32)
    best = torch.argmax(counts)
    inl_b, n_b = inl[best], counts[best]
    s_r, R_r, t_r = horn_sim3(x1, x2, inl_b.to(torch.float32), fix_scale)
    inl_r = sim3_score_plain(s_r[None], R_r[None], t_r[None], *consts)[0]
    n_r = inl_r.sum().to(torch.int32)
    use = n_r >= n_b
    n = torch.maximum(n_r, n_b)
    return (torch.where(use, s_r, s[best]), torch.where(use, R_r, R[best]),
            torch.where(use, t_r, t[best]), torch.where(use, inl_r, inl_b), n, n >= min_inliers,
            counts, best)


def project_residuals(fx, fy, cx, cy, s, R, t, x1, x2, uv1, uv2, is1, is2):
    """Paired residuals of one Sim3 guess (the reference's
    ``_sim3_project_residuals``): (r [N,4] forward then inverse,
    chi2_fwd [N], chi2_inv [N], depth_ok [N])."""
    y2 = s * (x1 @ R.T) + t
    z2 = torch.clamp_min(y2[:, 2], 1e-6)
    u2 = torch.stack([fx * y2[:, 0] / z2 + cx, fy * y2[:, 1] / z2 + cy], 1)
    si = 1.0 / s
    Ri = R.T
    ti = -si * (Ri @ t)
    y1 = si * (x2 @ Ri.T) + ti
    z1 = torch.clamp_min(y1[:, 2], 1e-6)
    u1 = torch.stack([fx * y1[:, 0] / z1 + cx, fy * y1[:, 1] / z1 + cy], 1)
    r_fwd = (u2 - uv2) * torch.sqrt(is2)[:, None]
    r_inv = (u1 - uv1) * torch.sqrt(is1)[:, None]
    depth_ok = (y1[:, 2] > 1e-3) & (y2[:, 2] > 1e-3)
    return (torch.cat([r_fwd, r_inv], 1), (r_fwd * r_fwd).sum(1), (r_inv * r_inv).sum(1),
            depth_ok)


def sim3_lm_solve_plain(x1, x2, uv1, uv2, valid, is1, is2, s0, R0, t0, fx: float, fy: float,
                        cx: float, cy: float, fix_scale: bool, chi2_th: float,
                        iters: int = LM_ITERS):
    """The reference's ``optimize_sim3``: (s 0-d, R [3,3], t [3], inlier [N]
    bool, n 0-d int32)."""
    dev = x1.device
    is1, is2 = inv_sigma2_or_ones(x1, is1, is2)
    res = lambda s, R, t: project_residuals(fx, fy, cx, cy, s, R, t, x1, x2, uv1, uv2, is1, is2)

    def robust_cost(s, R, t, inlier):
        _, c_f, c_i, dok = res(s, R, t)
        chi2 = c_f + c_i
        hub = torch.where(chi2 > chi2_th,
                          2.0 * torch.sqrt(chi2_th * torch.clamp_min(chi2, 0.0)) - chi2_th, chi2)
        hub = torch.where(dok, hub, 100.0 * chi2_th)
        return torch.sum(hub * (valid & inlier))

    def residuals(xi, s, R, t, w):
        # a batch of one: torch.func.jacfwd gives a float64 tangent to a 0-d
        # tensor combined with a Python number
        s1, R1, t1 = lie.sim3_retract(s[None], R[None], t[None], xi[None])
        r, *_ = res(s1, R1[0], t1[0])
        return (r * w[:, None]).reshape(-1)

    z7 = torch.zeros(7, device=dev)
    scale_mask = torch.ones(7, device=dev)
    scale_mask[6] = 0.0 if fix_scale else 1.0
    ladder = torch.tensor([1.0, 8.0, 64.0], device=dev)
    eye7 = torch.eye(7, device=dev)
    s, R, t = torch.as_tensor(s0, dtype=torch.float32, device=dev), R0, t0
    lam, inlier = torch.tensor(LM_LAMBDA0, device=dev), valid
    for _ in range(iters):
        _, c_f, c_i, dok = res(s, R, t)
        chi2 = c_f + c_i
        w_h = torch.where(chi2 > chi2_th, torch.sqrt(chi2_th / torch.clamp_min(chi2, 1e-12)), 1.0)
        w = torch.sqrt(w_h) * (valid & inlier & dok)
        r0 = residuals(z7, s, R, t, w)
        J = torch.func.jacfwd(residuals)(z7, s, R, t, w)          # [4N, 7]
        H = (J.T @ J) * scale_mask[:, None] * scale_mask[None, :] + torch.diag(1.0 - scale_mask)
        g = (J.T @ r0) * scale_mask
        cost = robust_cost(s, R, t, inlier)
        lams = lam * ladder
        Hd = H + lams[:, None, None] * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
        dx = -torch.linalg.solve(Hd, g.expand(3, 7)) * scale_mask
        s_a, R_a, t_a = lie.sim3_retract(s.expand(3), R.expand(3, 3, 3), t.expand(3, 3), dx)
        cost_a = torch.stack([robust_cost(s_a[k], R_a[k], t_a[k], inlier) for k in range(3)])
        improves = cost_a < cost
        pick = torch.argmax(improves.to(torch.uint8))
        any_imp = improves.any()
        s = torch.where(any_imp, s_a[pick], s)
        R = torch.where(any_imp, R_a[pick], R)
        t = torch.where(any_imp, t_a[pick], t)
        lam = torch.clamp(torch.where(any_imp, lams[pick] * 0.4, lam * 512.0), 1e-9, 1e6)
        _, c_f2, c_i2, dok2 = res(s, R, t)
        inlier = valid & (c_f2 < chi2_th) & (c_i2 < chi2_th) & dok2
    return s, R, t, inlier, inlier.sum().to(torch.int32)


# ---- the kernels -----------------------------------------------------------

@functools.cache
def _lib():
    lib = _build.load("sim3")
    h = lib.sim3_ransac_launch
    h.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_void_p]
    h.restype = ctypes.c_int
    lm = lib.sim3_lm_launch
    lm.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_float] * 4 \
        + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 5 + [ctypes.c_void_p]
    lm.restype = ctypes.c_int
    return lib


_WORKSPACES: dict = {}   # device -> [1 + MAX_H] int32: kernel 7's ticket, then its counts'
                         # accumulator; 0 between calls


def _pairs_checked(dev, N, x1, x2, uv1, uv2, valid, is1, is2):
    """Check the pairs a kernel reads; the pointers of is1 and is2 (0 for None)."""
    if not 0 < N <= MAX_N:
        raise ValueError(f"sim3 kernels take 1 to {MAX_N} pairs, got {N}")
    f32 = torch.float32
    for a, name, dt, shape in ((x1, "x1", f32, (N, 3)), (x2, "x2", f32, (N, 3)),
                               (uv1, "uv1", f32, (N, 2)), (uv2, "uv2", f32, (N, 2)),
                               (valid, "valid", torch.bool, (N,)), (is1, "is1", f32, (N,)),
                               (is2, "is2", f32, (N,))):
        if a is not None:
            _build.check_tensor(a, name, dt, shape, dev)
    return (0 if is1 is None else is1.data_ptr()), (0 if is2 is None else is2.data_ptr())


def sim3_ransac_solve(samples, x1, x2, uv1, uv2, valid, is1, is2, fx: float, fy: float,
                      cx: float, cy: float, th: float, fix_scale: bool, min_inliers: int):
    """One launch: the whole Sim3 RANSAC after its draw; see
    ``sim3_ransac_solve_plain``."""
    if not x1.is_cuda:
        return sim3_ransac_solve_plain(samples, x1, x2, uv1, uv2, valid, is1, is2, fx, fy, cx, cy,
                                       th, fix_scale, min_inliers)
    dev = x1.device
    H, N = samples.shape[0], x1.shape[0]
    if not 0 < H <= MAX_H:
        raise ValueError(f"sim3_ransac_solve: H = {H} hypotheses (1 to {MAX_H})")
    _build.check_tensor(samples, "samples", torch.int64, (H, 3), dev)
    p_is1, p_is2 = _pairs_checked(dev, N, x1, x2, uv1, uv2, valid, is1, is2)
    f32 = torch.float32
    hyp = torch.empty((H, 13), dtype=f32, device=dev)
    counts = torch.empty((H,), dtype=torch.int32, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    s = torch.empty((), dtype=f32, device=dev)
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty((3,), dtype=f32, device=dev)
    inliers = torch.empty((N,), dtype=torch.bool, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    success = torch.empty((), dtype=torch.bool, device=dev)
    ws = _WORKSPACES.get(dev)
    if ws is None:
        ws = _WORKSPACES[dev] = torch.zeros((1 + MAX_H,), dtype=torch.int32, device=dev)
    err = _lib().sim3_ransac_launch(
        samples.data_ptr(), x1.data_ptr(), x2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(),
        valid.data_ptr(), p_is1, p_is2, H, N, fx, fy, cx, cy, th, int(fix_scale), int(min_inliers),
        hyp.data_ptr(), ws.data_ptr() + 4, counts.data_ptr(), best.data_ptr(), s.data_ptr(),
        R.data_ptr(), t.data_ptr(), inliers.data_ptr(), n.data_ptr(), success.data_ptr(),
        ws.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "sim3_ransac_solve")
    sim3_ransac_solve.launches += 1
    return s, R, t, inliers, n, success, counts, best


sim3_ransac_solve.launches = 0


def sim3_lm_solve(x1, x2, uv1, uv2, valid, is1, is2, s0, R0, t0, fx: float, fy: float, cx: float,
                  cy: float, fix_scale: bool, chi2_th: float, iters: int = LM_ITERS):
    """One launch: the whole ``optimize_sim3``; see ``sim3_lm_solve_plain``."""
    if not x1.is_cuda:
        return sim3_lm_solve_plain(x1, x2, uv1, uv2, valid, is1, is2, s0, R0, t0, fx, fy, cx, cy,
                                   fix_scale, chi2_th, iters)
    dev = x1.device
    N = x1.shape[0]
    p_is1, p_is2 = _pairs_checked(dev, N, x1, x2, uv1, uv2, valid, is1, is2)
    f32 = torch.float32
    s0 = torch.as_tensor(s0, dtype=f32, device=dev).reshape(()).contiguous()
    R0, t0 = R0.to(f32).contiguous(), t0.to(f32).contiguous()
    _build.check_tensor(R0, "R0", f32, (3, 3), dev)
    _build.check_tensor(t0, "t0", f32, (3,), dev)
    s = torch.empty((), dtype=f32, device=dev)
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty((3,), dtype=f32, device=dev)
    inlier = torch.empty((N,), dtype=torch.bool, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    err = _lib().sim3_lm_launch(
        x1.data_ptr(), x2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(), valid.data_ptr(),
        p_is1, p_is2, s0.data_ptr(), R0.data_ptr(), t0.data_ptr(), N, fx, fy,
        cx, cy, int(fix_scale), iters, chi2_th, s.data_ptr(), R.data_ptr(), t.data_ptr(),
        inlier.data_ptr(), n.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "sim3_lm_solve")
    sim3_lm_solve.launches += 1
    return s, R, t, inlier, n


sim3_lm_solve.launches = 0
