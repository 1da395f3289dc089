"""Kernel 6: relocalization's PnP hypotheses, from the sampled minimal sets
to each candidate's best hypothesis in one launch.

``pnp_hypotheses`` launches ``csrc/pnp_score.cu`` for CUDA tensors and runs
its plain twin ``pnp_hypotheses_plain`` for CPU tensors; ``launches``
counts kernel launches.  The twin is ``dlt_pnp`` on every sampled set, then
``pnp_score_plain``, then the first ``argmax`` of each candidate.

The DLT takes only +, -, x, / and sqrt, each rounded once, in a fixed
order, so that the kernel (built with ``--fmad=false``) repeats it bit for
bit: the null vector of the 13x12 system by one-sided (Hestenes) Jacobi on
its columns, a fixed number of round-robin sweeps (a pair rotates only
while it is not orthogonal to float32 precision); |det M|^(1/3) by square
roots and Newton steps (``cbrt_newton``); the projection onto SO(3) as the
polar factor, by the same Jacobi on M's three columns (``polar_factor``).
Every sum is written out in a fixed tree, and every division is by a tensor
(PyTorch's CUDA division by a Python number multiplies by its
reciprocal, which rounds twice).  P and -P give the same R and t after
the determinant scaling and the polar factor is unique, so the result does
not depend on the SVD's sign and ordering conventions: it matches the
reference's ``_dlt_pnp`` (JAX ``solvers/pnp.py:38``) to float32 accuracy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NULL_SWEEPS = 8     # Jacobi sweeps of the 12 DLT columns (11 rounds of 6 pairs each)
POLAR_SWEEPS = 6    # Jacobi sweeps of M's 3 columns (pairs 01, 02, 12)
NEWTON_STEPS = 4    # cube-root Newton steps after a square-root start
CBRT_TINY = 1e-36   # |det| below this gives |s| < 1e-12, the reference's floor
ORTHO_TOL2 = 2.0 ** -48   # a pair is rotated only while gamma^2 > ORTHO_TOL2 alpha beta
MAX_POINTS = 4096   # staged in shared memory by the kernel


def _rounds(n: int = 12):
    """Round-robin pairings of n columns: round r pairs n-1 with r and
    (r + k) mod (n-1) with (r - k) mod (n-1); each pair as (low, high)."""
    out = []
    for r in range(n - 1):
        pairs = [(r, n - 1)] + [tuple(sorted(((r + k) % (n - 1), (r - k) % (n - 1))))
                                for k in range(1, n // 2)]
        out.append((torch.tensor([p[0] for p in pairs]), torch.tensor([p[1] for p in pairs])))
    return out


ROUNDS = _rounds()


def _dot(a, b):
    """Sum over the last axis (12 or 3 terms) of a * b as a fixed tree:
    adjacent pairs, pairs of those, ..., an odd last term carried to the
    next level; for 12 terms ((q0 + q1) + (q2 + q3)) + (q4 + q5) of the
    pair sums q, for 3 (p0 + p1) + p2 (``sum12`` and ``dot3`` in the
    kernel)."""
    p = a * b
    while p.shape[-1] > 1:
        n = p.shape[-1]
        s = p[..., 0:n - 1:2] + p[..., 1:n:2]
        p = torch.cat([s, p[..., n - 1:]], dim=-1) if n % 2 else s
    return p[..., 0]


def _rotation(alpha, beta, gamma):
    """(c, s) of the Jacobi rotation that makes columns with squared norms
    alpha, beta and inner product gamma orthogonal; (1, 0) where the pair is
    already orthogonal to float32 precision, |gamma| <= 2^-24 sqrt(alpha
    beta) (the usual one-sided Jacobi threshold; it also keeps zeta finite)."""
    zeta = (beta - alpha) / (gamma + gamma)
    sgn = torch.where(zeta >= 0, 1.0, -1.0)
    t = sgn / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
    c = torch.ones_like(t) / torch.sqrt(1.0 + t * t)
    rot = gamma * gamma > (ORTHO_TOL2 * alpha) * beta
    return torch.where(rot, c, 1.0), torch.where(rot, c * t, 0.0)


def _det3(m):
    """det of [..., 3, 3] by the first row's cofactors, term by term."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _cross(x, y):
    return torch.stack([x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
                        x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
                        x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], dim=-1)


def cbrt_newton(a):
    """a^(1/3) for a >= CBRT_TINY: the start a^(1/4 + 1/16 + ... + 1/1024)
    from square roots (within 3% for every float32 a >= 1e-36), then
    NEWTON_STEPS steps x <- (2x + a / x^2) / 3."""
    r = torch.sqrt(torch.sqrt(a))
    x = r
    for _ in range(4):
        r = torch.sqrt(torch.sqrt(r))
        x = x * r
    three = torch.full_like(a, 3.0)
    for _ in range(NEWTON_STEPS):
        x = ((x + x) + a / (x * x)) / three
    return x


def polar_factor(M):
    """The orthogonal polar factor of M [..., 3, 3] (det M > 0): one-sided
    Jacobi on M's columns gives M V = B with orthogonal columns; the two
    longest become U's columns, the shortest is their cross product (exact
    where M is near singular), and R = U V^T."""
    B = M.transpose(-1, -2).clone()                   # [..., column, row]
    V = torch.eye(3, dtype=M.dtype, device=M.device).expand(B.shape).clone()
    for _ in range(POLAR_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            bp, bq = B[..., p, :], B[..., q, :]
            c, s = _rotation(_dot(bp, bp), _dot(bq, bq), _dot(bp, bq))
            c, s = c[..., None], s[..., None]
            vp, vq = V[..., p, :], V[..., q, :]
            B[..., p, :], B[..., q, :] = c * bp - s * bq, s * bp + c * bq
            V[..., p, :], V[..., q, :] = c * vp - s * vq, s * vp + c * vq
    n2 = torch.stack([_dot(B[..., j, :], B[..., j, :]) for j in range(3)], dim=-1)
    k = torch.argmin(n2, dim=-1)                      # first minimum
    u = B / torch.sqrt(n2)[..., None]
    crosses = [_cross(u[..., (j + 1) % 3, :], u[..., (j + 2) % 3, :]) for j in range(3)]
    U = torch.stack([torch.where((k == j)[..., None], crosses[j], u[..., j, :]) for j in range(3)],
                    dim=-2)                           # [..., column, row]
    # R[i][j] = sum over columns c of U[c][i] V[c][j], term by term
    R = U[..., 0, :, None] * V[..., 0, None, :]
    R = R + U[..., 1, :, None] * V[..., 1, None, :]
    return R + U[..., 2, :, None] * V[..., 2, None, :]


def null_vector(A):
    """Right null vector of A [..., rows, 12] by one-sided Jacobi on its
    columns: NULL_SWEEPS sweeps of ROUNDS; the accumulated rotation's column
    whose image is shortest (the first on ties)."""
    cols = A.transpose(-1, -2)                        # [..., 12, rows]
    n_rows = cols.shape[-1]
    eye = torch.eye(12, dtype=A.dtype, device=A.device).expand(*cols.shape[:-1], 12)
    AV = torch.cat([cols, eye], dim=-1).contiguous()  # column j: A's, then V's
    rounds = [(lo.to(A.device), hi.to(A.device)) for lo, hi in ROUNDS]
    for _ in range(NULL_SWEEPS):
        for lo, hi in rounds:
            x, y = AV[..., lo, :], AV[..., hi, :]
            xa, ya = x[..., :n_rows], y[..., :n_rows]
            c, s = _rotation(_dot(xa, xa), _dot(ya, ya), _dot(xa, ya))
            c, s = c[..., None], s[..., None]
            AV[..., lo, :] = c * x - s * y
            AV[..., hi, :] = s * x + c * y
    a = AV[..., :n_rows]
    k = torch.argmin(_dot(a, a), dim=-1)              # first minimum
    return torch.gather(AV[..., n_rows:], -2, k[..., None, None].expand(*k.shape, 1, 12))[..., 0, :]


def dlt_pnp(xw, xn):
    """Linear PnP from 6 points, batched: world [...,6,3], normalised camera
    coordinates [...,6,2] -> (R [...,3,3], t [...,3])."""
    X = torch.cat([xw, torch.ones_like(xw[..., :1])], dim=-1)            # [...,6,4]
    z = torch.zeros_like(X)
    u, v = xn[..., 0:1], xn[..., 1:2]
    # the reference's 13th row is zero: it adds exact zeros to every sum
    A = torch.cat([torch.cat([X, z, -u * X], dim=-1), torch.cat([z, X, -v * X], dim=-1)], dim=-2)
    P = null_vector(A).reshape(*A.shape[:-2], 3, 4)
    M = P[..., :3]
    det = _det3(M)
    a = torch.abs(det)
    tiny = a < CBRT_TINY
    x = cbrt_newton(torch.where(tiny, 1.0, a))
    s = torch.where(tiny, 1e-12, torch.where(det > 0, x, -x))
    s = torch.where(torch.abs(s) < 1e-12, 1e-12, s)
    R = polar_factor(M / s[..., None, None])
    dR = _det3(R)
    sign = (dR > 0).to(R.dtype) - (dR < 0).to(R.dtype)
    return R * sign[..., None, None], P[..., 3] / s[..., None]


def pnp_score_plain(Rs, ts, xw, uv, valid, fx: float, fy: float, cx: float, cy: float,
                    th: float):
    """Rs [C,S,3,3], ts [C,S,3], xw [C,N,3], uv [N,2], valid [C,N] ->
    [C,S] int32 counts of points with z > 1e-3 and squared pixel error < th."""
    R = Rs[..., None]                                  # [C,S,3,3,1]
    x = xw[:, None, None, :, :]                        # [C,1,1,N,3]
    xc = (x[..., 0] * R[:, :, :, 0] + x[..., 1] * R[:, :, :, 1]) + x[..., 2] * R[:, :, :, 2]
    xc = xc + ts[..., None]                            # [C,S,3,N]
    zok = xc[:, :, 2] > 1e-3
    z = torch.where(zok, xc[:, :, 2], 1.0)
    du = fx * xc[:, :, 0] / z + cx - uv[:, 0]
    dv = fy * xc[:, :, 1] / z + cy - uv[:, 1]
    inl = valid[:, None, :] & zok & (du * du + dv * dv < th)
    return inl.sum(-1).to(torch.int32)


def pnp_hypotheses_plain(samples, xw, uv, valid, fx: float, fy: float, cx: float, cy: float,
                         th: float):
    """samples [C,S,6] point indices, xw [C,N,3], uv [N,2] undistorted pixels,
    valid [C,N] -> (Rs [C,S,3,3], ts [C,S,3], ns [C,S] int32 inlier counts,
    best [C] int64: the first hypothesis with the most inliers)."""
    C = xw.shape[0]
    f = lambda v: torch.full_like(uv[:, 0], v)
    xn = torch.stack([(uv[:, 0] - cx) / f(fx), (uv[:, 1] - cy) / f(fy)], dim=1)
    samples = samples.long()
    ci = torch.arange(C, device=xw.device)[:, None, None]
    Rs, ts = dlt_pnp(xw[ci, samples], xn[samples])
    ns = pnp_score_plain(Rs, ts, xw, uv, valid, fx, fy, cx, cy, th)
    return Rs, ts, ns, torch.argmax(ns, dim=1)


# ---- the kernel ------------------------------------------------------------

@functools.cache
def _fn():
    fn = _build.load("pnp_score").pnp_hypotheses_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 \
        + [ctypes.c_void_p] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_TICKETS: dict = {}   # device -> [>= C] int32, 0 between calls


def _tickets(dev, C: int):
    """The device's per-candidate tickets, grown to fit.  They hold 0
    between calls: the kernel's last CTA of each candidate resets its
    ticket, and calls on one stream run in order."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < C:
        t = torch.zeros((C,), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def pnp_hypotheses(samples, xw, uv, valid, fx: float, fy: float, cx: float, cy: float, th: float):
    """One launch: every hypothesis's DLT, its inlier count and each
    candidate's best; see ``pnp_hypotheses_plain``."""
    if not xw.is_cuda:
        return pnp_hypotheses_plain(samples, xw, uv, valid, fx, fy, cx, cy, th)
    dev = xw.device
    C, S, N = samples.shape[0], samples.shape[1], xw.shape[1]
    if not 0 < N <= MAX_POINTS or not 0 < S < 1 << 16:
        raise ValueError(f"pnp_hypotheses: N = {N} points (1 to {MAX_POINTS}) and S = {S} "
                         f"hypotheses (1 to 65535) a candidate")
    for t, name, dt, shape in ((samples, "samples", torch.int64, (C, S, 6)),
                               (xw, "xw", torch.float32, (C, N, 3)),
                               (uv, "uv", torch.float32, (N, 2)),
                               (valid, "valid", torch.bool, (C, N))):
        _build.check_tensor(t, name, dt, shape, dev)
    Rs = torch.empty((C, S, 3, 3), dtype=torch.float32, device=dev)
    ts = torch.empty((C, S, 3), dtype=torch.float32, device=dev)
    ns = torch.empty((C, S), dtype=torch.int32, device=dev)
    best = torch.empty((C,), dtype=torch.int64, device=dev)
    err = _fn()(samples.data_ptr(), xw.data_ptr(), uv.data_ptr(), valid.data_ptr(), C, S, N,
                fx, fy, cx, cy, th, Rs.data_ptr(), ts.data_ptr(), ns.data_ptr(), best.data_ptr(),
                _tickets(dev, C).data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "pnp_hypotheses")
    pnp_hypotheses.launches += 1
    return Rs, ts, ns, best


pnp_hypotheses.launches = 0
