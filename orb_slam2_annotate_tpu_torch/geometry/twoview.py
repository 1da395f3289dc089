"""Two-view geometry: DLT triangulation, 8-point F, DLT H, symmetric chi2,
essential decomposition and check_rt (port of geometry/twoview.py).

Every function takes a leading batch of hypotheses where the reference
vmaps: ``fit_*`` over [S, n, 2] samples, ``check_rt`` over [B] poses.
"""

from __future__ import annotations

import torch

from .smallsolve import solve3


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous DLT triangulation.  P1, P2: [..., 3, 4] projections;
    x1, x2: [..., N, 2] observations.  Returns [..., N, 3]."""
    P1 = P1.unsqueeze(-3)
    P2 = P2.unsqueeze(-3)
    A = torch.stack([
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                           # [..., N, 4, 4]
    A3 = A[..., :3]
    AtA = A3.transpose(-1, -2) @ A3
    Atb = -torch.einsum("...ij,...i->...j", A3, A[..., 3])
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return solve3(AtA + 1e-12 * eye, Atb)


def _normalize_points(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over masked points.  pts [..., N, 2]."""
    w = mask.to(pts.dtype)
    n = torch.clamp_min(w.sum(-1), 1.0)
    mean = (pts * w[..., None]).sum(-2) / n[..., None]
    d = (pts - mean[..., None, :]) * w[..., None]
    mdev = d.abs().sum(-2) / n[..., None]
    s = 1.0 / torch.clamp_min(mdev, 1e-8)
    npts = (pts - mean[..., None, :]) * s[..., None, :]
    zero = torch.zeros_like(s[..., 0])
    one = torch.ones_like(zero)
    T = torch.stack([
        torch.stack([s[..., 0], zero, -mean[..., 0] * s[..., 0]], -1),
        torch.stack([zero, s[..., 1], -mean[..., 1] * s[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return npts, T


def fit_fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point F21 (x2^T F x1 = 0), rank 2.  x1, x2: [..., N, 2]."""
    w = mask.to(x1.dtype)
    n1, T1 = _normalize_points(x1, mask)
    n2, T2 = _normalize_points(x2, mask)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1) * w[..., None]
    A = torch.cat([A, torch.zeros_like(A[..., :1, :])], dim=-2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    f = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    U, S, Vt2 = torch.linalg.svd(f)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = (U * S[..., None, :]) @ Vt2
    return T2.transpose(-1, -2) @ Fn @ T1


def fit_homography_dlt(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized DLT homography x2 ~ H21 x1.  x1, x2: [..., N, 2]."""
    w = mask.to(x1.dtype)
    n1, T1 = _normalize_points(x1, mask)
    n2, T2 = _normalize_points(x2, mask)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None],
                   torch.zeros_like(r1[..., :1, :])], dim=-2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    h = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    Hn = torch.linalg.solve(T2, h @ T1)
    h22 = Hn[..., 2, 2]
    h22 = torch.where(h22.abs() < 1e-10, torch.full_like(h22, 1e-10), h22)
    return Hn / h22[..., None, None]


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def fundamental_symmetric_chi2(F21, x1, x2, sigma2: float):
    """Per-match symmetric epipolar chi2 (chi1, chi2).  F21 [..., 3, 3],
    x1/x2 [N, 2] -> [..., N] each."""
    x1h, x2h = _homog(x1), _homog(x2)
    l2 = x1h @ F21.transpose(-1, -2)
    l1 = x2h @ F21
    d2 = (l2 * x2h).sum(-1) ** 2 / torch.clamp_min(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d1 = (l1 * x1h).sum(-1) ** 2 / torch.clamp_min(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    return d1 / sigma2, d2 / sigma2


def homography_symmetric_chi2(H21, x1, x2, sigma2: float):
    """Per-match symmetric transfer chi2.  H21 [..., 3, 3]."""
    H12 = torch.linalg.inv(H21)

    def transfer(H, a):
        b = _homog(a) @ H.transpose(-1, -2)
        w = b[..., 2]
        w = torch.where(w.abs() < 1e-10, torch.full_like(w, 1e-10), w)
        return b[..., :2] / w[..., None]

    e12 = ((transfer(H21, x1) - x2) ** 2).sum(-1)
    e21 = ((transfer(H12, x2) - x1) ** 2).sum(-1)
    return e21 / sigma2, e12 / sigma2


def decompose_essential(E: torch.Tensor):
    """E [3,3] -> four (R, t) candidates [4,3,3], [4,3] with |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp_min(torch.linalg.norm(t), 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def check_rt(R, t, x1, x2, mask, K, sigma2: float, th_chi2: float = 3.84,
             min_parallax_cos: float = 0.99998):
    """Cheirality + reprojection count for [B] (R, t) hypotheses.

    R [B,3,3], t [B,3]; x1, x2 [N,2]; mask [N] or [B,N].  Returns
    (ngood [B], good [B,N], parallax_cos [B], points3d [B,N,3]).
    """
    B = R.shape[0]
    dt, dev = R.dtype, R.device
    I34 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros(3, 1, dtype=dt, device=dev)], 1)
    P1 = (K @ I34).expand(B, 3, 4)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_dlt(P1, P2, x1.expand(B, -1, -1), x2.expand(B, -1, -1))   # [B,N,3]
    finite = torch.isfinite(X).all(-1)
    C2 = -torch.einsum("bji,bj->bi", R, t)
    r1 = X
    r2 = X - C2[:, None, :]
    cosp = (r1 * r2).sum(-1) / torch.clamp_min(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), 1e-12)
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = Xc2[..., 2]

    def reproj_chi2(P, x):
        p = _homog(X) @ P.transpose(-1, -2)
        w = p[..., 2]
        w = torch.where(w.abs() < 1e-10, torch.full_like(w, 1e-10), w)
        return ((p[..., :2] / w[..., None] - x) ** 2).sum(-1) / sigma2

    c1 = reproj_chi2(P1, x1)
    c2 = reproj_chi2(P2, x2)
    good = (mask & finite & (cosp < min_parallax_cos) & (z1 > 0) & (z2 > 0)
            & (c1 < th_chi2 * 4.0) & (c2 < th_chi2 * 4.0))
    ngood = good.sum(-1)
    cos_sorted = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), dim=-1).values
    idx = torch.clamp(ngood - 1, min=0).clamp(max=49)
    parallax_cos = torch.gather(cos_sorted, 1, idx[:, None])[:, 0]
    return ngood, good, parallax_cos, X
