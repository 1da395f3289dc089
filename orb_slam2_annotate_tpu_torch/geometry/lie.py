"""SO(3) / SE(3) / Sim(3) Lie-group operations (port of geometry/lie.py).

Conventions as in the reference: poses are (R, t) with x_cam = R x_world + t,
se3 tangents are [rho(3), phi(3)] (translation first).  All functions take
leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: hat(v) @ x == cross(v, x)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sinc_sq(sq):
    """sin(sqrt(sq))/sqrt(sq) with a Taylor branch near 0."""
    small = sq < 1e-8
    x = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return torch.where(small, 1.0 - sq / 6.0, torch.sin(x) / x)


def _cosc_sq(sq):
    """(1-cos(sqrt(sq)))/sq with a Taylor branch near 0."""
    small = sq < 1e-8
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    x = torch.sqrt(sq_safe)
    return torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(x)) / sq_safe)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: exp: so(3) -> SO(3)."""
    sq = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    a = _sinc_sq(sq)
    b = _cosc_sq(sq)
    return _eye3(phi) + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """log: SO(3) -> so(3), with the reference's near-pi branch."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sq = torch.sum(w * w, dim=-1)
    small = sq < 1e-12
    sin_theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    theta = torch.atan2(sin_theta, cos_theta)
    factor = torch.where(small, 1.0 + sq / 6.0, theta / sin_theta)
    near_pi = cos_theta < -1.0 + 1e-4
    safe = w * factor[..., None]
    theta = torch.where(
        near_pi, torch.arccos(torch.where(near_pi, cos_theta, torch.zeros_like(cos_theta))),
        theta)
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS),
                          0.0, 1.0)
    axis = torch.sqrt(torch.clamp_min(
        torch.where(near_pi[..., None], axis_sq, torch.ones_like(axis_sq)), _EPS))
    sign = torch.where(w.abs() > 1e-7, torch.sign(w), torch.ones_like(w))
    pi_sol = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], pi_sol, safe)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    sq = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    b = _cosc_sq(sq)
    small = sq < 1e-8
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    ts = torch.sqrt(sq_safe)
    c = torch.where(small, 1.0 / 6.0 - sq / 120.0, (ts - torch.sin(ts)) / (ts * sq_safe))
    return _eye3(phi) + b[..., None, None] * K + c[..., None, None] * K2


def se3_exp(xi: torch.Tensor):
    """exp: se(3) -> SE(3).  xi = [rho, phi] -> (R, t) with t = J_l(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    J = so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", J, rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log: SE(3) -> se(3)."""
    from .smallsolve import solve3

    phi = so3_log(R)
    J = so3_left_jacobian(phi)
    rho = solve3(J, t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def dot3(a0, b0, a1, b1, a2, b2):
    """a0 b0 + a1 b1 + a2 b2, each product rounded, the sums in order: the
    same bits on every device (a batched matmul or einsum rounds by the
    device's kernel)."""
    return a0 * b0 + a1 * b1 + a2 * b2


def via_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (a square root, sine or cosine) through float64, back in x's
    dtype: correctly rounded in float32 on every device, which torch's
    float32 ones on the CPU are not."""
    return fn(x.double()).to(x.dtype)


def se3_retract(R, t, xi):
    """Left retraction used by all solvers: T <- exp(xi) o T, R [..., 3, 3],
    t [..., 3], xi [..., 6].  exp(xi) and the composition written out in
    ``dot3``s, the square root, sine and cosine ``via_f64``, divisions by
    tensors: the same bits on the card and the CPU."""
    rho, p = xi[..., :3], xi[..., 3:6]
    sq = dot3(p[..., 0], p[..., 0], p[..., 1], p[..., 1], p[..., 2], p[..., 2])
    small = sq < _EPS
    one = torch.ones_like(sq)
    sq_safe = torch.where(small, one, sq)
    th = via_f64(torch.sqrt, sq_safe)
    sn, cs = via_f64(torch.sin, th), via_f64(torch.cos, th)
    num = lambda v: torch.full_like(sq, v)
    a = torch.where(small, 1.0 - sq / num(6.0), sn / th)
    b = torch.where(small, 0.5 - sq / num(24.0), (1.0 - cs) / sq_safe)
    c = torch.where(small, num(1.0) / num(6.0) - sq / num(120.0), (th - sn) / (th * sq_safe))
    zero = torch.zeros_like(sq)
    K = [[zero, -p[..., 2], p[..., 1]], [p[..., 2], zero, -p[..., 0]],
         [-p[..., 1], p[..., 0], zero]]
    K2 = [[dot3(K[r][0], K[0][m], K[r][1], K[1][m], K[r][2], K[2][m]) for m in range(3)]
          for r in range(3)]
    eye = lambda r, m: one if r == m else zero
    dR = [[eye(r, m) + a * K[r][m] + b * K2[r][m] for m in range(3)] for r in range(3)]
    J = [[eye(r, m) + b * K[r][m] + c * K2[r][m] for m in range(3)] for r in range(3)]
    R_new = torch.stack([torch.stack([dot3(dR[r][0], R[..., 0, m], dR[r][1], R[..., 1, m],
                                           dR[r][2], R[..., 2, m]) for m in range(3)], dim=-1)
                         for r in range(3)], dim=-2)
    t_new = torch.stack([dot3(dR[r][0], t[..., 0], dR[r][1], t[..., 1], dR[r][2], t[..., 2])
                         + dot3(J[r][0], rho[..., 0], J[r][1], rho[..., 1], J[r][2], rho[..., 2])
                         for r in range(3)], dim=-1)
    return R_new, t_new


def se3_apply(R, t, x):
    return torch.einsum("...ij,...j->...i", R, x) + t


def rotate_points(R, x, transpose: bool = False):
    """R x (R^T x with `transpose`) for each point, R [P,3,3], x [P,3], as
    three products and two sums in one order.  A batched einsum over the
    points lets the card pick its product kernel by P, so a split map's
    P / n rows would round otherwise than the whole map's; on the CPU this
    is the einsum's arithmetic bit for bit."""
    col = (lambda k: R[:, k, :]) if transpose else (lambda k: R[:, :, k])
    return col(0) * x[:, 0:1] + col(1) * x[:, 1:2] + col(2) * x[:, 2:3]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (3 entries) with the CPU's bits on
    every device.  torch.linalg.norm on the CPU (and XLA's jnp.linalg.norm)
    takes s = x0^2, s = fma(x1, x1, s), s = fma(x2, x2, s) in float32, then
    sqrt(s) correctly rounded; the card's reduction rounds otherwise, which
    moves gates that a point's own distances decide (its predicted octave).
    Each fused multiply-add is formed exactly through float64 (``_fma32``)
    and the square root taken in float64 (torch's float32 sqrt on the CPU is
    not correctly rounded; float64's, rounded to float32, is)."""
    d = v.double()
    s = (d[..., 0] * d[..., 0]).float()
    for k in (1, 2):
        s = _fma32(d[..., k] * d[..., k], s)
    return torch.sqrt(s.double()).float()


def _fma32(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """p + a rounded once to float32: p float64 (a product of two float32
    numbers, exact), a float32.  The float64 sum t and its TwoSum error give
    the exact value; rounding t to float32 is that value's rounding unless t
    lies on a float32 tie, where the error's sign decides."""
    ad = a.double()
    t = p + ad
    bp = t - ad
    err = (p - bp) + (ad - (t - bp))
    r = t.float()
    rd = r.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, -float("inf")))
    at_up = t == 0.5 * (rd + up.double())
    at_dn = t == 0.5 * (rd + dn.double())
    return torch.where(at_up & (err > 0), up, torch.where(at_dn & (err < 0), dn, r))


# ---------------------------------------------------------------------------
# Sim(3), used by loop closing.  xi = [rho(3), phi(3), sigma]; (s, R, t) maps
# x to s R x + t.
# ---------------------------------------------------------------------------


def sim3_exp(xi: torch.Tensor):
    """exp: sim(3) -> Sim(3), xi [..., 7] -> (s, R, t) with t = W rho,
    W = C I + A hat(phi) + B hat(phi)^2 and the reference's Taylor limits as
    theta -> 0 and sigma -> 0."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta = torch.linalg.norm(phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    eps = 1e-5
    sig_small = sigma.abs() < eps
    th_small = theta < eps
    one = torch.ones_like(sigma)
    sig_safe = torch.where(sig_small, one, sigma)
    th_safe = torch.where(th_small, one, theta)
    C = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe)
    b = s * torch.cos(theta)
    a = s * torch.sin(theta)
    den = sigma * sigma + theta * theta
    den_safe = torch.where(th_small & sig_small, one, den)
    A_gen = (sigma * a + (1.0 - b) * th_safe) / (th_safe * den_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * th_safe) / den_safe) / (th_safe * th_safe)
    A_th0 = torch.where(sig_small, 0.5 + sigma / 3.0,
                        ((sig_safe - 1.0) * s + 1.0) / (sig_safe * sig_safe))
    B_th0 = torch.where(sig_small, 1.0 / 6.0 + sigma / 4.0,
                        ((0.5 * sig_safe * sig_safe - sig_safe + 1.0) * s - 1.0) / sig_safe ** 3)
    A = torch.where(th_small, A_th0, A_gen)
    B = torch.where(th_small, B_th0, B_gen)
    W = C[..., None, None] * _eye3(xi) + A[..., None, None] * K + B[..., None, None] * K2
    return s, R, torch.einsum("...ij,...j->...i", W, rho)


def sim3_apply(s, R, t, x):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, x) + t


def sim3_inverse(s, R, t):
    s_inv = 1.0 / s
    R_inv = R.transpose(-1, -2)
    return s_inv, R_inv, -s_inv[..., None] * torch.einsum("...ij,...j->...i", R_inv, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) o (sb,Rb,tb): first apply b, then a."""
    return sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta


def sim3_retract(s, R, t, xi):
    """Left retraction: S <- exp(xi) o S."""
    ds, dR, dt = sim3_exp(xi)
    return sim3_compose(ds, dR, dt, s, R, t)


def sim3_log(s, R, t):
    """log: Sim(3) -> sim(3); rho solves t = W rho with W probed from sim3_exp."""
    from .smallsolve import solve3

    sigma = torch.log(s)
    phi = so3_log(R)
    basis = torch.eye(3, dtype=t.dtype, device=t.device)
    cols = [sim3_exp(torch.cat([basis[i].expand_as(t), phi, sigma[..., None]], dim=-1))[2]
            for i in range(3)]
    rho = solve3(torch.stack(cols, dim=-1), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [qx, qy, qz, qw]: the best-conditioned
    of Shepperd's four candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1)
    q1 = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    q2 = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    q3 = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = torch.argmax(torch.sum(cands * cands, dim=-1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [qx, qy, qz, qw] -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.clamp_min(n, _EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)
