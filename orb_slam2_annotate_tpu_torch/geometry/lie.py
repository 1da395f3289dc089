"""SO(3) / SE(3) Lie-group operations (port of geometry/lie.py, SE3 part).

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


def se3_retract(R, t, xi):
    """Left retraction used by all solvers: T <- exp(xi) o T."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)
