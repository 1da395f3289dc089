"""Closed-form 3x3 inverse and 6x6 SPD solve (port of geometry/smallsolve.py)."""

from __future__ import annotations

import torch


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    tiny = torch.where(det < 0, -1e-20, 1e-20)
    det_safe = torch.where(det.abs() < 1e-20, tiny, det)
    inv = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ], dim=-2)
    return inv / det_safe[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve [..., 3, 3] @ x = [..., 3] in closed form."""
    return torch.einsum("...ij,...j->...i", inv3(A), b)


def solve6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve a symmetric positive-definite [..., 6, 6] system by its 3x3
    block Schur complement (two adjugate 3x3 inverses)."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    u = g[..., :3]
    v = g[..., 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    S = D - B.transpose(-1, -2) @ AiB
    Si = inv3(S)
    Aiu = torch.einsum("...ij,...j->...i", Ai, u)
    rhs = v - torch.einsum("...ji,...j->...i", AiB, u)
    y = torch.einsum("...ij,...j->...i", Si, rhs)
    x = Aiu - torch.einsum("...ij,...j->...i", AiB, y)
    return torch.cat([x, y], dim=-1)
