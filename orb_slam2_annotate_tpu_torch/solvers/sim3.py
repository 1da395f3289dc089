"""Sim(3) estimation between keyframes for loop closing (port of
solvers/sim3.py).

Horn's closed-form absolute orientation inside a RANSAC loop, and the LM
refinement of OptimizeSim3.  As for PnP, sampling and solving are split:
``sample_sim3_sets`` draws the minimal triples from a ``torch.Generator``
and ``sim3_from_samples`` is the deterministic core (kernel 7 for every
hypothesis, then one weighted Horn over the best one's inliers), testable
on ``jax.random``'s own draws.  ``optimize_sim3`` is kernel 8.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.camera import CameraModel
from ..kernels.sim3 import horn_q, horn_rotation, sim3_hypotheses, sim3_lm_solve, sim3_score_plain


@dataclasses.dataclass
class Sim3Result:
    success: torch.Tensor    # 0-d bool
    s: torch.Tensor          # 0-d
    R: torch.Tensor          # [3,3]
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # 0-d int


def horn_sim3(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, fix_scale: bool = False):
    """Closed-form weighted Sim3 (s, R, t) with x2 ~ s R x1 + t (Horn 1987;
    the quaternion by Jacobi, as kernel 7 takes it).  x1, x2 [N,3], w [N]."""
    wsum = torch.clamp_min(w.sum(), 1e-9)
    c1 = (x1 * w[:, None]).sum(0) / wsum
    c2 = (x2 * w[:, None]).sum(0) / wsum
    a = x1 - c1
    b = x2 - c2
    M = torch.einsum("ni,nj,n->ij", a, b, w)
    R = horn_rotation(horn_q(M))
    Ra = a @ R.T
    num = (Ra * b * w[:, None]).sum()
    den = torch.clamp_min((Ra * Ra * w[:, None]).sum(), 1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    return s, R, c2 - s * (R @ c1)


def sample_sim3_sets(gen: torch.Generator, valid: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """[n_hyp, 3] distinct pair indices per set, uniform over the valid
    pairs.  With fewer than 3 valid pairs the sets are drawn from all N
    (the hypotheses then count no inliers beyond the valid ones)."""
    probs = torch.where(valid.sum() >= 3, valid, True).to(torch.float32)
    return torch.multinomial(probs.expand(n_hyp, -1), 3, replacement=False, generator=gen)


def _defaults(x1, valid, is1, is2):
    N = x1.shape[0]
    ones = torch.ones(N, device=x1.device)
    return (torch.ones(N, dtype=torch.bool, device=x1.device) if valid is None else valid,
            ones if is1 is None else is1, ones if is2 is None else is2)


def sim3_from_samples(cam: CameraModel, samples, x1, x2, uv1, uv2, fix_scale: bool = False,
                      valid=None, th_chi2: float = 9.21, inv_sigma2_1=None, inv_sigma2_2=None,
                      min_inliers: int = 20) -> Sim3Result:
    """The reference's sim3_ransac after sampling: kernel 7 fits and counts
    every triple of samples [H,3] and picks the first best; a weighted Horn
    over its inliers is kept when it counts at least as many."""
    valid, is1, is2 = _defaults(x1, valid, inv_sigma2_1, inv_sigma2_2)
    args = (x1.contiguous(), x2.contiguous(), uv1.contiguous(), uv2.contiguous(),
            valid.contiguous(), is1.contiguous(), is2.contiguous())
    consts = (cam.fx, cam.fy, cam.cx, cam.cy, th_chi2)
    ss, Rs, ts, ns, best = sim3_hypotheses(samples.long().contiguous(), *args, *consts, fix_scale)
    s_b, R_b, t_b, n_b = ss[best], Rs[best], ts[best], ns[best]
    inl_b = sim3_score_plain(s_b[None], R_b[None], t_b[None], *args, *consts)[0]
    s_r, R_r, t_r = horn_sim3(x1, x2, inl_b.to(torch.float32), fix_scale)
    inl_r = sim3_score_plain(s_r[None], R_r[None], t_r[None], *args, *consts)[0]
    n_r = inl_r.sum().to(torch.int32)
    use = n_r >= n_b
    n_f = torch.maximum(n_r, n_b)
    return Sim3Result(n_f >= min_inliers, torch.where(use, s_r, s_b), torch.where(use, R_r, R_b),
                      torch.where(use, t_r, t_b), torch.where(use, inl_r, inl_b), n_f)


def sim3_ransac(gen: torch.Generator, cam: CameraModel, x1, x2, uv1, uv2, n_hyp: int = 128,
                fix_scale: bool = False, valid=None, th_chi2: float = 9.21, inv_sigma2_1=None,
                inv_sigma2_2=None, min_inliers: int = 20) -> Sim3Result:
    """RANSAC Sim3 from matched camera-frame point pairs with image-space
    scoring both ways (the reference's sim3_ransac, Sim3Solver.cc)."""
    valid, _, _ = _defaults(x1, valid, None, None)
    samples = sample_sim3_sets(gen, valid, n_hyp)
    return sim3_from_samples(cam, samples, x1, x2, uv1, uv2, fix_scale, valid, th_chi2,
                             inv_sigma2_1, inv_sigma2_2, min_inliers)


def optimize_sim3(cam: CameraModel, s0, R0, t0, x1, x2, uv1, uv2, fix_scale: bool = False,
                  iters: int = 8, valid=None, inv_sigma2_1=None, inv_sigma2_2=None,
                  chi2_th: float = 10.0) -> Sim3Result:
    """LM refinement of a Sim3 from matched pairs (Optimizer::OptimizeSim3):
    one kernel-8 launch; success needs >= 20 inliers."""
    valid, is1, is2 = _defaults(x1, valid, inv_sigma2_1, inv_sigma2_2)
    s, R, t, inl, n = sim3_lm_solve(x1.contiguous(), x2.contiguous(), uv1.contiguous(),
                                    uv2.contiguous(), valid.contiguous(), is1.contiguous(),
                                    is2.contiguous(), s0, R0, t0, cam.fx, cam.fy, cam.cx, cam.cy,
                                    fix_scale, chi2_th, iters)
    return Sim3Result(n >= 20, s, R, t, inl, n)
