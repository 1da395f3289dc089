"""Sim(3) estimation between keyframes for loop closing (port of
solvers/sim3.py).

Horn's closed-form absolute orientation inside a RANSAC loop, and the LM
refinement of OptimizeSim3.  As for PnP, sampling and solving are split:
``sample_sim3_sets`` draws the minimal triples from a ``torch.Generator``
and ``sim3_from_samples`` is the deterministic core (kernel 7: every
hypothesis, the best, the weighted Horn over its inliers and the choice, in
one launch), testable on ``jax.random``'s own draws.  ``optimize_sim3`` is
kernel 8.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.camera import CameraModel
from ..kernels.sim3 import sim3_lm_solve, sim3_ransac_solve


@dataclasses.dataclass
class Sim3Result:
    success: torch.Tensor    # 0-d bool
    s: torch.Tensor          # 0-d
    R: torch.Tensor          # [3,3]
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # 0-d int


def sample_sim3_sets(gen: torch.Generator, valid: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """[n_hyp, 3] distinct pair indices per set, uniform over the valid
    pairs.  With fewer than 3 valid pairs the sets are drawn from all N
    (the hypotheses then count no inliers beyond the valid ones)."""
    probs = torch.where(valid.sum() >= 3, valid, True).to(torch.float32)
    return torch.multinomial(probs.expand(n_hyp, -1), 3, replacement=False, generator=gen)


def _contiguous(*xs):
    return tuple(None if x is None else x.contiguous() for x in xs)


def _valid_or_all(x1, valid):
    return torch.ones(x1.shape[0], dtype=torch.bool, device=x1.device) if valid is None else valid


def sim3_from_samples(cam: CameraModel, samples, x1, x2, uv1, uv2, fix_scale: bool = False,
                      valid=None, th_chi2: float = 9.21, inv_sigma2_1=None, inv_sigma2_2=None,
                      min_inliers: int = 20) -> Sim3Result:
    """The reference's sim3_ransac after sampling, one kernel-7 launch:
    every triple of samples [H,3] fitted and counted, the first best, and a
    weighted Horn over its inliers kept when it counts at least as many."""
    s, R, t, inl, n, ok, _, _ = sim3_ransac_solve(
        samples.long().contiguous(),
        *_contiguous(x1, x2, uv1, uv2, _valid_or_all(x1, valid), inv_sigma2_1, inv_sigma2_2),
        cam.fx, cam.fy, cam.cx, cam.cy, th_chi2, fix_scale, min_inliers)
    return Sim3Result(ok, s, R, t, inl, n)


def sim3_ransac(gen: torch.Generator, cam: CameraModel, x1, x2, uv1, uv2, n_hyp: int = 128,
                fix_scale: bool = False, valid=None, th_chi2: float = 9.21, inv_sigma2_1=None,
                inv_sigma2_2=None, min_inliers: int = 20) -> Sim3Result:
    """RANSAC Sim3 from matched camera-frame point pairs with image-space
    scoring both ways (the reference's sim3_ransac, Sim3Solver.cc)."""
    valid = _valid_or_all(x1, valid)
    samples = sample_sim3_sets(gen, valid, n_hyp)
    return sim3_from_samples(cam, samples, x1, x2, uv1, uv2, fix_scale, valid, th_chi2,
                             inv_sigma2_1, inv_sigma2_2, min_inliers)


def optimize_sim3(cam: CameraModel, s0, R0, t0, x1, x2, uv1, uv2, fix_scale: bool = False,
                  iters: int = 8, valid=None, inv_sigma2_1=None, inv_sigma2_2=None,
                  chi2_th: float = 10.0) -> Sim3Result:
    """LM refinement of a Sim3 from matched pairs (Optimizer::OptimizeSim3):
    one kernel-8 launch; success needs >= 20 inliers."""
    s, R, t, inl, n = sim3_lm_solve(
        *_contiguous(x1, x2, uv1, uv2, _valid_or_all(x1, valid), inv_sigma2_1, inv_sigma2_2),
        s0, R0, t0, cam.fx, cam.fy, cam.cx, cam.cy, fix_scale, chi2_th, iters)
    return Sim3Result(n >= 20, s, R, t, inl, n)
