"""Batched PnP RANSAC for relocalization (port of solvers/pnp.py).

Every hypothesis is a 6-point DLT (null vector of the 13x12 system, scale
and sign from the determinant, projection onto SO(3)).  Kernel 6
(``kernels/pnp_score.pnp_hypotheses``) solves and scores all hypotheses
of all candidates and picks each candidate's best in one launch, and each
candidate's best is polished by the pose-only LM (kernel 4, all candidates
in one launch).  As for the initializer, sampling and solving are split:
``sample_pnp_sets`` draws the minimal sets from a ``torch.Generator`` and
``pnp_from_samples`` is the deterministic core, testable on
``jax.random``'s own draws.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..geometry.camera import CameraModel
from ..kernels.pnp_score import dlt_pnp, pnp_hypotheses
from ..kernels.pose_lm import optimize_pose_batched

__all__ = ["PnPResult", "dlt_pnp", "sample_pnp_sets", "pnp_from_samples", "pnp_ransac"]


@dataclasses.dataclass
class PnPResult:
    success: torch.Tensor    # [C] bool
    R: torch.Tensor          # [C,3,3]
    t: torch.Tensor          # [C,3]
    inliers: torch.Tensor    # [C,N] bool
    n_inliers: torch.Tensor  # [C] int


def sample_pnp_sets(gen: torch.Generator, valid: torch.Tensor, n_hyp: int = 256) -> torch.Tensor:
    """[C, n_hyp, 6] distinct indices per set, uniform over the valid entries
    of each row of valid [C, N].  A row with fewer than 6 valid entries
    draws from all N (its candidate cannot pass the caller's gates)."""
    C, N = valid.shape
    enough = valid.sum(1, keepdim=True) >= 6
    probs = torch.where(enough, valid, True).to(torch.float32)
    probs = probs[:, None, :].expand(C, n_hyp, N).reshape(C * n_hyp, N)
    return torch.multinomial(probs, 6, replacement=False, generator=gen).reshape(C, n_hyp, 6)


def pnp_from_samples(cam: CameraModel, samples: torch.Tensor, xw: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, chi2_th: float = 5.991, min_inliers: int = 10,
                     polish=None) -> PnPResult:
    """samples [C,S,6], xw [C,N,3] world points, uv [N,2] undistorted pixels,
    valid [C,N].  ``polish`` lists the candidates to polish with the LM
    (all by default), all in one kernel-4 launch; the others keep their
    best DLT pose and fail."""
    C, S, _ = samples.shape
    N = xw.shape[1]
    dev = xw.device
    with record_function("reloc/hypotheses"):
        Rs, ts, ns, best = pnp_hypotheses(samples.long().contiguous(), xw.contiguous(),
                                          uv.contiguous(), valid.contiguous(), cam.fx, cam.fy,
                                          cam.cx, cam.cy, chi2_th * 4.0)
    cr = torch.arange(C, device=dev)
    R, t, n_best = Rs[cr, best], ts[cr, best], ns[cr, best]
    inliers = torch.zeros((C, N), dtype=torch.bool, device=dev)
    n = torch.zeros(C, dtype=torch.int64, device=dev)
    ok = torch.zeros(C, dtype=torch.bool, device=dev)
    pick = cr if polish is None else torch.tensor(polish, dtype=torch.long, device=dev)
    if len(pick):
        # every polished candidate in one launch; uv, ur and inv_sigma2 are shared
        with record_function("reloc/polish"):
            R[pick], t[pick], inliers[pick], n_p = optimize_pose_batched(
                cam, R[pick], t[pick], xw[pick], uv, torch.full((N,), -1.0, device=dev),
                torch.ones(N, device=dev), valid[pick])
            n[pick] = n_p.long()
            ok[pick] = (n_best[pick] >= min_inliers) & (n_p >= min_inliers)
    return PnPResult(ok, R, t, inliers, n)


def pnp_ransac(gen: torch.Generator, cam: CameraModel, xw: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, n_hyp: int = 256, chi2_th: float = 5.991,
               min_inliers: int = 10) -> PnPResult:
    """One correspondence set: xw [N,3], uv [N,2], valid [N].  Returns a
    PnPResult without the candidate axis."""
    samples = sample_pnp_sets(gen, valid[None], n_hyp)
    r = pnp_from_samples(cam, samples, xw[None], uv, valid[None], chi2_th, min_inliers)
    return PnPResult(r.success[0], r.R[0], r.t[0], r.inliers[0], r.n_inliers[0])
