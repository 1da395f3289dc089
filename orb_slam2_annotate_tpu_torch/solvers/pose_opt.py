"""Motion-only pose optimization (port of solvers/pose_opt.py).

The reference's 4 rounds x 5 LM iterations (one linearization and a
3-value damping ladder each, chi2 reclassification between rounds) run
in one launch of kernel 4, ``kernels/pose_lm.optimize_pose_batched``;
``optimize_pose`` is its call with one problem.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.pose_lm import optimize_pose_batched


@dataclasses.dataclass
class PoseObs:
    """Padded unary observations: xw [N,3], uv [N,2], ur [N] (<0 mono),
    inv_sigma2 [N], valid [N] bool."""

    xw: torch.Tensor
    uv: torch.Tensor
    ur: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


def optimize_pose(cam, R0, t0, obs: PoseObs, rounds: int = 4, iters_per_round: int = 5,
                  lm_lambda0: float = 1e-3):
    """Returns (R, t, inlier_mask [N], n_inliers)."""
    R, t, inlier, n = optimize_pose_batched(cam, R0[None], t0[None], obs.xw[None], obs.uv, obs.ur,
                                            obs.inv_sigma2, obs.valid[None], rounds,
                                            iters_per_round, lm_lambda0)
    return R[0], t[0], inlier[0], n[0]
