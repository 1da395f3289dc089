"""Motion-only pose optimization (port of solvers/pose_opt.py).

4 rounds x 5 LM iterations, each one linearization (kernel 4a) and a
3-value damping ladder scored in one launch (kernel 4b), with chi2
reclassification between rounds.  Accept/reject runs as ``torch.where`` on
device tensors, so the loop never waits for the device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..geometry.smallsolve import solve6_spd
from ..kernels.pose_lm import (CHI2_MONO, CHI2_STEREO, pose_costs, pose_linearize,
                               residual_jac)


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
    dev = obs.xw.device
    delta2_all = torch.where(obs.ur >= 0, CHI2_STEREO, CHI2_MONO)
    edges = (obs.xw.contiguous(), obs.uv.contiguous(), obs.ur.contiguous(),
             obs.inv_sigma2.contiguous())
    ladder = torch.tensor([1.0, 8.0, 64.0], device=dev)
    eye6 = torch.eye(6, device=dev)
    R, t, inlier = R0, t0, obs.valid
    for round_idx in range(rounds):
        robust = round_idx < 2
        mask = (obs.valid & inlier).contiguous()
        lam = torch.tensor(lm_lambda0, device=dev)
        for _ in range(iters_per_round):
            H, g, cost = pose_linearize(cam, R, t, *edges, mask, robust)
            lams = lam * ladder
            Hd = H + lams[:, None, None] * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            dx = -solve6_spd(Hd, g.expand(3, 6))
            R_a, t_a = lie.se3_retract(R.expand(3, 3, 3), t.expand(3, 3), dx)
            cost_a = pose_costs(cam, R_a, t_a, *edges, mask)
            improves = cost_a < cost
            pick = torch.argmax(improves.to(torch.uint8))      # smallest improving lambda
            any_imp = improves.any()
            R = torch.where(any_imp, R_a[pick], R)
            t = torch.where(any_imp, t_a[pick], t)
            lam = torch.clamp(torch.where(any_imp, lams[pick] * 0.4, lam * 512.0), 1e-9, 1e6)
        r, _, _, depth_ok = residual_jac(cam, R, t, obs.xw, obs.uv, obs.ur)
        chi2 = torch.sum(r * r, dim=0) * obs.inv_sigma2
        inlier = obs.valid & (chi2 <= delta2_all) & depth_ok
    return R, t, inlier, torch.sum(inlier)
