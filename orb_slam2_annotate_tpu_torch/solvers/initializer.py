"""Monocular two-view bootstrap: batched H/F RANSAC + model selection
(port of solvers/initializer.py).

Sampling and solving are split: ``sample_minimal_sets`` draws the RANSAC
minimal sets from a ``torch.Generator`` (which cannot reproduce
``jax.random`` draws), and ``initialize_from_samples`` is the deterministic
core, testable on the reference's own samples.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import twoview

TH_F = 3.841
TH_H = 5.991
SCORE_GAMMA_F = 5.991


@dataclasses.dataclass
class InitResult:
    success: torch.Tensor          # 0-d bool
    used_homography: torch.Tensor  # 0-d bool
    R: torch.Tensor                # [3,3] cam2 <- cam1
    t: torch.Tensor                # [3] unit baseline
    points: torch.Tensor           # [N,3] in frame-1 coordinates
    good: torch.Tensor             # [N] bool
    n_good: torch.Tensor           # 0-d int


def sample_minimal_sets(gen: torch.Generator, match_mask: torch.Tensor, n: int = 200) -> torch.Tensor:
    """[n, 8] distinct match indices per set, uniform over matched entries."""
    probs = match_mask.to(torch.float32)
    probs = probs / torch.clamp_min(probs.sum(), 1e-9)
    return torch.multinomial(probs.expand(n, -1), 8, replacement=False, generator=gen)


def _cos_deg(deg: float, device) -> torch.Tensor:
    return torch.cos(torch.deg2rad(torch.tensor(deg, dtype=torch.float32, device=device)))


def _score_f(F, x1, x2, mm, sigma2):
    c1, c2 = twoview.fundamental_symmetric_chi2(F, x1, x2, sigma2)
    in1, in2 = c1 < TH_F, c2 < TH_F
    zero = torch.zeros_like(c1)
    s = torch.where(in1 & mm, SCORE_GAMMA_F - c1, zero) + torch.where(in2 & mm, SCORE_GAMMA_F - c2, zero)
    return s.sum(-1), in1 & in2 & mm


def _score_h(H, x1, x2, mm, sigma2):
    c1, c2 = twoview.homography_symmetric_chi2(H, x1, x2, sigma2)
    in1, in2 = c1 < TH_H, c2 < TH_H
    zero = torch.zeros_like(c1)
    s = torch.where(in1 & mm, TH_H - c1, zero) + torch.where(in2 & mm, TH_H - c2, zero)
    return s.sum(-1), in1 & in2 & mm


def initialize_from_samples(samples: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                            match_mask: torch.Tensor, K: torch.Tensor, sigma: float = 1.0,
                            min_parallax_deg: float = 1.0, min_triangulated: int = 50) -> InitResult:
    """x1, x2 [N,2] matched pixels, match_mask [N] bool, samples [S,8]."""
    sigma2 = sigma * sigma
    dev = x1.device
    samples = samples.long()
    s_x1, s_x2 = x1[samples], x2[samples]
    ones = torch.ones(samples.shape, dtype=torch.bool, device=dev)
    Fs = twoview.fit_fundamental_8pt(s_x1, s_x2, ones)
    Hs = twoview.fit_homography_dlt(s_x1, s_x2, ones)
    scores_f, inls_f = _score_f(Fs, x1, x2, match_mask, sigma2)
    scores_h, inls_h = _score_h(Hs, x1, x2, match_mask, sigma2)
    bf, bh = torch.argmax(scores_f), torch.argmax(scores_h)
    SF, SH = scores_f[bf], scores_h[bh]

    F_best = twoview.fit_fundamental_8pt(x1, x2, inls_f[bf])
    _, F_inl = _score_f(F_best, x1, x2, match_mask, sigma2)
    H_best = twoview.fit_homography_dlt(x1, x2, inls_h[bh])
    _, H_inl = _score_h(H_best, x1, x2, match_mask, sigma2)
    use_h = SH / torch.clamp_min(SH + SF, 1e-9) > 0.40
    cos_min = _cos_deg(min_parallax_deg, dev)

    E = K.T @ F_best @ K
    Rs, ts = twoview.decompose_essential(E)
    ngoods, goods, parallaxes, Xs = twoview.check_rt(Rs, ts, x1, x2, F_inl, K, sigma2 * 4.0)
    best_rt = torch.argmax(ngoods)
    nG = ngoods[best_rt]
    sorted_n = torch.sort(ngoods).values
    clear = sorted_n[-1].float() > 1.5 * torch.clamp_min(sorted_n[-2].float(), 1.0)
    enough = nG >= torch.clamp_min((0.9 * F_inl.sum().float()).to(torch.int32), min_triangulated)
    f_success = clear & enough & (parallaxes[best_rt] < cos_min)

    R_h, t_h, h_valid = _reconstruct_h(H_best, K, x1, x2, H_inl, sigma2)
    ngood_h, good_h, par_h, X_h = twoview.check_rt(R_h[None], t_h[None], x1, x2, H_inl, K,
                                                   sigma2 * 4.0)
    h_success = (h_valid
                 & (ngood_h[0] >= torch.clamp_min((0.9 * H_inl.sum().float()).to(torch.int32),
                                                  min_triangulated))
                 & (par_h[0] < cos_min))
    success = torch.where(use_h, h_success, f_success)
    R = torch.where(use_h, R_h, Rs[best_rt])
    t = torch.where(use_h, t_h, ts[best_rt])
    X = torch.where(use_h, X_h[0], Xs[best_rt])
    good = torch.where(use_h, good_h[0], goods[best_rt])
    n_good = torch.where(use_h, ngood_h[0], nG)
    return InitResult(success, use_h, R, t, X, good & match_mask, n_good)


def _reconstruct_h(H, K, x1, x2, inl, sigma2):
    """Faugeras homography decomposition: the 8 (R, t) solutions scored by
    cheirality; returns (R, t, valid)."""
    A = torch.linalg.inv(K) @ H @ K
    U, w, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    ok = (d1 / torch.clamp_min(d2, 1e-9) > 1.00001) & (d2 / torch.clamp_min(d3, 1e-9) > 1.00001)
    den13 = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / den13, 0.0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / den13, 0.0))
    prod = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    aux_st = prod / torch.clamp_min((d1 + d3) * d2, 1e-12)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, 1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp_min((d1 - d3) * d2, 1e-12)
    aux_sp = prod / torch.clamp_min((d1 - d3) * d2, 1e-12)
    e1 = (1.0, -1.0, 1.0, -1.0)
    e3 = (1.0, -1.0, -1.0, 1.0)
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    Rs, ts = [], []
    for positive in (True, False):
        for i in range(4):
            x1v, x3v = e1[i] * aux1, e3[i] * aux3
            if positive:
                st = e1[i] * e3[i] * aux_st
                Rp = torch.stack([torch.stack([ctheta, zero, -st]), torch.stack([zero, one, zero]),
                                  torch.stack([st, zero, ctheta])])
                tp = torch.stack([x1v, zero, -x3v]) * (d1 - d3)
            else:
                sp = e1[i] * e3[i] * aux_sp
                Rp = torch.stack([torch.stack([cphi, zero, sp]), torch.stack([zero, -one, zero]),
                                  torch.stack([sp, zero, -cphi])])
                tp = torch.stack([x1v, zero, x3v]) * (d1 + d3)
            Rs.append(s * U @ Rp @ Vt)
            t = U @ tp
            ts.append(t / torch.clamp_min(torch.linalg.norm(t), 1e-12))
    Rs, ts = torch.stack(Rs), torch.stack(ts)
    ns, _, _, _ = twoview.check_rt(Rs, ts, x1, x2, inl, K, sigma2 * 4.0)
    best = torch.argmax(ns)
    srt = torch.sort(ns).values
    clear = srt[-2].float() < 0.75 * srt[-1].float()
    return Rs[best], ts[best], ok & clear
