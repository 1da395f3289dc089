"""Offline rBRIEF pattern learning (port of ops/pattern_train.py): the
recipe by which OpenCV's bit_pattern_31_ was made (ORB paper, section 4.3),
re-run from scratch with a view-stability term.

Steered binary test responses are gathered over keypoints seen from two
nearby camera poses of rendered scenes, and each candidate test is scored
by (a) its flip rate between the two views of one keypoint, (b) its flip
rate against a shuffled pairing, whose difference ranks the candidates, and
(c) its absolute correlation with the tests already picked.  The corpus's
keypoints come from the port's extractor (kernels 1 and 2 on the card) and
its blur from ``pyramid.gaussian_blur``; everything after is numpy.

Run:  python -m orb_slam2_annotate_tpu_torch.ops.pattern_train [--device cpu]
Writes orb_slam2_annotate_tpu_torch/ops/brief_pattern.npy ([256, 4] int32
(py, px, qy, qx)), which ops/orb.py loads.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

PATCH_R = 13  # sample radius (keeps rotated samples inside the 31x31 patch)


def _bilinear(img: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    h, w = img.shape
    y = np.clip(y, 0.0, h - 1.001)
    x = np.clip(x, 0.0, w - 1.001)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    fy = y - y0
    fx = x - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx)


def _corpus_pairs(n_scenes: int = 12, kps_per_scene: int = 400, view_offsets: tuple = (2, 5),
                  device="cuda"):
    """Matched keypoints in two views: [(blur_a, blur_b, xy_a, xy_b, ang_a,
    ang_b)], from noise (PlaneScene, BlobScene) and structured textures at
    two baselines; correspondences from the renderer's exact depth."""
    import torch

    from ..geometry.camera import CameraModel
    from ..io.synthetic import (BlobScene, PlaneScene, StructuredScene, orbit_trajectory,
                                true_correspondence)
    from . import extractor as ex
    from . import pyramid
    from .orb import OrbTables

    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    cfg = ex.ExtractorConfig(n_features=512, n_levels=2)
    tab = OrbTables().to(device)
    poses = orbit_trajectory(max(view_offsets) + 1, step=0.06)
    makers = (lambda s: PlaneScene(seed=s), lambda s: BlobScene(seed=s),
              lambda s: StructuredScene(seed=s))

    def features(img):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
        f = ex.extract(x, tab, cfg)
        blur = pyramid.gaussian_blur(x).cpu().numpy()
        valid = f.valid.cpu().numpy() & (f.octave.cpu().numpy() == 0)
        return blur, f.xy.cpu().numpy(), valid, f.angle.cpu().numpy()

    out = []
    r = PATCH_R + 3
    for seed in range(n_scenes):
        scene = makers[seed % 3](seed + 100)
        Ra, ta = poses[0]
        img_a, dep_a = scene.render(cam, Ra, ta, h=240, w=320)
        blur_a, xa, va, aa = features(img_a)
        for off in view_offsets:
            Rb, tb = poses[off]
            img_b, _ = scene.render(cam, Rb, tb, h=240, w=320)
            blur_b, xb, vb, ab = features(img_b)
            xb_pred, okc = true_correspondence(cam, Ra, ta, Rb, tb, dep_a, xa)
            cnt = 0
            for i in np.nonzero(va & okc)[0]:
                j = np.argmin(((xb - xb_pred[i]) ** 2).sum(1) + 1e9 * (~vb))
                if ((xb[j] - xb_pred[i]) ** 2).sum() > 4:
                    continue
                if not (r <= xa[i, 0] < 320 - r and r <= xa[i, 1] < 240 - r):
                    continue
                if not (r <= xb[j, 0] < 320 - r and r <= xb[j, 1] < 240 - r):
                    continue
                out.append((blur_a, blur_b, xa[i], xb[j], aa[i], ab[j]))
                cnt += 1
                if cnt >= kps_per_scene:
                    break
    return out


def learn_pattern(n_bits: int | None = None, n_candidates: int = 12000, corr_thresh: float = 0.3,
                  max_flip: float = 0.08, seed: int = 7, verbose: bool = True,
                  device="cuda") -> np.ndarray:
    """The learned pattern, [n_bits, 4] int32 (py, px, qy, qx); `max_flip`
    is accepted and unused, as in the reference."""
    if n_bits is None:
        from .orb import N_BITS as n_bits
    rng = np.random.RandomState(seed)
    pairs = _corpus_pairs(device=device)
    n_kp = len(pairs)

    sigma = 2.0 * PATCH_R / 5.0
    cand = np.clip(np.round(rng.randn(n_candidates, 4) * sigma), -PATCH_R, PATCH_R).astype(np.int32)
    cand = cand[~np.all(cand[:, :2] == cand[:, 2:], axis=1)]
    C = cand.shape[0]
    py, px, qy, qx = (cand[:, k].astype(np.float64) for k in range(4))

    def responses(img, xy, ang):
        ca, sa = np.cos(ang), np.sin(ang)
        ip = _bilinear(img, xy[1] + (sa * px + ca * py), xy[0] + (ca * px - sa * py))
        iq = _bilinear(img, xy[1] + (sa * qx + ca * qy), xy[0] + (ca * qx - sa * qy))
        return ip < iq

    A = np.zeros((n_kp, C), bool)
    B = np.zeros((n_kp, C), bool)
    for k, (ia, ib, xya, xyb, anga, angb) in enumerate(pairs):
        A[k] = responses(ia, xya, anga)
        B[k] = responses(ib, xyb, angb)

    flip = (A != B).mean(axis=0)           # matched-pair flip rate
    mean = A.mean(axis=0)                  # balance
    # random-pair disagreement: the same responses against a shuffled pairing
    perm = rng.permutation(n_kp)
    rand_flip = (A != B[perm]).mean(axis=0)
    margin = rand_flip - flip
    if verbose:
        print(f"candidates: {C}, median flip {np.median(flip):.3f}, "
              f"median rand {np.median(rand_flip):.3f}, best margin {margin.max():.3f}")

    # rank by per-bit margin (the sum of margins is the expected matched-vs-
    # random separation; the decorrelation below keeps it from double-counting)
    order = np.argsort(-margin)
    Af = A.astype(np.float32)
    Ac = Af - Af.mean(axis=0, keepdims=True)
    norm = np.sqrt((Ac**2).sum(axis=0)) + 1e-9

    picked: list[int] = []
    thr = corr_thresh
    while len(picked) < n_bits:
        for ci in order:
            if len(picked) >= n_bits:
                break
            if ci in picked:
                continue
            if picked:
                corr = np.abs(Ac[:, picked].T @ Ac[:, ci] / (norm[picked] * norm[ci]))
                if corr.max() > thr:
                    continue
            picked.append(int(ci))
        if len(picked) < n_bits:
            thr += 0.1
            if verbose:
                print(f"relaxing corr threshold to {thr:.1f} ({len(picked)} picked)")

    sel = np.asarray(picked)
    if verbose:
        print(f"picked {len(picked)}: mean |p-.5|={np.abs(mean[sel]-0.5).mean():.3f} "
              f"mean flip={flip[sel].mean():.3f}")
    return cand[sel]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = os.path.join(os.path.dirname(__file__), "brief_pattern.npy")
    np.save(out, learn_pattern(device=args.device))
    print("wrote", out)


if __name__ == "__main__":
    main()
