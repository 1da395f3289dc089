"""Kernel 9: a stereo frame's row-band match, SAD refinement, disparity,
depth and acceptance, in one launch.

``stereo_match`` launches ``csrc/stereo.cu`` for CUDA tensors and runs the
plain twin ``stereo_match_plain`` for CPU tensors; ``stereo_match.launches``
counts kernel launches.  Both return (ur, depth, best, bestd, ok) for the N
left keypoints: the refined right x where ok (else -1), the depth where ok
(else 0), the matched right keypoint (int32; 0 without a candidate), its
Hamming distance (2048 without a candidate) and the acceptance.

The twin is the reference's ``_make_frame_stereo`` after its extractions,
step by step: the row-band candidate gate on the raw keypoints, the
distances as one matrix product of the +-1 forms, the first argmin, the
acceptance ``bestd < th``, ``_sad_subpixel_refine`` (9 slides of a 9 x 9
SAD, centres rounded half to even, a parabola through the first minimum),
the disparity range test, the depth, and the median-distance gate.  The SAD
sums run term by term in the kernel's order, and every division is by a
tensor (PyTorch's CUDA division by a Python number multiplies by the
reciprocal), so kernel and twin agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..ops.hamming import hamming_pairwise
from . import _build

NO_MATCH = 2048    # the reference's sentinel distance for a non-candidate
HALF = 4           # 9 x 9 SAD patch
SLIDE = 4          # slides -4 .. 4
MEDIAN_NAN = 80.0  # jnp.nan_to_num's stand-in for the NaN median
BAND_SHIFT, MAX_BANDS = 2, 1024  # kernel 9's row bands (csrc/stereo.cu)
# kernel 9's shared memory: sizeof(Fixed) in csrc/stereo.cu (8 rows a CTA:
# a 64-entry list, a 9 x 9 patch and a 9 x 32 strip each; a 514-bin
# histogram; three words and a flag), 15925 B that the runtime rounds to 16,
# then 24 B a right keypoint, a word a band start and a word a level, within
# the 227 KiB a CTA may take on sm_90
FIXED_SMEM = -(-(4 * (8 * (64 + 81 + 9 * 32) + 514 + 3) + 1) // 16) * 16
SMEM_PER_CTA = 227 * 1024


def stereo_candidates(xy_l, oct_l, valid_l, xy_r, oct_r, valid_r, scales, fx: float):
    """[N, M] bool: right keypoint j is a candidate for left keypoint i (same
    row band, scaled by j's octave; disparity in [0, fx]; both valid;
    octaves at most one apart), all on the raw coordinates."""
    row_r = 2.0 * scales[oct_r.long().clamp(0, scales.shape[0] - 1)]
    dy = (xy_l[:, 1, None] - xy_r[None, :, 1]).abs()
    disp = xy_l[:, 0, None] - xy_r[None, :, 0]
    return ((dy <= row_r[None, :]) & (disp >= 0) & (disp <= fx) & valid_l[:, None]
            & valid_r[None, :] & ((oct_l[:, None] - oct_r[None, :]).abs() <= 1))


def band_shift(H: int):
    """(bs, nb): kernel 9's bands of 2^bs rows, nb of them over H rows."""
    bs = BAND_SHIFT
    while -(-H // 2 ** bs) > MAX_BANDS:
        bs += 1
    return bs, -(-H // 2 ** bs)


def max_right_keypoints(H: int, L: int) -> int:
    """The most right keypoints kernel 9 stages for H image rows and L
    levels: a CTA's shared memory less the fixed part, the band starts and
    the scales, over 24 B a keypoint (a 16-byte record, an index, a rank)."""
    return (SMEM_PER_CTA - FIXED_SMEM - 4 * (band_shift(H)[1] + 1) - 4 * L) // 24


def stereo_bands(y_l, y_r, scales, H: int):
    """Kernel 9's row bands, its integer arithmetic in torch: (band of each
    left row [N], band of each right keypoint [M], radius R).  The kernel
    gates left row i only against the right keypoints whose band is within
    R of i's, so ``stereo_candidates`` must be false for every other pair.

    A band is bh = 2^bs image rows (4, more while the image would need over
    1024 bands): floor(y) >> bs, saturated to int32 (NaN as 0) and clamped
    to [0, nb).  R = floor(floor(tol_max) / bh) + 1 for tol_max the largest
    2 scales[l] (NaN ignored, at least 0; every band when it is 1e9 or
    more): a float |yl - yr| <= tol comes from a difference of at most tol
    + half an ulp, below floor(tol_max) + 1, so the floored rows differ by
    at most floor(tol_max) + 1 and the bands by at most R."""
    bs, nb = band_shift(H)

    def band(y):
        r = torch.nan_to_num(torch.floor(y.double()), nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
        return torch.where(r < 0, 0, torch.clamp(torch.div(r, 2 ** bs, rounding_mode="floor"),
                                                  max=nb - 1)).long()

    tol = 2.0 * scales.float()
    tol = tol[~torch.isnan(tol)]
    tol_max = max(0.0, float(tol.max())) if tol.numel() else 0.0
    R = min((math.floor(tol_max) >> bs) + 1, nb) if tol_max < 1e9 else nb
    return band(y_l), band(y_r), R


def sad_subpixel_refine(image_l, image_r, xy_l, xy_r, ur0):
    """The right x refined by 9 slides of a 9 x 9 SAD and a parabola through
    the first minimum (the reference's _sad_subpixel_refine).  xy_l, xy_r
    [N, 2] matched raw keypoints, ur0 [N] the right x to slide around."""
    h, w = image_l.shape
    dev = image_l.device
    r = torch.arange(-HALF, HALF + 1, device=dev)
    offs = torch.arange(-SLIDE, SLIDE + 1, device=dev)
    n, s = xy_l.shape[0], offs.shape[0]
    xl = (torch.round(xy_l[:, 0]).long()[:, None] + r).clamp(0, w - 1)
    yl = (torch.round(xy_l[:, 1]).long()[:, None] + r).clamp(0, h - 1)
    pl = image_l[yl[:, :, None], xl[:, None, :]].reshape(n, 1, -1)            # [N, 1, 81]
    xr = (torch.round(ur0[:, None] + offs.float()).long()[:, :, None] + r).clamp(0, w - 1)
    yr = (torch.round(xy_r[:, 1]).long()[:, None] + r).clamp(0, h - 1)
    pr = image_r[yr[:, None, :, None], xr[:, :, None, :]].reshape(n, s, -1)   # [N, 9, 81]
    diffs = (pl - pr).abs()
    sads = torch.zeros((n, s), dtype=image_l.dtype, device=dev)
    for k in range(diffs.shape[2]):                                          # the kernel's order
        sads = sads + diffs[:, :, k]
    jc = torch.argmin(sads, dim=1).clamp(1, 2 * SLIDE - 1)[:, None]
    s_m = sads.gather(1, jc - 1)[:, 0]
    s_0 = sads.gather(1, jc)[:, 0]
    s_p = sads.gather(1, jc + 1)[:, 0]
    denom = torch.clamp_min(s_m + s_p - 2.0 * s_0, 1e-6)
    delta = torch.clamp(0.5 * (s_m - s_p) / denom, -1.0, 1.0)
    return ur0 + (jc[:, 0] - SLIDE).float() + delta


def median_gate(ok, bestd):
    """The reference's median-distance gate: jnp.median over the accepted
    rows' distances with NaN elsewhere is NaN (then 80) unless every row is
    accepted; rows above 2.1 x the median are dropped."""
    n = ok.shape[0]
    if n == 0:
        return ok
    d = bestd.to(torch.float32)
    s = torch.sort(d).values
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    med = torch.where(ok.all(), med, torch.full_like(med, MEDIAN_NAN))
    return ok & (d <= torch.full_like(med, 2.1) * med)


def stereo_match_plain(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r, desc_r, x_und,
                       image_l, image_r, scales, fx: float, bf: float, th: int):
    cand = stereo_candidates(xy_l, oct_l, valid_l, xy_r, oct_r, valid_r, scales, fx)
    dm = torch.where(cand, hamming_pairwise(desc_l, desc_r), NO_MATCH)
    best = torch.argmin(dm, dim=1)
    bestd = dm.gather(1, best[:, None])[:, 0]
    ur = sad_subpixel_refine(image_l, image_r, xy_l, xy_r[best], xy_r[best, 0])
    disp = x_und - ur
    ok = (bestd < th) & (disp > 0.1) & (disp < fx)
    depth = torch.full_like(disp, bf) / torch.clamp_min(disp, 0.1)
    ok = median_gate(ok, bestd)
    return (torch.where(ok, ur, -1.0), torch.where(ok, depth, 0.0), best.to(torch.int32),
            bestd.to(torch.int32), ok)


@functools.cache
def _lib():
    fn = _build.load("stereo").stereo_match_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 12 + [I] * 6 + [F, F] + [P] * 6 + [P]
    fn.restype = ctypes.c_int
    return fn


_WORKSPACES: dict = {}   # device -> [2] int32: the ticket and the count of rows not accepted
                         # (one 64-bit word to the kernel); 0 between calls


F32, I32, BOOL = torch.float32, torch.int32, torch.bool


def check_inputs(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r, desc_r, x_und, image_l,
                 image_r, scales, th: int, device):
    """Kernel 9's checks, one fused test a tensor: types, shapes,
    contiguity, `device`, the 16-byte descriptors and 8-byte xy_r, 1 <= M <=
    max_right_keypoints(H, L) (8999 at VGA and 8 levels), th in [0, 2048], a
    level table, 1 <= H, W < 2^23.  Returns (N, M, H, W, L, the twelve
    pointers)."""
    N, M = xy_l.shape[0], xy_r.shape[0]
    H, W = image_l.shape
    L = scales.shape[0]
    c = _build.check_tensor
    c(xy_l, "xy_l", F32, (N, 2), device)
    c(oct_l, "oct_l", I32, (N,), device)
    c(valid_l, "valid_l", BOOL, (N,), device)
    c(desc_l, "desc_l", I32, (N, 16), device)
    c(xy_r, "xy_r", F32, (M, 2), device)
    c(oct_r, "oct_r", I32, (M,), device)
    c(valid_r, "valid_r", BOOL, (M,), device)
    c(desc_r, "desc_r", I32, (M, 16), device)
    c(x_und, "x_und", F32, (N,), device)
    c(image_l, "image_l", F32, (H, W), device)
    c(image_r, "image_r", F32, (H, W), device)
    c(scales, "scales", F32, (L,), device)
    ptrs = (xy_l.data_ptr(), oct_l.data_ptr(), valid_l.data_ptr(), desc_l.data_ptr(),
            xy_r.data_ptr(), oct_r.data_ptr(), valid_r.data_ptr(), desc_r.data_ptr(),
            x_und.data_ptr(), image_l.data_ptr(), image_r.data_ptr(), scales.data_ptr())
    if ptrs[3] % 16 or ptrs[7] % 16 or ptrs[4] % 8:
        raise ValueError("stereo_match reads descriptors as 16-byte and xy as 8-byte vectors: "
                         "misaligned input")
    if (not (0 <= th <= NO_MATCH) or L == 0 or not (0 < H < (1 << 23) and 0 < W < (1 << 23))
            or not (0 < M <= max_right_keypoints(H, L))):
        raise ValueError(f"stereo_match takes th in [0, {NO_MATCH}], a level table, images of 1 to "
                         f"2^23 - 1 rows and columns and 1 to max_right_keypoints(H, L) right "
                         f"keypoints (its shared memory); got th {th}, L {L}, image {H} x {W}, "
                         f"M {M}")
    return N, M, H, W, L, ptrs


def stereo_match(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r, desc_r, x_und, image_l,
                 image_r, scales, fx: float, bf: float, th: int):
    """Kernel 9.  xy [N, 2] / [M, 2] f32 raw keypoints, octaves int32, valid
    bool, descriptors [., 16] int32, x_und [N] f32 the undistorted left x,
    images [H, W] f32, scales [L] f32; th the acceptance threshold."""
    if not xy_l.is_cuda:
        return stereo_match_plain(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r, desc_r,
                                  x_und, image_l, image_r, scales, fx, bf, th)
    dev = xy_l.device
    N, M, H, W, L, ptrs = check_inputs(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r,
                                       desc_r, x_und, image_l, image_r, scales, th, dev)
    # outputs shaped and typed as checked inputs: empty_like is the cheapest allocation
    ur, depth = torch.empty_like(x_und), torch.empty_like(x_und)
    best, bestd = torch.empty_like(oct_l), torch.empty_like(oct_l)
    ok = torch.empty_like(valid_l)
    ws = _WORKSPACES.get(dev)
    if ws is None:
        ws = _WORKSPACES[dev] = torch.zeros(2, dtype=I32, device=dev)
    err = _lib()(*ptrs, N, M, H, W, L, int(th), float(fx), float(bf), ur.data_ptr(),
                 depth.data_ptr(), best.data_ptr(), bestd.data_ptr(), ok.data_ptr(),
                 ws.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "stereo_match")
    if N:
        stereo_match.launches += 1
    return ur, depth, best, bestd, ok


stereo_match.launches = 0
