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

import torch

from ..ops.hamming import hamming_pairwise
from . import _build

NO_MATCH = 2048    # the reference's sentinel distance for a non-candidate
HALF = 4           # 9 x 9 SAD patch
SLIDE = 4          # slides -4 .. 4
MEDIAN_NAN = 80.0  # jnp.nan_to_num's stand-in for the NaN median


def stereo_candidates(xy_l, oct_l, valid_l, xy_r, oct_r, valid_r, scales, fx: float):
    """[N, M] bool: right keypoint j is a candidate for left keypoint i (same
    row band, scaled by j's octave; disparity in [0, fx]; both valid;
    octaves at most one apart), all on the raw coordinates."""
    row_r = 2.0 * scales[oct_r.long().clamp(0, scales.shape[0] - 1)]
    dy = (xy_l[:, 1, None] - xy_r[None, :, 1]).abs()
    disp = xy_l[:, 0, None] - xy_r[None, :, 0]
    return ((dy <= row_r[None, :]) & (disp >= 0) & (disp <= fx) & valid_l[:, None]
            & valid_r[None, :] & ((oct_l[:, None] - oct_r[None, :]).abs() <= 1))


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


_WORKSPACES: dict = {}   # device -> [2] int32: the ticket and the count of rows not accepted;
                         # 0 between calls


def stereo_match(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r, desc_r, x_und, image_l,
                 image_r, scales, fx: float, bf: float, th: int):
    """Kernel 9.  xy [N, 2] / [M, 2] f32 raw keypoints, octaves int32, valid
    bool, descriptors [., 16] int32, x_und [N] f32 the undistorted left x,
    images [H, W] f32, scales [L] f32; th the acceptance threshold."""
    if not xy_l.is_cuda:
        return stereo_match_plain(xy_l, oct_l, valid_l, desc_l, xy_r, oct_r, valid_r, desc_r,
                                  x_und, image_l, image_r, scales, fx, bf, th)
    dev = xy_l.device
    N, M = xy_l.shape[0], xy_r.shape[0]
    H, W = image_l.shape
    L = scales.shape[0]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    for t, name, dtype, shape in (
            (xy_l, "xy_l", f32, (N, 2)), (oct_l, "oct_l", i32, (N,)), (valid_l, "valid_l", b, (N,)),
            (desc_l, "desc_l", i32, (N, 16)), (xy_r, "xy_r", f32, (M, 2)),
            (oct_r, "oct_r", i32, (M,)), (valid_r, "valid_r", b, (M,)),
            (desc_r, "desc_r", i32, (M, 16)), (x_und, "x_und", f32, (N,)),
            (image_l, "image_l", f32, (H, W)), (image_r, "image_r", f32, (H, W)),
            (scales, "scales", f32, (L,))):
        _build.check_tensor(t, name, dtype, shape, dev)
    if desc_l.data_ptr() % 16 or desc_r.data_ptr() % 16 or xy_r.data_ptr() % 8:
        raise ValueError("stereo_match reads descriptors as 16-byte and xy as 8-byte vectors: "
                         "misaligned input")
    if not (0 < M < (1 << 20)) or not (0 <= th <= NO_MATCH) or L == 0:
        raise ValueError(f"stereo_match takes 1 to 2^20 - 1 right keypoints, th in [0, {NO_MATCH}] "
                         f"and a level table; got M {M}, th {th}, L {L}")
    ur = torch.empty(N, dtype=f32, device=dev)
    depth = torch.empty(N, dtype=f32, device=dev)
    best = torch.empty(N, dtype=i32, device=dev)
    bestd = torch.empty(N, dtype=i32, device=dev)
    ok = torch.empty(N, dtype=b, device=dev)
    ws = _WORKSPACES.get(dev)
    if ws is None:
        ws = _WORKSPACES[dev] = torch.zeros(2, dtype=i32, device=dev)
    err = _lib()(xy_l.data_ptr(), oct_l.data_ptr(), valid_l.data_ptr(), desc_l.data_ptr(),
                 xy_r.data_ptr(), oct_r.data_ptr(), valid_r.data_ptr(), desc_r.data_ptr(),
                 x_und.data_ptr(), image_l.data_ptr(), image_r.data_ptr(), scales.data_ptr(),
                 N, M, H, W, L, int(th), float(fx), float(bf), ur.data_ptr(), depth.data_ptr(),
                 best.data_ptr(), bestd.data_ptr(), ok.data_ptr(), ws.data_ptr(),
                 _build.stream_ptr(dev))
    _build.check_launch(err, "stereo_match")
    if N:
        stereo_match.launches += 1
    return ur, depth, best, bestd, ok


stereo_match.launches = 0
