"""Kernel 3: the batched, gate-fused Hamming matcher, and each map point's
distinctive descriptor.

``hamming_match`` and ``distinctive_descriptors`` launch
``csrc/hamming.cu`` for CUDA tensors and run their plain twins
(``hamming_match_plain``, ``distinctive_descriptors_plain``) for CPU
tensors.  Each wrapper's ``launches`` counts its kernel launches.

The matcher takes B problems at once: every array may carry a leading batch
dimension or leave it out, and an array without one is shared by all
problems (batch stride 0 in the kernel).  Candidates are the pairs whose row
and column are valid and that pass one gate, evaluated per pair in the
kernel: none, ``WindowGate`` (circular window, optionally with an octave
band), ``EpipolarGate`` (distance to the epipolar line) or ``MaskGate`` (a
dense [N1,N2] mask, kept for ``match_masked``'s API).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.hamming import MAX_DIST, hamming_pairwise, masked_min2
from ..ops.orb import DESC_WORDS
from . import _build


class WindowGate(NamedTuple):
    """dx*dx + dy*dy <= r*r between proj_xy [N1,2] and xy2 [N2,2], radius
    [N1] or a float; with pred_octave [N1] and octave2 [N2] also
    pred + lo <= octave2 <= pred + hi."""

    proj_xy: torch.Tensor
    radius: torch.Tensor | float
    xy2: torch.Tensor
    pred_octave: torch.Tensor | None = None
    octave2: torch.Tensor | None = None
    lo: int = -1
    hi: int = 1


class EpipolarGate(NamedTuple):
    """(l . [x2, y2, 1])^2 / max(l0^2 + l1^2, 1e-12) < 3.84 / inv_sigma2[octave2]
    with the line l = [x1, y1, 1] @ F12; F12 [3,3], xy1 [N1,2], xy2 [N2,2],
    octave2 [N2] int32, inv_sigma2 [levels]."""

    F12: torch.Tensor
    xy1: torch.Tensor
    xy2: torch.Tensor
    octave2: torch.Tensor
    inv_sigma2: torch.Tensor


class MaskGate(NamedTuple):
    mask: torch.Tensor   # [N1,N2] bool


# ---- plain twins -----------------------------------------------------------

def window_mask(xy1_proj: torch.Tensor, xy2: torch.Tensor, radius) -> torch.Tensor:
    """Circular-window candidate mask [..., N1, N2]; radius a float or [..., N1]."""
    dx = xy1_proj[..., :, None, 0] - xy2[..., None, :, 0]
    dy = xy1_proj[..., :, None, 1] - xy2[..., None, :, 1]
    d2 = dx * dx + dy * dy
    r = torch.as_tensor(radius, dtype=torch.float32, device=xy1_proj.device)
    return d2 <= (r * r)[..., None]


def octave_mask(pred_octave: torch.Tensor, octave2: torch.Tensor, lo_off: int = -1,
                hi_off: int = 1) -> torch.Tensor:
    o = pred_octave[..., :, None]
    o2 = octave2[..., None, :]
    return (o2 >= o + lo_off) & (o2 <= o + hi_off)


def epipolar_mask(F12, xy1, xy2, octave2, inv_sigma2) -> torch.Tensor:
    """The epipolar gate [..., N1, N2], written term by term in the kernel's order."""
    x1, y1 = xy1[..., 0], xy1[..., 1]
    F = F12[..., None, :, :]
    l0 = x1 * F[..., 0, 0] + y1 * F[..., 1, 0] + F[..., 2, 0]
    l1 = x1 * F[..., 0, 1] + y1 * F[..., 1, 1] + F[..., 2, 1]
    l2 = x1 * F[..., 0, 2] + y1 * F[..., 1, 2] + F[..., 2, 2]
    den = torch.clamp_min(l0 * l0 + l1 * l1, 1e-12)
    v = (l0[..., :, None] * xy2[..., None, :, 0] + l1[..., :, None] * xy2[..., None, :, 1]
         + l2[..., :, None])
    thr = 3.84 * (1.0 / inv_sigma2[octave2.long()])
    return (v * v) / den[..., :, None] < thr[..., None, :]


def gate_mask(gate) -> torch.Tensor | None:
    """The candidate mask a gate stands for, or None for no gate."""
    if gate is None:
        return None
    if isinstance(gate, MaskGate):
        return gate.mask
    if isinstance(gate, EpipolarGate):
        return epipolar_mask(*gate)
    m = window_mask(gate.proj_xy, gate.xy2, gate.radius)
    if gate.pred_octave is not None:
        m = m & octave_mask(gate.pred_octave, gate.octave2, gate.lo, gate.hi)
    return m


def hamming_match_plain(desc1, desc2, row_valid, col_valid, max_dist: int, ratio: float,
                        mutual: bool = False, gate=None):
    """desc1 [B?,N1,16], desc2 [B?,N2,16] int32, row_valid [B?,N1] / col_valid
    [B?,N2] bool or None (all valid) -> (idx [B?,N1] int32, -1 if unmatched;
    dist [B?,N1] int32, MAX_DIST if unmatched)."""
    n1 = desc1.shape[-2]
    dev = desc1.device
    rv = torch.ones(n1, dtype=torch.bool, device=dev) if row_valid is None else row_valid
    cv = (torch.ones(desc2.shape[-2], dtype=torch.bool, device=dev) if col_valid is None
          else col_valid)
    cand = rv[..., :, None] & cv[..., None, :]
    g = gate_mask(gate)
    if g is not None:
        cand = cand & g
    d, cand = torch.broadcast_tensors(hamming_pairwise(desc1, desc2), cand)
    best, bidx, second = masked_min2(d, cand)
    ok = (best <= max_dist) & (best.float() < ratio * second.float())
    dm = torch.where(cand, d, torch.full_like(d, MAX_DIST))
    if mutual:
        rbest_idx = torch.argmin(dm, dim=-2)
        ok = ok & (torch.gather(rbest_idx, -1, bidx) == torch.arange(n1, device=dev))
    else:
        col_best = dm.min(dim=-2).values
        ok = ok & (best <= torch.gather(col_best, -1, bidx))
    idx = torch.where(ok, bidx, -1).to(torch.int32)
    dist = torch.where(ok, best, MAX_DIST).to(torch.int32)
    return idx, dist


_OBS_LANES = 32    # the kernel's table width: one observation a lane of a warp
_MED_BIG = 2048    # the reference's sentinel for unobserved slots


def distinctive_descriptors_plain(kf_desc, obs_kf, obs_ft, obs_cnt):
    """kf_desc [K,N,16] int32, obs_kf / obs_ft [Q,M] int32 (keyframe, feature)
    of each point's observations, obs_cnt [Q] int32 in 0..M -> (desc [Q,16]
    int32: the observed descriptor with the least median distance to the
    others, best [Q] int32: its slot, the first on ties and 0 when cnt = 0)."""
    M = obs_kf.shape[1]
    descs = kf_desc[obs_kf.long(), obs_ft.long()]                      # [Q,M,16]
    d = hamming_pairwise(descs, descs)                                 # [Q,M,M]
    obs_mask = torch.arange(M, device=descs.device)[None, :] < obs_cnt[:, None]
    dm = torch.where(obs_mask[:, None, :], d, _MED_BIG)
    dsort = torch.sort(dm, dim=-1).values
    med_idx = torch.clamp(torch.div(obs_cnt - 1, 2, rounding_mode="floor"), 0, M - 1)
    mi = med_idx.long()[:, None, None].expand(-1, M, 1)
    med = torch.gather(dsort, -1, mi)[..., 0]
    med = torch.where(obs_mask, med, _MED_BIG)
    best = torch.argmin(med, dim=1)                                    # first minimum
    return descs[torch.arange(descs.shape[0], device=descs.device), best], best.to(torch.int32)


# ---- the kernel ------------------------------------------------------------

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
GATE_NONE, GATE_WINDOW, GATE_EPIPOLAR, GATE_MASK = 0, 1, 2, 3


class _MatchArgs(ctypes.Structure):
    """csrc/hamming.cu's MatchArgs, field for field."""

    _fields_ = [("d1", _P), ("d2", _P), ("rv", _P), ("cv", _P),
                ("s_d1", _LL), ("s_d2", _LL), ("s_rv", _LL), ("s_cv", _LL),
                ("pxy", _P), ("rad", _P), ("poct", _P), ("xy2", _P), ("oct2", _P),
                ("s_pxy", _LL), ("s_rad", _LL), ("s_poct", _LL), ("s_xy2", _LL), ("s_oct2", _LL),
                ("rad_scalar", ctypes.c_float), ("lo", ctypes.c_int), ("hi", ctypes.c_int),
                ("use_oct", ctypes.c_int),
                ("F", _P), ("xy1", _P), ("isig2", _P), ("s_F", _LL), ("s_xy1", _LL),
                ("mask", _P), ("s_mask", _LL),
                ("B", ctypes.c_int), ("N1", ctypes.c_int), ("N2", ctypes.c_int),
                ("gate", ctypes.c_int), ("max_dist", ctypes.c_int), ("mutual", ctypes.c_int),
                ("ratio", ctypes.c_float),
                ("colkey", _P), ("rowstate", _P), ("ticket", _P), ("out", _P)]


@functools.cache
def _fns():
    lib = _build.load("hamming")
    match = lib.hamming_match_launch
    match.argtypes = [ctypes.POINTER(_MatchArgs), _P]
    match.restype = ctypes.c_int
    dd = lib.distinctive_descriptors_launch
    dd.argtypes = [_P] + [ctypes.c_int] * 2 + [_P] * 3 + [ctypes.c_int] + [_P] * 3
    dd.restype = ctypes.c_int
    return match, dd


_WORKSPACE: dict = {}   # device -> (colkey [>= B*N2] i64, rowstate [>= B*N1*3] i32, ticket [>= B] i32)
_KEY_INIT = MAX_DIST << 32


def _workspace(dev, B: int, N1: int, N2: int):
    """The device's matcher workspace, grown to fit.  Between calls the column
    keys hold KEY_INIT and the tickets 0: the kernel's finishing CTAs restore
    both, and calls on one stream run in order."""
    ws = _WORKSPACE.get(dev)
    if ws is None or ws[0].numel() < B * N2 or ws[1].numel() < 3 * B * N1 or ws[2].numel() < B:
        n2 = max(B * N2, 0 if ws is None else ws[0].numel())
        n1 = max(3 * B * N1, 0 if ws is None else ws[1].numel())
        nb = max(B, 0 if ws is None else ws[2].numel())
        ws = (torch.full((n2,), _KEY_INIT, dtype=torch.int64, device=dev),
              torch.empty((n1,), dtype=torch.int32, device=dev),
              torch.zeros((nb,), dtype=torch.int32, device=dev))
        _WORKSPACE[dev] = ws
    return ws


def _arg(t, name: str, dtype, tail: tuple, dev):
    """(pointer, batch stride, batch size or 0 if shared) of a kernel input
    of shape [*tail] (shared) or [B, *tail]."""
    if t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"hamming_match: {name} must be a contiguous {dtype} tensor on {dev}, "
                         f"got {t.dtype} on {t.device}")
    shape = t.shape
    if shape[len(shape) - len(tail):] != tail or len(shape) - len(tail) not in (0, 1):
        raise ValueError(f"hamming_match: {name} of shape {tuple(shape)}, expected "
                         f"[B,]{list(tail)}")
    if len(shape) == len(tail):
        return t.data_ptr(), 0, 0
    return t.data_ptr(), t.stride(0), shape[0]


def hamming_match(desc1, desc2, row_valid, col_valid, max_dist: int, ratio: float,
                  mutual: bool = False, gate=None):
    """One launch for B matching problems; see ``hamming_match_plain``."""
    if not desc1.is_cuda:
        return hamming_match_plain(desc1, desc2, row_valid, col_valid, max_dist, ratio, mutual,
                                   gate)
    dev = desc1.device
    N1, N2 = desc1.shape[-2], desc2.shape[-2]
    if N2 == 0:
        raise ValueError("hamming_match: desc2 has no rows")
    a = _MatchArgs()
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    batch = []

    def put(field, t, dtype, tail):
        ptr, stride, bsz = _arg(t, field, dtype, tail, dev)
        setattr(a, field, ptr)
        if bsz:
            batch.append(bsz)
        return stride

    a.s_d1 = put("d1", desc1, i32, (N1, DESC_WORDS))
    if desc2.data_ptr() % 16:
        raise ValueError("hamming_match: desc2 must be 16-byte aligned (cp.async)")
    a.s_d2 = put("d2", desc2, i32, (N2, DESC_WORDS))
    if row_valid is not None:
        a.s_rv = put("rv", row_valid, u8, (N1,))
    if col_valid is not None:
        a.s_cv = put("cv", col_valid, u8, (N2,))
    if gate is None:
        a.gate = GATE_NONE
    elif isinstance(gate, WindowGate):
        a.gate = GATE_WINDOW
        a.s_pxy = put("pxy", gate.proj_xy, f32, (N1, 2))
        if torch.is_tensor(gate.radius):
            a.s_rad = put("rad", gate.radius, f32, (N1,))
        else:
            a.rad_scalar = float(gate.radius)
        a.s_xy2 = put("xy2", gate.xy2, f32, (N2, 2))
        if gate.pred_octave is not None:
            a.use_oct, a.lo, a.hi = 1, int(gate.lo), int(gate.hi)
            a.s_poct = put("poct", gate.pred_octave, i32, (N1,))
            a.s_oct2 = put("oct2", gate.octave2, i32, (N2,))
    elif isinstance(gate, EpipolarGate):
        a.gate = GATE_EPIPOLAR
        a.s_F = put("F", gate.F12, f32, (3, 3))
        a.s_xy1 = put("xy1", gate.xy1, f32, (N1, 2))
        a.s_xy2 = put("xy2", gate.xy2, f32, (N2, 2))
        a.s_oct2 = put("oct2", gate.octave2, i32, (N2,))
        _arg(gate.inv_sigma2, "inv_sigma2", f32, tuple(gate.inv_sigma2.shape), dev)
        a.isig2 = gate.inv_sigma2.data_ptr()
    elif isinstance(gate, MaskGate):
        a.gate = GATE_MASK
        a.s_mask = put("mask", gate.mask, u8, (N1, N2))
    else:
        raise TypeError(f"hamming_match: unknown gate {type(gate).__name__}")
    B = batch[0] if batch else 1
    if any(n != B for n in batch):
        raise ValueError(f"hamming_match: batch sizes differ: {batch}")
    out = torch.empty((2, B, N1), dtype=i32, device=dev)
    colkey, rowstate, ticket = _workspace(dev, B, N1, N2)
    a.B, a.N1, a.N2 = B, N1, N2
    a.max_dist, a.ratio, a.mutual = int(max_dist), float(ratio), int(bool(mutual))
    a.colkey, a.rowstate, a.ticket = colkey.data_ptr(), rowstate.data_ptr(), ticket.data_ptr()
    a.out = out.data_ptr()
    match, _ = _fns()
    _build.check_launch(match(ctypes.byref(a), _build.stream_ptr(dev)), "hamming_match")
    hamming_match.launches += 1
    return (out[0], out[1]) if batch else (out[0, 0], out[1, 0])


def distinctive_descriptors(kf_desc, obs_kf, obs_ft, obs_cnt):
    """One launch, one warp a point; see ``distinctive_descriptors_plain``."""
    if not kf_desc.is_cuda:
        return distinctive_descriptors_plain(kf_desc, obs_kf, obs_ft, obs_cnt)
    dev = kf_desc.device
    K, N, Q = kf_desc.shape[0], kf_desc.shape[1], obs_kf.shape[0]
    _build.check_tensor(kf_desc, "kf_desc", torch.int32, (K, N, DESC_WORDS), dev)
    _build.check_tensor(obs_kf, "obs_kf", torch.int32, (Q, _OBS_LANES), dev)
    _build.check_tensor(obs_ft, "obs_ft", torch.int32, (Q, _OBS_LANES), dev)
    _build.check_tensor(obs_cnt, "obs_cnt", torch.int32, (Q,), dev)
    if kf_desc.data_ptr() % 16:
        raise ValueError("distinctive_descriptors: kf_desc must be 16-byte aligned")
    desc = torch.empty((Q, DESC_WORDS), dtype=torch.int32, device=dev)
    best = torch.empty((Q,), dtype=torch.int32, device=dev)
    _, dd = _fns()
    err = dd(kf_desc.data_ptr(), K, N, obs_kf.data_ptr(), obs_ft.data_ptr(), obs_cnt.data_ptr(), Q,
             desc.data_ptr(), best.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "distinctive_descriptors")
    distinctive_descriptors.launches += 1
    return desc, best


hamming_match.launches = 0
distinctive_descriptors.launches = 0
