"""Kernel 6: inlier counts of batched PnP hypotheses.

``pnp_score`` launches ``csrc/pnp_score.cu`` for CUDA tensors and runs its
plain twin ``pnp_score_plain`` for CPU tensors; ``launches`` counts kernel
launches.  The twin writes out the reference's ``xw @ R.T + t`` product
term by term in a fixed order, and the kernel is built with
``--fmad=false`` to take the same roundings, so the counts are equal.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def pnp_score_plain(Rs, ts, xw, uv, valid, fx: float, fy: float, cx: float, cy: float,
                    th: float):
    """Rs [C,S,3,3], ts [C,S,3], xw [C,N,3], uv [N,2], valid [C,N] ->
    [C,S] int32 counts of points with z > 1e-3 and squared pixel error < th."""
    R = Rs[..., None]                                  # [C,S,3,3,1]
    x = xw[:, None, None, :, :]                        # [C,1,1,N,3]
    xc = (x[..., 0] * R[:, :, :, 0] + x[..., 1] * R[:, :, :, 1]) + x[..., 2] * R[:, :, :, 2]
    xc = xc + ts[..., None]                            # [C,S,3,N]
    zok = xc[:, :, 2] > 1e-3
    z = torch.where(zok, xc[:, :, 2], 1.0)
    du = fx * xc[:, :, 0] / z + cx - uv[:, 0]
    dv = fy * xc[:, :, 1] / z + cy - uv[:, 1]
    inl = valid[:, None, :] & zok & (du * du + dv * dv < th)
    return inl.sum(-1).to(torch.int32)


@functools.cache
def _fn():
    fn = _build.load("pnp_score").pnp_score_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def pnp_score(Rs, ts, xw, uv, valid, fx: float, fy: float, cx: float, cy: float, th: float):
    if not xw.is_cuda:
        return pnp_score_plain(Rs, ts, xw, uv, valid, fx, fy, cx, cy, th)
    dev = xw.device
    C, S, N = Rs.shape[0], Rs.shape[1], xw.shape[1]
    for t, name, dt, shape in ((Rs, "Rs", torch.float32, (C, S, 3, 3)),
                               (ts, "ts", torch.float32, (C, S, 3)),
                               (xw, "xw", torch.float32, (C, N, 3)),
                               (uv, "uv", torch.float32, (N, 2)),
                               (valid, "valid", torch.bool, (C, N))):
        _build.check_tensor(t, name, dt, shape, dev)
    out = torch.empty((C, S), dtype=torch.int32, device=dev)
    err = _fn()(Rs.data_ptr(), ts.data_ptr(), xw.data_ptr(), uv.data_ptr(), valid.data_ptr(),
                C, S, N, fx, fy, cx, cy, th, out.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "pnp_score")
    pnp_score.launches += 1
    return out


pnp_score.launches = 0
