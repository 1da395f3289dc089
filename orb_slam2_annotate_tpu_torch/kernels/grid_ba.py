"""Kernel 12: local BA's grid LM (``ba_core.bundle_adjust_grid``).

``grid_ba_solve`` launches ``csrc/grid_ba.cu`` for CUDA tensors: one solve
is 2 + 5 x iters launches of four kernels (setup; a linearization, the
Schur blocks, the Cholesky, the retraction and point steps, the tries'
costs with the pick, each iteration; the inlier mask), on one workspace, with
no host read.  For CPU tensors it runs the plain twin,
``ba_core.bundle_adjust_grid_plain``.  ``grid_ba_solve.launches`` counts
the calls that launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from . import _build

MAX_C = 32              # cameras: a point's cameras are one 32-bit mask
LIST_BYTES = 80         # gba_schur's shared memory a point of a camera: index, mask, B H^-1
SCHUR_STATIC = 1024     # at least gba_schur's static shared memory
SMEM_PER_CTA = 232_448  # what an H100 CTA may use
MAX_LIST = (SMEM_PER_CTA - SCHUR_STATIC) // LIST_BYTES   # min(N, P) a call may have


def launches_per_solve(iters: int) -> int:
    """Device kernels one solve launches: setup, five an iteration, the mask."""
    return 2 + 5 * iters


@functools.cache
def _lib():
    lib = _build.load("grid_ba")
    lib.grid_ba_launch.argtypes = [ctypes.c_float] * 5 + [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 7
    lib.grid_ba_launch.restype = ctypes.c_int
    lib.grid_ba_work_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.grid_ba_work_bytes.restype = ctypes.c_longlong
    lib.grid_ba_work_layout.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.grid_ba_work_layout.restype = ctypes.c_int
    return lib


def work_bytes(C: int, P: int) -> int:
    """Bytes of one call's workspace."""
    return _lib().grid_ba_work_bytes(C, P)


def work_views(work: torch.Tensor, C: int, P: int) -> dict:
    """The parts of a call's workspace (``grid_ba_solve(..., work=...)``) as
    tensors, named as csrc/grid_ba.cu's ``Work``: after a call they hold
    its last iteration's linearization (Hcc upper [C,21], gc, the cost a
    camera, B_pc [C,18,P] where the point's camera mask has bit c, gp [3,P],
    Hpp upper [6,P]), Schur blocks (S [3,C,C,36] for free c >= d, rhs),
    steps (dc [3,6C]) and tries, for the checks of chip_smoke.py."""
    shapes = {"inv": (C, P), "mask": (P,), "Hcc": (C, 21), "gc": (C, 6), "cost_lin": (C,),
              "B": (C, 18, P), "gp": (3, P), "Hinv": (3, 9, P), "S": (3, C, C, 36),
              "rhs": (3, C, 6), "R_a": (3, C, 3, 3), "t_a": (3, C, 3), "X_a": (3, P, 3),
              "cost_try": (3, C), "fail": (3,), "lam": (1,), "ticket": (1,), "Hpp": (6, P),
              "dc": (3, 6 * C)}
    offs = (ctypes.c_longlong * (len(shapes) + 1))()
    if _lib().grid_ba_work_layout(C, P, offs) != len(shapes):
        raise RuntimeError("grid_ba: the workspace's parts differ from csrc/grid_ba.cu's")
    f, i = work.view(torch.float32), work.view(torch.int32)
    ints = ("inv", "mask", "fail", "ticket")
    return {name: (i if name in ints else f)[offs[k]:offs[k] + math.prod(shape)].view(shape)
            for k, (name, shape) in enumerate(shapes.items())}


FIELDS = ("R", "t", "points", "cam_fixed", "cam_valid", "pt_valid", "pt_loc", "uv", "ur",
          "inv_sigma2", "edge_valid")


def check_inputs(g, iters: int, lam_ladder, device) -> tuple:
    """Validate a GridBA for the kernel on `device` (dtypes, shapes, C <=
    MAX_C, min(N, P) <= MAX_LIST, three ladder values, iters >= 0); raises
    before any launch.  Returns (C, N, P, the fields made contiguous)."""
    C, N = g.pt_loc.shape if g.pt_loc.dim() == 2 else (-1, -1)
    P = g.points.shape[0]
    if g.pt_loc.dim() != 2 or C < 1 or N < 1 or P < 1:
        raise ValueError(f"grid_ba: pt_loc must be [C, N] and points [P, 3] with C, N, P >= 1, "
                         f"got {tuple(g.pt_loc.shape)} and {tuple(g.points.shape)}")
    if C > MAX_C:
        raise ValueError(f"grid_ba: {C} cameras, the kernel takes at most {MAX_C}")
    if min(N, P) > MAX_LIST:
        raise ValueError(f"grid_ba: min(N, P) = {min(N, P)}, the kernel takes at most {MAX_LIST}")
    if len(lam_ladder) != 3:
        raise ValueError(f"grid_ba: the kernel takes three damping values, got {len(lam_ladder)}")
    if iters < 0:
        raise ValueError(f"grid_ba: iters {iters} < 0")
    f32, b8 = torch.float32, torch.bool
    specs = ((f32, (C, 3, 3)), (f32, (C, 3)), (f32, (P, 3)), (b8, (C,)), (b8, (C,)), (b8, (P,)),
             (torch.int32, (C, N)), (f32, (C, N, 2)), (f32, (C, N)), (f32, (C, N)), (b8, (C, N)))
    ns = types.SimpleNamespace(**{name: getattr(g, name).contiguous() for name in FIELDS})
    for name, (dtype, shape) in zip(FIELDS, specs):
        _build.check_tensor(getattr(ns, name), name, dtype, shape, device)
    return C, N, P, ns


def grid_ba_solve(cam, g, iters: int = 10, robust: bool = True, lam0: float = 1e-5,
                  lam_ladder: tuple = (1.0, 8.0, 64.0), work: torch.Tensor | None = None):
    """``ba_core.bundle_adjust_grid`` on the GridBA `g`: (R [C,3,3], t [C,3],
    points [P,3], edge_inlier [C,N] bool, cost 0-d, None when iters is 0).
    `work`: a uint8 tensor of ``work_bytes(C, P)`` to use as the workspace
    (its parts readable after the call with ``work_views``); by default one
    is allocated."""
    if not g.points.is_cuda:
        from ..solvers.ba_core import bundle_adjust_grid_plain

        return bundle_adjust_grid_plain(cam, g, iters, robust, lam0, lam_ladder)
    dev = g.points.device
    C, N, P, g = check_inputs(g, iters, lam_ladder, dev)
    lib = _lib()
    f32 = torch.float32
    if work is None:
        work = torch.empty(lib.grid_ba_work_bytes(C, P), dtype=torch.uint8, device=dev)
    else:
        _build.check_tensor(work, "work", torch.uint8, (lib.grid_ba_work_bytes(C, P),), dev)
    R = torch.empty((C, 3, 3), dtype=f32, device=dev)
    t = torch.empty((C, 3), dtype=f32, device=dev)
    X = torch.empty((P, 3), dtype=f32, device=dev)
    inlier = torch.empty((C, N), dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    err = lib.grid_ba_launch(
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, g.R.data_ptr(), g.t.data_ptr(),
        g.points.data_ptr(), g.cam_fixed.data_ptr(), g.cam_valid.data_ptr(), g.pt_valid.data_ptr(),
        g.pt_loc.data_ptr(), g.uv.data_ptr(), g.ur.data_ptr(), g.inv_sigma2.data_ptr(),
        g.edge_valid.data_ptr(), C, N, P, iters, int(bool(robust)), lam0, *lam_ladder,
        work.data_ptr(), R.data_ptr(), t.data_ptr(), X.data_ptr(), inlier.data_ptr(),
        cost.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "grid_ba")
    grid_ba_solve.launches += 1
    return R, t, X, inlier, (cost if iters > 0 else None)


grid_ba_solve.launches = 0
