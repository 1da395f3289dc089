"""Kernel 12b: the dense BA's reduced camera system by Cholesky, in one
fixed order on every device.

``chol_solve(Sf, rf)`` solves Sf x = rf for a symmetric Sf [n, n] f32
(its lower triangle read), x [n] all NaN where a pivot is not > 0 (the
reference's ``jax.scipy.linalg.solve(assume_a="pos")`` refused).  Every
entry of the factor and of the two triangular solves is one chain of
multiply-subtracts in a fixed order (``csrc/chol_solve.cu`` states it),
each product rounded before its subtraction, square roots and divisions
correctly rounded: CUDA tensors launch ``csrc/chol_solve.cu``
(``launches_per_solve(n)`` device kernels, no host read), CPU tensors run
the plain twin ``chol_solve_plain``, a column at a time, which gives the
kernel's bits.  ``chol_solve.launches`` counts the calls that launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.cache
def _lib():
    lib = _build.load("chol_solve")
    lib.chol_solve_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.chol_solve_launch.restype = ctypes.c_int
    return lib


PB = 32          # csrc/chol_solve.cu's panel width
MAX_N = 12288    # csrc/chol_solve.cu's MAX_N


def launches_per_solve(n: int) -> int:
    """Device kernels one solve of an n x n system launches: a panel of PB
    columns each (the forward solve inside, as the factor's row n), then the
    back solve."""
    return -(-n // PB) + 1


def chol_solve_plain(Sf: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """The twin: right-looking, a column at a time (the kernel's chains in
    the same order, so the same bits on any device)."""
    n = Sf.shape[0]
    L = Sf.clone()
    piv = torch.empty_like(rf)
    for k in range(n):
        piv[k] = L[k, k]
        lkk = torch.sqrt(L[k, k].double()).to(L.dtype)
        col = L[k + 1:, k] / lkk
        L[k, k] = lkk
        L[k + 1:, k] = col
        L[k + 1:, k + 1:] -= col[:, None] * col[None, :]
    y = rf.clone()
    for k in range(n):
        y[k] = y[k] / L[k, k]
        y[k + 1:] -= L[k + 1:, k] * y[k]
    for k in range(n - 1, -1, -1):
        y[k] = y[k] / L[k, k]
        y[:k] -= L[k, :k] * y[k]
    return torch.where((piv > 0).all(), y, torch.full_like(y, float("nan")))


def check_inputs(Sf: torch.Tensor, rf: torch.Tensor, device) -> int:
    """Validate a system for the kernel (f32, Sf [n, n], rf [n], contiguous,
    on `device`, 1 <= n <= MAX_N); raises before any launch.  Returns n."""
    n = Sf.shape[0] if Sf.dim() == 2 else -1
    if Sf.dim() != 2 or Sf.shape[1] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"chol_solve: Sf must be [n, n] with 1 <= n <= {MAX_N}, "
                         f"got {tuple(Sf.shape)}")
    _build.check_tensor(Sf, "Sf", torch.float32, (n, n), device)
    _build.check_tensor(rf, "rf", torch.float32, (n,), device)
    return n


def chol_solve(Sf: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """x [n] with Sf x = rf, all NaN where Sf is not positive definite."""
    if not Sf.is_cuda:
        return chol_solve_plain(Sf, rf)
    dev = Sf.device
    n = check_inputs(Sf, rf, dev)
    lib = _lib()
    work = torch.empty((n + 1) * n + 1, dtype=torch.float32, device=dev)
    x = torch.empty(n, dtype=torch.float32, device=dev)
    err = lib.chol_solve_launch(Sf.data_ptr(), rf.data_ptr(), n, work.data_ptr(),
                                work[(n + 1) * n:].data_ptr(), x.data_ptr(),
                                _build.stream_ptr(dev))
    _build.check_launch(err, "chol_solve")
    chol_solve.launches += 1
    return x


chol_solve.launches = 0
