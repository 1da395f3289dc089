"""Kernel 12c: the distributed BA's reduced camera system by LU with partial
pivoting, in one fixed order on every device.

``lu_solve(Sf, rf)`` solves Sf x = rf for Sf [n, n] f32 as the reference's
``jnp.linalg.solve`` does (an LU: a system that is not positive definite
still gives a step).  The pivot of column k is the first row of largest
|entry| (a NaN above every number), rows swap whole, and every entry of the
factors and of the two triangular solves is one chain of multiply-subtracts
in a fixed order (``csrc/lu_solve.cu`` states it), each product rounded
before its subtraction, divisions correctly rounded: CUDA tensors launch
``csrc/lu_solve.cu`` (``launches_per_solve(n)`` device kernels, no host
read), CPU tensors run the plain twin ``lu_solve_plain``, a column at a
time, which gives the kernel's bits.  ``lu_solve.launches`` counts the calls
that launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

PB = 32          # csrc/lu_solve.cu's panel width
MAX_N = 12288    # csrc/lu_solve.cu's MAX_N: a panel's rows, one a thread, in a cluster of 12 CTAs


@functools.cache
def _lib():
    lib = _build.load("lu_solve")
    lib.lu_solve_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.lu_solve_launch.restype = ctypes.c_int
    lib.lu_solve_work_floats.argtypes = [ctypes.c_int]
    lib.lu_solve_work_floats.restype = ctypes.c_longlong
    lib.lu_solve_max_clusters.argtypes = [ctypes.c_int]
    lib.lu_solve_max_clusters.restype = ctypes.c_int
    return lib


def max_clusters(n: int) -> int:
    """How many clusters of the panel's CTAs at size n (ceil(n / 1024) each)
    the card holds at once (cudaOccupancyMaxActiveClusters); needs a card."""
    got = _lib().lu_solve_max_clusters(n)
    if got < 0:
        _build.check_launch(-got, "lu_solve_max_clusters")
    return got


def launches_per_solve(n: int) -> int:
    """Device kernels one solve of an n x n system launches: a panel of PB
    columns each (with the previous panel's update of the other columns and
    of b in the same launch), then the back solve."""
    return -(-n // PB) + 1


def lu_solve_plain(Sf: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """The twin: right-looking, a column at a time, the pivot torch.argmax's
    (the first largest |entry|, a NaN above every number)."""
    n = Sf.shape[0]
    A = Sf.clone()
    y = rf.clone()
    for k in range(n):
        p = k + int(torch.argmax(A[k:, k].abs()))
        if p != k:
            A[[k, p]] = A[[p, k]]
            y[[k, p]] = y[[p, k]]
        A[k + 1:, k] = A[k + 1:, k] / A[k, k]
        A[k + 1:, k + 1:] -= A[k + 1:, k, None] * A[k, None, k + 1:]
    for k in range(n):
        y[k + 1:] -= A[k + 1:, k] * y[k]
    for k in range(n - 1, -1, -1):
        y[k] = y[k] / A[k, k]
        y[:k] -= A[:k, k] * y[k]
    return y


def check_inputs(Sf: torch.Tensor, rf: torch.Tensor, device) -> int:
    """Validate a system for the kernel (f32, Sf [n, n], rf [n], contiguous,
    on `device`, 1 <= n <= MAX_N); raises before any launch.  Returns n."""
    n = Sf.shape[0] if Sf.dim() == 2 else -1
    if Sf.dim() != 2 or Sf.shape[1] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"lu_solve: Sf must be [n, n] with 1 <= n <= {MAX_N}, "
                         f"got {tuple(Sf.shape)}")
    _build.check_tensor(Sf, "Sf", torch.float32, (n, n), device)
    _build.check_tensor(rf, "rf", torch.float32, (n,), device)
    return n


def lu_solve(Sf: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """x [n] with Sf x = rf."""
    if not Sf.is_cuda:
        return lu_solve_plain(Sf, rf)
    dev = Sf.device
    n = check_inputs(Sf, rf, dev)
    lib = _lib()
    work = torch.empty(lib.lu_solve_work_floats(n), dtype=torch.float32, device=dev)
    x = torch.empty(n, dtype=torch.float32, device=dev)
    err = lib.lu_solve_launch(Sf.data_ptr(), rf.data_ptr(), n, work.data_ptr(), x.data_ptr(),
                              _build.stream_ptr(dev))
    _build.check_launch(err, "lu_solve")
    lu_solve.launches += 1
    return x


lu_solve.launches = 0
