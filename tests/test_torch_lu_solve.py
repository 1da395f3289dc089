"""Kernel 12c's plain twin (kernels/lu_solve.lu_solve_plain: the
distributed BA's LU with partial pivoting in one fixed order) against the
JAX package's jnp.linalg.solve and against the kernel's schedule, on systems
made from a seed with numpy.

Tolerances: against JAX, x within 1e-4 x its largest entry (float32 systems
of condition number ~1e2-1e3, symmetric or not, positive definite or not);
against a numpy walk of csrc/lu_solve.cu's schedule (b carried as column n,
so the forward solve is that column; 32-column panels factored alone, a
column at a time, their row swaps then applied to the later columns as one
gather, U's 32 rows and the rows below taking the panel's terms in the next
launch; the last panel's swaps and terms on b, then the back solve by
32-row blocks from the last, its terms in descending k), bit for bit, also
where |entries| tie for the pivot; the wrapper's checks refuse a bad system
before any launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch.kernels import lu_solve as k12c

from test_torch_chol_solve import spd_system

torch.set_num_threads(1)

PB = k12c.PB


def first_largest(v: np.ndarray) -> int:
    """torch.argmax's pivot: the first NaN, else the first largest."""
    nan = np.flatnonzero(np.isnan(v))
    return int(nan[0]) if nan.size else int(np.argmax(v))


@np.errstate(invalid="ignore", divide="ignore")
def kernel_walk(S: np.ndarray, r: np.ndarray) -> np.ndarray:
    """csrc/lu_solve.cu's schedule in numpy float32 (see the docstring)."""
    n = S.shape[0]
    A = np.concatenate([S, r[:, None]], axis=1)       # b as column n
    pairs = None                                      # the last panel's (row, source) pairs
    for j0 in range(0, n, PB):
        w = min(PB, n - j0)
        if pairs is not None:         # the items: panel k - 1 on columns j0 .. n
            jp = j0 - PB
            dst, src = pairs
            A[dst, j0:] = A[src, j0:]
            for mm in range(PB):      # U's rows, then the rows below
                A[jp + mm + 1:j0, j0:] -= A[jp + mm + 1:j0, jp + mm, None] * A[jp + mm, None, j0:]
            for mm in range(PB):
                A[j0:, j0:] -= A[j0:, jp + mm, None] * A[jp + mm, None, j0:]
        P = A[j0:, j0:j0 + w]         # the panel: a row a thread, a column at a time
        org = np.arange(n - j0)
        for jj in range(w):
            pr = jj + first_largest(np.abs(P[jj:, jj]))
            P[[jj, pr]] = P[[pr, jj]]
            org[[jj, pr]] = org[[pr, jj]]
            P[jj + 1:, jj] = P[jj + 1:, jj] / P[jj, jj]
            P[jj + 1:, jj + 1:] -= P[jj + 1:, jj, None] * P[jj, None, jj + 1:]
        moved = np.flatnonzero(org != np.arange(n - j0))
        pairs = (j0 + moved, j0 + org[moved])
    j0 = (n - 1) // PB * PB           # the back solve: the last panel on y first
    dst, src = pairs
    v = A[:, n].copy()
    v[dst] = v[src]
    for mm in range(n - j0):
        v[j0 + mm + 1:] -= A[j0 + mm + 1:, j0 + mm] * v[j0 + mm]
    for k0 in reversed(range(0, n, PB)):   # then by 32-row blocks, the last first
        w = min(PB, n - k0)
        for jj in reversed(range(w)):
            k = k0 + jj
            v[k] = v[k] / A[k, k]
            v[k0:k] -= A[k0:k, k] * v[k]
        for mm in reversed(range(w)):
            v[:k0] -= A[:k0, k0 + mm] * v[k0 + mm]
    return v


def general_system(n: int, seed: int, ties: bool = False):
    rng = np.random.default_rng(seed)
    if ties:       # small integers: |entries| tie for the pivot in most columns
        A = rng.integers(-3, 4, (n, n)).astype(np.float32) + 4 * np.eye(n, dtype=np.float32)
    else:
        A = (rng.standard_normal((n, n)) + 3 * np.eye(n)).astype(np.float32)
    return A, rng.standard_normal(n).astype(np.float32)


def indefinite_system(n: int, seed: int):
    S, r = spd_system(n, seed)
    return (S - 0.8 * np.eye(n, dtype=np.float32) * np.diag(S).mean()).astype(np.float32), r


CASES = {"n 6": lambda: general_system(6, 1), "n 40": lambda: general_system(40, 2),
         "n 96, SPD, camera 3 fixed": lambda: spd_system(96, 3, (3,)),
         "n 130": lambda: general_system(130, 4),
         "n 70, ties": lambda: general_system(70, 5, ties=True),
         "n 64, symmetric indefinite": lambda: indefinite_system(64, 6)}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_solve(name):
    S, r = CASES[name]()
    x = k12c.lu_solve(torch.from_numpy(S), torch.from_numpy(r)).numpy()
    ref = np.asarray(jnp.linalg.solve(jnp.asarray(S), jnp.asarray(r)))
    assert np.isfinite(x).all()
    assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", list(CASES))
def test_twin_has_the_kernel_schedules_bits(name):
    S, r = CASES[name]()
    x = k12c.lu_solve_plain(torch.from_numpy(S), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(x.view(np.int32), kernel_walk(S, r).view(np.int32))


def test_launches_per_solve():
    """A launch a 32-column panel (the previous panel's update in it), then the back solve."""
    assert [k12c.launches_per_solve(n) for n in (6, 32, 33, 768, 3840)] == [2, 2, 3, 25, 121]


@pytest.mark.parametrize("what", ["not square", "empty", "float64", "rf's shape", "too large"])
def test_wrapper_checks_raise(what):
    S, r = (torch.from_numpy(a) for a in general_system(12, 1))
    cpu = torch.device("cpu")
    big = torch.empty(k12c.MAX_N + 1, 1).expand(-1, k12c.MAX_N + 1)
    args = {"not square": (S[:, :6], r), "empty": (torch.empty(0, 0), r[:0]),
            "float64": (S.double(), r), "rf's shape": (S, r[:6]),
            "too large": (big, torch.empty(k12c.MAX_N + 1))}[what]
    with pytest.raises((TypeError, ValueError)):
        k12c.check_inputs(*args, cpu)
    assert k12c.check_inputs(S, r, cpu) == 12
