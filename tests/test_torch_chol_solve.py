"""Kernel 12b's plain twin (kernels/chol_solve.chol_solve_plain: the dense
BA's Cholesky in one fixed order) against the JAX package's
jax.scipy.linalg.solve(assume_a="pos") and against the kernel's schedule, on
systems made from a seed with numpy.

Tolerances: against JAX, x within 1e-4 x its largest entry (float32 systems
of condition number ~1e2-1e3); against a numpy walk of csrc/chol_solve.cu's
schedule (r appended to S as row n of the factor, so the forward solve is
that row; 32-column panels, one launch each: every later entry takes the
previous panel's 32 terms, the diagonal block is factored a column at a
time, the rows below solved against it a column at a time; the back solve
by 32-row blocks from the last, its terms in descending k), bit for bit; a
system that is not positive definite gives all NaN in the twin, the walk
and JAX; the wrapper's checks refuse a bad system before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch.kernels import chol_solve as k12b
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba

torch.set_num_threads(1)

PB = k12b.PB


def spd_system(n: int, seed: int, fixed=()):
    """A float32 SPD system of size n (n a multiple of 6 when cameras are
    `fixed`: their rows held by identity, as ba_core.reduced_system does)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n + 8)).astype(np.float32)
    S = (A @ A.T / n + 0.5 * np.eye(n)).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    if fixed:
        free = torch.ones(n // 6, dtype=torch.bool)
        free[list(fixed)] = False
        Sf, rf = tba.reduced_system(torch.from_numpy(S).reshape(n // 6, 6, n // 6, 6)
                                    .permute(0, 2, 1, 3), torch.from_numpy(r).reshape(-1, 6), free)
        return Sf.numpy().copy(), rf.numpy().copy()
    return S, r


@np.errstate(invalid="ignore")          # a pivot not > 0: NaN, as the kernel's
def kernel_walk(S: np.ndarray, r: np.ndarray) -> np.ndarray:
    """csrc/chol_solve.cu's schedule in numpy float32 (see the docstring)."""
    f32 = np.float32
    n = S.shape[0]
    A = np.zeros((n + 1, n), f32)       # the augmented factor: r as row n
    A[:n] = np.tril(S)
    A[n] = r
    fail = False
    for j0 in range(0, n, PB):
        w = min(PB, n - j0)
        for m in range(j0 - PB, j0) if j0 else ():   # panel k - 1's terms on every later entry
            A[j0:, j0:] -= A[j0:, m, None] * A[j0:n, m][None, :]
        D = A[j0:j0 + w, j0:j0 + w]      # the diagonal block, one warp a column at a time
        for jj in range(w):
            fail |= not D[jj, jj] > 0
            D[jj, jj] = f32(np.sqrt(np.float64(D[jj, jj])))
            D[jj + 1:, jj] /= D[jj, jj]
            D[jj + 1:, jj + 1:] -= D[jj + 1:, jj, None] * D[jj + 1:, jj][None, :]
        T = A[j0 + w:, j0:j0 + w]        # the rows below (row n among them), a thread a row
        for jj in range(w):
            T[:, jj] /= D[jj, jj]
            T[:, jj + 1:] -= T[:, jj, None] * D[jj + 1:, jj][None, :]
    L = np.tril(A[:n])
    v = A[n].copy()                     # y; the back solve by 32-row blocks, the last first
    for k0 in reversed(range(0, n, PB)):
        w = min(PB, n - k0)
        for jj in reversed(range(w)):
            k = k0 + jj
            v[k] = v[k] / L[k, k]
            v[k0:k] -= L[k, k0:k] * v[k]
        for m in reversed(range(w)):
            v[:k0] -= L[k0 + m, :k0] * v[k0 + m]
    return np.full(n, np.nan, f32) if fail else v


CASES = {"n 6": (6, ()), "n 40": (40, ()), "n 96, camera 3 fixed": (96, (3,)),
         "n 130": (130, ()), "n 192, cameras 0 and 31 fixed": (192, (0, 31))}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_solve(name):
    n, fixed = CASES[name]
    S, r = spd_system(n, 19 + n, fixed)
    x = k12b.chol_solve(torch.from_numpy(S), torch.from_numpy(r)).numpy()
    ref = np.asarray(jax.scipy.linalg.solve(jnp.asarray(S), jnp.asarray(r), assume_a="pos"))
    assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", list(CASES))
def test_twin_has_the_kernel_schedules_bits(name):
    n, fixed = CASES[name]
    S, r = spd_system(n, 7 + n, fixed)
    x = k12b.chol_solve_plain(torch.from_numpy(S), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(x.view(np.int32), kernel_walk(S, r).view(np.int32))


@pytest.mark.parametrize("n, bad", [(6, 0), (40, 37), (130, 100)])
def test_not_positive_definite_gives_nan(n, bad):
    S, r = spd_system(n, 3 + n)
    S[bad, bad] = -1.0
    x = k12b.chol_solve(torch.from_numpy(S), torch.from_numpy(r)).numpy()
    ref = np.asarray(jax.scipy.linalg.solve(jnp.asarray(S), jnp.asarray(r), assume_a="pos"))
    assert np.isnan(x).all() and np.isnan(kernel_walk(S, r)).all() and np.isnan(ref).all()


def test_dense_solve_runs_the_twin():
    """ba_core._cholesky_solve is the twin, reshaped to the cameras' rows."""
    S, r = spd_system(48, 5)
    dc = tba._cholesky_solve(torch.from_numpy(S), torch.from_numpy(r), 8)
    assert dc.shape == (8, 6)
    np.testing.assert_array_equal(dc.reshape(-1).numpy().view(np.int32),
                                  kernel_walk(S, r).view(np.int32))


@pytest.mark.parametrize("what", ["not square", "empty", "float64", "rf's shape", "strided"])
def test_wrapper_checks_raise(what):
    S, r = (torch.from_numpy(a) for a in spd_system(12, 1))
    cpu = torch.device("cpu")
    args = {"not square": (S[:, :6], r), "empty": (torch.empty(0, 0), r[:0]),
            "float64": (S.double(), r), "rf's shape": (S, r[:6]),
            "strided": (S.T.contiguous()[:, ::1].T, r)}[what]
    with pytest.raises((TypeError, ValueError)):
        k12b.check_inputs(*args, cpu)
    assert k12b.check_inputs(S, r, cpu) == 12


def test_launches_per_solve():
    """A launch a 32-column panel (the forward solve inside it), then the back solve."""
    assert [k12b.launches_per_solve(n) for n in (6, 32, 33, 768, 3840)] == [2, 2, 3, 25, 121]


def test_wrapper_takes_the_long_run_size():
    """n = 6 x 640 (the distributed BA's system at max_kf 640) passes both wrappers' checks."""
    from orb_slam2_annotate_tpu_torch.kernels import lu_solve as k12c

    n, cpu = 3840, torch.device("cpu")
    S, r = torch.empty(n, n), torch.empty(n)
    assert k12b.check_inputs(S, r, cpu) == n and k12c.check_inputs(S, r, cpu) == n
    assert k12b.MAX_N >= n and k12c.MAX_N >= n
