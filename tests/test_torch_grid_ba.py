"""Local BA's grid LM: the port's ``ba_core.bundle_adjust_grid`` (on CPU
tensors its plain twin, kernel 12's reference) against the JAX package's on
seeded numpy grids (``_grid_ba_cases.py``, which chip_smoke.py shares) at
C = 8 cameras (4 free), N = 128 slots, P = 256 points: stereo rows and
outliers, mono rows, duplicate (point, camera) slots, points behind a
camera, invalid and all-but-one fixed cameras, fewer points, a damping that
makes every try (or the first) indefinite, lambda at both clamps, robust and
not; 1 and 4 LM iterations.

Tolerances.  In float64 (both packages; JAX under ``jax.enable_x64``) the
two compute the same function: poses within 1e-8, points within 1e-8 of
their distance to camera 0's centre, inlier masks equal, the cost within
1e-7 relative (the port's chi2 gates are float32 numbers in either type:
``torch.where`` of two Python numbers gives the default float32).  In float32, as the System runs it, the tolerances
tests/test_torch_pipeline.py holds the local BA to: poses within 1e-3 (R
entries, t in m), points within 1e-2 of their distance to camera 0's
centre, the cost within 1e-4 relative, inlier masks equal but for at most 1%
of the valid slots, each within 1% of its chi2 gate.  Three cases are held
in float64 only: at this size their float32 solutions are draws over the
sums' rounding in both packages (mono points over a 0.4 m baseline; a point
2 m behind a camera, whose barrier its other observers pull on; lambda 1e-9,
where a point's block is barely damped), apart by 1e-3 to 1e-2 between the
packages while each agrees with its own float64 run no better.  A try whose
Cholesky fails is never taken, so there the returned state is the start
state exactly.  ``schur_solve_planes`` at one lambda on the port's
linearization: dc and dp within 1e-6 of their largest magnitude in float64.
The wrapper's input checks raise before any launch, and on CPU tensors it
runs the twin without launching.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.solvers import ba_core as jba
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba

from _grid_ba_cases import CAM as CAM_ARGS
from _grid_ba_cases import FIELDS, problem_cases

torch.set_num_threads(1)

C, N, P = 8, 128, 256
CAM = CameraModel.create(**CAM_ARGS)
TCAM = TCam.create(**CAM_ARGS)
CASES = problem_cases(C, N, P, seed=12)


F32_DRAWS = ("mono, 6 iterations", "points behind a camera", "lambda at the lower clamp")


def as_dtype(p, dtype):
    return {k: (v.astype(dtype) if v.dtype == np.float32 else v) for k, v in p.items()}


def jax_grid(p):
    return jba.GridBA(**{k: jnp.asarray(p[k]) for k in FIELDS})


def torch_grid(p):
    return tba.GridBA(**{k: torch.from_numpy(np.array(p[k])) for k in FIELDS})


def run_both(name, iters, dtype):
    p, _, robust, lam0, ladder = CASES[name]
    p = as_dtype(p, dtype)
    with jax.enable_x64(dtype == np.float64):
        out_j = [np.asarray(a) for a in
                 jba.bundle_adjust_grid(CAM, jax_grid(p), iters, robust, lam0, ladder)]
    out_t = [a.numpy() for a in tba.bundle_adjust_grid(TCAM, torch_grid(p), iters, robust, lam0,
                                                       ladder)]
    return p, out_j, out_t


def assert_agree(p, out_j, out_t, pose, point, cost, mask_frac):
    (Rj, tj, Xj, inl_j, cost_j), (Rt, tt, Xt, inl_t, cost_t) = out_j, out_t
    np.testing.assert_allclose(Rt, Rj, atol=pose, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=pose, rtol=0)
    centre = -Rj[0].T @ tj[0]
    dist = np.linalg.norm(Xj - centre, axis=1)
    assert np.all(np.linalg.norm(Xt - Xj, axis=1) <= point * dist)
    np.testing.assert_allclose(cost_t, cost_j, rtol=cost)
    base = p["edge_valid"] & (p["pt_loc"] >= 0)
    diff = inl_t != inl_j
    assert diff.sum() <= mask_frac * base.sum()
    if diff.any():
        _, chi2, delta2, _ = tba.grid_cost(TCAM, torch.from_numpy(Rt), torch.from_numpy(tt),
                                           torch.from_numpy(Xt), torch_grid(p), chi2_out=True)
        near = np.abs((chi2 / delta2).numpy() - 1.0) < 0.01
        assert not np.any(diff & ~near)


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_grid_ba_matches_jax_float64(name, iters):
    p, out_j, out_t = run_both(name, iters, np.float64)
    assert_agree(p, out_j, out_t, pose=1e-8, point=1e-8, cost=1e-7, mask_frac=0.0)
    if name.startswith("not positive definite (every"):
        for got, start in zip(out_t[:3], (p["R"], p["t"], p["points"])):
            np.testing.assert_array_equal(got, start)


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("name", [n for n in CASES if n not in F32_DRAWS])
def test_grid_ba_matches_jax_float32(name, iters):
    p, out_j, out_t = run_both(name, iters, np.float32)
    assert_agree(p, out_j, out_t, pose=1e-3, point=1e-2, cost=1e-4, mask_frac=0.01)
    if name.startswith("not positive definite (every"):
        for got, start in zip(out_t[:3], (p["R"], p["t"], p["points"])):
            np.testing.assert_array_equal(got, start)


def test_schur_solve_planes_matches_jax():
    """One damped solve on the port's linearization of the base case, in
    both packages, in float64."""
    p = as_dtype(CASES["stereo rows, outliers"][0], np.float64)
    g = torch_grid(p)
    base_valid, selT = tba.grid_inverse_index(g)
    Hcc, Hpp, B, gc, gp, _ = tba.grid_linearize(TCAM, g, g.R, g.t, g.points, True, base_valid, selT)
    free = g.cam_valid & ~g.cam_fixed
    dc_t, dp_t = tba.schur_solve_planes(Hcc, Hpp, B, gc, gp, torch.tensor(1e-3, dtype=torch.float64),
                                        free)
    with jax.enable_x64(True):
        dc_j, dp_j = (np.asarray(a) for a in jba.schur_solve_planes(
            *(jnp.asarray(a.numpy()) for a in (Hcc, Hpp, B, gc, gp)), jnp.float64(1e-3),
            jnp.asarray(free.numpy())))
    for got, ref in ((dc_t, dc_j), (dp_t, dp_j)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_wrapper_checks_raise():
    """check_inputs refuses what the kernel does not take, before a launch;
    on CPU tensors the wrapper runs the twin and launches nothing."""
    dev = torch.device("cpu")
    p = CASES["stereo rows, outliers"][0]
    good = torch_grid(p)
    C_, N_, P_, _ = k12.check_inputs(good, 4, (1.0, 8.0, 64.0), dev)
    assert (C_, N_, P_) == (C, N, P)

    def with_(**kw):
        return tba.GridBA(**{**good.__dict__, **kw})

    bad = {
        "float64 R": (with_(R=good.R.double()), 4, (1.0, 8.0, 64.0), TypeError),
        "int64 pt_loc": (with_(pt_loc=good.pt_loc.long()), 4, (1.0, 8.0, 64.0), TypeError),
        "uv of another shape": (with_(uv=good.uv[:, :-1]), 4, (1.0, 8.0, 64.0), ValueError),
        "33 cameras": (with_(pt_loc=torch.zeros(33, N, dtype=torch.int32)), 4, (1.0, 8.0, 64.0),
                       ValueError),
        "two ladder values": (good, 4, (1.0, 8.0), ValueError),
        "negative iters": (good, -1, (1.0, 8.0, 64.0), ValueError),
        "too many points and slots for the Schur list": (
            with_(pt_loc=torch.zeros(C, k12.MAX_LIST + 1, dtype=torch.int32),
                  points=torch.zeros(k12.MAX_LIST + 1, 3)), 4, (1.0, 8.0, 64.0), ValueError),
        "no points": (with_(points=torch.zeros(0, 3)), 4, (1.0, 8.0, 64.0), ValueError),
    }
    for what, (g, iters, ladder, err) in bad.items():
        with pytest.raises(err):
            k12.check_inputs(g, iters, ladder, dev)
            pytest.fail(f"check_inputs took {what}")
    with pytest.raises(ValueError):
        k12.check_inputs(good, 4, (1.0, 8.0, 64.0), torch.device("meta"))
    n0 = k12.grid_ba_solve.launches
    out = k12.grid_ba_solve(TCAM, good, 2)
    ref = tba.bundle_adjust_grid_plain(TCAM, good, 2)
    assert k12.grid_ba_solve.launches == n0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert k12.launches_per_solve(4) == 22 and k12.launches_per_solve(6) == 32
