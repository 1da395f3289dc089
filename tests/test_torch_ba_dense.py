"""The port's dense edge-list BA (solvers/ba_core.py: build_normal_eqs,
schur_solve_dense, bundle_adjust, edge_cost) against the JAX package's, on
tests/test_solvers.make_ba_problem with stereo edges, outliers, a second
fixed camera, octave weights and invalid edges.

Tolerances (float32; the scatters add in edge order on the CPU): the
normal-equation blocks within 1e-5 x the largest entry of each, the cost
within 1e-6 relative; the Schur solve's camera and point steps within 5e-4
x the largest of each, on the same blocks (a float32 Cholesky of a reduced
system whose condition number is ~1e5: the two agree to 5e-5-1e-4); bundle_adjust's poses within
1e-5, points within 1e-4 m, inlier mask equal, cost within 1e-5 relative;
edge_cost equals the cost build_normal_eqs returns for the same state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.solvers import ba_core as jba
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba

from test_solvers import CAM, make_ba_problem, reproj_rmse

torch.set_num_threads(1)

TCAM = TCam(**{f.name: float(getattr(CAM, f.name)) for f in dataclasses.fields(TCam)})


def problem(seed=3, stereo=0.4, outliers=0.05):
    prob, Rs, ts, X = make_ba_problem(n_cams=5, n_pts=60, seed=seed)
    rng = np.random.RandomState(seed)
    E = prob.cam_idx.shape[0]
    ci, pi = np.asarray(prob.cam_idx), np.asarray(prob.pt_idx)
    Xc = np.einsum("eij,ej->ei", Rs[ci], X[pi]) + ts[ci]
    ur = np.full(E, -1.0, np.float32)
    st = rng.rand(E) < stereo
    ur[st] = 500 * Xc[st, 0] / Xc[st, 2] + 320 - float(CAM.bf) / Xc[st, 2] + rng.randn(st.sum()) * 0.5
    uv = np.array(prob.uv)
    out = rng.rand(E) < outliers
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    fixed = np.zeros(5, bool)
    fixed[[0, 2]] = True
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 3, E)).astype(np.float32)
    return prob._replace(ur=jnp.asarray(ur), uv=jnp.asarray(uv), cam_fixed=jnp.asarray(fixed),
                         edge_valid=jnp.asarray(rng.rand(E) > 0.05),
                         inv_sigma2=jnp.asarray(inv_s2)), Rs


def to_port(jp):
    return convert.ba_problem_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                                         device="cpu")


def close_rel(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("robust", [True, False])
def test_build_normal_eqs_matches_reference(robust):
    jp, _ = problem()
    tp = to_port(jp)
    ref = jba.build_normal_eqs(CAM, jp, robust)
    out = tba.build_normal_eqs(TCAM, tp, robust)
    for name, a, b in zip(("Hcc", "Hpp", "B", "gc", "gp"), ref[:5], out[:5]):
        assert tuple(b.shape) == np.asarray(a).shape, name
        close_rel(a, b.numpy(), 1e-5)
    np.testing.assert_allclose(float(out[5]), float(ref[5]), rtol=1e-6)
    assert float(tba.edge_cost(TCAM, tp)) == float(out[5])


@pytest.mark.parametrize("lam", [1e-5, 1e-2])
def test_schur_solve_dense_matches_reference(lam):
    jp, _ = problem(seed=4)
    blocks = jba.build_normal_eqs(CAM, jp, True)[:5]
    free = np.asarray(jp.cam_valid) & ~np.asarray(jp.cam_fixed)
    dc_j, dp_j = jba.schur_solve_dense(*blocks, lam, jnp.asarray(free))
    dc_t, dp_t = tba.schur_solve_dense(*(torch.from_numpy(np.array(a)) for a in blocks),
                                       torch.tensor(lam), torch.from_numpy(free))
    close_rel(dc_j, dc_t.numpy(), 5e-4)
    close_rel(dp_j, dp_t.numpy(), 5e-4)
    assert not dc_t[~torch.from_numpy(free)].any()


@pytest.mark.parametrize("seed,iters", [(3, 10), (8, 4)])
def test_bundle_adjust_matches_reference(seed, iters):
    jp, Rs = problem(seed=seed)
    R_j, t_j, X_j, inl_j, cost_j = jba.bundle_adjust(CAM, jp, iters)
    R, t, X, inl, cost = tba.bundle_adjust(TCAM, to_port(jp), iters)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-5)
    # it solved the problem: the inliers reproject well, the fixed cameras stayed
    after = reproj_rmse(CAM, jp._replace(R=jnp.asarray(R.numpy()), t=jnp.asarray(t.numpy()),
                                         points=jnp.asarray(X.numpy())))
    assert after < reproj_rmse(CAM, jp)
    fixed = np.asarray(jp.cam_fixed)
    np.testing.assert_array_equal(R.numpy()[fixed], np.asarray(jp.R)[fixed])


def test_ba_problem_converters_round_trip():
    jp, _ = problem()
    d = {k: np.asarray(v) for k, v in jp._asdict().items()}
    back = convert.ba_problem_to_numpy(convert.ba_problem_from_numpy(d, device="cpu"))
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype), err_msg=k)
        assert back[k].dtype != np.float64
