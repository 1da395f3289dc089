"""The port's Sim3 pose graph (solvers/pose_graph.py), essential graph and
global BA (solvers/ba_cg.py) against the JAX package, on numpy inputs made
from a seed.

Tolerances: both pose-graph solvers on the drifted 10-keyframe chain of
tests/test_loop_components.py bring the cost below 1e-4 in both packages
and agree on s, R, t within 1e-4; the essential graph built from a
constructed map has the same edges (endpoints and validity exactly) and
measurements within 1e-5, and both solvers on it agree within 1e-3 (its
cost is not driven to zero, so LM's path decides the last digits);
edge_residual_jac within 1e-4 (relative); bundle_adjust_cg on a small
problem: the same edge inliers, poses within 1e-4 and points within
1e-3 + 5e-4 |X| (a monocular problem's scale is weakly held, so the ten
LM steps of 25 CG iterations each leave float32 noise of that size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.geometry import lie as jlie
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.solvers import ba_cg as jcg
from orb_slam2_annotate_tpu.solvers import ba_core as jba
from orb_slam2_annotate_tpu.solvers import pose_graph as jpg
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.solvers import ba_cg as tcg
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba
from orb_slam2_annotate_tpu_torch.solvers import pose_graph as tpg

torch.set_num_threads(1)

ARGS = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)


def T(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=tol)


def to_port(prob) -> tpg.PoseGraphProblem:
    return tpg.PoseGraphProblem(**{k: T(np.asarray(v)) for k, v in prob._asdict().items()})


def chain_problem():
    """The drifted circle of test_loop_components.py: exact odometry and loop
    edges, initial poses with accumulated error, keyframe 0 fixed."""
    K = 10
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        gt.append((np.asarray(jlie.so3_exp(jnp.asarray([0.0, th, 0.0], jnp.float32))),
                   np.asarray([np.cos(th), 0.0, np.sin(th)], np.float32)))
    rng = np.random.RandomState(4)
    est = [gt[0]]
    for k in range(1, K):
        Rr, tr = jlie.se3_compose(*gt[k], *jlie.se3_inverse(*map(jnp.asarray, gt[k - 1])))
        dR, dt = jlie.se3_exp(jnp.asarray(rng.randn(6) * 0.02, jnp.float32))
        Rn, tn = jlie.se3_compose(dR, dt, Rr, tr)
        est.append(tuple(np.asarray(x) for x in jlie.se3_compose(
            Rn, tn, *map(jnp.asarray, est[k - 1]))))
    pairs = [(k, k + 1) for k in range(K - 1)] + [(K - 1, 0)]
    ms_ = [jpg.edge_measurement(jnp.ones(()), jnp.asarray(gt[i][0]), jnp.asarray(gt[i][1]),
                                jnp.ones(()), jnp.asarray(gt[j][0]), jnp.asarray(gt[j][1]))
           for i, j in pairs]
    E = len(pairs)
    return jpg.PoseGraphProblem(
        s=jnp.ones(K), R=jnp.asarray(np.stack([e[0] for e in est])),
        t=jnp.asarray(np.stack([e[1] for e in est])), fixed=jnp.zeros(K, bool).at[0].set(True),
        valid=jnp.ones(K, bool), e_i=jnp.asarray([p[0] for p in pairs], jnp.int32),
        e_j=jnp.asarray([p[1] for p in pairs], jnp.int32),
        e_s=jnp.asarray([float(m[0]) for m in ms_]),
        e_R=jnp.asarray(np.stack([np.asarray(m[1]) for m in ms_])),
        e_t=jnp.asarray(np.stack([np.asarray(m[2]) for m in ms_])),
        e_valid=jnp.ones(E, bool), e_weight=jnp.ones(E))


SOLVERS = {"dense": (jpg.optimize_pose_graph, tpg.optimize_pose_graph),
           "cg": (jpg.optimize_pose_graph_cg, tpg.optimize_pose_graph_cg)}


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_chain_agrees(solver):
    jsolve, tsolve = SOLVERS[solver]
    prob = chain_problem()
    ref = jsolve(prob, 25)
    got = tsolve(to_port(prob), 25)
    assert float(ref[3]) < 1e-4 and float(got[3]) < 1e-4
    for a, b in zip(ref[:3], got[:3]):
        close(a, b, 1e-4)


def graph_map():
    """A 16-slot map whose keyframes see overlapping windows of points (a
    covisibility chain with strong edges), 14 valid, poses along a line."""
    K, P, N = 16, 512, 64
    rng = np.random.RandomState(0)
    obs = np.full((K, N), -1, np.int32)
    for k in range(14):
        obs[k] = (np.arange(N) + k * 24) % P
    valid = np.arange(K) < 14
    m = jms.empty_map(K, P, N)
    return m._replace(
        kf_R=jnp.asarray(np.stack([np.asarray(jlie.so3_exp(jnp.asarray(
            rng.randn(3).astype(np.float32) * 0.05))) for _ in range(K)])),
        kf_t=jnp.asarray((rng.randn(K, 3) * 0.05 + np.arange(K)[:, None] * [0.1, 0, 0])
                         .astype(np.float32)),
        kf_valid=jnp.asarray(valid), kf_frame_id=jnp.asarray(np.where(valid, np.arange(K), -1),
                                                             jnp.int32),
        kf_feat_valid=jnp.ones((K, N), bool), kf_obs=jnp.asarray(obs),
        mp_pos=jnp.asarray(rng.randn(P, 3).astype(np.float32)), mp_valid=jnp.ones(P, bool),
        n_kf=jnp.asarray(14, jnp.int32))


def essential_graphs():
    m = graph_map()
    slot, cand = 13, 0
    R12 = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015], jnp.float32)))
    s12, t12 = np.float32(1.03), np.asarray([0.05, -0.02, 0.01], np.float32)
    s_c, R_c, t_c = jlie.sim3_compose(jnp.asarray(s12), jnp.asarray(R12), jnp.asarray(t12),
                                      jnp.ones(()), m.kf_R[cand], m.kf_t[cand])
    la = np.array([5, 9] + [0] * 14, np.int32)
    lb = np.array([1, 3] + [0] * 14, np.int32)
    lok = np.array([True, True] + [False] * 14)
    ref = jlc.build_essential_graph(m, jnp.asarray(slot), jnp.asarray(cand), s_c, R_c, t_c,
                                    jnp.asarray(s12), jnp.asarray(R12), jnp.asarray(t12),
                                    jnp.asarray(la), jnp.asarray(lb), jnp.asarray(lok))
    tm = convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    got = tlc.build_essential_graph(tm, slot, cand, T(np.asarray(s_c)), T(np.asarray(R_c)),
                                    T(np.asarray(t_c)), T(s12), T(R12), T(t12), T(la), T(lb),
                                    T(lok))
    return ref, got


def test_build_essential_graph_agrees():
    ref, got = essential_graphs()
    for name in ("e_i", "e_j", "e_valid", "fixed", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    ok = np.asarray(ref.e_valid)
    for name in ("e_s", "e_R", "e_t"):
        close(np.asarray(getattr(ref, name))[ok], getattr(got, name).numpy()[ok], 1e-5)
    for name in ("s", "R", "t"):
        close(getattr(ref, name), getattr(got, name).numpy(), 1e-6)
    assert ok.sum() > 14          # tree, strong covisibility and loop edges


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_on_an_essential_graph_agrees(solver):
    jsolve, tsolve = SOLVERS[solver]
    ref_prob, got_prob = essential_graphs()
    ref = jsolve(ref_prob, 15)
    got = tsolve(got_prob, 15)
    close(ref[3], got[3].numpy(), 1e-3 * max(1.0, float(ref[3])))
    for a, b in zip(ref[:3], got[:3]):
        close(a, b, 1e-3)


def ba_problem():
    """6 cameras on a line looking at 60 points, noisy observations, camera 0 fixed."""
    rng = np.random.RandomState(5)
    C, P = 6, 60
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (P, 3)).astype(np.float32)
    R = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32) * 0.03)))
                  for _ in range(C)])
    t = (np.arange(C)[:, None] * np.array([-0.2, 0, 0]) + rng.randn(C, 3) * 0.01).astype(np.float32)
    ci, pi = np.meshgrid(np.arange(C), np.arange(P), indexing="ij")
    ci, pi = ci.reshape(-1).astype(np.int32), pi.reshape(-1).astype(np.int32)
    xc = np.einsum("eij,ej->ei", R[ci], X[pi]) + t[ci]
    uv = np.stack([400 * xc[:, 0] / xc[:, 2] + 160, 400 * xc[:, 1] / xc[:, 2] + 120], 1)
    uv = (uv + rng.randn(*uv.shape) * 0.7).astype(np.float32)
    uv[::17] += 25.0                                      # outliers
    E = ci.shape[0]
    Xn = (X + rng.randn(P, 3) * 0.02).astype(np.float32)
    tn = (t + rng.randn(C, 3) * 0.01).astype(np.float32)
    tn[0] = t[0]
    return jba.BAProblem(R=jnp.asarray(R), t=jnp.asarray(tn), points=jnp.asarray(Xn),
                         cam_fixed=jnp.asarray(np.arange(C) == 0), cam_valid=jnp.ones(C, bool),
                         pt_valid=jnp.ones(P, bool), cam_idx=jnp.asarray(ci),
                         pt_idx=jnp.asarray(pi), uv=jnp.asarray(uv), ur=jnp.full((E,), -1.0),
                         inv_sigma2=jnp.ones(E), edge_valid=jnp.asarray(rng.rand(E) > 0.05))


def to_port_ba(prob) -> tba.BAProblem:
    return tba.BAProblem(**{k: T(np.asarray(v)) for k, v in prob._asdict().items()})


def test_edge_residual_jac_agrees():
    prob = ba_problem()
    for a, b in zip(jba.edge_residual_jac(CAM, prob), tba.edge_residual_jac(TCAM, to_port_ba(prob))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


def test_bundle_adjust_cg_agrees():
    prob = ba_problem()
    R, t, X, inl, cost = jcg.bundle_adjust_cg(CAM, prob, iters=10, cg_iters=25)
    Rp, tp, Xp, inlp, costp = tcg.bundle_adjust_cg(TCAM, to_port_ba(prob), iters=10, cg_iters=25)
    np.testing.assert_array_equal(inlp.numpy(), np.asarray(inl))
    close(R, Rp.numpy(), 1e-4)
    close(t, tp.numpy(), 1e-4)
    np.testing.assert_allclose(Xp.numpy(), np.asarray(X), rtol=5e-4, atol=1e-3)
    assert float(costp) < float(jcg.bundle_adjust_cg(CAM, prob, iters=1, cg_iters=25)[4]) * 1.01
