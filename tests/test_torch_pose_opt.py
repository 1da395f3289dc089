"""Parity of the port's pose-only LM (plain twins of kernel 4) with
solvers/pose_opt.py on identical PoseObs: ``optimize_pose``, the batched
twin ``optimize_pose_batched`` (one JAX call per problem; mono, half
stereo, mostly invalid), and the twin's steps.

Tolerances: R and t within 1e-4; inlier masks differ on at most 1% of
edges, and only where chi2 sits within 1% of its gate (summation order
moves chi2 by ulps).  The shared uv / ur / inv_sigma2 layout equals the
per-problem layout exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.geometry import lie as jlie
from orb_slam2_annotate_tpu.solvers import pose_opt as jpo
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.kernels import pose_lm as tk4
from orb_slam2_annotate_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM_J = CameraModel.create(**ARGS)
CAM_T = TCam.create(**ARGS)
BF = 40.0   # fx x a 0.16 m baseline, for the stereo edges
CAM_SJ = CameraModel.create(**ARGS, bf=BF)
CAM_ST = TCam.create(**ARGS, bf=BF)


def T(a):
    return torch.from_numpy(np.array(a))


def make_obs(seed, n=512, outliers=0.15, noise=1.0, stereo_frac=0.0, valid_frac=0.95):
    rng = np.random.RandomState(seed)
    xw = (rng.rand(n, 3) * [8, 6, 6] + [-4, -3, 4]).astype(np.float32)
    R, t = jlie.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, 0.03, -0.01], jnp.float32))
    R, t = np.asarray(R), np.asarray(t)
    xc = xw @ R.T + t
    uv = 250.0 * xc[:, :2] / xc[:, 2:] + [160.0, 120.0]
    octave = rng.randint(0, 4, n)
    uv = uv + rng.randn(n, 2) * noise * 1.2 ** octave[:, None]
    bad = rng.rand(n) < outliers
    uv[bad] += rng.randn(int(bad.sum()), 2) * 25.0
    valid = rng.rand(n) < valid_frac
    xw[~valid] = 0.0
    ur = np.full(n, -1.0, np.float32)
    if stereo_frac:
        st = rng.rand(n) < stereo_frac
        ur[st] = uv[st, 0] - BF / xc[st, 2] + rng.randn(int(st.sum())) * noise
    obs = dict(xw=xw, uv=uv.astype(np.float32), ur=ur,
               inv_sigma2=(1.0 / 1.2 ** (2.0 * octave)).astype(np.float32), valid=valid)
    dR, dt = jlie.se3_exp(jnp.asarray(rng.randn(6) * [0.05, 0.05, 0.05, 0.01, 0.01, 0.01],
                                      jnp.float32))
    R0, t0 = jlie.se3_compose(dR, dt, jnp.asarray(R), jnp.asarray(t))
    return obs, np.asarray(R0), np.asarray(t0)


def jax_pose(cam, obs, R0, t0):
    return jpo.optimize_pose(cam, jnp.asarray(R0), jnp.asarray(t0),
                             jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}))


def assert_pose_agrees(cam, obs, got, ref):
    """The module's tolerances: R, t within 1e-4; masks differ on <= 1% of
    edges, only where chi2 is within 1% of its gate."""
    (Rt, tt, inl_t, _), (Rj, tj, inl_j, _) = got, ref
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    diff = inl_t.numpy() != np.asarray(inl_j)
    assert diff.mean() <= 0.01
    if diff.any():
        r, _, _, _ = tk4.residual_jac(cam, Rt, tt, T(obs["xw"]), T(obs["uv"]), T(obs["ur"]))
        chi2 = ((r * r).sum(0) * T(obs["inv_sigma2"])).numpy()
        gate = np.where(obs["ur"] >= 0, jpo.CHI2_STEREO, jpo.CHI2_MONO)
        assert np.all(np.abs(chi2[diff] / gate[diff] - 1.0) < 0.01)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose(seed):
    obs, R0, t0 = make_obs(seed)
    got = tpo.optimize_pose(CAM_T, T(R0), T(t0), tpo.PoseObs(**{k: T(v) for k, v in obs.items()}))
    assert_pose_agrees(CAM_T, obs, got, jax_pose(CAM_J, obs, R0, t0))


PROBLEMS = {"mono": {}, "half_stereo": dict(stereo_frac=0.5), "mostly_invalid": dict(valid_frac=0.1)}


@pytest.fixture(scope="module")
def batch():
    """The three problems of PROBLEMS through one batched twin call (B = 3)."""
    probs = [make_obs(10 + i, **kw) for i, kw in enumerate(PROBLEMS.values())]
    stack = lambda k: T(np.stack([obs[k] for obs, _, _ in probs]))
    out = tk4.optimize_pose_batched(CAM_ST, T(np.stack([p[1] for p in probs])),
                                    T(np.stack([p[2] for p in probs])), stack("xw"), stack("uv"),
                                    stack("ur"), stack("inv_sigma2"), stack("valid"))
    return probs, out


@pytest.mark.parametrize("b", range(len(PROBLEMS)), ids=list(PROBLEMS))
def test_batched_twin_matches_jax(batch, b):
    probs, (R, t, inl, n) = batch
    obs, R0, t0 = probs[b]
    assert R.shape == (3, 3, 3) and inl.shape == (3, 512) and n.dtype == torch.int32
    assert int(n[b]) == int(inl[b].sum())
    assert_pose_agrees(CAM_ST, obs, (R[b], t[b], inl[b], n[b]), jax_pose(CAM_SJ, obs, R0, t0))
    if b == 1:
        assert (obs["ur"] >= 0).mean() > 0.4
    if b == 2:
        assert obs["valid"].mean() < 0.15 and int(n[b]) >= 20


def test_shared_layout_equals_per_problem():
    obs, R0, t0 = make_obs(20, stereo_frac=0.5)
    rng = np.random.RandomState(21)
    valid = T(np.stack([obs["valid"], obs["valid"] & (rng.rand(512) < 0.8)]))
    R0s, t0s = T(np.stack([R0, R0])), T(np.stack([t0, t0 + np.float32(0.02)]))
    xw = T(np.stack([obs["xw"]] * 2))
    shared = [T(obs[k]) for k in ("uv", "ur", "inv_sigma2")]
    per = [T(np.stack([obs[k]] * 2)) for k in ("uv", "ur", "inv_sigma2")]
    a = tk4.optimize_pose_batched(CAM_ST, R0s, t0s, xw, *shared, valid)
    b = tk4.optimize_pose_batched(CAM_ST, R0s, t0s, xw, *per, valid)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0][0], a[0][1])


@pytest.mark.parametrize("robust", [True, False])
def test_linearize_and_costs(robust):
    obs, R0, t0 = make_obs(5)
    mask = obs["valid"] & (np.random.RandomState(9).rand(512) < 0.9)
    ed = [T(obs[k]) for k in ("xw", "uv", "ur", "inv_sigma2")]
    H, g, c = tk4.pose_linearize_plain(CAM_T, T(R0), T(t0), *ed, T(mask), robust)
    # reference quantities from the JAX helpers
    o = jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()})
    r, J, st, dok = jpo._residual_jac(CAM_J, jnp.asarray(R0), jnp.asarray(t0), o)
    chi2 = jpo._chi2(r, o.inv_sigma2, st)
    d2 = jnp.where(o.ur >= 0, jpo.CHI2_STEREO, jpo.CHI2_MONO)
    w = o.inv_sigma2 * jpo._huber_weight(chi2, d2, robust) * (jnp.asarray(mask) & dok)
    Jw = J * w[None, None, :]
    Hj = jnp.einsum("rin,rjn->ij", Jw, J)
    gj = jnp.einsum("rin,rn->i", Jw, r)
    cj = jpo._pose_cost(CAM_J, jnp.asarray(R0), jnp.asarray(t0), o,
                        jnp.asarray(mask).astype(jnp.float32), d2)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-5)
    Rs = np.stack([R0, np.eye(3, dtype=np.float32), R0])
    ts = np.stack([t0, t0, t0 * 1.01]).astype(np.float32)
    costs = tk4.pose_costs_plain(CAM_T, T(Rs), T(ts), *ed, T(mask))
    ref = [float(jpo._pose_cost(CAM_J, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), o,
                                jnp.asarray(mask).astype(jnp.float32), d2)) for i in range(3)]
    np.testing.assert_allclose(costs.numpy(), ref, rtol=1e-5)
