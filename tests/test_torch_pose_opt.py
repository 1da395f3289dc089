"""Parity of the port's pose-only LM (plain twins of kernel 4) with
solvers/pose_opt.py on identical PoseObs.

Tolerances: R and t within 1e-4; inlier masks differ on at most 1% of
edges, and only where chi2 sits within 1% of the gate (summation order
moves chi2 by ulps).
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

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM_J = CameraModel.create(**ARGS)
CAM_T = TCam.create(**ARGS)


def T(a):
    return torch.from_numpy(np.array(a))


def make_obs(seed, n=512, outliers=0.15, noise=1.0):
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
    valid = rng.rand(n) < 0.95
    xw[~valid] = 0.0
    obs = dict(xw=xw, uv=uv.astype(np.float32), ur=np.full(n, -1.0, np.float32),
               inv_sigma2=(1.0 / 1.2 ** (2.0 * octave)).astype(np.float32), valid=valid)
    dR, dt = jlie.se3_exp(jnp.asarray(rng.randn(6) * [0.05, 0.05, 0.05, 0.01, 0.01, 0.01],
                                      jnp.float32))
    R0, t0 = jlie.se3_compose(dR, dt, jnp.asarray(R), jnp.asarray(t))
    return obs, np.asarray(R0), np.asarray(t0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose(seed):
    obs, R0, t0 = make_obs(seed)
    Rj, tj, inl_j, n_j = jpo.optimize_pose(CAM_J, jnp.asarray(R0), jnp.asarray(t0),
                                           jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}))
    Rt, tt, inl_t, n_t = tpo.optimize_pose(CAM_T, T(R0), T(t0),
                                           tpo.PoseObs(**{k: T(v) for k, v in obs.items()}))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    diff = inl_t.numpy() != np.asarray(inl_j)
    assert diff.mean() <= 0.01
    if diff.any():
        r, _, _, _ = tk4.residual_jac(CAM_T, Rt, tt, T(obs["xw"]), T(obs["uv"]), T(obs["ur"]))
        chi2 = ((r * r).sum(0) * T(obs["inv_sigma2"])).numpy()
        assert np.all(np.abs(chi2[diff] / 5.991 - 1.0) < 0.01)


@pytest.mark.parametrize("robust", [True, False])
def test_linearize_and_costs(robust):
    obs, R0, t0 = make_obs(5)
    mask = obs["valid"] & (np.random.RandomState(9).rand(512) < 0.9)
    ed = [T(obs[k]) for k in ("xw", "uv", "ur", "inv_sigma2")]
    H, g, c = tk4.pose_linearize(CAM_T, T(R0), T(t0), *ed, T(mask), robust)
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
    costs = tk4.pose_costs(CAM_T, T(Rs), T(ts), *ed, T(mask))
    ref = [float(jpo._pose_cost(CAM_J, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), o,
                                jnp.asarray(mask).astype(jnp.float32), d2)) for i in range(3)]
    np.testing.assert_allclose(costs.numpy(), ref, rtol=1e-5)
