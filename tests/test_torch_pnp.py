"""Parity of the port's PnP RANSAC with solvers/pnp.py.

``torch.Generator`` cannot reproduce ``jax.random``, so the deterministic
core ``pnp_from_samples`` is fed the minimal sets pnp_ransac draws
(pnp.py:80-85).  Tolerances: R and t of single DLT hypotheses within 1e-4
on well-conditioned draws of noise-free points (the port's Jacobi DLT in
float32 against the reference's LAPACK SVDs; a near-degenerate 6-point
draw can differ more, so those are compared by outcome only);
kernel 6's counting gives exactly the reference's inlier counts on the
same hypotheses, and its first best equals the reference's argmax; the
polished pose within 1e-4 and the same inlier set.  The DLT's cube root
within 2 float32 ulps of float64, its polar factor within 2e-6 of
float64 ``torch.linalg.svd``'s U V^T, near-singular M included.
The batched polish (all candidates in one kernel-4 call) equals the
per-candidate ``optimize_pose`` loop it replaced exactly.
``pnp_ransac`` with the port's own draws is held to the reference test's
outcome bounds (tests/test_loop_components.py:62).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel, lie
from orb_slam2_annotate_tpu.solvers import pnp as jpnp
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.kernels import pnp_score as k6
from orb_slam2_annotate_tpu_torch.solvers import pnp as tpnp
from orb_slam2_annotate_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(1)

CAM = CameraModel.create(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)
TCAM = convert.camera_from_numpy({k: np.asarray(v) for k, v in CAM._asdict().items()})


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """120 points, 30 of them outliers by 40-120 px (the reference's test)."""
    rng = np.random.RandomState(2)
    n = 120
    X = rng.uniform([-2, -2, 3], [2, 2, 9], (n, 3)).astype(np.float32)
    R_true = np.asarray(lie.so3_exp(jnp.asarray([0.1, -0.2, 0.15], jnp.float32)))
    t_true = np.array([0.3, -0.1, 0.4], np.float32)
    Xc = X @ R_true.T + t_true
    uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 160, 400 * Xc[:, 1] / Xc[:, 2] + 120], 1) \
        + rng.randn(n, 2) * 0.5
    out = rng.choice(n, 30, replace=False)
    uv[out] += rng.uniform(40, 120, (30, 2))
    valid = np.ones(n, bool)
    valid[[3, 50]] = False
    return X, uv.astype(np.float32), valid, R_true, t_true, out


def jax_samples(key, valid, n_hyp=256):
    """The minimal sets pnp_ransac draws (pnp.py:80-85)."""
    N = valid.shape[0]
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(k, N, (6,), replace=False, p=probs))(keys))


def jax_hypotheses(X, uv, samples):
    xn = np.stack([(uv[:, 0] - CAM.cx) / CAM.fx, (uv[:, 1] - CAM.cy) / CAM.fy], 1)
    Rs, ts = jax.vmap(lambda s: jpnp._dlt_pnp(jnp.asarray(X)[s], jnp.asarray(xn)[s]))(
        jnp.asarray(samples))
    return np.asarray(Rs), np.asarray(ts), xn


def jax_counts(X, uv, valid, Rs, ts, chi2_th=5.991):
    """pnp.py:90-100's score, over the given hypotheses."""
    def score(R, t):
        xc = jnp.asarray(X) @ R.T + t
        zok = xc[:, 2] > 1e-3
        z = jnp.where(zok, xc[:, 2], 1.0)
        u = CAM.fx * xc[:, 0] / z + CAM.cx
        v = CAM.fy * xc[:, 1] / z + CAM.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return jnp.sum(jnp.asarray(valid) & zok & (e2 < chi2_th * 4.0))
    return np.asarray(jax.vmap(score)(jnp.asarray(Rs), jnp.asarray(ts)))


@pytest.mark.parametrize("seed", [0, 1])
def test_dlt_hypotheses(scene, seed):
    X, _, valid, R_true, t_true, _ = scene
    Xc = X @ R_true.T + t_true                       # noise-free projections
    uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 160, 400 * Xc[:, 1] / Xc[:, 2] + 120], 1)
    samples = jax_samples(jax.random.PRNGKey(seed), valid)
    Rs, ts, xn = jax_hypotheses(X, uv.astype(np.float32), samples)
    idx = T(samples).long()
    R_got, t_got = tpnp.dlt_pnp(T(X)[idx], T(xn.astype(np.float32))[idx])
    # well-conditioned draws: the 12x12 DLT system's second-smallest singular
    # value is >= 2e-3 of its largest, so the null vector is well separated
    gap = []
    for s in samples:
        Xh = np.concatenate([X[s], np.ones((6, 1), np.float32)], 1).astype(np.float64)
        u, v = xn[s, :1], xn[s, 1:]
        A = np.concatenate([np.concatenate([Xh, 0 * Xh, -u * Xh], 1),
                            np.concatenate([0 * Xh, Xh, -v * Xh], 1)])
        sv = np.linalg.svd(A, compute_uv=False)
        gap.append(sv[-2] / sv[0])
    good = np.asarray(gap) >= 2e-3
    assert good.sum() >= 80
    np.testing.assert_allclose(R_got.numpy()[good], Rs[good], atol=1e-4)
    np.testing.assert_allclose(t_got.numpy()[good], ts[good], atol=1e-4)
    # the rest by outcome: every hypothesis is a rotation
    RtR = R_got @ R_got.transpose(-1, -2)
    assert torch.allclose(RtR, torch.eye(3).expand_as(RtR), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_score_counts(scene, seed):
    X, uv, valid, _, _, _ = scene
    samples = jax_samples(jax.random.PRNGKey(seed), valid)
    Rs, ts, _ = jax_hypotheses(X, uv, samples)
    ref = jax_counts(X, uv, valid, Rs, ts)
    got = k6.pnp_score_plain(T(Rs)[None], T(ts)[None], T(X)[None], T(uv), T(valid)[None],
                             TCAM.fx, TCAM.fy, TCAM.cx, TCAM.cy, 5.991 * 4.0)
    assert got.dtype == torch.int32 and got.shape == (1, 256)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert ref.max() > 70 and k6.pnp_hypotheses.launches == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_pnp_from_samples(scene, seed):
    X, uv, valid, _, _, _ = scene
    key = jax.random.PRNGKey(seed)
    ref = jpnp.pnp_ransac(key, CAM, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid))
    got = tpnp.pnp_from_samples(TCAM, T(jax_samples(key, valid))[None], T(X)[None], T(uv),
                                T(valid)[None])
    assert bool(got.success[0]) == bool(ref.success)
    assert int(got.n_inliers[0]) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.R[0].numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t[0].numpy(), np.asarray(ref.t), atol=1e-4)


@pytest.mark.parametrize("polish", [None, [0, 2]], ids=["all", "subset"])
def test_pnp_from_samples_batched_equals_per_candidate_loop(scene, polish):
    X, uv, valid, _, _, _ = scene
    rng = np.random.RandomState(4)
    N = len(X)
    # three candidates: the scene, fewer valid points, perturbed world points
    xw = T(np.stack([X, X, X + rng.randn(*X.shape).astype(np.float32) * 0.01]))
    v = T(np.stack([valid, valid & (rng.rand(N) < 0.7), valid]))
    samples = tpnp.sample_pnp_sets(torch.Generator().manual_seed(3), v, 64)
    got = tpnp.pnp_from_samples(TCAM, samples, xw, T(uv), v, polish=polish)
    # the loop the batch replaced: best DLT pose, then optimize_pose per candidate
    ref = tpnp.pnp_from_samples(TCAM, samples, xw, T(uv), v, polish=[])
    n_best = k6.pnp_score_plain(ref.R[:, None].contiguous(), ref.t[:, None].contiguous(), xw,
                                T(uv), v, TCAM.fx, TCAM.fy, TCAM.cx, TCAM.cy, 5.991 * 4.0)[:, 0]
    for c in (range(3) if polish is None else polish):
        obs = tpo.PoseObs(xw=xw[c], uv=T(uv), ur=torch.full((N,), -1.0),
                          inv_sigma2=torch.ones(N), valid=v[c])
        ref.R[c], ref.t[c], ref.inliers[c], ref.n_inliers[c] = tpo.optimize_pose(
            TCAM, ref.R[c], ref.t[c], obs)
        ref.success[c] = (n_best[c] >= 10) & (ref.n_inliers[c] >= 10)
    for name in ("success", "R", "t", "inliers", "n_inliers"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert bool(got.success[0]) and int(got.n_inliers[0]) > 70


def test_pnp_ransac_with_outliers(scene):
    X, uv, _, R_true, t_true, _ = scene
    res = tpnp.pnp_ransac(torch.Generator().manual_seed(0), TCAM, T(X), T(uv),
                          torch.ones(len(X), dtype=torch.bool))
    assert bool(res.success)
    dR = res.R.numpy() @ R_true.T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-2
    assert np.linalg.norm(res.t.numpy() - t_true) < 0.05
    assert int(res.n_inliers) > 70


def test_sample_pnp_sets(scene):
    _, _, valid, _, _, _ = scene
    v = np.stack([valid, np.arange(len(valid)) < 4])        # row 2: too few valid entries
    s = tpnp.sample_pnp_sets(torch.Generator().manual_seed(1), T(v), 64).numpy()
    assert s.shape == (2, 64, 6)
    assert valid[s[0]].all()
    assert all(len(set(row)) == 6 for row in s.reshape(-1, 6))


def test_cube_root_against_pow():
    # |det M| of random and near-singular M, from 1e-36 up: the square-root
    # start and the Newton steps within 2 float32 ulps of the float64 root
    rng = np.random.RandomState(5)
    M = rng.randn(200, 3, 3)
    M[100:, :, 2] = M[100:, :, 0] * 0.3 + M[100:, :, 1] * 0.1 + rng.randn(100, 3) * 1e-6
    a = np.abs(np.linalg.det(M))
    a = np.concatenate([a, np.logspace(-36, 3, 40)]).astype(np.float32)
    got = k6.cbrt_newton(T(a)).numpy()
    ref = a.astype(np.float64) ** (1.0 / 3.0)
    np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)
    assert got.dtype == np.float32


@pytest.mark.parametrize("kind", ["random", "near-singular"])
def test_polar_factor_against_svd(kind):
    # the polar factor U V^T of torch.linalg.svd (float64) for det M > 0;
    # near singular: one singular value 1e-7 of the largest, where the
    # cross product gives U's last column
    rng = np.random.RandomState(6)
    U = np.linalg.qr(rng.randn(300, 3, 3))[0]
    V = np.linalg.qr(rng.randn(300, 3, 3))[0]
    s = rng.uniform(0.2, 3.0, (300, 3))
    if kind == "near-singular":
        s[:, 2] = s[:, 0] * 1e-7
    M = np.einsum("bij,bj,bkj->bik", U, s, V)
    M[np.linalg.det(M) < 0] *= -1
    M = M.astype(np.float32)
    u, _, vh = torch.linalg.svd(torch.from_numpy(M).double())
    ref = (u @ vh).numpy()
    got = k6.polar_factor(T(M)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(np.linalg.det(got.astype(np.float64)), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_pnp_hypotheses_best_equals_jax_argmax(scene, seed):
    # JAX's first argmax over its own hypotheses' counts.  The two DLTs round
    # differently, so a count may move by a point on the gate's edge: at
    # most 1% of the counts may differ, by 1 (none do on these seeds' tops)
    X, uv, valid, _, _, _ = scene
    samples = jax_samples(jax.random.PRNGKey(seed), valid)
    Rs, ts, _ = jax_hypotheses(X, uv, samples)
    ref = jax_counts(X, uv, valid, Rs, ts)
    got_R, got_t, got_n, best = k6.pnp_hypotheses_plain(
        T(samples)[None], T(X)[None], T(uv), T(valid)[None], TCAM.fx, TCAM.fy, TCAM.cx, TCAM.cy,
        5.991 * 4.0)
    assert best.dtype == torch.int64 and got_n.dtype == torch.int32
    diff = np.abs(got_n[0].numpy() - ref)
    assert (diff > 0).mean() <= 0.01 and diff.max() <= 1
    assert int(best[0]) == int(np.argmax(ref))
    assert int(got_n[0, best[0]]) == int(ref.max())
    np.testing.assert_allclose(got_R[0, best[0]].numpy(), Rs[np.argmax(ref)], atol=1e-4)
    np.testing.assert_allclose(got_t[0, best[0]].numpy(), ts[np.argmax(ref)], atol=1e-4)
