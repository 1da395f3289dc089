"""The port's Sim3 half of geometry/lie.py and solvers/sim3.py against the
JAX package, on numpy inputs made from a seed.

Tolerances: the Lie functions within 1e-5 (sim3_log 1e-4, it solves a 3x3
system); horn_sim3 within 1e-5 (the port takes Horn's quaternion by Jacobi,
the reference by ``eigh``); kernel 7's twin on every sampled triple within
1e-4 of the reference's vmapped Horn (t within 1e-4 + 1e-4 |t|: triples with
an outlier give ill-conditioned fits with |t| up to ~10); sim3_from_samples
(kernel 7's twin) fed the reference's own sampled sets (``jax.random.split``
+ the vmapped ``choice`` of sim3_ransac) gives the same success, inlier
count and mask, and s, R, t within 1e-5, also with fewer than 3 valid
pairs, with a refined fit that counts fewer inliers than the best
hypothesis, and with no valid pair; its tree sums within 1e-6 (relative)
of a float64 sum; optimize_sim3 (kernel 8's twin) the same count, masks
that differ on at most 1% of pairs, and s, R, t within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.geometry import lie as jlie
from orb_slam2_annotate_tpu.solvers import sim3 as jsim3
from orb_slam2_annotate_tpu_torch.geometry import lie as tlie
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.kernels import sim3 as ksim3
from orb_slam2_annotate_tpu_torch.solvers import sim3 as tsim3

torch.set_num_threads(1)

ARGS = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)


def T(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a), rtol=rtol, atol=tol)


def pairs(seed: int, n: int = 96, n_bad: int = 24, scale: float = 1.4, depth_err: float = 0.0):
    """Matched camera-frame points x1, x2 ~ s R x1 + t, their pixels, n_bad
    outliers; with depth_err, 30% of the x2 moved along their viewing rays
    by a factor 1 + depth_err x U(0.5, 1)."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform([-2, -2, 3], [2, 2, 8], (n, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32) * 0.2)))
    t = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    x2 = (scale * x1 @ R.T + t).astype(np.float32)
    proj = lambda x: np.stack([400 * x[:, 0] / x[:, 2] + 160, 400 * x[:, 1] / x[:, 2] + 120],
                              1).astype(np.float32)
    uv1 = proj(x1) + rng.randn(n, 2).astype(np.float32) * 0.5
    uv2 = proj(x2)
    bad = rng.choice(n, n_bad, replace=False)
    x2[bad] = rng.uniform([-2, -2, 3], [2, 2, 8], (n_bad, 3))
    if depth_err:
        far = rng.choice(n, int(0.3 * n), replace=False)
        x2[far] *= 1 + depth_err * rng.uniform(0.5, 1.0, (len(far), 1))
    return x1, x2, uv1, uv2, (scale, R, t)


def test_sim3_lie_functions_agree():
    rng = np.random.RandomState(0)
    xi = (rng.randn(6, 7) * 0.3).astype(np.float32)
    xi[0] = 0.0                 # both Taylor branches
    xi[1, 3:6] = 0.0            # theta -> 0
    xi[2, 6] = 0.0              # sigma -> 0
    for a, b in zip(jlie.sim3_exp(jnp.asarray(xi)), tlie.sim3_exp(T(xi))):
        close(a, b, 1e-5)
    sa, Ra, ta = (np.asarray(v) for v in jlie.sim3_exp(jnp.asarray(xi)))
    sb, Rb, tb = (np.asarray(v) for v in jlie.sim3_exp(jnp.asarray(xi[::-1].copy())))
    x = rng.randn(6, 3).astype(np.float32)
    close(jlie.sim3_apply(sa, Ra, ta, x), tlie.sim3_apply(T(sa), T(Ra), T(ta), T(x)), 1e-5)
    for a, b in zip(jlie.sim3_inverse(sa, Ra, ta), tlie.sim3_inverse(T(sa), T(Ra), T(ta))):
        close(a, b, 1e-5)
    for a, b in zip(jlie.sim3_compose(sa, Ra, ta, sb, Rb, tb),
                    tlie.sim3_compose(T(sa), T(Ra), T(ta), T(sb), T(Rb), T(tb))):
        close(a, b, 1e-5)
    for a, b in zip(jlie.sim3_retract(sa, Ra, ta, xi[::-1].copy()),
                    tlie.sim3_retract(T(sa), T(Ra), T(ta), T(xi[::-1].copy()))):
        close(a, b, 1e-5)
    for k in range(6):
        close(jlie.sim3_log(sa[k], Ra[k], ta[k]), tlie.sim3_log(T(sa[k]), T(Ra[k]), T(ta[k])), 1e-4)
    close(jlie.se3_apply(Ra, ta, x), tlie.se3_apply(T(Ra), T(ta), T(x)), 1e-6)
    q = jlie.rot_to_quat(Ra)
    close(q, tlie.rot_to_quat(T(Ra)), 1e-6)
    close(jlie.quat_to_rot(q), tlie.quat_to_rot(T(np.asarray(q))), 1e-6)


def test_jacobi_eig4_matches_eigh():
    rng = np.random.RandomState(1)
    A = rng.randn(64, 4, 4).astype(np.float32)
    Q = A + A.transpose(0, 2, 1)
    vals, vecs = ksim3.jacobi_eig4(T(Q))
    ref = np.linalg.eigvalsh(Q.astype(np.float64))
    np.testing.assert_allclose(np.sort(vals.numpy(), axis=1), ref, atol=1e-4)
    # Q V = V diag(vals), V orthonormal
    QV = np.einsum("bij,bjk->bik", Q, vecs.numpy())
    np.testing.assert_allclose(QV, vecs.numpy() * vals.numpy()[:, None, :], atol=1e-4)
    np.testing.assert_allclose(np.einsum("bji,bjk->bik", vecs.numpy(), vecs.numpy()),
                               np.broadcast_to(np.eye(4), (64, 4, 4)), atol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_agrees(fix_scale):
    x1, x2, _, _, _ = pairs(2)
    w = (np.random.RandomState(3).rand(x1.shape[0]) > 0.3).astype(np.float32)
    for a, b in zip(jsim3.horn_sim3(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w), fix_scale),
                    ksim3.horn_sim3(T(x1), T(x2), T(w), fix_scale)):
        close(a, b, 1e-5)


def reference_samples(key, valid: np.ndarray, n_hyp: int) -> np.ndarray:
    """sim3_ransac's own draws (JAX solvers/sim3.py:96-99)."""
    probs = valid.astype(np.float32)
    probs = jnp.asarray(probs / max(probs.sum(), 1e-9))
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, valid.shape[0], (3,), replace=False, p=probs))(keys))


@pytest.mark.parametrize("n", [1, 2, 3, 37, 512, 1000, 4096])
def test_tree_sum_matches_float64(n):
    x = np.random.RandomState(n).rand(n, 3).astype(np.float32)
    got = ksim3.tree_sum(T(x)).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64).sum(0), rtol=1e-6, atol=0)


def test_kernel7_twin_fits_every_triple_like_the_reference():
    x1, x2, uv1, uv2, _ = pairs(4)
    valid = np.ones(x1.shape[0], bool)
    samples = reference_samples(jax.random.PRNGKey(5), valid, 256)
    idx = T(samples).long()
    s, R, t = ksim3.horn3_plain(T(x1)[idx], T(x2)[idx], False)
    n, best = ksim3.sim3_ransac_solve_plain(
        T(samples), T(x1), T(x2), T(uv1), T(uv2), T(valid), None, None,
        400.0, 400.0, 160.0, 120.0, 9.21, False, 20)[6:]
    js, jR, jt = jax.vmap(lambda smp: jsim3.horn_sim3(
        jnp.asarray(x1)[smp], jnp.asarray(x2)[smp], jnp.ones(3)))(jnp.asarray(samples))
    close(js, s, 1e-4)
    close(jR, R, 1e-4)
    close(jt, t, 1e-4, rtol=1e-4)
    assert int(best) == int(torch.argmax(n)) and n.dtype == torch.int32


@pytest.mark.parametrize("case", ["all valid", "partial valid", "fix scale", "fewer than 3 valid",
                                  "refined counts fewer", "none valid"])
def test_sim3_from_samples_fed_reference_draws(case):
    # "fewer than 3 valid": one valid pair, the draws from all N; "refined
    # counts fewer": depth errors bias the weighted Horn, so the best
    # hypothesis is kept
    x1, x2, uv1, uv2, truth = pairs(6, n_bad=0 if case == "fewer than 3 valid" else 24,
                                    depth_err=0.3 if case == "refined counts fewer" else 0.0)
    n = x1.shape[0]
    valid = {"partial valid": np.random.RandomState(8).rand(n) > 0.25,
             "fewer than 3 valid": np.arange(n) == 5,
             "none valid": np.zeros(n, bool)}.get(case, np.ones(n, bool))
    fix = case == "fix scale"
    if fix:
        x2 = (x1 @ truth[1].T + truth[2]).astype(np.float32)
        uv2 = np.stack([400 * x2[:, 0] / x2[:, 2] + 160, 400 * x2[:, 1] / x2[:, 2] + 120],
                       1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jsim3.sim3_ransac(key, CAM, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(uv1),
                            jnp.asarray(uv2), 128, fix, valid=jnp.asarray(valid), th_chi2=100.0,
                            min_inliers=12)
    got = tsim3.sim3_from_samples(TCAM, T(reference_samples(key, valid, 128)), T(x1), T(x2),
                                  T(uv1), T(uv2), fix, valid=T(valid), th_chi2=100.0,
                                  min_inliers=12)
    assert bool(got.success) == bool(ref.success) == (case not in ("fewer than 3 valid",
                                                                  "none valid"))
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    for a, b in ((ref.s, got.s), (ref.R, got.R), (ref.t, got.t)):
        close(a, b, 1e-5)
    if case in ("fewer than 3 valid", "refined counts fewer"):
        # the weighted Horn over the kept mask counts fewer: use_refined is false
        w = got.inliers.to(torch.float32)
        s_r, R_r, t_r = ksim3.horn_sim3(T(x1), T(x2), w, fix)
        n_r = ksim3.sim3_score_plain(s_r[None], R_r[None], t_r[None], T(x1), T(x2), T(uv1),
                                     T(uv2), T(valid), torch.ones(n), torch.ones(n), 400.0, 400.0,
                                     160.0, 120.0, 100.0)[0].sum()
        assert int(n_r) < int(got.n_inliers)


def test_sim3_ransac_recovers_the_similarity():
    x1, x2, uv1, uv2, (s, R, t) = pairs(10, n=80, n_bad=20)
    gen = torch.Generator().manual_seed(0)
    res = tsim3.sim3_ransac(gen, TCAM, T(x1), T(x2), T(uv1), T(uv2), 128)
    assert bool(res.success)
    assert abs(float(res.s) - s) < 0.02
    assert np.linalg.norm(res.t.numpy() - t) < 0.05
    ang = np.arccos(np.clip((np.trace(res.R.numpy() @ R.T) - 1) / 2, -1, 1))
    assert ang < 1e-2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_agrees(fix_scale):
    x1, x2, uv1, uv2, (s, R, t) = pairs(11)
    if fix_scale:
        x2 = (x1 @ R.T + t).astype(np.float32)
        uv2 = np.stack([400 * x2[:, 0] / x2[:, 2] + 160, 400 * x2[:, 1] / x2[:, 2] + 120],
                       1).astype(np.float32)
        s = 1.0
    n = x1.shape[0]
    valid = np.random.RandomState(12).rand(n) > 0.1
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32))) @ R
    s0, t0 = np.float32(s * 0.95), (t + [0.04, -0.02, 0.03]).astype(np.float32)
    ref = jsim3.optimize_sim3(CAM, jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
                              jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(uv1), jnp.asarray(uv2),
                              fix_scale, valid=jnp.asarray(valid), chi2_th=100.0)
    got = tsim3.optimize_sim3(TCAM, T(s0), T(R0), T(t0), T(x1), T(x2), T(uv1), T(uv2), fix_scale,
                              valid=T(valid), chi2_th=100.0)
    assert int(got.n_inliers) == int(ref.n_inliers) and bool(got.success) == bool(ref.success)
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).mean() <= 0.01
    for a, b in ((ref.s, got.s), (ref.R, got.R), (ref.t, got.t)):
        close(a, b, 1e-4)
