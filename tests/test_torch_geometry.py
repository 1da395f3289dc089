"""Parity of the port's geometry (lie, smallsolve, camera, twoview) with the
JAX package on the same numpy inputs.

Tolerances: closed-form float32 arithmetic agrees to 1e-5 (relative where
magnitudes grow); SVD-based fits agree up to the sign of the null vector,
so they are compared after normalizing that sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import camera as jcam
from orb_slam2_annotate_tpu.geometry import lie as jlie
from orb_slam2_annotate_tpu.geometry import smallsolve as jss
from orb_slam2_annotate_tpu.geometry import twoview as jtv
from orb_slam2_annotate_tpu_torch.geometry import camera as tcam
from orb_slam2_annotate_tpu_torch.geometry import lie as tlie
from orb_slam2_annotate_tpu_torch.geometry import smallsolve as tss
from orb_slam2_annotate_tpu_torch.geometry import twoview as ttv

RNG = np.random.RandomState(7)


def T(a):
    return torch.from_numpy(np.array(a))


def close(a_torch, b_jax, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(a_torch.numpy(), np.asarray(b_jax), atol=atol, rtol=rtol)


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.5, 3.1])
def test_so3_se3_maps(scale):
    xi = (RNG.randn(16, 6) * scale).astype(np.float32)
    R_j, t_j = jax.vmap(jlie.se3_exp)(jnp.asarray(xi))
    R_t, t_t = tlie.se3_exp(T(xi))
    close(R_t, R_j)
    close(t_t, t_j)
    close(tlie.so3_log(T(R_j)), jax.vmap(jlie.so3_log)(R_j), atol=2e-4)
    close(tlie.se3_log(T(R_j), T(t_j)), jax.vmap(jlie.se3_log)(R_j, t_j), atol=2e-4)
    Rr_j, tr_j = jax.vmap(jlie.se3_retract)(R_j, t_j, jnp.asarray(xi[::-1].copy()))
    Rr_t, tr_t = tlie.se3_retract(R_t, t_t, T(xi[::-1].copy()))
    close(Rr_t, Rr_j, atol=1e-5)
    close(tr_t, tr_j, atol=1e-5)


def test_smallsolve():
    A = RNG.randn(32, 6, 6).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    g = RNG.randn(32, 6).astype(np.float32)
    close(tss.solve6_spd(T(H), T(g)), jss.solve6_spd(jnp.asarray(H), jnp.asarray(g)), rtol=1e-4,
          atol=1e-4)
    M = RNG.randn(32, 3, 3).astype(np.float32)
    close(tss.inv3(T(M)), jss.inv3(jnp.asarray(M)), rtol=1e-4, atol=1e-4)


def test_camera_undistort_project():
    args = dict(fx=250.0, fy=251.0, cx=160.0, cy=120.0, k1=-0.2, k2=0.05, p1=1e-3, p2=-2e-3,
                k3=0.01, width=320, height=240)
    cj = jcam.CameraModel.create(**args)
    ct = tcam.CameraModel.create(**args)
    uv = (RNG.rand(100, 2) * [320, 240]).astype(np.float32)
    close(tcam.undistort_pixels(ct, T(uv)), jcam.undistort_pixels(cj, jnp.asarray(uv)), atol=1e-3)
    xc = (RNG.randn(100, 3) + [0, 0, 5]).astype(np.float32)
    close(tcam.project(ct, T(xc)), jcam.project(cj, jnp.asarray(xc)), atol=1e-3)
    np.testing.assert_array_equal(tcam.in_image(ct, T(uv * 1.3), 2.0).numpy(),
                                  np.asarray(jcam.in_image(cj, jnp.asarray(uv * 1.3), 2.0)))
    np.testing.assert_array_equal(ct.K().numpy(), np.asarray(cj.K))


def _two_view(n=64):
    K = np.array([[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1]], np.float32)
    X = (RNG.rand(n, 3) * [4, 3, 4] + [-2, -1.5, 5]).astype(np.float32)
    R, _ = jlie.se3_exp(jnp.asarray([0.3, 0.0, 0.05, 0.01, -0.04, 0.02], jnp.float32))
    R = np.asarray(R)
    t = np.array([-0.3, 0.02, 0.05], np.float32)
    x1 = X @ K.T
    x1 = (x1[:, :2] / x1[:, 2:]).astype(np.float32)
    x2 = (X @ R.T + t) @ K.T
    x2 = (x2[:, :2] / x2[:, 2:] + RNG.randn(n, 2) * 0.3).astype(np.float32)
    return K, R, t, x1, x2


def test_triangulate_dlt():
    K, R, t, x1, x2 = _two_view()
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    P2 = K @ np.hstack([R, t[:, None]]).astype(np.float32)
    ref = jtv.triangulate_dlt_batch(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(x1), jnp.asarray(x2))
    close(ttv.triangulate_dlt(T(P1), T(P2), T(x1), T(x2)), ref, rtol=1e-3, atol=1e-3)


def _sign_normalized(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M) * np.sign(M.reshape(-1)[np.argmax(np.abs(M))])


@pytest.mark.parametrize("model", ["fundamental", "homography"])
def test_model_fits_and_chi2(model):
    K, R, t, x1, x2 = _two_view()
    mask = RNG.rand(64) > 0.2
    if model == "fundamental":
        j = jtv.fit_fundamental_8pt(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
        m = ttv.fit_fundamental_8pt(T(x1), T(x2), T(mask))
        cj = jtv.fundamental_symmetric_chi2(j, jnp.asarray(x1), jnp.asarray(x2), 1.0)
        ct = ttv.fundamental_symmetric_chi2(T(np.asarray(j)), T(x1), T(x2), 1.0)
    else:
        j = jtv.fit_homography_dlt(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
        m = ttv.fit_homography_dlt(T(x1), T(x2), T(mask))
        cj = jtv.homography_symmetric_chi2(j, jnp.asarray(x1), jnp.asarray(x2), 1.0)
        ct = ttv.homography_symmetric_chi2(T(np.asarray(j)), T(x1), T(x2), 1.0)
    np.testing.assert_allclose(_sign_normalized(m.numpy()), _sign_normalized(j), atol=2e-4)
    for a, b in zip(ct, cj):
        close(a, b, rtol=1e-3, atol=1e-3)


def test_decompose_essential_and_check_rt():
    K, R, t, x1, x2 = _two_view()
    F = jtv.fit_fundamental_8pt(jnp.asarray(x1), jnp.asarray(x2))
    E = np.asarray(jnp.asarray(K).T @ F @ jnp.asarray(K))
    Rs_j, ts_j = jtv.decompose_essential(jnp.asarray(E))
    Rs_t, ts_t = ttv.decompose_essential(T(E))
    # the four candidates form the same set (SVD signs may order them differently)
    for Rt, tt in zip(Rs_t.numpy(), ts_t.numpy()):
        d = [np.abs(Rt - np.asarray(Rj)).max() + np.abs(tt - np.asarray(tj)).max()
             for Rj, tj in zip(Rs_j, ts_j)]
        assert min(d) < 1e-4
    mask = np.ones(64, bool)
    for i in range(4):
        n_j, g_j, p_j, X_j = jtv.check_rt(Rs_j[i], ts_j[i], jnp.asarray(x1), jnp.asarray(x2),
                                          jnp.asarray(mask), jnp.asarray(K), jnp.asarray(K), 4.0)
        n_t, g_t, p_t, X_t = ttv.check_rt(T(np.asarray(Rs_j[i]))[None], T(np.asarray(ts_j[i]))[None],
                                          T(x1), T(x2), T(mask), T(K), 4.0)
        assert int(n_t[0]) == int(n_j)
        np.testing.assert_array_equal(g_t[0].numpy(), np.asarray(g_j))
        close(p_t[0], p_j, atol=1e-5)
        close(X_t[0], X_j, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("P", [1, 7, 100, 4096, 16384])
def test_rotate_points_is_the_einsum_on_the_cpu(P):
    """lie.rotate_points (loop correction and the global BA's fold) gives
    the CPU einsum's bits, and the JAX package's einsum to 1e-5."""
    R = (RNG.randn(P, 3, 3)).astype(np.float32)
    x = (RNG.randn(P, 3) * 10).astype(np.float32)
    for spec, transpose in (("pij,pj->pi", False), ("pji,pj->pi", True)):
        got = tlie.rotate_points(T(R), T(x), transpose=transpose)
        want = torch.einsum(spec, T(R), T(x))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
        close(got, jnp.einsum(spec, jnp.asarray(R), jnp.asarray(x)), atol=1e-4)
