"""The port's stereo rectifier against the JAX package's geometry/rectify.py,
with tests/test_rectify.py's intrinsics and distortion.

Tolerances: ``rectify_map`` within 1e-3 px (the distortion's float32
steps); ``remap_bilinear`` / ``remap_pair`` (kernel 10's plain twin)
within 1e-4 on the 0-255 scale, and bit for bit at integer source
coordinates; ``stereo_rectify``'s R1, R2, P1, P2 and bf within 1e-5
(relative for bf); the ``StereoRectifier`` end to end within 1e-4.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import lie as jlie
from orb_slam2_annotate_tpu.geometry import rectify as jrect
from orb_slam2_annotate_tpu_torch.geometry import rectify as trect
from orb_slam2_annotate_tpu_torch.kernels import remap as k10

torch.set_num_threads(1)

K = np.array([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.28, 0.07, 1e-4, -2e-5, 0.0], np.float32)
H, W = 96, 128
R_RIG = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.02, -0.03, 0.01], np.float32))))
T_RIG = np.array([-0.11, 0.004, -0.002], np.float32)


@pytest.fixture(scope="module")
def rig():
    return jrect.stereo_rectify(K, DIST, K, DIST, R_RIG, T_RIG, H, W)


@pytest.mark.parametrize("case", ["identity", "distortion", "distortion + rectification"])
def test_rectify_map_agrees(case, rig):
    R1, _, P1, _, _ = rig
    dist, R, P = {"identity": (np.zeros(5), np.eye(3), K), "distortion": (DIST, np.eye(3), K),
                  "distortion + rectification": (DIST, R1, P1)}[case]
    ref = np.asarray(jrect.rectify_map(K, dist, R, P, H, W))
    got = trect.rectify_map(K, dist, R, P, H, W)
    assert got.dtype == torch.float32 and got.shape == (H, W, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


def test_remap_bilinear_agrees_and_is_exact_at_integers():
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    maps = {"identity": np.stack([u, v], -1), "shift (3, 2)": np.stack([u + 3, v + 2], -1),
            "distortion": np.asarray(jrect.rectify_map(K, DIST, np.eye(3), K, H, W)),
            "fractional, partly outside": np.stack([1.3 * u - 20.25, 0.9 * v + 15.6], -1)}
    for name, m in maps.items():
        m = m.astype(np.float32)
        ref = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
        got = k10.remap_bilinear_plain(torch.from_numpy(img), torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0, err_msg=name)
        if name in ("identity", "shift (3, 2)"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(
        k10.remap_bilinear_plain(torch.from_numpy(img), torch.from_numpy(maps["identity"])).numpy(),
        img)


def test_remap_pair_agrees():
    rng = np.random.RandomState(1)
    il, ir = (rng.uniform(0, 255, (H, W)).astype(np.float32) for _ in range(2))
    ml = np.array(jrect.rectify_map(K, DIST, np.eye(3), K, H, W))
    mr = ml + np.float32(0.37)
    ref = jrect.remap_pair(*(jnp.asarray(a) for a in (il, ir, ml, mr)))
    got = k10.remap_pair(*(torch.from_numpy(a) for a in (il, ir, ml, mr)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)


def test_stereo_rectify_agrees(rig):
    got = trect.stereo_rectify(K, DIST, K, DIST, R_RIG, T_RIG, H, W)
    for name, g, r in zip(("R1", "R2", "P1", "P2"), got[:4], rig[:4]):
        assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=name)
    assert abs(got[4] - rig[4]) <= 1e-5 * rig[4]


def test_stereo_rectifier_agrees(rig):
    R1, R2, P1, P2, _ = rig
    rng = np.random.RandomState(2)
    il = rng.randint(0, 256, (H, W)).astype(np.uint8)
    ir = rng.randint(0, 256, (H, W)).astype(np.uint8)
    ref = jrect.StereoRectifier(K, DIST, R1, P1, K, DIST, R2, P2, H, W)
    port = trect.StereoRectifier(K, DIST, R1, P1, K, DIST, R2, P2, H, W, device="cpu")
    for g, r in zip(port(il, ir), ref(il, ir)):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)
    assert port.cam.fx == float(ref.cam.fx) and port.cam.cy == float(ref.cam.cy)
    assert inspect.signature(trect.StereoRectifier.__init__).parameters["device"].default == "cuda"
