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


def remap_inputs():
    z = lambda *s: torch.zeros(s)
    return [z(H, W), z(H, W), z(H, W, 2), z(H, W, 2)]


REMAP_BAD = {
    "dtype": (1, lambda t: t.double(), TypeError),
    "shape": (3, lambda t: t[:, :-1].contiguous(), ValueError),
    "image shape": (1, lambda t: t[:-1], ValueError),
    "non-contiguous": (0, lambda t: t.t().contiguous().t(), ValueError),
    "wrong device": (2, lambda t: t.to("meta"), ValueError),
    "misaligned map": (3, lambda t: torch.zeros(t.numel() + 1)[1:].view(t.shape), ValueError),
}


@pytest.mark.parametrize("bad", list(REMAP_BAD))
def test_remap_checks_raise(bad):
    """Each bad input to kernel 10's fused checks (the maps' once, the
    images' every call) raises, on CPU tensors."""
    k, edit, err = REMAP_BAD[bad]
    dev = torch.device("cpu")
    args = remap_inputs()
    assert k10.check_maps(args[2], args[3], dev)[:2] == (H, W)
    assert k10.check_images(args[0], args[1], dev) == (H, W)
    args[k] = edit(args[k])
    with pytest.raises(err):
        k10.check_images(args[0], args[1], dev)
        k10.check_maps(args[2], args[3], dev)


def test_stereo_rectifier_passes_f32_tensors_through():
    """A rectifier on the CPU takes f32 contiguous tensors as they are and
    converts anything else once; its device carries the maps' own."""
    port = trect.StereoRectifier(K, np.zeros(5), np.eye(3), K, K, np.zeros(5), np.eye(3), K, H, W,
                                 device="cpu")
    im = torch.rand(H, W)
    assert port._as_f32(im) is im
    u8 = np.zeros((H, W), np.uint8)
    got = port._as_f32(u8)
    assert got.dtype == torch.float32 and got.is_contiguous() and port.device == port.map_l.device
    assert port._as_f32(im.t().contiguous().t()).is_contiguous()


def test_stereo_rectifier_maps_are_read_only():
    """Kernel 10 reads the maps' pointers checked at construction, so the
    rectifier's maps cannot be replaced."""
    port = trect.StereoRectifier(K, np.zeros(5), np.eye(3), K, K, np.zeros(5), np.eye(3), K, H, W,
                                 device="cpu")
    for name in ("map_l", "map_r"):
        assert getattr(port, name).shape == (H, W, 2)
        with pytest.raises(AttributeError):
            setattr(port, name, torch.zeros(H, W, 2))
