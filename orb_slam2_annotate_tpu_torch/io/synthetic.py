"""Synthetic sequences with exact ground truth, numpy only.

A copy of the parts of orb_slam2_annotate_tpu/io/synthetic.py that the
monocular slice and the loop scenes use (PlaneScene, orbit_trajectory,
RoomScene, circle_trajectory, loop_trajectory): importing the
reference package would import jax, and the machines that run the port
need not have OpenCV.  ``warp_perspective`` therefore reimplements the
arithmetic of ``cv2.warpPerspective(INTER_LINEAR, BORDER_CONSTANT)`` as
OpenCV 5 evaluates it for float32 images: float32 coefficients of the
inverse map, a per-row constant, one fused multiply-add per coordinate, a
float32 division, and fused multiply-add lerps.  tests/test_torch_system.py
checks that frames are bit-identical to the reference renderer's.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: a*b is exact in float64, one rounding to
    float32 after the add (a float64 add then rounds twice only in ties
    that float32 images do not reach)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F32)


def _invert3(S: np.ndarray) -> np.ndarray:
    """cv::invert's closed form for a 3x3 double matrix."""
    d = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
         - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
         + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    d = 1.0 / d
    return np.array([
        (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d, (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
        (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d, (S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d,
        (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d, (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d,
        (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d, (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
        (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d])


def warp_perspective(src: np.ndarray, H: np.ndarray, size: tuple[int, int],
                     border_value: float) -> np.ndarray:
    """Bilinear warp of a float32 image by the forward homography H (src ->
    dst pixels) into `size` = (w, h), constant border."""
    w, h = size
    M = _invert3(np.asarray(H, np.float64)).astype(_F32)
    x = np.arange(w, dtype=_F32)[None, :]
    y = np.arange(h, dtype=_F32)[:, None]
    row_x, row_y, row_w = (y * M[1] + M[2], y * M[4] + M[5], y * M[7] + M[8])
    # pixels on the horizon (w == 0) map to non-finite coordinates; they
    # fall outside the source and take the border value
    with np.errstate(divide="ignore", invalid="ignore"):
        sw = _fma32(M[6], x, row_w)
        sx = (_fma32(M[0], x, row_x) / sw).astype(_F32)
        sy = (_fma32(M[3], x, row_y) / sw).astype(_F32)
        big = np.float32(2**30)
        sx = np.where(np.isfinite(sx), np.clip(sx, -big, big), -big).astype(_F32)
        sy = np.where(np.isfinite(sy), np.clip(sy, -big, big), -big).astype(_F32)
    ix = np.floor(sx)
    iy = np.floor(sy)
    a = (sx - ix).astype(_F32)
    b = (sy - iy).astype(_F32)
    ix = ix.astype(np.int64)
    iy = iy.astype(np.int64)
    hs, ws = src.shape
    bv = _F32(border_value)

    def pix(yi, xi):
        ok = (yi >= 0) & (yi < hs) & (xi >= 0) & (xi < ws)
        return np.where(ok, src[np.clip(yi, 0, hs - 1), np.clip(xi, 0, ws - 1)], bv).astype(_F32)

    p00, p01 = pix(iy, ix), pix(iy, ix + 1)
    p10, p11 = pix(iy + 1, ix), pix(iy + 1, ix + 1)
    h0 = _fma32(a, (p01 - p00).astype(_F32), p00)
    h1 = _fma32(a, (p11 - p10).astype(_F32), p10)
    out = _fma32(b, (h1 - h0).astype(_F32), h0)
    outside = (ix >= ws) | (ix + 1 < 0) | (iy >= hs) | (iy + 1 < 0)
    return np.where(outside, bv, out).astype(_F32)


def orbit_trajectory(n_frames: int, radius: float = 0.0, step: float = 0.05,
                     yaw_rate: float = 0.004):
    """Sideways translation with slow yaw: list of ground-truth Tcw (R, t)."""
    poses = []
    for k in range(n_frames):
        yaw = yaw_rate * k
        Rwc = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                       np.float32)
        cw = np.array([k * step, 0.015 * np.sin(k * 0.2), 0.01 * k], np.float32)
        R = Rwc.T
        poses.append((R, -R @ cw))
    return poses


class PlaneScene:
    """Piecewise-planar textured scene rendered by homography warping, with
    exact per-pixel depth."""

    def __init__(self, seed: int = 0, tex_size: int = 768):
        rng = np.random.RandomState(seed)
        self.planes = []

        def make_texture():
            t = np.zeros((tex_size, tex_size), np.float32)
            for octave in range(2, 7):
                n = tex_size // (2 ** octave)
                layer = rng.rand(n, n).astype(np.float32) - 0.5
                layer = np.kron(layer, np.ones((2 ** octave, 2 ** octave), np.float32))
                t += layer * (1.4 ** octave)
            t = t[:tex_size, :tex_size]
            t = 120.0 + 60.0 * t / np.abs(t).max()
            return np.clip(t, 5, 250)

        self.planes.append((np.array([-6.0, -4.0, 9.0]), np.array([12.0, 0, 0]),
                            np.array([0, 8.0, 0]), make_texture()))
        self.planes.append((np.array([-6.0, 2.0, 9.5]), np.array([12.0, 0, 0]),
                            np.array([0, 0.0, -8.0]), make_texture()))
        self.planes.append((np.array([-2.5, -1.5, 6.5]), np.array([2.0, 0, 0.3]),
                            np.array([0, 2.0, 0]), make_texture()))
        self.planes.append((np.array([1.0, -1.0, 5.5]), np.array([1.8, 0, -0.4]),
                            np.array([0, 1.8, 0]), make_texture()))

    def render(self, cam, R: np.ndarray, t: np.ndarray, h: int = 480, w: int = 640):
        """(image [h,w] f32, depth [h,w] f32) at pose Tcw = (R, t)."""
        K = np.array([[float(cam.fx), 0, float(cam.cx)], [0, float(cam.fy), float(cam.cy)],
                      [0, 0, 1.0]], np.float64)
        img = np.full((h, w), 40.0, np.float32)
        depth = np.zeros((h, w), np.float32)
        order = sorted(((R @ (O + 0.5 * U + 0.5 * V) + t)[2], pi)
                       for pi, (O, U, V, _) in enumerate(self.planes))
        for _, pi in reversed(order):  # far to near
            O, U, V, T = self.planes[pi]
            th, tw = T.shape
            B = np.stack([U, V, O], axis=1)
            M = K @ np.hstack([R @ B[:, :2], (R @ B[:, 2] + t)[:, None]])
            H = M @ np.diag([1.0 / tw, 1.0 / th, 1.0])
            a, b, c = (R @ U)[2], (R @ V)[2], (R @ O + t)[2]
            ramp = np.fromfunction(
                lambda yy, xx: (a * (xx + 0.5) / tw + b * (yy + 0.5) / th + c).astype(np.float32),
                (th, tw))
            warped = warp_perspective(T, H, (w, h), -1.0)
            wz = warp_perspective(ramp, H, (w, h), -1.0)
            m = (warped >= 0) & (wz > 0.1)
            img[m] = warped[m]
            depth[m] = wz[m]
        return img, depth


def loop_trajectory(n_frames: int, extent: float = 1.8, step: float = 0.06):
    """Out-and-back sweep: x goes 0 -> extent -> 0 at constant heading."""
    xs, x, direction = [], 0.0, 1.0
    for _ in range(n_frames):
        xs.append(x)
        x += direction * step
        if x >= extent:
            direction = -1.0
        if x <= 0 and direction < 0:
            direction = 1.0
    R = np.eye(3, dtype=np.float32)
    return [(R, -R @ np.array([xk, 0.0, 0.0], np.float32)) for xk in xs]


class RoomScene(PlaneScene):
    """Four textured walls around the origin and a floor: a camera circling
    outward sees each wall in turn, so covisibility between a loop's start
    and end breaks until the loop closes."""

    def __init__(self, seed: int = 0, half: float = 6.0, tex_size: int = 768):
        rng = np.random.RandomState(seed)
        self.planes = []

        def make_texture():
            t = np.zeros((tex_size, tex_size), np.float32)
            for octave in range(2, 7):
                n = tex_size // (2 ** octave)
                layer = rng.rand(n, n).astype(np.float32) - 0.5
                layer = np.kron(layer, np.ones((2 ** octave, 2 ** octave), np.float32))
                t += layer * (1.4 ** octave)
            t = t[:tex_size, :tex_size]
            t = 120.0 + 60.0 * t / np.abs(t).max()
            return np.clip(t, 5, 250)

        h = half
        walls = [(np.array([-h, -4.0, h]), np.array([2 * h, 0, 0])),     # z = +h
                 (np.array([h, -4.0, h]), np.array([0, 0, -2 * h])),     # x = +h
                 (np.array([h, -4.0, -h]), np.array([-2 * h, 0, 0])),    # z = -h
                 (np.array([-h, -4.0, -h]), np.array([0, 0, 2 * h]))]    # x = -h
        V = np.array([0, 8.0, 0])
        for O, U in walls:
            self.planes.append((O, U, V, make_texture()))
        self.planes.append((np.array([-h, 2.0, h]), np.array([2 * h, 0, 0]),
                            np.array([0, 0, -2 * h]), make_texture()))            # floor


def circle_trajectory(n_frames: int, radius: float = 1.0, turns: float = 1.0):
    """Outward-facing camera on a circle (world->cam poses)."""
    poses = []
    for k in range(n_frames):
        a = 2.0 * np.pi * turns * k / n_frames
        sa, ca = np.sin(a), np.cos(a)
        p = np.array([radius * sa, 0.0, radius * ca], np.float32)
        R = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], np.float32)
        poses.append((R, -R @ p))
    return poses
