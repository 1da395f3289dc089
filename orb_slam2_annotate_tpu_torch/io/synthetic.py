"""Synthetic sequences with exact ground truth, numpy only.

A copy of orb_slam2_annotate_tpu/io/synthetic.py (BlobScene, PlaneScene,
RoomScene, StructuredScene and make_structured_texture; orbit, loop,
circle and multi-loop trajectories; true_correspondence;
render_frames_cached): importing the reference package would import jax,
and the machines that run the port need not have OpenCV.  ``warp_perspective`` therefore reimplements the
arithmetic of ``cv2.warpPerspective(INTER_LINEAR, BORDER_CONSTANT)`` as
OpenCV 5 evaluates it for float32 images: float32 coefficients of the
inverse map, a per-row constant, one fused multiply-add per coordinate, a
float32 division, and fused multiply-add lerps.  tests/test_torch_system.py
and tests/test_torch_trainers.py check that frames are bit-identical to the
reference renderer's.
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


class BlobScene:
    """A cloud of Gaussian blobs at varied depths, each with a world-fixed
    asymmetric lobe (so its intensity-centroid angle is view-consistent),
    rendered far to near with exact depth."""

    def __init__(self, n_blobs: int = 1500, seed: int = 0,
                 extent=((-4.0, 4.0), (-3.0, 3.0), (4.0, 12.0))):
        rng = np.random.RandomState(seed)
        lo = np.array([e[0] for e in extent])
        hi = np.array([e[1] for e in extent])
        self.pts = rng.uniform(lo, hi, (n_blobs, 3)).astype(np.float32)
        self.amp = rng.uniform(60, 200, n_blobs).astype(np.float32)
        self.sign = np.where(rng.rand(n_blobs) > 0.3, 1.0, -1.0).astype(np.float32)
        # mostly sharp dots (1-3 px at typical depth) and a few broad patches
        sharp = rng.uniform(0.06, 0.30, n_blobs)
        broad = rng.uniform(1.0, 2.5, n_blobs)
        self.size = np.where(rng.rand(n_blobs) < 0.9, sharp, broad).astype(np.float32)
        d = np.random.RandomState(12345).randn(n_blobs, 3).astype(np.float32)
        self._lobe = d / np.linalg.norm(d, axis=1, keepdims=True)

    def render(self, cam, R: np.ndarray, t: np.ndarray, h: int = 480, w: int = 640,
               background: float = 90.0):
        """(image [h,w] f32, depth [h,w] f32) at pose Tcw = (R, t)."""
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        xc = self.pts @ R.T + t
        z = xc[:, 2]
        vis = z > 0.5
        u = fx * xc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * xc[:, 1] / np.maximum(z, 1e-6) + cy
        sigma_px = self.size * fx / np.maximum(z, 1e-6) / 8.0
        img = np.full((h, w), background, np.float32)
        img += np.linspace(0, 15, w, dtype=np.float32)[None, :]
        img += np.linspace(0, 10, h, dtype=np.float32)[:, None]
        depth = np.full((h, w), 0.0, np.float32)
        lc = (self.pts + self._lobe * (self.size[:, None] * 1.5)) @ R.T + t
        lz = np.maximum(lc[:, 2], 1e-6)
        lu = fx * lc[:, 0] / lz + cx
        lv = fy * lc[:, 1] / lz + cy
        for i in np.argsort(-z):  # far to near, so near blobs overwrite depth
            if not vis[i]:
                continue
            s = max(float(sigma_px[i]), 0.8)
            rad = int(3 * s + 1) + int(abs(lu[i] - u[i]) + abs(lv[i] - v[i]) + 2)
            ui, vi = int(round(u[i])), int(round(v[i]))
            if ui < -rad or ui >= w + rad or vi < -rad or vi >= h + rad:
                continue
            x0, x1 = max(ui - rad, 0), min(ui + rad + 1, w)
            y0, y1 = max(vi - rad, 0), min(vi + rad + 1, h)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1, dtype=np.float32) - u[i]
            ys = np.arange(y0, y1, dtype=np.float32) - v[i]
            g = np.exp(-(ys[:, None] ** 2 + xs[None, :] ** 2) / (2 * s * s))
            xs2 = np.arange(x0, x1, dtype=np.float32) - lu[i]
            ys2 = np.arange(y0, y1, dtype=np.float32) - lv[i]
            g2 = np.exp(-(ys2[:, None] ** 2 + xs2[None, :] ** 2) / (2 * s * s * 1.5))
            img[y0:y1, x0:x1] += self.sign[i] * self.amp[i] * (g + 0.55 * g2)
            m = g > 0.3
            depth[y0:y1, x0:x1][m] = z[i]
        return np.clip(img, 0, 255), depth


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


def true_correspondence(cam, Ra, ta, Rb, tb, depth_a, xy_a):
    """Pixels xy_a [N,2] of view A mapped into view B through A's depth
    map: (xy_b [N,2] f32, valid [N])."""
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    h, w = depth_a.shape
    xi = np.clip(np.round(xy_a[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(xy_a[:, 1]).astype(int), 0, h - 1)
    z = depth_a[yi, xi]
    ok = z > 0
    xc = np.stack([(xy_a[:, 0] - cx) / fx * z, (xy_a[:, 1] - cy) / fy * z, z], 1)
    xw = (xc - ta) @ Ra  # Ra^T (xc - ta)
    xb = xw @ Rb.T + tb
    zb = np.maximum(xb[:, 2], 1e-6)
    xy_b = np.stack([fx * xb[:, 0] / zb + cx, fy * xb[:, 1] / zb + cy], 1)
    ok &= xb[:, 2] > 0.1
    return xy_b.astype(np.float32), ok


def make_structured_texture(rng: np.random.RandomState, tex_size: int = 768) -> np.ndarray:
    """Shape-rich texture: overlapping rectangles, circles and stripe bands
    on a smooth gradient (repeated high-contrast structure, which starves
    descriptor matching where the noise textures are unique)."""
    t = np.zeros((tex_size, tex_size), np.float32)
    yy, xx = np.mgrid[0:tex_size, 0:tex_size].astype(np.float32)
    t += 40.0 + 30.0 * (xx / tex_size) + 20.0 * (yy / tex_size)
    for _ in range(60):
        x0, y0 = rng.randint(0, tex_size - 40, 2)
        w, h = rng.randint(20, 160, 2)
        shade = rng.uniform(30, 230)
        t[y0:y0 + h, x0:x0 + w] = 0.35 * t[y0:y0 + h, x0:x0 + w] + 0.65 * shade
    for _ in range(30):
        cx, cy = rng.randint(40, tex_size - 40, 2)
        r = rng.randint(10, 60)
        shade = rng.uniform(30, 230)
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        t[mask] = 0.3 * t[mask] + 0.7 * shade
    for _ in range(6):
        y0 = rng.randint(0, tex_size - 30)
        h = rng.randint(8, 24)
        period = rng.randint(16, 48)
        shade = rng.uniform(40, 220)
        stripes = ((xx[y0:y0 + h] // period) % 2).astype(np.float32)
        t[y0:y0 + h] = np.where(stripes > 0, shade, t[y0:y0 + h])
    return np.clip(t, 5, 250)


class StructuredScene(PlaneScene):
    """PlaneScene's geometry with shape-rich textures (make_structured_texture)."""

    def __init__(self, seed: int = 0, tex_size: int = 768):
        rng = np.random.RandomState(seed)
        geometry = [(np.array([-6.0, -4.0, 9.0]), np.array([12.0, 0, 0]), np.array([0, 8.0, 0])),
                    (np.array([-6.0, 2.0, 9.5]), np.array([12.0, 0, 0]), np.array([0, 0.0, -8.0])),
                    (np.array([-2.5, -1.5, 6.5]), np.array([2.0, 0, 0.3]), np.array([0, 2.0, 0])),
                    (np.array([1.0, -1.0, 5.5]), np.array([1.8, 0, -0.4]), np.array([0, 1.8, 0]))]
        self.planes = [(O, U, V, make_structured_texture(rng, tex_size)) for O, U, V in geometry]


def multi_loop_trajectory(n_frames: int, laps: float = 3.1, r0: float = 1.5, dr: float = 0.35):
    """Outward-facing spiral: `laps` revolutions, the radius growing `dr` a
    lap (world->cam poses); each revolution revisits the same walls."""
    poses = []
    for k in range(n_frames):
        frac = laps * k / n_frames
        a = 2.0 * np.pi * frac
        r = r0 + dr * frac
        sa, ca = np.sin(a), np.cos(a)
        p = np.array([r * sa, 0.0, r * ca], np.float32)
        R = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], np.float32)
        poses.append((R, -R @ p))
    return poses


def render_frames_cached(scene, cam, poses, h: int, w: int, scene_key: str,
                         with_depth: bool = False, cache_dir: str | None = None,
                         n_workers: int = 2, verbose: bool = False):
    """Render a pose sequence, memoized on disk as one uint8 .npy (and
    float16 depth) keyed by the scene key, camera, size and poses; the
    cache directory is `cache_dir`, else $ORBTPU_RENDER_CACHE, else
    orbtpu_render_cache under the temporary directory.
    Returns (frames [F,h,w] uint8, depth [F,h,w] float32 | None)."""
    import hashlib
    import os
    import sys
    import tempfile
    import time
    from concurrent.futures import ThreadPoolExecutor

    cache_dir = cache_dir or os.environ.get(
        "ORBTPU_RENDER_CACHE", os.path.join(tempfile.gettempdir(), "orbtpu_render_cache"))
    pose_bytes = np.ascontiguousarray(
        np.stack([np.hstack([R.reshape(-1), t.reshape(-1)]) for R, t in poses])
        .astype(np.float32)).tobytes()
    cam_sig = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    key = hashlib.sha1(f"{scene_key}|{cam_sig}|{h}x{w}|d{int(with_depth)}|".encode()
                       + pose_bytes).hexdigest()[:16]
    base = os.path.join(cache_dir, key)
    try:
        img = np.load(base + "_img.npy")
        dep = np.load(base + "_dep.npy").astype(np.float32) if with_depth else None
        if img.shape == (len(poses), h, w):
            return img, dep
    except (OSError, ValueError):
        pass
    t0 = time.perf_counter()

    def one(args):
        R, t = args
        im, dp = scene.render(cam, R, t, h=h, w=w)
        return (np.clip(im, 0, 255).astype(np.uint8),
                dp.astype(np.float16) if with_depth else None)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        rendered = list(ex.map(one, poses))
    img = np.stack([r[0] for r in rendered])
    dep16 = np.stack([r[1] for r in rendered]) if with_depth else None
    if verbose:
        print(f"render_frames_cached: {len(poses)} frames in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(base + "_img.npy", img)
        if with_depth:
            np.save(base + "_dep.npy", dep16)
    except OSError:  # the cache is best-effort
        pass
    return img, dep16.astype(np.float32) if with_depth else None
