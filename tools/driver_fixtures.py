"""On-disk dataset fixtures for the dataset drivers: TUM (mono and RGB-D),
KITTI and EuRoC (stereo) layouts, written with numpy and the standard
library only (no cv2, no matplotlib).

``chip_smoke.py`` (the port, on the card), ``tools/jax_io_reference.py``
(the JAX package, on the CPU) and ``tests/test_torch_drivers.py`` all write
their fixtures with this module, so both packages' drivers read the same
pixels: each caller renders the frames with its own package's
``io/synthetic`` module (the two renderers agree bit for bit) and passes it
in.  Distorted captures and the stereo rig's rectification are computed
here, in numpy.
"""

from __future__ import annotations

import os
import struct
import types
import zlib

import numpy as np

# the cells' camera: bench.py's VGA pinhole, and the distortion of
# tests/test_drivers.py's distorted mono fixture
VGA = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
K1, K2 = -0.15, 0.03
SCENE_SEED = 9
STEP = 0.06
EUROC_T0_NS = 1403636579763555584
EUROC_DT_NS = 50_000_000
# the EuRoC rig: radial distortion of each camera, the right camera 0.2 m to
# the right and yawed 0.6 degrees (x2 = R x1 + t)
EUROC_D_LEFT = (-0.15, 0.03, 0.0, 0.0, 0.0)
EUROC_D_RIGHT = (-0.12, 0.02, 0.0, 0.0, 0.0)
EUROC_ROTVEC = (0.0, 0.010, 0.002)
EUROC_BASELINE = 0.2


def png_bytes(img: np.ndarray) -> bytes:
    """A gray PNG of a uint8 (8-bit) or uint16 (16-bit) [H, W] array, every
    row with filter type 0."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"a 2-D uint8 or uint16 array, not {img.dtype} {img.shape}")
    h, w = img.shape
    bits = 8 * img.dtype.itemsize
    rows = img.astype(">u2") if bits == 16 else img
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8).reshape(h, -1)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def to_u8(img: np.ndarray) -> np.ndarray:
    """A rendered float image as the uint8 a camera stores (clipped, cut)."""
    return np.clip(img, 0, 255).astype(np.uint8)


def camera(**kw) -> types.SimpleNamespace:
    """A pinhole camera for the renderers (they read fx, fy, cx, cy)."""
    return types.SimpleNamespace(**{**VGA, **kw})


def render_orbit(synthetic, n: int, cam=None):
    """(ground-truth poses, float images) of n orbit frames of
    PlaneScene(SCENE_SEED), rendered by `synthetic` (either package's)."""
    cam = cam or camera()
    scene = synthetic.PlaneScene(seed=SCENE_SEED)
    poses = synthetic.orbit_trajectory(n, step=STEP)
    renders = [scene.render(cam, R, t, h=cam.height, w=cam.width) for R, t in poses]
    return poses, renders


def distorted_capture(img: np.ndarray, fx, fy, cx, cy, k1, k2, p1=0.0, p2=0.0, k3=0.0):
    """What a lens with this radial-tangential distortion captures of a
    pinhole image: raw(y) = pinhole(undistort(y)), bilinear, 0 outside
    (cv::remap with BORDER_CONSTANT); float32, the undistortion by 8
    fixed-point steps (cv::undistortPoints)."""
    h, w = img.shape
    f32 = np.float32
    u, v = np.meshgrid(np.arange(w, dtype=f32), np.arange(h, dtype=f32))
    xd, yd = (u - f32(cx)) / f32(fx), (v - f32(cy)) / f32(fy)
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        radial = f32(1.0) + r2 * (f32(k1) + r2 * (f32(k2) + r2 * f32(k3)))
        dx = f32(2.0 * p1) * x * y + f32(p2) * (r2 + f32(2.0) * x * x)
        dy = f32(p1) * (r2 + f32(2.0) * y * y) + f32(2.0 * p2) * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    sx, sy = x * f32(fx) + f32(cx), y * f32(fy) + f32(cy)
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    src = np.asarray(img, f32)

    def at(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(inb, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], f32(0.0))

    top = at(y0, x0) * (1 - ax) + at(y0, x0 + 1) * ax
    bot = at(y0 + 1, x0) * (1 - ax) + at(y0 + 1, x0 + 1) * ax
    return (top * (1 - ay) + bot * ay).astype(f32)


def rodrigues(w) -> np.ndarray:
    """so(3) exp of a rotation vector, float64."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def _rotvec(R: np.ndarray) -> np.ndarray:
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (0.5 if th < 1e-12 else th / (2 * np.sin(th)))


def euroc_rig(cam=None):
    """The EuRoC fixture's rig: (K, D_l, D_r, R_rel, t_rel, R1, R2, P1, P2, bf),
    the rectification by Bouguet's split of the relative rotation (both
    packages' stereo_rectify), in float64."""
    cam = cam or camera()
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    R_rel = rodrigues(EUROC_ROTVEC).astype(np.float32)
    t_rel = -R_rel @ np.array([EUROC_BASELINE, 0.0, 0.0], np.float32)
    R = R_rel.astype(np.float64)
    t = t_rel.astype(np.float64)
    r_half = rodrigues(-_rotvec(R) / 2)
    t_half = r_half @ t
    e1 = t_half / np.linalg.norm(t_half)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    e2 /= np.linalg.norm(e2)
    R_rect = np.stack([e1, e2, np.cross(e1, e2)])
    R2 = R_rect @ r_half
    R1 = R2 @ R
    f = K[1, 1]
    P1 = np.array([[f, 0, K[0, 2], 0], [0, f, K[1, 2], 0], [0, 0, 1, 0]], np.float64)
    P2 = P1.copy()
    P2[0, 3] = -f * np.linalg.norm(t)
    return (K, np.asarray(EUROC_D_LEFT), np.asarray(EUROC_D_RIGHT), R_rel, t_rel, R1, R2, P1,
            P2, float(f * np.linalg.norm(t)))


def settings_yaml(fx, fy, cx, cy, width, height, k1=0.0, k2=0.0, bf=0.0, fps=30.0,
                  n_features=1024, n_levels=8, extra: str = "") -> str:
    """A settings file in the reference's format (Examples/*/*.yaml)."""
    return (f"%YAML:1.0\n---\nCamera.fx: {fx:.6f}\nCamera.fy: {fy:.6f}\nCamera.cx: {cx:.6f}\n"
            f"Camera.cy: {cy:.6f}\nCamera.k1: {k1}\nCamera.k2: {k2}\nCamera.p1: 0.0\n"
            f"Camera.p2: 0.0\nCamera.k3: 0.0\nCamera.fps: {fps}\nCamera.bf: {bf:.6f}\n"
            f"Camera.RGB: 1\nCamera.width: {width}\nCamera.height: {height}\nThDepth: 100.0\n"
            f"DepthMapFactor: 5000.0\nORBextractor.nFeatures: {n_features}\n"
            f"ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: {n_levels}\n"
            f"ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n" + extra)


def matrix_yaml(name: str, M) -> str:
    """An ``!!opencv-matrix`` node, its data written ``data:[`` over lines
    of four, as the reference's Examples/Stereo/EuRoC.yaml writes it."""
    M = np.atleast_2d(np.asarray(M, np.float64))
    vals = [f"{v:.9f}" for v in M.reshape(-1)]
    lines = ",\n          ".join(", ".join(vals[i:i + 4]) for i in range(0, len(vals), 4))
    return (f"{name}: !!opencv-matrix\n   rows: {M.shape[0]}\n   cols: {M.shape[1]}\n"
            f"   dt: d\n   data:[{lines}]\n")


def write_settings(path: str, text: str) -> str:
    with open(path, "w") as f:
        f.write(text)
    return path


def write_tum_mono(root: str, images, rate: float = 30.0) -> str:
    """A TUM sequence (rgb/ and rgb.txt) of uint8 images; returns its dir."""
    seq = os.path.join(root, "tum_seq")
    os.makedirs(os.path.join(seq, "rgb"), exist_ok=True)
    with open(os.path.join(seq, "rgb.txt"), "w") as f:
        f.write("# color images\n")
        for k, img in enumerate(images):
            rel = f"rgb/{k:04d}.png"
            write_png(os.path.join(seq, rel), img)
            f.write(f"{k / rate:.6f} {rel}\n")
    return seq


def write_tum_rgbd(root: str, images, depths, factor: float = 5000.0, rate: float = 30.0):
    """A TUM RGB-D sequence: uint8 images, depth (metres, 0 = none) as 16-bit
    PNGs of depth x factor, and an association file.  Returns (dir, file)."""
    seq = os.path.join(root, "tum_rgbd")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    assoc = os.path.join(root, "associations.txt")
    with open(assoc, "w") as f:
        for k, (img, dep) in enumerate(zip(images, depths)):
            write_png(os.path.join(seq, "rgb", f"{k:04d}.png"), img)
            d16 = np.clip(np.round(np.asarray(dep, np.float64) * factor), 0, 65535)
            write_png(os.path.join(seq, "depth", f"{k:04d}.png"), d16.astype(np.uint16))
            ts = f"{k / rate:.6f}"
            f.write(f"{ts} rgb/{k:04d}.png {ts} depth/{k:04d}.png\n")
    return seq, assoc


def write_kitti_mono(root: str, images, rate: float = 10.0) -> str:
    """A KITTI odometry sequence (image_0/ and times.txt); returns its dir."""
    seq = os.path.join(root, "kitti_seq")
    os.makedirs(os.path.join(seq, "image_0"), exist_ok=True)
    for k, img in enumerate(images):
        write_png(os.path.join(seq, "image_0", f"{k:06d}.png"), img)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.write("".join(f"{k / rate:.6e}\n" for k in range(len(images))))
    return seq


def write_euroc_stereo(root: str, lefts, rights):
    """An EuRoC mav0 tree (cam0/, cam1/) and its timestamp list.  Returns
    (mav0 dir, timestamps file, timestamps in s)."""
    seq = os.path.join(root, "mav0")
    for cam_dir in ("cam0", "cam1"):
        os.makedirs(os.path.join(seq, cam_dir, "data"), exist_ok=True)
    names = [str(EUROC_T0_NS + k * EUROC_DT_NS) for k in range(len(lefts))]
    for ns, il, ir in zip(names, lefts, rights):
        write_png(os.path.join(seq, "cam0", "data", ns + ".png"), il)
        write_png(os.path.join(seq, "cam1", "data", ns + ".png"), ir)
    ts_file = os.path.join(root, "timestamps.txt")
    with open(ts_file, "w") as f:
        f.write("\n".join(names) + "\n")
    return seq, ts_file, [float(ns) * 1e-9 for ns in names]


def matched_centres(rows: np.ndarray, times, centres, tol: float = 1e-3):
    """(estimated, true) camera centres of the TUM rows [M, 8] whose
    timestamp is within `tol` of a frame's (`times`, `centres` [F, 3])."""
    times = np.asarray(times, np.float64)
    est, gt = [], []
    for r in np.atleast_2d(rows):
        i = int(np.argmin(np.abs(times - r[0])))
        if abs(times[i] - r[0]) < tol:
            est.append(r[1:4])
            gt.append(centres[i])
    return np.asarray(est, np.float64).reshape(-1, 3), np.asarray(gt, np.float64).reshape(-1, 3)


def build_cells(root: str, synthetic, n: int = 24):
    """Every driver cell's fixture under `root`, rendered at VGA by
    `synthetic`.  Returns {cell: dict(args=the driver's arguments after its
    module, times=[F], centres=[F, 3] true camera centres)}."""
    os.makedirs(root, exist_ok=True)
    cam = camera()
    poses, renders = render_orbit(synthetic, n, cam)
    times30 = [k / 30.0 for k in range(n)]
    centres = np.stack([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                        for R, t in poses])
    cells = {}

    plain = write_settings(os.path.join(root, "settings_vga.yaml"),
                           settings_yaml(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                         bf=cam.fx * 0.08))
    # TUM mono, captured through a distorting lens (k1, k2 in the settings)
    raw = [to_u8(distorted_capture(img, cam.fx, cam.fy, cam.cx, cam.cy, K1, K2))
           for img, _ in renders]
    dist = write_settings(os.path.join(root, "settings_distorted.yaml"),
                          settings_yaml(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                        k1=K1, k2=K2))
    cells["tum_mono"] = dict(args=["mono", dist, write_tum_mono(root, raw)], times=times30,
                             centres=centres)
    # TUM RGB-D: 16-bit depth at DepthMapFactor 5000
    seq, assoc = write_tum_rgbd(root, [to_u8(img) for img, _ in renders],
                                [dep for _, dep in renders])
    cells["tum_rgbd"] = dict(args=["rgbd", plain, seq, assoc], times=times30, centres=centres)
    # KITTI mono at 10 Hz
    cells["kitti_mono"] = dict(args=["mono", plain,
                                     write_kitti_mono(root, [to_u8(img) for img, _ in renders])],
                               times=[k / 10.0 for k in range(n)], centres=centres)
    # EuRoC stereo: raw distorted, yawed pairs and the LEFT./RIGHT. blocks
    K, D_l, D_r, R_rel, t_rel, R1, R2, P1, P2, bf = euroc_rig(cam)
    scene = synthetic.PlaneScene(seed=SCENE_SEED)
    lefts, rights = [], []
    for (R, t), (img, _) in zip(poses, renders):
        img_r, _ = scene.render(cam, R_rel @ R, R_rel @ t + t_rel, h=cam.height, w=cam.width)
        lefts.append(to_u8(distorted_capture(img, cam.fx, cam.fy, cam.cx, cam.cy, *D_l[:2])))
        rights.append(to_u8(distorted_capture(img_r, cam.fx, cam.fy, cam.cx, cam.cy, *D_r[:2])))
    blocks = (f"LEFT.height: {cam.height}\nLEFT.width: {cam.width}\n"
              + matrix_yaml("LEFT.K", K) + matrix_yaml("LEFT.D", D_l) + matrix_yaml("LEFT.R", R1)
              + matrix_yaml("LEFT.P", P1) + matrix_yaml("RIGHT.K", K)
              + matrix_yaml("RIGHT.D", D_r) + matrix_yaml("RIGHT.R", R2)
              + matrix_yaml("RIGHT.P", P2))
    stereo = write_settings(os.path.join(root, "settings_euroc.yaml"),
                            settings_yaml(P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2], cam.width,
                                          cam.height, bf=bf, fps=20.0, extra=blocks))
    mav0, ts_file, times = write_euroc_stereo(root, lefts, rights)
    cells["euroc_stereo"] = dict(args=["stereo", stereo, mav0, ts_file], times=times,
                                 centres=centres)
    return cells
