"""Dataset readers for TUM RGB-D, KITTI odometry and EuRoC MAV sequences
(port of io/datasets.py).

Each reader returns the samples of a sequence, (timestamp, image paths...),
in the layouts the reference's example drivers read
(Examples/Monocular/mono_tum.cc:36-48 LoadImages, mono_kitti.cc,
mono_euroc.cc, stereo_*.cc, rgbd_tum.cc); RGB-D association files follow
TUM's ``associate.py`` format.  Images are decoded by the port's native
loader only (``io/native_loader.py``): the JAX package tries cv2 first and
matplotlib last, and the port has neither.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import native_loader


def load_image_gray(path: str) -> np.ndarray:
    """A PNG / PGM as grayscale float32 [H, W] (a 16-bit image, such as a TUM
    depth map, as its raw values)."""
    return native_loader.decode(path)


@dataclasses.dataclass
class MonoSample:
    timestamp: float
    image_path: str


@dataclasses.dataclass
class StereoSample:
    timestamp: float
    left_path: str
    right_path: str


@dataclasses.dataclass
class RGBDSample:
    timestamp: float
    rgb_path: str
    depth_path: str


def _data_lines(path: str):
    """The stripped lines of a text file, without blanks and `#` comments."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_tum_mono(seq_dir: str) -> list[MonoSample]:
    """A TUM sequence directory with rgb.txt (mono_tum.cc LoadImages)."""
    out = []
    for line in _data_lines(os.path.join(seq_dir, "rgb.txt")):
        ts, rel = line.split()[:2]
        out.append(MonoSample(float(ts), os.path.join(seq_dir, rel)))
    return out


def read_tum_rgbd(seq_dir: str, assoc_path: str) -> list[RGBDSample]:
    """An association file of `ts_rgb rgb ts_depth depth` lines
    (rgbd_tum.cc:91-114)."""
    out = []
    for line in _data_lines(assoc_path):
        p = line.split()
        out.append(RGBDSample(float(p[0]), os.path.join(seq_dir, p[1]),
                              os.path.join(seq_dir, p[3])))
    return out


def read_kitti_stereo(seq_dir: str) -> list[StereoSample]:
    """A KITTI odometry sequence directory: times.txt, image_0/ and image_1/
    (stereo_kitti.cc LoadImages)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    return [StereoSample(ts, os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
                         os.path.join(seq_dir, "image_1", f"{i:06d}.png"))
            for i, ts in enumerate(times)]


def read_kitti_mono(seq_dir: str) -> list[MonoSample]:
    """The left camera of a KITTI sequence (mono_kitti.cc LoadImages)."""
    return [MonoSample(s.timestamp, s.left_path) for s in read_kitti_stereo(seq_dir)]


def read_euroc_stereo(seq_dir: str, ts_file: str) -> list[StereoSample]:
    """An EuRoC mav0 directory and a list of nanosecond timestamps
    (stereo_euroc.cc LoadImages)."""
    return [StereoSample(float(ts) * 1e-9, os.path.join(seq_dir, "cam0", "data", ts + ".png"),
                         os.path.join(seq_dir, "cam1", "data", ts + ".png"))
            for ts in _data_lines(ts_file)]


def read_euroc_mono(seq_dir: str, ts_file: str) -> list[MonoSample]:
    """cam0 of an EuRoC sequence (mono_euroc.cc LoadImages)."""
    return [MonoSample(s.timestamp, s.left_path) for s in read_euroc_stereo(seq_dir, ts_file)]


def load_tum_groundtruth(path: str):
    """groundtruth.txt, `ts tx ty tz qx qy qz qw` (world <- camera) a line:
    (timestamps [N], positions [N,3], quaternions [N,4])."""
    arr = np.asarray([[float(v) for v in line.split()] for line in _data_lines(path)])
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]
