"""The port's trajectory, settings and dataset readers and its native image
loader (io/trajectory.py, io/config.py, io/datasets.py,
io/native_loader.py) against the JAX package's.

Tolerances: save_kitti, load_tum and every timestamp and position of
save_tum give the same text; a quaternion component may differ by 1 in the
7th decimal (rot_to_quat's float32 rounds apart).  The settings parse gives
the dict PyYAML gives the JAX loader, value for value and type for type, on
tests/test_drivers.py's settings texts and on an EuRoC-style
``data:[`` block spread over lines; load_settings gives the same camera,
SlamConfig and stream settings; the rectification maps agree within 1e-3
px.  The dataset readers give the same samples.  The port's loader,
compiled from native/loader.cpp into the port's _build/, decodes exactly
what the JAX package's native loader decodes (8-bit gray, 16-bit, RGB PNG
and PGM) and exactly cv2's gray.
"""

import dataclasses
import os
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import lie as jlie
from orb_slam2_annotate_tpu.io import config as jconfig
from orb_slam2_annotate_tpu.io import datasets as jdatasets
from orb_slam2_annotate_tpu.io import native_loader as jnative
from orb_slam2_annotate_tpu.io import trajectory as jtraj
from orb_slam2_annotate_tpu_torch.io import config as tconfig
from orb_slam2_annotate_tpu_torch.io import datasets as tdatasets
from orb_slam2_annotate_tpu_torch.io import native_loader as tnative
from orb_slam2_annotate_tpu_torch.io import trajectory as ttraj
from orb_slam2_annotate_tpu_torch.kernels import _build

from test_drivers import DISTORT_YAML, SETTINGS_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import driver_fixtures as fx  # noqa: E402

torch.set_num_threads(1)


def random_poses(n=12, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32))))
        T[:3, 3] = rng.randn(3).astype(np.float32)
        out.append(None if k == 3 else T)
    return out


def test_save_tum_matches_reference(tmp_path):
    stamped = [(k / 30.0, T) for k, T in enumerate(random_poses())]
    jtraj.save_tum(str(tmp_path / "j.txt"), stamped)
    ttraj.save_tum(str(tmp_path / "t.txt"), stamped)
    a = open(tmp_path / "j.txt").read().split("\n")
    b = open(tmp_path / "t.txt").read().split("\n")
    assert len(a) == len(b) == 12        # 11 poses, one None, the final newline
    for la, lb in zip(a, b):
        ta, tb = la.split(), lb.split()
        assert ta[:4] == tb[:4]
        # the same quaternion sign, and at most 1 in the 7th decimal apart
        assert np.abs(np.asarray(ta[4:], float) - np.asarray(tb[4:], float)).max(initial=0) \
            <= 1.0000001e-7
    ts_j, pos_j, q_j = jtraj.load_tum(str(tmp_path / "j.txt"))
    ts_t, pos_t, q_t = ttraj.load_tum(str(tmp_path / "j.txt"))
    for x, y in ((ts_j, ts_t), (pos_j, pos_t), (q_j, q_t)):
        np.testing.assert_array_equal(x, y)


def test_save_kitti_matches_reference(tmp_path):
    poses = random_poses(seed=1)
    jtraj.save_kitti(str(tmp_path / "j.txt"), poses)
    ttraj.save_kitti(str(tmp_path / "t.txt"), poses)
    assert open(tmp_path / "j.txt").read() == open(tmp_path / "t.txt").read()


def _mat_yaml(name, M):
    """tests/test_drivers.py's matrix writer: `data: [...]` on one line."""
    M = np.asarray(M, np.float64)
    rows, cols = M.shape
    data = ", ".join(f"{v:.9f}" for v in M.reshape(-1))
    return f"{name}:\n   rows: {rows}\n   cols: {cols}\n   dt: d\n   data: [{data}]\n"


def _rig_blocks(writer):
    K, D_l, D_r, _, _, R1, R2, P1, P2, _ = fx.euroc_rig()
    return ("LEFT.height: 480\nLEFT.width: 640\n"
            + "".join(writer(n, M) for n, M in (
                ("LEFT.K", K), ("LEFT.D", np.atleast_2d(D_l)), ("LEFT.R", R1), ("LEFT.P", P1),
                ("RIGHT.K", K), ("RIGHT.D", np.atleast_2d(D_r)), ("RIGHT.R", R2),
                ("RIGHT.P", P2))))


SETTINGS = {
    "plain": SETTINGS_YAML,
    "distorted": DISTORT_YAML,
    # test_drivers.py's stereo text: the rig blocks as that test writes them
    "stereo_rig": SETTINGS_YAML.replace("Camera.width: 320\nCamera.height: 240\n", "")
                  + _rig_blocks(_mat_yaml),
    # the reference's EuRoC.yaml style: `data:[` with no space, over lines
    "euroc_style": fx.settings_yaml(500.0, 500.0, 320.0, 240.0, 640, 480, bf=100.0,
                                    extra=_rig_blocks(fx.matrix_yaml)),
}


def _typed(v):
    """A parsed value with its types spelled out, for an exact comparison."""
    if isinstance(v, dict):
        return {k: _typed(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_typed(x) for x in v]
    return (type(v).__name__, v)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_settings_match_reference(tmp_path, name):
    path = str(tmp_path / "settings.yaml")
    with open(path, "w") as f:
        f.write(SETTINGS[name])
    assert _typed(tconfig.load_opencv_yaml(path)) == _typed(jconfig.load_opencv_yaml(path))
    sensor = "stereo" if "rig" in name or "euroc" in name else "mono"
    js, ts = jconfig.load_settings(path, sensor=sensor), tconfig.load_settings(path, sensor=sensor)
    for f in dataclasses.fields(ts.cam):
        assert float(getattr(ts.cam, f.name)) == float(getattr(js.cam, f.name)), f.name
    assert dataclasses.asdict(ts.slam) == dataclasses.asdict(js.slam)
    assert (ts.fps, ts.rgb_order, ts.depth_map_factor) == (js.fps, js.rgb_order,
                                                           js.depth_map_factor)
    jr = jconfig.load_stereo_rectification(path)
    tr = tconfig.load_stereo_rectification(path, device="cpu")
    assert (jr is None) == (tr is None) == (sensor == "mono")
    if tr is not None:
        for a, b in ((jr.map_l, tr.map_l), (jr.map_r, tr.map_r)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-3)
        assert dataclasses.astuple(tr.cam) == tuple(float(v) for v in jr.cam)


def test_settings_parse_rejects_bad_lines():
    with pytest.raises(ValueError, match="unterminated list"):
        tconfig.parse_opencv_yaml("a:\n   data: [1, 2,\n")
    with pytest.raises(ValueError, match="key: value"):
        tconfig.parse_opencv_yaml("just text\n")


def test_dataset_readers_match_reference(tmp_path):
    img = np.zeros((8, 8), np.uint8)
    tum = fx.write_tum_mono(str(tmp_path), [img] * 3)
    with open(os.path.join(tum, "rgb.txt"), "a") as f:
        f.write("\n# a trailing comment\n")
    seq, assoc = fx.write_tum_rgbd(str(tmp_path), [img] * 3, [img.astype(np.float32)] * 3)
    kitti = fx.write_kitti_mono(str(tmp_path), [img] * 3)
    mav0, ts_file, _ = fx.write_euroc_stereo(str(tmp_path), [img] * 3, [img] * 3)
    gt = str(tmp_path / "groundtruth.txt")
    with open(gt, "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n0.0 1 2 3 0 0 0 1\n\n0.5 4 5 6 0 0 1 0\n")
    as_tuples = lambda xs: [dataclasses.astuple(x) for x in xs]
    for jf, tf, args in (("read_tum_mono", "read_tum_mono", (tum,)),
                         ("read_tum_rgbd", "read_tum_rgbd", (seq, assoc)),
                         ("read_kitti_mono", "read_kitti_mono", (kitti,)),
                         ("read_kitti_stereo", "read_kitti_stereo", (kitti,)),
                         ("read_euroc_mono", "read_euroc_mono", (mav0, ts_file)),
                         ("read_euroc_stereo", "read_euroc_stereo", (mav0, ts_file))):
        a, b = getattr(jdatasets, jf)(*args), getattr(tdatasets, tf)(*args)
        assert len(a) == 3 and as_tuples(a) == as_tuples(b), jf
    for x, y in zip(jdatasets.load_tum_groundtruth(gt), tdatasets.load_tum_groundtruth(gt)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def jax_loader():
    """The JAX package's native loader, built as its own tests build it."""
    if not jnative.available():
        subprocess.run(["bash", os.path.join(REPO, "native", "build.sh")], check=True)
    assert jnative.available()


def _image(kind, path):
    rng = np.random.RandomState(len(kind))
    if kind == "gray8":
        img = (rng.rand(60, 80) * 255).astype(np.uint8)
        cv2.imwrite(path + ".png", img)
    elif kind == "gray16":
        img = (rng.rand(50, 70) * 50000).astype(np.uint16)
        cv2.imwrite(path + ".png", img)
    elif kind == "rgb":
        img = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
        cv2.imwrite(path + ".png", img)
    else:
        img = (rng.rand(40, 50) * 255).astype(np.uint8)
        with open(path + ".pgm", "wb") as f:
            f.write(b"P5\n50 40\n255\n" + img.tobytes())
        return path + ".pgm", img
    return path + ".png", img


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb", "pgm"])
def test_decode_matches_reference(tmp_path, jax_loader, kind):
    path, img = _image(kind, str(tmp_path / kind))
    out = tnative.decode(path)
    np.testing.assert_array_equal(out, jnative.decode(path))
    assert out.dtype == np.float32 and out.shape == img.shape[:2]
    if kind != "rgb":
        # gray and 16-bit values come back as stored, as cv2 reads them
        np.testing.assert_array_equal(out, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(tdatasets.load_image_gray(path), out)
    assert os.path.dirname(_build._LIBS["host_loader"]._name) == _build.BUILD_DIR


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_fixture_png_writer_round_trips(tmp_path, dtype):
    img = (np.random.RandomState(4).rand(9, 13) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "x.png")
    fx.write_png(path, img)
    np.testing.assert_array_equal(tnative.decode(path), img.astype(np.float32))
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_prefetch_loader_in_order(tmp_path):
    imgs = [(np.random.RandomState(i).rand(30, 40) * 255).astype(np.uint8) for i in range(8)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"f{i}.png"))
        fx.write_png(paths[-1], img)
    with tnative.PrefetchLoader(paths, n_threads=2, ahead=2) as loader:
        assert len(loader) == 8
        for i in (0, 1, 3):
            np.testing.assert_array_equal(loader[i], imgs[i].astype(np.float32))
        with pytest.raises(ValueError, match="out of order"):
            loader[2]               # already passed: its buffer is freed
        with pytest.raises(ValueError, match="out of order"):
            loader[6]               # beyond the decode window
        np.testing.assert_array_equal(loader[5], imgs[5].astype(np.float32))
        with pytest.raises(IndexError):
            loader[8]
    with pytest.raises(ValueError, match="closed"):
        loader[6]


def test_decode_error_raises(tmp_path):
    p = str(tmp_path / "garbage.png")
    with open(p, "wb") as f:
        f.write(b"not an image at all")
    with pytest.raises(IOError):
        tnative.decode(p)
    with tnative.PrefetchLoader([p]) as loader:
        with pytest.raises(IOError, match="decode failed"):
            loader[0]
