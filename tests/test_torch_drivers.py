"""The port's dataset drivers (orb_slam2_annotate_tpu_torch/drivers/) against
the JAX package's examples/, on the CPU: run_tum mono on a 16-frame 320x240
TUM fixture (written by tools/driver_fixtures.py: the port's renderer,
PNGs of numpy + zlib) and run_synthetic on 12 frames of its built-in
sequence, and run_tum once more as a user calls it.  (Six frames, as first
planned, end before either sequence's monocular initialization, at frames
12 and 8.)

Tolerances: both packages' trajectory files parse with the reference's
trajectory.load_tum; the port tracks as many frames as the reference, and
its Sim3-aligned ATE is within max(1.5 x, +0.01 m) of the reference
driver's on the same fixture (the System tests' bound).
"""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.io import native_loader as jnative
from orb_slam2_annotate_tpu.io import trajectory as jtraj
from orb_slam2_annotate_tpu_torch.drivers import run_synthetic, run_tum
from orb_slam2_annotate_tpu_torch.io import evaluation, synthetic

from test_drivers import SETTINGS_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import driver_fixtures as fx  # noqa: E402

torch.set_num_threads(1)
N = 16            # the TUM fixture's frames
N_SYNTHETIC = 12


def bound(ate_ref: float) -> float:
    return max(1.5 * ate_ref, ate_ref + 0.01)


def tum_ate(path, times, centres):
    """(Sim3-aligned ATE, rows) of a TUM trajectory file against the truth,
    read with the reference's load_tum."""
    ts, pos, q = jtraj.load_tum(path)
    assert np.allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-3)
    est, gt = fx.matched_centres(np.column_stack([ts, pos, q]), times, centres)
    assert len(est) == len(ts)
    return float(evaluation.ate_rmse(est, gt, with_scale=True)[0]), len(ts)


@pytest.fixture(scope="module")
def tum_fixture(tmp_path_factory):
    if not jnative.available():
        subprocess.run(["bash", os.path.join(REPO, "native", "build.sh")], check=True)
    root = tmp_path_factory.mktemp("tum")
    cam = fx.camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    poses, renders = fx.render_orbit(synthetic, N, cam)
    seq = fx.write_tum_mono(str(root), [fx.to_u8(img) for img, _ in renders])
    settings = fx.write_settings(str(root / "settings.yaml"), SETTINGS_YAML)
    centres = np.stack([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                        for R, t in poses])
    return settings, seq, [k / 30.0 for k in range(N)], centres


def _in_dir(path, fn):
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def test_run_tum_mono_matches_reference(tmp_path, tum_fixture, monkeypatch):
    settings, seq, times, centres = tum_fixture
    jax_main = runpy.run_path(os.path.join(REPO, "examples", "run_tum.py"),
                              run_name="jax_run_tum")["main"]
    monkeypatch.setattr(sys, "argv", ["run_tum.py", "mono", settings, seq])
    _in_dir(tmp_path / "jax", jax_main)
    out = _in_dir(tmp_path / "port",
                  lambda: run_tum.main(["mono", settings, seq, "--device", "cpu"]))
    ate_j, rows_j = tum_ate(str(tmp_path / "jax" / "CameraTrajectory.txt"), times, centres)
    ate_t, rows_t = tum_ate(str(tmp_path / "port" / "CameraTrajectory.txt"), times, centres)
    assert rows_t == rows_j == out["tracked"] >= 3
    assert ate_t <= bound(ate_j), (ate_t, ate_j)
    kf_j = jtraj.load_tum(str(tmp_path / "jax" / "KeyFrameTrajectory.txt"))[0]
    kf_t = jtraj.load_tum(str(tmp_path / "port" / "KeyFrameTrajectory.txt"))[0]
    assert len(kf_t) == len(kf_j) >= 2 and out["frames"] == N


def test_run_synthetic_matches_reference(tmp_path, monkeypatch):
    ns = runpy.run_path(os.path.join(REPO, "examples", "run_synthetic.py"),
                        run_name="jax_run_synthetic")
    # the reference writes its trajectory to /tmp: into tmp_path instead
    real_save = ns["trajectory"].save_tum
    monkeypatch.setattr(ns["trajectory"], "save_tum",
                        lambda path, poses: real_save(str(tmp_path / "jax_traj.txt"), poses))
    monkeypatch.setattr(sys, "argv", ["run_synthetic.py", str(N_SYNTHETIC)])
    ate_j, tracked_j = ns["main"](N_SYNTHETIC)
    out = _in_dir(tmp_path / "port",
                  lambda: run_synthetic.main([str(N_SYNTHETIC), "--device", "cpu"]))
    ts_j = jtraj.load_tum(str(tmp_path / "jax_traj.txt"))[0]
    ts_t = jtraj.load_tum(str(tmp_path / "port" / run_synthetic.TRAJECTORY_FILE))[0]
    assert len(ts_t) == out["tracked"] == tracked_j == len(ts_j) >= 3
    assert out["ate_m"] <= bound(float(ate_j)), (out["ate_m"], ate_j)


def test_run_tum_as_a_subprocess(tmp_path, tum_fixture):
    """`python -m ...drivers.run_tum`, from another directory."""
    settings, seq, times, centres = tum_fixture
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "orb_slam2_annotate_tpu_torch.drivers.run_tum",
                        "mono", settings, seq, "--device", "cpu"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "median tracking time" in r.stdout
    ate, rows = tum_ate(str(tmp_path / "CameraTrajectory.txt"), times, centres)
    assert rows >= 3 and ate < 0.08
