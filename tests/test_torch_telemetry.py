"""The port's utils/telemetry.py against the JAX package's, and
System.telemetry after a short run of the port's System.

Tolerances: report() is the reference's text character for character on
the same samples; StageStats' count, total, best, worst, mean and median
equal; a stage opens a profiler span of its name; after 14 frames of the
slice, frontend/extract counts every frame, tracking/step every call of
the tracking step, mapping/keyframe every keyframe made after
initialization, and the three are the only stages.
"""

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.utils import telemetry as jtel
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.io import synthetic as tsyn
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config
from orb_slam2_annotate_tpu_torch.pipeline import tracking as ttk
from orb_slam2_annotate_tpu_torch.utils import telemetry as ttel

torch.set_num_threads(1)

TCAM = TCam.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=4,
             init_min_matches=60)


def test_report_matches_reference():
    rng = np.random.RandomState(0)
    samples = {"frontend/extract": rng.uniform(1e-4, 5e-2, 37),
               "tracking/step": rng.uniform(1e-3, 0.3, 12),
               "a/very/long/stage/name/over/28/chars": [2.5, 0.001],
               "mapping/keyframe": [0.123456789]}
    ref, out = jtel.Telemetry(enable_jax_annotations=False), ttel.Telemetry()
    for name, dts in samples.items():
        for dt in dts:
            ref.stages[name].add(float(dt))
            out.stages[name].add(float(dt))
    assert out.report() == ref.report()
    for name in samples:
        a, b = ref.stages[name], out.stages[name]
        assert (a.count, a.total, a.best, a.worst, a.mean, a.median) == \
            (b.count, b.total, b.best, b.worst, b.mean, b.median)
    out.reset()
    assert out.report() == "" and ttel.StageStats().median == 0.0


def test_stage_times_and_annotates():
    tel = ttel.Telemetry()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tel.stage("unit/stage"):
                torch.ones(8).sum()
    assert tel.stages["unit/stage"].count == 3 and tel.stages["unit/stage"].total > 0
    assert any(e.name == "unit/stage" for e in prof.events())
    with pytest.raises(RuntimeError):
        with tel.stage("unit/raises"):
            raise RuntimeError("inside a stage")
    assert "unit/raises" not in tel.stages


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with ttel.profile_trace(str(tmp_path / "trace")):
        with ttel.Telemetry().stage("unit/traced"):
            torch.ones(4).cumsum(0)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "unit/traced" in text


def test_system_telemetry_has_its_stages(monkeypatch):
    calls = {"track_frame": 0}
    real = ttk.track_frame

    def counted(*a, **kw):
        calls["track_frame"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ttk, "track_frame", counted)
    slam = TSystem(TCAM, mono_slice_config(**SIZES), device="cpu")
    scene = tsyn.PlaneScene(seed=1)
    n = 14
    for k, (R, t) in enumerate(tsyn.orbit_trajectory(n, step=0.06)):
        slam.track_mono(scene.render(TCAM, R, t, h=240, w=320)[0], k / 30.0)
    st = slam.telemetry.stages
    assert set(st) == {"frontend/extract", "tracking/step", "mapping/keyframe"}
    assert st["frontend/extract"].count == n
    assert st["tracking/step"].count == calls["track_frame"] > 0
    # the two bootstrap keyframes are made by initialization, not the chain
    assert st["mapping/keyframe"].count == int(slam.map.n_kf) - 2 > 0
    for line, name in zip(slam.telemetry.report().splitlines(), sorted(st)):
        assert line.startswith(name) and f"n={st[name].count:5d}" in line
