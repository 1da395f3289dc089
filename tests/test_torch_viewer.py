"""The port's viz/viewer.py (the counterpart of tests/test_viewer.py) on the
port's System, headless with matplotlib's Agg backend: the interactive
viewer draws every `every` frames and saves a figure; its keys reach the
System (localization mode, reset) and flip its toggles; draw_frame and
draw_map save figures of the port's tensors; the covisibility edges it
draws are the pairs the reference's viewer draws on the same map.
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam2_annotate_tpu.worldmap import map_state as jms  # noqa: E402
from orb_slam2_annotate_tpu_torch import convert  # noqa: E402
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam  # noqa: E402
from orb_slam2_annotate_tpu_torch.io import synthetic as tsyn  # noqa: E402
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig, System  # noqa: E402
from orb_slam2_annotate_tpu_torch.viz import viewer  # noqa: E402

torch.set_num_threads(1)

TCAM = TCam.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)


class Ev:
    def __init__(self, key):
        self.key = key


def test_interactive_viewer_updates_headless(tmp_path):
    cfg = SlamConfig(n_features=256, n_levels=3, max_kf=16, max_mp=4096, init_min_matches=50,
                     enable_loop_closing=False)
    slam = System(TCAM, cfg, device="cpu")
    view = viewer.InteractiveViewer(slam, every=2)
    scene = tsyn.PlaneScene(seed=1)
    poses = tsyn.orbit_trajectory(6, step=0.06)
    drawn = 0
    for k, (R, t) in enumerate(poses):
        img = np.clip(scene.render(TCAM, R, t, h=240, w=320)[0], 0, 255).astype(np.uint8)
        slam.track_mono(img, k / 30.0)
        if view.update(image=img, frame=slam.last_frame, obs=slam.last_obs,
                       force=(k == len(poses) - 1)):
            drawn += 1
    assert drawn >= 2
    view.savefig(str(tmp_path / "view.png"))
    assert (tmp_path / "view.png").stat().st_size > 1000
    # the map panel's title counts the System's points and keyframes
    assert view.ax_map.get_title() == f"{slam.n_mappoints} pts / {slam.n_keyframes} KFs"
    # menu semantics: localization toggle reaches the System; reset works
    view._on_key(Ev("l"))
    assert view.localization_mode and slam._localization_only
    view._on_key(Ev("l"))
    assert not view.localization_mode and not slam._localization_only
    for key, attr in (("f", "follow"), ("p", "show_points"), ("k", "show_keyframes"),
                      ("g", "show_graph")):
        before = getattr(view, attr)
        view._on_key(Ev(key))
        assert getattr(view, attr) is not before
    view._on_key(Ev("r"))
    assert slam.n_keyframes == 0
    view._on_key(Ev("q"))
    assert view.closed and not view.update(force=True)
    view.close()


def test_draw_frame_and_map_save_figures(tmp_path):
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=16, max_mp=4096, init_min_matches=60,
                     max_frames_between_kf=4, enable_loop_closing=False)
    slam = System(TCAM, cfg, device="cpu")
    scene = tsyn.PlaneScene(seed=1)
    for k, (R, t) in enumerate(tsyn.orbit_trajectory(16, step=0.06)):
        img = np.clip(scene.render(TCAM, R, t, h=240, w=320)[0], 0, 255).astype(np.uint8)
        slam.track_mono(img, k / 30.0)
    assert slam.n_keyframes >= 3
    p = viewer.draw_frame(img, slam.last_frame, slam.last_obs, path=str(tmp_path / "f.png"))
    assert (tmp_path / "f.png").stat().st_size > 1000 and p == str(tmp_path / "f.png")
    traj = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in slam.frame_trajectory() if T is not None])
    viewer.draw_map(slam.map, trajectory=traj, path=str(tmp_path / "m.png"))
    assert (tmp_path / "m.png").stat().st_size > 1000
    fig = viewer.draw_map(slam.map)
    assert fig.axes[0].get_title() == f"{slam.n_mappoints} map points / {slam.n_keyframes} keyframes"
    # the covisibility edges drawn are the reference viewer's pairs (W >= 15)
    centers = viewer._kf_centers(slam.map)
    W = np.asarray(jms.covisibility(jms.MapState(**convert.map_state_to_numpy(slam.map))))
    ref_pairs = [(a, b) for a in centers for b in centers if a < b and W[a, b] >= 15]
    assert len(viewer._covis_edges(slam.map, centers)) == len(ref_pairs) > 0
