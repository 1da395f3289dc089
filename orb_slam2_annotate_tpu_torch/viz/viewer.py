"""Host-side visualization (port of viz/viewer.py): the FrameDrawer and
MapDrawer panels and an interactive two-panel viewer, in matplotlib.

The viewer works on the host: it reads the map's and the frame's tensors
with ``.cpu().numpy()`` whenever it draws, and the covisibility graph with
``map_state.covisibility``.  matplotlib is imported inside the functions,
so the package imports without it.  The GPU machine this port is checked on
has no matplotlib, so ``chip_smoke.py`` does not drive the viewer; the CPU
tests draw it headless (Agg).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def draw_frame_into(ax, image, frame, obs, extra_title: str = ""):
    """Render the FrameDrawer panel into an existing axes (shared by
    draw_frame and InteractiveViewer)."""
    if image is not None:
        ax.imshow(_np(image), cmap="gray", vmin=0, vmax=255)
    if frame is not None:
        xy = _np(frame.xy_raw)
        v = _np(frame.valid)
        tracked = (_np(obs) >= 0) if obs is not None else np.zeros(len(xy), bool)
        ax.scatter(xy[v & ~tracked, 0], xy[v & ~tracked, 1], s=6,
                   facecolors="none", edgecolors="#ffcc00", linewidths=0.5)
        ax.scatter(xy[v & tracked, 0], xy[v & tracked, 1], s=10,
                   facecolors="none", edgecolors="#00dd44", linewidths=0.9)
        ax.set_title(f"{int((v & tracked).sum())} tracked / "
                     f"{int(v.sum())} features" + extra_title)
    ax.axis("off")


def draw_frame(image, frame, obs, path: str | None = None):
    """FrameDrawer::DrawFrame analog: keypoints over the image, tracked map
    points green, untracked features faint.  Saves to `path` and returns
    it, or returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    draw_frame_into(ax, image, frame, obs)
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def _kf_centers(m) -> dict:
    """Camera centres of the valid keyframes, by slot."""
    kf_R, kf_t = _np(m.kf_R), _np(m.kf_t)
    return {s: -kf_R[s].T @ kf_t[s] for s in np.nonzero(_np(m.kf_valid))[0]}


def _covis_edges(m, centers: dict):
    """Pairs of keyframe centres with >= 15 shared points (the reference's
    covisibility-graph threshold for drawing)."""
    from ..worldmap import map_state as ms

    W = _np(ms.covisibility(m))
    ks = list(centers)
    return [(centers[a], centers[b]) for i, a in enumerate(ks) for b in ks[i + 1:]
            if W[a, b] >= 15]


def draw_map(m, trajectory=None, path: str | None = None, elev=-75, azim=-90):
    """MapDrawer analog: 3D map points, keyframe frusta (as axes), the
    covisibility graph, and optionally the frame trajectory [F,3]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..parallel.points import full_map

    m = full_map(m)                  # a map split over ranks: every point
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    mp = _np(m.mp_pos)[_np(m.mp_valid)]
    if len(mp):
        ax.scatter(mp[:, 0], mp[:, 1], mp[:, 2], s=1, c="k", alpha=0.4)
    kf_R = _np(m.kf_R)
    centers = _kf_centers(m)
    for s, c in centers.items():
        z = kf_R[s].T @ np.array([0, 0, 0.15])
        ax.plot([c[0], c[0] + z[0]], [c[1], c[1] + z[1]], [c[2], c[2] + z[2]], c="b", lw=1)
        ax.scatter(*c, s=14, c="b")
    for ca, cb in _covis_edges(m, centers):
        ax.plot([ca[0], cb[0]], [ca[1], cb[1]], [ca[2], cb[2]], c="g", lw=0.4, alpha=0.5)
    if trajectory is not None:
        tr = _np(trajectory)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], c="r", lw=1.2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(f"{len(mp)} map points / {len(centers)} keyframes")
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


class InteractiveViewer:
    """Viewer::Run analog: a live two-panel display -- the current frame
    with tracked features (FrameDrawer) and the 3D map with keyframes,
    covisibility and the current pose (MapDrawer) -- refreshed every
    `every` frames, with the reference's GUI menu as keyboard toggles:

        f  follow camera           p  show points
        k  show keyframes          g  show covisibility graph
        l  localization mode (the System's)
        r  reset (System.reset)    q  close the viewer

    Headless (matplotlib Agg) ``update`` renders without a window, and the
    toggles are plain attributes that drivers and tests can flip.  The map
    is a value, so the viewer snapshots it whenever ``update`` is called.
    """

    def __init__(self, system=None, every: int = 5, follow: bool = True):
        import matplotlib
        import matplotlib.pyplot as plt

        self.system = system
        self.every = max(1, every)
        self.follow = follow
        self.show_points = True
        self.show_keyframes = True
        self.show_graph = True
        self.localization_mode = False
        self.closed = False
        self._n = 0
        self._interactive = matplotlib.get_backend().lower() not in ("agg", "pdf", "svg", "ps")
        self.fig = plt.figure(figsize=(13, 6))
        self.ax_img = self.fig.add_subplot(1, 2, 1)
        self.ax_map = self.fig.add_subplot(1, 2, 2, projection="3d")
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        if self._interactive:
            plt.ion()
            self.fig.show()

    def _on_key(self, event):
        k = (event.key or "").lower()
        if k == "f":
            self.follow = not self.follow
        elif k == "p":
            self.show_points = not self.show_points
        elif k == "k":
            self.show_keyframes = not self.show_keyframes
        elif k == "g":
            self.show_graph = not self.show_graph
        elif k == "l":
            self.localization_mode = not self.localization_mode
            if self.system is not None:
                if self.localization_mode:
                    self.system.activate_localization_mode()
                else:
                    self.system.deactivate_localization_mode()
        elif k == "r" and self.system is not None:
            self.system.reset()
        elif k == "q":
            self.closed = True

    def update(self, image=None, frame=None, obs=None, m=None, pose=None, force: bool = False):
        """Refresh both panels; call once per tracked frame.  Renders every
        `self.every` calls (or when `force`); returns whether it drew."""
        self._n += 1
        if self.closed or (self._n % self.every and not force):
            return False
        if m is None and self.system is not None:
            m = self.system.map
        if m is not None:
            from ..parallel.points import full_map

            m = full_map(m)
        if pose is None and self.system is not None:
            pose = (_np(self.system.R), _np(self.system.t))
        ax = self.ax_img
        ax.clear()
        draw_frame_into(ax, image, frame, obs,
                        extra_title="  [LOC]" if self.localization_mode else "")
        axm = self.ax_map
        axm.clear()
        if m is not None:
            mp_valid = _np(m.mp_valid)
            if self.show_points:
                mp = _np(m.mp_pos)[mp_valid]
                if len(mp):
                    axm.scatter(mp[:, 0], mp[:, 1], mp[:, 2], s=1, c="k", alpha=0.35)
            centers = _kf_centers(m)
            if self.show_keyframes and centers:
                cs = np.stack(list(centers.values()))
                axm.scatter(cs[:, 0], cs[:, 1], cs[:, 2], s=12, c="b")
            if self.show_graph and len(centers) > 1:
                for ca, cb in _covis_edges(m, centers):
                    axm.plot([ca[0], cb[0]], [ca[1], cb[1]], [ca[2], cb[2]], c="g", lw=0.4,
                             alpha=0.5)
            if pose is not None:
                R, t = pose
                c = -_np(R).T @ _np(t)
                axm.scatter(*c, s=40, c="r", marker="^")
                if self.follow:
                    r = 2.0
                    axm.set_xlim(c[0] - r, c[0] + r)
                    axm.set_ylim(c[1] - r, c[1] + r)
                    axm.set_zlim(c[2] - r, c[2] + r)
            axm.set_title(f"{int(mp_valid.sum())} pts / {len(centers)} KFs")
        if self._interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        else:
            self.fig.canvas.draw()
        return True

    def savefig(self, path: str):
        self.fig.savefig(path, dpi=100, bbox_inches="tight")

    def close(self):
        import matplotlib.pyplot as plt

        self.closed = True
        plt.close(self.fig)
