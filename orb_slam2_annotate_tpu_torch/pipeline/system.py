"""System facade, synchronous path (port of pipeline/system.py).

Sequences frame build, initialization (two-view for mono, depth-seeded from
one frame for RGB-D and stereo), the tracking step with relocalization, the
keyframe policy, the keyframe chain with keyframe culling, and loop closing
with its global BA on an explicit ``device``.  Each stage is a
``torch.profiler.record_function`` span (frontend/extract, init/mono,
init/depth, tracking/step, tracking/relocalize, mapping/keyframe, and loop
closing's loop/detect, loop/sim3, loop/correct, loop/gba, loop/fold), which
costs nothing unless a profiler is recording.

The port runs the mono, RGB-D and stereo sensors synchronously
(``track_mono``, ``track_rgbd``, ``track_stereo``), with loop closing,
relocalization and keyframe culling each on or off: ``SlamConfig()`` is the
reference's default monocular configuration, and ``mono_slice_config`` the
same minus loop closing; with depth, loop closing fixes the Sim3 scale.
Fuse, pipelining and point sharding are not ported: they raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..geometry.camera import CameraModel
from ..ops import matching
from ..ops.extractor import ExtractorConfig
from ..ops.orb import OrbTables
from ..solvers import initializer
from ..worldmap import map_state as ms
from . import local_mapping as lm
from . import policy
from . import tracking as tk
from .frame import Frame, make_frame_mono, make_frame_rgbd, make_frame_stereo
from .loop_closing import LoopCloser, LoopCloserConfig


@dataclasses.dataclass
class SlamConfig:
    """The reference's SlamConfig fields with the same defaults."""

    sensor: str = "mono"
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    max_kf: int = 256
    max_mp: int = 16384
    max_frames_between_kf: int = 20
    min_frames_between_kf: int = 1
    kf_ref_ratio: float = 0.8
    min_inliers_track: int = 15
    min_inliers_local: int = 30
    th_depth: float = 40.0           # close-depth threshold, in baselines (RGB-D / stereo)
    init_min_matches: int = 100
    seed: int = 0
    verbose: bool = False
    enable_fuse: bool = False
    stats_in_triangulate: bool | None = None
    enable_cull: bool = True
    enable_local_ba: bool = True
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    enable_kf_culling: bool = True
    shard_points: bool = False
    async_depth: int = 0

    @property
    def extractor(self) -> ExtractorConfig:
        return ExtractorConfig(n_features=self.n_features, n_levels=self.n_levels, scale=self.scale)


# the sensors and settings the port implements; every other value raises
# (loop closing, relocalization and keyframe culling take either value)
SENSORS = ("mono", "rgbd", "stereo")
SLICE_SETTINGS = dict(enable_fuse=False, stats_in_triangulate=None, enable_cull=True,
                      enable_local_ba=True, async_depth=0, shard_points=False)


def mono_slice_config(**kw) -> SlamConfig:
    """The reference's defaults minus loop closing (relocalization and
    keyframe culling on), plus sizes and toggles from `kw`."""
    return SlamConfig(**{**SLICE_SETTINGS, "enable_loop_closing": False, **kw})


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    ref_kf_slot: int
    R_cr: np.ndarray
    t_cr: np.ndarray
    lost: bool


class System:
    """Mono / RGB-D / stereo SLAM engine on one torch device."""

    def __init__(self, cam: CameraModel, config: SlamConfig | None = None, device="cuda"):
        cfg = config or SlamConfig()
        unsupported = {k: getattr(cfg, k) for k, v in SLICE_SETTINGS.items() if getattr(cfg, k) != v}
        if cfg.sensor not in SENSORS:
            unsupported["sensor"] = cfg.sensor
        if unsupported:
            raise NotImplementedError(f"not ported yet: {unsupported}")
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.tab = OrbTables().to(self.device)
        self.map = ms.empty_map(cfg.max_kf, cfg.max_mp, cfg.n_features, device=self.device)
        self.state = "NO_IMAGES"
        self.frame_id = -1
        self.records: list[FrameRecord] = []
        self._rng = np.random.RandomState(cfg.seed)
        self._gen = torch.Generator(device=self.device)
        self._kf_valid_host = np.zeros(cfg.max_kf, bool)
        self._mp_upper = 0
        self.last_frame: Optional[Frame] = None
        self.last_obs = None
        self.R = torch.eye(3, device=self.device)
        self.t = torch.zeros(3, device=self.device)
        self.vel = None
        self.ref_kf = 0
        self.last_kf_frame = -999
        self.ref_tracked = 0
        self._last_n_local = 0
        self._peak_n_local = 0
        self._init_frame: Optional[Frame] = None
        self._pose_np = None
        self._rel_np = None
        self._cur_ts = 0.0
        # loop closing, and the keyframe database (BoW rows) that
        # relocalization queries
        self.loop_closer = LoopCloser(cam, cfg.max_kf,
                                      LoopCloserConfig(fix_scale=cfg.sensor != "mono"),
                                      seed=cfg.seed + 1, device=self.device) \
            if cfg.enable_loop_closing or cfg.enable_relocalization else None
        self.frames_since_reloc = 0
        # reset() keeps the mode, as the reference's does
        self._localization_only = getattr(self, "_localization_only", False)

    def _upload(self, image) -> torch.Tensor:
        """A grayscale image (numpy or tensor) on the device: uint8 stays
        uint8 (the cast to f32 happens on the device), anything else f32."""
        if torch.is_tensor(image):
            return image.to(self.device)
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = img.astype(np.float32)
        return torch.from_numpy(img).to(self.device)

    def track_mono(self, image, timestamp: float):
        """image [H,W] grayscale uint8 or float32.  Returns 4x4 Tcw or None."""
        with record_function("frontend/extract"):
            frame = make_frame_mono(self._upload(image), self.cam, self.tab, self.cfg.extractor)
        return self._track(frame, timestamp)

    def track_rgbd(self, image, depth, timestamp: float):
        """image [H,W] grayscale, depth [H,W] metric (0 = invalid), registered
        to the image.  Returns 4x4 Tcw or None."""
        with record_function("frontend/extract"):
            frame = make_frame_rgbd(self._upload(image),
                                    torch.as_tensor(depth).to(self.device, torch.float32),
                                    self.cam, self.tab, self.cfg.extractor)
        return self._track(frame, timestamp, has_depth=True)

    def track_stereo(self, image_l, image_r, timestamp: float):
        """A rectified pair [H,W] (numpy or tensors).  Returns 4x4 Tcw or None."""
        with record_function("frontend/extract"):
            frame = make_frame_stereo(self._upload(image_l), self._upload(image_r), self.cam,
                                      self.tab, self.cfg.extractor)
        return self._track(frame, timestamp, has_depth=True)

    def activate_localization_mode(self):
        """Track against the frozen map: no keyframes are made."""
        self._localization_only = True

    def deactivate_localization_mode(self):
        self._localization_only = False

    def reset(self):
        self.__init__(self.cam, self.cfg, self.device)

    # ------------------------------------------------------------------

    def _track(self, frame: Frame, timestamp: float, has_depth: bool = False):
        self.frame_id += 1
        self._cur_ts = timestamp
        if self.state in ("NO_IMAGES", "NOT_INITIALIZED"):
            if has_depth:
                with record_function("init/depth"):
                    ok = self._initialize_depth(frame, timestamp)
            else:
                with record_function("init/mono"):
                    ok = self._initialize_mono(frame, timestamp)
            if not ok:
                self._record(lost=True)
                return None
            self.state = "OK"
            self._record()
            return self._pose44()

        has_vel = self.vel is not None
        eye, zero = torch.eye(3, device=self.device), torch.zeros(3, device=self.device)
        vel_R, vel_t = self.vel if has_vel else (eye, zero)
        if self.last_frame is None or self.last_obs is None:
            # no previous frame: the motion model cannot run
            self.last_frame = frame
            self.last_obs = torch.full((frame.xy.shape[0],), -1, dtype=torch.int32,
                                       device=self.device)
            has_vel = False
        with record_function("tracking/step"):
            step = tk.track_frame(self.cam, self.map, frame, self.last_frame, self.last_obs,
                                  self.R, self.t, vel_R, vel_t, has_vel, self.ref_kf)
        if self.cfg.verbose:
            print(f"  [track] f{self.frame_id}: pre={step.n_pre} local={step.n_local} "
                  f"local_kf={step.n_local_kf} ref_tracked={self.ref_tracked}")
        if step.n_pre < self.cfg.min_inliers_track or step.n_local < self.cfg.min_inliers_local:
            if not (step.n_pre < self.cfg.min_inliers_track and self._try_relocalize(frame)):
                self._lose()
                self._maybe_auto_reset()
                return None
            # relocalized: run the step again from the recovered pose
            with record_function("tracking/step"):
                step = tk.track_frame(self.cam, self.map, frame, self.last_frame, self.last_obs,
                                      self.R, self.t, eye, zero, False, self.ref_kf)
            if step.n_local < self.cfg.min_inliers_local:
                self._lose()
                return None

        self.map = self.map.replace(mp_visible=step.mp_visible, mp_found=step.mp_found)
        self._last_n_local = step.n_local
        self._peak_n_local = max(self._peak_n_local, step.n_local)
        self.state = "OK"
        host = torch.cat([step.R.reshape(9), step.t, step.R_cr.reshape(9), step.t_cr]).cpu().numpy()
        self._pose_np = (host[:9].reshape(3, 3), host[9:12])
        self._rel_np = (host[12:21].reshape(3, 3), host[21:24])
        self.vel = (step.vel_R, step.vel_t)
        self.R, self.t = step.R, step.t
        self.last_frame = frame
        self.last_obs = step.obs
        if not self._localization_only and self._need_keyframe(step.n_local):
            with record_function("mapping/keyframe"):
                self._create_keyframe(frame, timestamp, step.obs, has_depth)
        self._record()
        return self._pose44()

    def _lose(self):
        self.state = "LOST"
        self.vel = None
        self._record(lost=True)

    def _ensure_capacity(self):
        """Double the keyframe or map-point capacity before it runs out."""
        if self._kf_valid_host.all():
            new_K = 2 * self.map.K
            self.map = ms.grow_map(self.map, new_K=new_K)
            self._kf_valid_host = np.concatenate(
                [self._kf_valid_host, np.zeros(new_K - len(self._kf_valid_host), bool)])
            if self.loop_closer is not None:
                self.loop_closer.grow_db(new_K)
        n = self.map.N
        self._mp_upper += 2 * n
        if self._mp_upper + 2 * n > self.map.P:
            self._mp_upper = self.n_mappoints
            if self._mp_upper + 2 * n > self.map.P:
                self.map = ms.grow_map(self.map, new_P=2 * self.map.P)

    def _maybe_auto_reset(self):
        """Lost right after initialization (<= 5 keyframes): start over, as
        the reference does (System::Reset clears the records too)."""
        if self.state == "LOST" and 0 < self.n_keyframes <= 5:
            self.reset()

    def _need_keyframe(self, n_tracked: int) -> bool:
        return policy.need_new_keyframe(
            self.frame_id - self.last_kf_frame, n_tracked, self._peak_n_local,
            min_frames=self.cfg.min_frames_between_kf, max_frames=self.cfg.max_frames_between_kf,
            ref_ratio=self.cfg.kf_ref_ratio, min_track=self.cfg.min_inliers_track)

    def _max_depth(self) -> float:
        """The close-depth threshold: th_depth baselines."""
        return self.cfg.th_depth * (self.cam.bf / self.cam.fx)

    def _create_keyframe(self, frame: Frame, timestamp: float, obs: torch.Tensor,
                         has_depth: bool = False):
        self._ensure_capacity()
        slot = int(np.argmin(self._kf_valid_host))
        # +1: the keyframe this chain inserts is not in _kf_valid_host yet
        do_kf_cull = self.cfg.enable_kf_culling and self.n_keyframes + 1 > 8
        self.map, cull_info = lm.keyframe_chain(
            self.map, self.cam, frame, slot, self.R, self.t, obs, self.frame_id, timestamp,
            self._max_depth() if has_depth else None, do_kf_cull=do_kf_cull)
        self._kf_valid_host[slot] = True
        if self.loop_closer is not None:
            # writes the keyframe's BoW row; with loop closing on, resolves
            # the candidates (and maybe closes a loop) at once, then folds a
            # finished global BA
            det = self.loop_closer.dispatch_detection(self.map, slot)
            if self.cfg.enable_loop_closing:
                self.map, closed = self.loop_closer.resolve_detection(self.map, slot, det)
                if closed and self.cfg.verbose:
                    print(f"  [loop] closed at kf slot {slot}")
            self.map = self.loop_closer.maybe_fold_gba(self.map)
        if do_kf_cull:
            self._apply_cull_info(cull_info)
        # adopt the keyframe's pose, which a loop correction may have moved
        self.R = self.map.kf_R[slot]
        self.t = self.map.kf_t[slot]
        self.last_obs = self.map.kf_obs[slot]
        self.ref_kf = slot
        self._rel_np = None          # this frame is the reference keyframe
        self.last_kf_frame = self.frame_id
        self.ref_tracked = self._last_n_local
        self._peak_n_local = 0

    def _apply_cull_info(self, info: lm.CullInfo):
        """Fold culled slots into the host mirror and re-reference the frame
        records of culled keyframes."""
        ok = info.ok.cpu().numpy()
        if not ok.any():
            return
        slots = info.slots.cpu().numpy()[ok]
        self._kf_valid_host[slots] = False
        self._reparent_records(slots, info.new_ref.cpu().numpy()[ok], info.R_rel.cpu().numpy()[ok],
                               info.t_rel.cpu().numpy()[ok])

    def _reparent_records(self, culled, new_refs, R_rels, t_rels):
        """Re-express the records of culled reference keyframes relative to
        their replacements: Tcr' = Tcr Trel."""
        by_slot = {int(c): (int(nr), R_rels[i], t_rels[i])
                   for i, (c, nr) in enumerate(zip(culled, new_refs))}
        for rec in self.records:
            if rec.lost or rec.ref_kf_slot not in by_slot:
                continue
            new_ref, R_rel, t_rel = by_slot[rec.ref_kf_slot]
            rec.t_cr = rec.R_cr @ t_rel + rec.t_cr
            rec.R_cr = rec.R_cr @ R_rel
            rec.ref_kf_slot = new_ref

    def _try_relocalize(self, frame: Frame) -> bool:
        """Relocalize against the BoW candidates (PnP RANSAC seeded with the
        frame id), then refine the winner with one local-map track; success
        needs >= 50 inliers."""
        if self.loop_closer is None or self.n_keyframes < 2:
            return False
        lc = self.loop_closer
        self._gen.manual_seed(self.frame_id)
        with record_function("tracking/relocalize"):
            cand = tk.relocalize_candidates(self.cam, self.map, frame, lc.vocab, lc.db.bows,
                                            self._gen)
            slot = int(cand.best_slot)
            if slot < 0:
                return False
            with record_function("reloc/local_map"):
                res2 = tk.track_local_map(self.cam, self.map, frame, cand.R, cand.t, cand.obs)
                n_inliers = int(res2.n_inliers)
        if n_inliers < 50:
            return False
        self.R, self.t = res2.R, res2.t
        self.last_frame = frame
        self.last_obs = res2.obs
        self.vel = None
        self.ref_kf = slot
        self.state = "OK"
        self.frames_since_reloc = 0
        if self.cfg.verbose:
            print(f"  [reloc] recovered against kf slot {slot} ({n_inliers} inliers)")
        return True

    def _initialize_mono(self, frame: Frame, timestamp: float) -> bool:
        n_feat = int(frame.valid.sum())
        if self._init_frame is None:
            if n_feat >= self.cfg.init_min_matches:
                self._init_frame = frame
                self._init_ts = timestamp
                self._init_fid = self.frame_id
            self.state = "NOT_INITIALIZED"
            return False
        if n_feat < self.cfg.init_min_matches:
            self._init_frame = None
            return False
        f0 = self._init_frame
        res = matching.search_for_initialization(f0, frame, window=100.0)
        if int(res.count) < self.cfg.init_min_matches:
            self._init_frame = None
            return False
        x2 = frame.xy[torch.clamp_min(res.idx, 0).long()]
        self._gen.manual_seed(int(self._rng.randint(2**31)))
        samples = initializer.sample_minimal_sets(self._gen, res.matched, 200)
        init = initializer.initialize_from_samples(samples, f0.xy, x2, res.matched,
                                                   self.cam.K(self.device), 1.0,
                                                   min_parallax_deg=2.5)
        if not bool(init.success):
            return False
        self.map, obs1 = policy.build_mono_init_map(self.map, self.cam, f0, frame, init, res.idx,
                                                    self._init_fid, self._init_ts, self.frame_id,
                                                    timestamp)
        # as in the reference, the two bootstrap keyframes get no BoW row: their
        # zero rows score 0.5 against every query (ROADMAP.md §3)
        self.R = self.map.kf_R[1]
        self.t = self.map.kf_t[1]
        self.last_frame = frame
        self.last_obs = obs1
        self.vel = None
        self.ref_kf = 1
        self._kf_valid_host[:2] = True
        self._pose_np = None
        self._rel_np = None
        self.last_kf_frame = self.frame_id
        self.ref_tracked = int(init.n_good)
        self._init_frame = None
        return True

    def _initialize_depth(self, frame: Frame, timestamp: float) -> bool:
        """One keyframe at the origin with a point from every close-depth
        feature; needs depth on min(500, n_features // 2) features."""
        n_depth = int((frame.valid & (frame.depth > 0)).sum())
        if n_depth < min(500, self.cfg.n_features // 2):
            return False
        slot = int(np.argmin(self._kf_valid_host))
        self.map = policy.build_depth_init_map(self.map, self.cam, frame, slot, self.frame_id,
                                               timestamp, self._max_depth())
        self.R = torch.eye(3, device=self.device)
        self.t = torch.zeros(3, device=self.device)
        self.last_frame = frame
        self.last_obs = self.map.kf_obs[slot]
        self.vel = None
        self.ref_kf = slot
        self._kf_valid_host[slot] = True
        self._pose_np = None
        self._rel_np = None
        self.last_kf_frame = self.frame_id
        self.ref_tracked = int((self.last_obs >= 0).sum())
        return True

    # ---- bookkeeping ---------------------------------------------------

    def _pose44(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        if self._pose_np is not None:
            T[:3, :3], T[:3, 3] = self._pose_np
        else:
            T[:3, :3] = self.R.cpu().numpy()
            T[:3, 3] = self.t.cpu().numpy()
        return T

    def _record(self, lost: bool = False):
        if lost or self.state != "OK":
            self.records.append(FrameRecord(self.frame_id, self._cur_ts, self.ref_kf,
                                            np.eye(3, dtype=np.float32),
                                            np.zeros(3, np.float32), True))
            return
        if self._rel_np is not None:
            Rcr, tcr = self._rel_np
        else:
            Rcr, tcr = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self.records.append(FrameRecord(self.frame_id, self._cur_ts, self.ref_kf,
                                        np.asarray(Rcr, np.float32).copy(),
                                        np.asarray(tcr, np.float32).copy(), False))

    def flush(self):
        """Fold a pending global BA into the map (the synchronous path has no
        other work in flight).  Call before reading trajectories or the map."""
        if self.loop_closer is not None:
            self.map = self.loop_closer.maybe_fold_gba(self.map, force=True)

    def frame_trajectory(self):
        """[(frame_id, 4x4 Tcw or None)] through the current keyframe poses."""
        self.flush()
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        out = []
        for rec in self.records:
            if rec.lost:
                out.append((rec.frame_id, None))
                continue
            Rr, tr = kf_R[rec.ref_kf_slot], kf_t[rec.ref_kf_slot]
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = rec.R_cr @ Rr
            T[:3, 3] = rec.R_cr @ tr + rec.t_cr
            out.append((rec.frame_id, T))
        return out

    def keyframe_trajectory(self):
        """[(frame_id, 4x4 Tcw)] of the valid keyframes, by frame id."""
        self.flush()
        v = self.map.kf_valid.cpu().numpy()
        fids = self.map.kf_frame_id.cpu().numpy()
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        out = []
        for s in np.argsort(fids):
            if v[s]:
                T = np.eye(4, dtype=np.float32)
                T[:3, :3], T[:3, 3] = kf_R[s], kf_t[s]
                out.append((int(fids[s]), T))
        return out

    @property
    def observation_overflow(self):
        """(points over MAX_OBS observations, observations dropped)."""
        n, d = ms.observation_overflow(self.map)
        return int(n), int(d)

    @property
    def n_keyframes(self) -> int:
        return int(self._kf_valid_host.sum())

    @property
    def n_mappoints(self) -> int:
        return int(self.map.mp_valid.sum())
