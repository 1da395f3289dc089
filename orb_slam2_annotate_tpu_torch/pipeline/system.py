"""System facade (port of pipeline/system.py).

Sequences frame build, initialization (two-view for mono, depth-seeded from
one frame for RGB-D and stereo), the tracking step with relocalization, the
keyframe policy, the keyframe chain (with fuse, culling and local BA as the
config says), and loop closing with its global BA on an explicit
``device``.  Each stage is a ``torch.profiler.record_function`` span
(frontend/extract, init/mono, init/depth, tracking/step,
tracking/relocalize, mapping/keyframe with the chain's mapping/* stages, and
loop closing's loop/detect, loop/sim3, loop/correct, loop/gba, loop/fold),
which costs nothing unless a profiler is recording; frontend/extract,
tracking/step and mapping/keyframe are opened by ``System.telemetry``
(utils/telemetry.py), which also keeps their host times.

The port runs the mono, RGB-D and stereo sensors (``track_mono``,
``track_rgbd``, ``track_stereo``) with every ``SlamConfig`` setting:
``SlamConfig()`` is the reference's default monocular configuration, and
``mono_slice_config`` the same minus loop closing; with depth, loop closing
fixes the Sim3 scale.  With ``async_depth > 0`` tracking is pipelined: each
frame's step is dispatched without a host read
(``tracking.track_frame_device``), its counts and poses are copied to
pinned host memory behind a CUDA event, and the keyframe / LOST policy of a
frame runs once its copy has landed, at most ``async_depth`` frames later;
``flush()`` drains the pipeline.  ``save_map`` / ``load_map`` persist the
map in the reference's file format (io/checkpoint.py); ``warmup`` runs each
stage once on throwaway state.  In a process group of several ranks
(parallel/mesh.py) every rank runs the same frames, and loop closing's
global BA is sharded over the ranks.  The map is replicated, or with
``shard_points`` its point axis is split over the ranks (each holds
max_mp / n rows, parallel/points.py; keyframe state stays replicated);
``shard_points`` does nothing at a world of one, as the reference on one
device.
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
from ..parallel import mesh as mesh_mod
from ..parallel import points as pts
from ..solvers import initializer
from ..utils.telemetry import Telemetry
from ..worldmap import map_state as ms
from ..worldmap import vocabulary as voc
from . import local_mapping as lm
from . import policy
from . import tracking as tk
from .frame import Frame, make_frame_mono, make_frame_rgbd, make_frame_stereo
from .loop_closing import LoopCloser, LoopCloserConfig, LoopDetectOut, detect_loop_device


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
    # the free runner's (pipeline/device_loop.py): a global BA right after
    # each live closure while max_kf <= free_live_gba_max_kf, and the reset
    # after an early loss; System ignores them
    free_live_gba: bool = True
    free_live_gba_max_kf: int = 256
    free_auto_reset: bool = True
    shard_points: bool = False
    async_depth: int = 0

    @property
    def extractor(self) -> ExtractorConfig:
        return ExtractorConfig(n_features=self.n_features, n_levels=self.n_levels, scale=self.scale)


SENSORS = ("mono", "rgbd", "stereo")


def point_mesh(cfg):
    """The mesh the live map's point axis is split over: every rank of the
    default process group when shard_points is set and it holds more than
    one, else None (a whole map; at a world of one shard_points does
    nothing, as the reference on one device)."""
    if not cfg.shard_points or mesh_mod.world_size() == 1:
        return None
    mesh = mesh_mod.map_mesh()
    if cfg.max_mp % mesh.size:
        raise ValueError(f"shard_points: max_mp={cfg.max_mp} is not a multiple of the "
                         f"{mesh.size} ranks")
    return mesh


def mono_slice_config(**kw) -> SlamConfig:
    """The reference's defaults minus loop closing (relocalization, keyframe
    culling, recent-point culling and local BA on; fuse off; synchronous
    tracking), plus sizes and toggles from `kw`."""
    return SlamConfig(**{"enable_fuse": False, "stats_in_triangulate": None, "enable_cull": True,
                         "enable_local_ba": True, "async_depth": 0, "shard_points": False,
                         "enable_loop_closing": False, **kw})


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
        if cfg.sensor not in SENSORS:
            raise ValueError(f"unknown sensor {cfg.sensor!r}: one of {SENSORS}")
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.tab = OrbTables().to(self.device)
        self.map = ms.empty_map(cfg.max_kf, cfg.max_mp, cfg.n_features, device=self.device,
                                mesh=point_mesh(cfg))
        self.state = "NO_IMAGES"
        self.frame_id = -1
        self.records: list[FrameRecord] = []
        self._rng = np.random.RandomState(cfg.seed)
        self._gen = torch.Generator(device=self.device)
        self._kf_valid_host = np.zeros(cfg.max_kf, bool)
        self._mp_upper = 0
        # pipelined tracking: frames awaiting their host copies, and the
        # previous keyframe's cull info and loop detection, read at the next
        self._inflight: list[dict] = []
        self._pending_cull = None
        self._pending_det = None
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
        self.telemetry = Telemetry()
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
        with self.telemetry.stage("frontend/extract"):
            frame = make_frame_mono(self._upload(image), self.cam, self.tab, self.cfg.extractor)
        return self._track(frame, timestamp)

    def track_rgbd(self, image, depth, timestamp: float):
        """image [H,W] grayscale, depth [H,W] metric (0 = invalid), registered
        to the image.  Returns 4x4 Tcw or None."""
        with self.telemetry.stage("frontend/extract"):
            frame = make_frame_rgbd(self._upload(image),
                                    torch.as_tensor(depth).to(self.device, torch.float32),
                                    self.cam, self.tab, self.cfg.extractor)
        return self._track(frame, timestamp, has_depth=True)

    def track_stereo(self, image_l, image_r, timestamp: float):
        """A rectified pair [H,W] (numpy or tensors).  Returns 4x4 Tcw or None."""
        with self.telemetry.stage("frontend/extract"):
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

    def change_calibration(self, cam: CameraModel):
        """Runtime recalibration (Tracking::ChangeCalibration,
        Tracking.cc:1683).  As in the reference, only the tracker's camera
        changes: the loop closer keeps the one it was made with (ROADMAP.md
        §3)."""
        self.cam = cam

    def warmup(self):
        """Run every stage the steady-state pipeline can reach once, on
        throwaway state: a zero frame's tracking step, the keyframe chain in
        each keyframe-cull variant the config reaches, a database row and a
        relocalization.  Nothing of the System's state is touched.  On the
        card this pays the first-use costs (the kernels' builds, cuBLAS
        handles, the allocator's pools) before the first real frame."""
        cam, cfg, dev = self.cam, self.cfg, self.device
        h, w = int(cam.height), int(cam.width)
        img = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        has_depth = cfg.sensor in ("stereo", "rgbd")
        if cfg.sensor == "stereo":
            frame = make_frame_stereo(img, img, cam, self.tab, cfg.extractor)
        elif cfg.sensor == "rgbd":
            frame = make_frame_rgbd(img, torch.ones((h, w), device=dev), cam, self.tab,
                                    cfg.extractor)
        else:
            frame = make_frame_mono(img, cam, self.tab, cfg.extractor)
        m0 = self.map.replace(**{f.name: getattr(self.map, f.name).clone()
                                 for f in dataclasses.fields(ms.MapState)})
        obs0 = torch.full((frame.xy.shape[0],), -1, dtype=torch.int32, device=dev)
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        track = tk.track_frame_device if cfg.async_depth > 0 else tk.track_frame
        step = track(cam, m0, frame, frame, obs0, eye, zero, eye, zero, False, self.ref_kf)
        slot = int(np.argmin(self._kf_valid_host))
        for do_cull in ((False, True) if cfg.enable_kf_culling else (False,)):
            m, _ = lm.keyframe_chain(
                m0, cam, frame, slot, step.R, step.t, step.obs, 0, 0.0,
                self._max_depth() if has_depth else None, do_cull_recent=cfg.enable_cull,
                stats_in_triangulate=(cfg.enable_fuse if cfg.stats_in_triangulate is None
                                      else cfg.stats_in_triangulate),
                do_fuse=cfg.enable_fuse, do_local_ba=cfg.enable_local_ba, do_kf_cull=do_cull)
        if self.loop_closer is not None:
            lc = self.loop_closer
            det = detect_loop_device(lc.vocab, lc.db.bows.clone(), m, slot, lc.cfg.gap_kf)
            cand = tk.relocalize_candidates(cam, m, frame, lc.vocab, det.db_bows,
                                            torch.Generator(device=dev).manual_seed(0))
            tk.track_local_map(cam, m, frame, cand.R, cand.t, cand.obs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save_map(self, path: str):
        """Persist the map (the reference's System.h:115 SaveMap TODO), after
        ``flush()``; the header's extra holds frame_id and ref_kf.  A map
        split over ranks is written whole by rank 0 (every rank calls it)."""
        self.flush()
        from ..io import checkpoint

        checkpoint.save_map(path, self.map, extra={"frame_id": self.frame_id,
                                                   "ref_kf": int(self.ref_kf)})

    def load_map(self, path: str):
        """Restore a saved map: the tracker is LOST with no velocity and must
        relocalize into it; the keyframe database is rebuilt from the
        keyframes (one kernel-5 launch over all K slots) and the pipelined
        queue is cleared.  ``_mp_upper`` stays as it was, as in the
        reference (its system.py:565-568): the next keyframe's capacity
        check reads the true count once it exceeds the map's tier."""
        from ..io import checkpoint

        self.map, extra = checkpoint.load_map(path, self.device)
        mesh = point_mesh(self.cfg)
        if mesh is not None:
            self.map = mesh_mod.shard_map_state(self.map, mesh)
        self.state = "LOST"
        self.vel = None
        self.ref_kf = int(extra.get("ref_kf", 0))
        self._kf_valid_host = self.map.kf_valid.cpu().numpy().copy()
        self._inflight = []
        self._pending_cull = None
        self._pending_det = None
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.db = voc.KeyFrameDatabase(policy.keyframe_bows(lc.vocab, self.map))

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
        if self.cfg.async_depth > 0:
            return self._track_async(frame, timestamp, has_depth, has_vel, vel_R, vel_t)
        with self.telemetry.stage("tracking/step"):
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
            with self.telemetry.stage("tracking/step"):
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
            with self.telemetry.stage("mapping/keyframe"):
                self._create_keyframe(frame, timestamp, step.obs, has_depth)
        self._record()
        return self._pose44()

    # ---- pipelined tracking (async_depth > 0) ---------------------------

    def _track_async(self, frame: Frame, timestamp: float, has_depth: bool, has_vel: bool,
                     vel_R, vel_t):
        """Dispatch this frame's step with no host read, then resolve every
        in-flight frame whose copy has landed, blocking only while more than
        async_depth frames are in flight.  Returns the frame's unresolved
        4x4 Tcw as a device tensor (None or a numpy 4x4 while LOST)."""
        if self.state == "LOST":
            self.last_frame = frame
            self.last_obs = torch.full((frame.xy.shape[0],), -1, dtype=torch.int32,
                                       device=self.device)
            if not self._try_relocalize(frame):
                self._record(lost=True)
                return None
            # recovered: record this frame relative to the relocalization keyframe
            Rr = self.map.kf_R[self.ref_kf].cpu().numpy()
            tr = self.map.kf_t[self.ref_kf].cpu().numpy()
            R_np, t_np = self.R.cpu().numpy(), self.t.cpu().numpy()
            Rcr = R_np @ Rr.T
            self._rel_np = (Rcr, t_np - Rcr @ tr)
            self._pose_np = (R_np, t_np)
            self._record()
            return self._pose44()
        with self.telemetry.stage("tracking/step"):
            step = tk.track_frame_device(self.cam, self.map, frame, self.last_frame,
                                         self.last_obs, self.R, self.t, vel_R, vel_t, has_vel,
                                         self.ref_kf)
            host, event = self._prefetch(*step.host_bundle())
        self.map = self.map.replace(mp_visible=step.mp_visible, mp_found=step.mp_found)
        self.R, self.t = step.R, step.t
        self.vel = (step.vel_R, step.vel_t)
        self.last_frame = frame
        self.last_obs = step.obs
        self._inflight.append(dict(frame_id=self.frame_id, ts=timestamp, ref_kf=self.ref_kf,
                                   frame=frame, step=step, has_depth=has_depth, host=host,
                                   event=event))
        while self._inflight:
            if not self._ready(self._inflight[0]) and len(self._inflight) <= self.cfg.async_depth:
                break
            if not self._resolve_oldest():
                break
        T = torch.eye(4, device=self.device)
        T[:3, :3], T[:3, 3] = step.R, step.t
        return T

    def _prefetch(self, *tensors):
        """Start copies of `tensors` to the host: (host tensors, the CUDA
        event recorded after the copies).  On the CPU the tensors are their
        own host copies and there is no event."""
        if self.device.type != "cuda":
            return list(tensors), None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _ready(self, e: dict) -> bool:
        """Whether an in-flight frame's copy has landed on the host (a CPU
        tensor is ready once computed); above a world of one, on every rank,
        so all ranks resolve a frame at the same step."""
        return e["event"] is None or mesh_mod.all_ranks(e["event"].query())

    @staticmethod
    def _landed(host: list, event) -> list:
        """The host copies, once their event has completed."""
        if event is not None:
            event.synchronize()
        return host

    def _lost_record(self, e: dict):
        self.records.append(FrameRecord(e["frame_id"], e["ts"], e["ref_kf"],
                                        np.eye(3, dtype=np.float32), np.zeros(3, np.float32), True))

    def _resolve_oldest(self) -> bool:
        """Resolve the oldest in-flight frame: its record, and the keyframe /
        LOST policy.  Returns False if tracking was lost (pipeline drained)."""
        e = self._inflight.pop(0)
        stats, poses = (h.numpy() for h in self._landed(e["host"], e["event"]))
        n_pre, n_local = int(stats[0]), int(stats[1])
        if self.cfg.verbose:
            print(f"  [track] f{e['frame_id']}: pre={n_pre} local={n_local} "
                  f"(lag {self.frame_id - e['frame_id']})")
        if n_pre < self.cfg.min_inliers_track or n_local < self.cfg.min_inliers_local:
            # every later in-flight frame chained off this bad pose
            self._lost_record(e)
            for e2 in self._inflight:
                self._lost_record(e2)
            self._inflight.clear()
            self.state = "LOST"
            self.vel = None
            if self._try_relocalize(self.last_frame):
                self.state = "OK"
            else:
                self._maybe_auto_reset()
            return False
        self._last_n_local = n_local
        self._peak_n_local = max(self._peak_n_local, n_local)
        rec = FrameRecord(e["frame_id"], e["ts"], e["ref_kf"], poses[2, :9].reshape(3, 3).copy(),
                          poses[2, 9:12].copy(), False)
        if not self._localization_only and self._need_keyframe(n_local, e["frame_id"]):
            with self.telemetry.stage("mapping/keyframe"):
                slot = self._create_keyframe_async(e)
            # this frame is the new reference keyframe
            rec = FrameRecord(e["frame_id"], e["ts"], slot, np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), False)
        self.records.append(rec)
        return True

    def _resolve_pending(self):
        """Apply the previous keyframe's cull info and resolve its loop
        detection, both copied to the host since."""
        if self._pending_cull is not None:
            self._apply_cull_info(lm.CullInfo(*self._landed(*self._pending_cull)))
            self._pending_cull = None
        if self._pending_det is not None:
            det_slot, det, host, event = self._pending_det
            self._pending_det = None
            det = LoopDetectOut(det.db_bows, *self._landed(host, event))
            self.map, closed = self.loop_closer.resolve_detection(self.map, det_slot, det)
            if closed and self.cfg.verbose:
                print(f"  [loop] closed at kf slot {det_slot}")

    def _create_keyframe_async(self, e: dict) -> int:
        """The keyframe chain for a lagged frame.  The cull info and the loop
        detection it produces are copied to the host without waiting and
        read at the next keyframe (or by ``flush``)."""
        self._ensure_capacity()
        self._resolve_pending()
        if self.loop_closer is not None:
            self.map = self.loop_closer.maybe_fold_gba(self.map)
        slot = int(np.argmin(self._kf_valid_host))
        step = e["step"]
        self.map, cull_info = self._run_keyframe_chain(e["frame"], slot, step.R, step.t, step.obs,
                                                       e["frame_id"], e["ts"], e["has_depth"])
        self._kf_valid_host[slot] = True
        if cull_info is not None:
            self._pending_cull = self._prefetch(cull_info.slots, cull_info.ok, cull_info.new_ref,
                                                cull_info.R_rel, cull_info.t_rel)
        if self.loop_closer is not None:
            # writes the keyframe's BoW row; the candidates are resolved at the next keyframe
            det = self.loop_closer.dispatch_detection(self.map, slot)
            if self.cfg.enable_loop_closing:
                self._pending_det = (slot, det, *self._prefetch(det.cands, det.ok, det.cand_covis))
        # as the reference, the tracker goes on from the step's pose and
        # observations, not the keyframe's (ROADMAP.md §3: the pipelined
        # tracker loses the map on the loop cell in both packages)
        self.ref_kf = slot
        self.last_kf_frame = e["frame_id"]
        self.ref_tracked = self._last_n_local
        self._peak_n_local = 0
        return slot

    # ------------------------------------------------------------------

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

    def _need_keyframe(self, n_tracked: int, frame_id: int | None = None) -> bool:
        """The keyframe decision for this frame, or for the pipelined frame
        `frame_id`."""
        since = (self.frame_id if frame_id is None else frame_id) - self.last_kf_frame
        return policy.need_new_keyframe(
            since, n_tracked, self._peak_n_local,
            min_frames=self.cfg.min_frames_between_kf, max_frames=self.cfg.max_frames_between_kf,
            ref_ratio=self.cfg.kf_ref_ratio, min_track=self.cfg.min_inliers_track)

    def _max_depth(self) -> float:
        """The close-depth threshold: th_depth baselines."""
        return self.cfg.th_depth * (self.cam.bf / self.cam.fx)

    def _run_keyframe_chain(self, frame: Frame, slot: int, R, t, obs, frame_id: int,
                            timestamp: float, has_depth: bool):
        """The keyframe chain with the config's stage toggles; returns (map,
        CullInfo, or None when keyframe culling did not run)."""
        cfg = self.cfg
        # +1: the keyframe this chain inserts is not in _kf_valid_host yet
        do_kf_cull = cfg.enable_kf_culling and self.n_keyframes + 1 > 8
        m, cull_info = lm.keyframe_chain(
            self.map, self.cam, frame, slot, R, t, obs, frame_id, timestamp,
            self._max_depth() if has_depth else None, do_cull_recent=cfg.enable_cull,
            stats_in_triangulate=(cfg.enable_fuse if cfg.stats_in_triangulate is None
                                  else cfg.stats_in_triangulate),
            do_fuse=cfg.enable_fuse, do_local_ba=cfg.enable_local_ba, do_kf_cull=do_kf_cull)
        return m, (cull_info if do_kf_cull else None)

    def _create_keyframe(self, frame: Frame, timestamp: float, obs: torch.Tensor,
                         has_depth: bool = False):
        self._ensure_capacity()
        slot = int(np.argmin(self._kf_valid_host))
        self.map, cull_info = self._run_keyframe_chain(frame, slot, self.R, self.t, obs,
                                                       self.frame_id, timestamp, has_depth)
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
        if cull_info is not None:
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
        if self.loop_closer is None or not self.cfg.enable_relocalization or self.n_keyframes < 2:
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
        """Drain the pipelined frames, apply the last keyframe's cull info and
        loop detection, and fold a pending global BA into the map.  Call
        before reading trajectories or the map."""
        while self._inflight:
            if not self._resolve_oldest():
                break
        self._resolve_pending()
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
        return int(pts.sum_points(self.map.mesh, self.map.mp_valid.sum()))
