"""Free-running SLAM (port of pipeline/device_loop.py): the whole per-frame
state machine over device-resident state, and FreeRunner, which feeds it.

Each frame runs the tracking state machine (init -> OK -> LOST -> reloc),
the keyframe policy, the keyframe chain with the in-place re-referencing
of the trajectory ring, live loop closing (``loop_closing.free_loop_stage``)
and a live global BA after each closure, and the auto-reset after an early
loss; the per-frame records go into device rings that ``finish()`` reads
once.

Why this port reads where the reference does not: the reference builds the
frame as one jitted program with no device-to-host read, because each read
on its remote TPU cost a ~25 ms link round trip, and branches with
``lax.cond``.  On a local H100 a read costs the wait for the queued work
and a few microseconds, and torch has no traced ``lax.cond``.  So each cond
becomes a Python branch on a predicate computed on the card by the
reference's formula, and each decision point reads its scalars in one
small copy: the mode (with ``has_vel``, ``ref_kf`` and the keyframe
counter, which the tracking step needs on the host), the init gates,
``need_kf`` (with the free slot and ``need_reset``), and in the loop stage
the candidates to try and each one's acceptance.  ``need_reloc`` is known
on the host from the counts ``tracking.track_frame`` reads for its own
fallbacks.  Only the branch taken runs, as under ``lax.cond``; the
tracking branch is never run branch-free, since relocalization and the
keyframe chain are far too expensive to run on every frame.

Random draws are keyed by frame, as the reference's ``fold_in(PRNGKey(seed
+ offset), frame_id)``: initialization (offset 0), relocalization (+7) and
the loop stage (+13, then candidate and stage) each seed a
``torch.Generator`` from (seed + offset, frame id[, candidate, stage]), so a
run's draws do not depend on its history: scan mode equals per-frame mode
and a reset does not shift later draws.  The draws are not
``jax.random``'s.

The runner owns ``state``: the rings (trajectory, modes, counts, loop
diag), the database rows and the closure records are written in place;
the map is replaced stage by stage, as the System replaces it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..geometry.camera import CameraModel
from ..ops import matching
from ..ops.orb import DESC_WORDS, OrbTables
from ..parallel import mesh as mesh_mod
from ..parallel import points as pts
from ..solvers import initializer
from ..solvers.sim3 import sample_sim3_sets
from ..worldmap import map_state as ms
from ..worldmap import vocabulary as voc
from . import local_mapping as lm
from . import policy
from . import tracking as tk
from .frame import Frame, make_frame_mono, make_frame_rgbd, make_frame_stereo
from .loop_closing import (CLOSURE_REC_W, MAX_CLOSURE_REC, MAX_LOOP_EDGES, LoopCloser,
                           LoopCloserConfig, LoopDetectOut, batch_detect_loops, free_loop_stage,
                           global_ba_cg)
from .system import SENSORS, SlamConfig, point_mesh

# tracker modes
MODE_FIRST = 0      # waiting for a usable init frame
MODE_SECOND = 1     # mono: have an init frame, matching against it
MODE_OK = 2
MODE_LOST = 3

# seed offsets of the reference's draws
SEED_INIT, SEED_RELOC, SEED_LOOP = 0, 7, 13


@dataclasses.dataclass
class FreeState:
    """Everything the per-frame step needs, on the device: the reference's
    FreeState fields, shapes and dtypes (0-d tensors for its scalars)."""

    m: ms.MapState
    bows: torch.Tensor          # [K, W] keyframe BoW rows
    R: torch.Tensor             # [3,3] current Tcw
    t: torch.Tensor             # [3]
    vel_R: torch.Tensor
    vel_t: torch.Tensor
    has_vel: torch.Tensor       # bool
    mode: torch.Tensor          # i32
    ref_kf: torch.Tensor        # i32
    last_kf_frame: torch.Tensor  # i32
    peak_n_local: torch.Tensor  # i32
    last: Frame                 # previous frame
    last_obs: torch.Tensor      # [N] i32
    init_f: Frame               # stashed mono-init frame
    init_fid: torch.Tensor      # i32
    init_ts: torch.Tensor       # f32
    streaks: torch.Tensor       # [K] i32 candidate consistency streaks
    loop_edge_a: torch.Tensor   # [MAX_LOOP_EDGES] i32
    loop_edge_b: torch.Tensor   # [MAX_LOOP_EDGES] i32
    loop_edge_ok: torch.Tensor  # [MAX_LOOP_EDGES] bool
    n_loops: torch.Tensor       # i32 closures so far
    last_loop_nkf: torch.Tensor  # i32 map.n_kf at the last closure
    n_resets: torch.Tensor      # i32 auto-resets
    n_kf_skipped: torch.Tensor  # i32 keyframes wanted with the map full
    n_gba: torch.Tensor         # i32 live global BAs
    closure_rec: torch.Tensor   # [MAX_CLOSURE_REC, CLOSURE_REC_W] f32
    traj: torch.Tensor          # [F, 12] packed Tcr
    traj_ref: torch.Tensor      # [F] i32 reference keyframe slot
    traj_ok: torch.Tensor       # [F] bool
    ring_mode: torch.Tensor     # [F] i32 mode after the frame
    ring_nlocal: torch.Tensor   # [F] i32 inliers
    ring_loop: torch.Tensor     # [F, 8] f32 loop-funnel diag

    def replace(self, **kw) -> "FreeState":
        return dataclasses.replace(self, **kw)


def _i32(v, dev) -> torch.Tensor:
    # a fill on the device: torch.tensor(v, device=...) would copy from
    # pageable host memory, which waits for the card
    return torch.full((), v, dtype=torch.int32, device=dev)


def _empty_frame(n: int, device=None) -> Frame:
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    return Frame(xy=z(n, 2), xy_raw=z(n, 2), ur=torch.full((n,), -1.0, device=device),
                 depth=z(n), octave=z(n, dt=torch.int32), angle=z(n), response=z(n),
                 desc=z(n, DESC_WORDS, dt=torch.int32), valid=z(n, dt=torch.bool))


def init_state(cfg: SlamConfig, n_words: int, max_frames: int, device=None,
               mesh=None) -> FreeState:
    """A fresh state; with a `mesh` the map holds this rank's point rows."""
    n, K, F = cfg.n_features, cfg.max_kf, max_frames
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    eye = torch.eye(3, device=device)
    return FreeState(
        m=ms.empty_map(K, cfg.max_mp, n, device=device, mesh=mesh), bows=z(K, n_words),
        R=eye.clone(), t=z(3), vel_R=eye.clone(), vel_t=z(3), has_vel=z(dt=torch.bool),
        mode=_i32(MODE_FIRST, device), ref_kf=_i32(0, device), last_kf_frame=_i32(-999, device),
        peak_n_local=_i32(0, device), last=_empty_frame(n, device),
        last_obs=torch.full((n,), -1, dtype=torch.int32, device=device),
        init_f=_empty_frame(n, device), init_fid=_i32(-1, device), init_ts=z(),
        streaks=z(K, dt=torch.int32), loop_edge_a=z(MAX_LOOP_EDGES, dt=torch.int32),
        loop_edge_b=z(MAX_LOOP_EDGES, dt=torch.int32),
        loop_edge_ok=z(MAX_LOOP_EDGES, dt=torch.bool), n_loops=_i32(0, device),
        last_loop_nkf=_i32(0, device), n_resets=_i32(0, device), n_kf_skipped=_i32(0, device),
        n_gba=_i32(0, device), closure_rec=z(MAX_CLOSURE_REC, CLOSURE_REC_W),
        traj=z(F, 12), traj_ref=z(F, dt=torch.int32), traj_ok=z(F, dt=torch.bool),
        ring_mode=z(F, dt=torch.int32), ring_nlocal=z(F, dt=torch.int32), ring_loop=z(F, 8))


def seeded(gen: torch.Generator, *parts: int) -> torch.Generator:
    """`gen` re-seeded from the integers `parts` (seed + offset, frame id,
    ...): the same parts give the same draws, whatever ran before."""
    state = np.random.SeedSequence([p & 0xFFFFFFFF for p in parts]).generate_state(2, np.uint32)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _where_frame(keep, a: Frame, b: Frame) -> Frame:
    return Frame(**{f.name: torch.where(keep, getattr(a, f.name), getattr(b, f.name))
                    for f in dataclasses.fields(Frame)})


def make_step(cfg: SlamConfig):
    """The free-running step for a fixed config: ``step(cam, tab, vocab, st,
    *images, frame_id, ts, loc_only) -> FreeState`` with one image (mono),
    image and depth (RGB-D) or the left and right images (stereo); frame_id,
    ts and loc_only are host values."""
    ecfg = cfg.extractor
    N = cfg.n_features
    has_depth = cfg.sensor in ("stereo", "rgbd")
    MIN_TRACK, MIN_LOCAL = cfg.min_inliers_track, cfg.min_inliers_local
    MINF, MAXF, KF_RATIO = cfg.min_frames_between_kf, cfg.max_frames_between_kf, cfg.kf_ref_ratio
    INIT_MIN, TH_DEPTH, SEED = cfg.init_min_matches, cfg.th_depth, cfg.seed
    EN_FUSE = cfg.enable_fuse
    # live GBA only at tiers where its closure-frame cost is affordable;
    # above the bound finish() runs the deferred GBA instead
    EN_LIVE_GBA = cfg.free_live_gba and cfg.max_kf <= cfg.free_live_gba_max_kf
    LCFG = LoopCloserConfig(fix_scale=cfg.sensor != "mono")
    gens: dict = {}

    def gen_for(dev, *parts) -> torch.Generator:
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev)
        return seeded(gens[dev], *parts)

    def live_gba(cam, m: ms.MapState) -> ms.MapState:
        """Full-map BA right after a closure, anchored at the oldest
        keyframe, then the points' geometry (BA changes no descriptor)."""
        with record_function("loop/gba"):
            big = torch.iinfo(torch.int32).max
            anchor = torch.argmin(torch.where(m.kf_valid, m.kf_frame_id, big))
            R, t, X, _ = global_ba_cg(cam, m, anchor, LCFG.global_ba_iters, cg_iters=25)
            return ms.update_mappoint_geometry(m.replace(kf_R=R, kf_t=t, mp_pos=X))

    def write_rec(st: FreeState, i: int, ref, Rcr, tcr, ok, mode, n_local) -> FreeState:
        if 0 <= i < st.traj.shape[0]:        # the reference drops out-of-range writes
            st.traj[i] = torch.cat([Rcr.reshape(9), tcr.reshape(3)])
            st.traj_ref[i] = ref
            st.traj_ok[i] = ok
            st.ring_mode[i] = mode
            st.ring_nlocal[i] = n_local
        return st

    # ---------------- keyframe chain ---------------------------------

    def run_chain(cam, vocab, st: FreeState, frame: Frame, slot: int, frame_id: int, ts: float):
        dev = st.m.device
        with record_function("mapping/keyframe"):
            m, cull = lm.keyframe_chain(
                st.m, cam, frame, slot, st.R, st.t, st.last_obs, frame_id, ts,
                TH_DEPTH * cam.bf / cam.fx if has_depth else None,
                do_cull_recent=cfg.enable_cull, stats_in_triangulate=EN_FUSE, do_fuse=EN_FUSE,
                do_local_ba=cfg.enable_local_ba, do_kf_cull=cfg.enable_kf_culling)
        # re-reference ring records whose reference keyframe was culled:
        # Tcr' = Tcr Trel, in place
        Rcr = st.traj[:, :9].reshape(-1, 3, 3)
        tcr = st.traj[:, 9:12]
        for i in range(cull.slots.shape[0]):
            hit = st.traj_ok & cull.ok[i] & (st.traj_ref == cull.slots[i])
            t_new = Rcr @ cull.t_rel[i] + tcr
            R_new = Rcr @ cull.R_rel[i]
            Rcr = torch.where(hit[:, None, None], R_new, Rcr)
            tcr = torch.where(hit[:, None], t_new, tcr)
            st.traj_ref.copy_(torch.where(hit, cull.new_ref[i], st.traj_ref))
        st.traj.copy_(torch.cat([Rcr.reshape(-1, 9), tcr], 1))

        if cfg.enable_loop_closing:
            out = free_loop_stage(
                LCFG, cam, vocab, m, st.bows, slot, st.streaks, st.loop_edge_a, st.loop_edge_b,
                st.loop_edge_ok, st.n_loops, st.last_loop_nkf,
                lambda i, stage, valid, n: sample_sim3_sets(
                    gen_for(dev, SEED + SEED_LOOP, frame_id, i, stage), valid, n),
                frame_id=frame_id, closure_rec=st.closure_rec)
            m, n_gba, crec = out.m, st.n_gba, out.closure_rec
            if EN_LIVE_GBA and out.closed:
                m = live_gba(cam, m)
                n_gba = n_gba + 1
                crec[torch.remainder(out.n_loops - 1, MAX_CLOSURE_REC).long(), 10] = 1.0
            if 0 <= frame_id < st.ring_loop.shape[0]:
                st.ring_loop[frame_id] = out.diag
            st = st.replace(bows=out.bows, streaks=out.streaks, loop_edge_a=out.loop_a,
                            loop_edge_b=out.loop_b, loop_edge_ok=out.loop_ok,
                            n_loops=out.n_loops, last_loop_nkf=out.last_loop_nkf, n_gba=n_gba,
                            closure_rec=crec, has_vel=st.has_vel & (not out.closed))
        else:
            st.bows[slot] = voc.bow_vector(vocab, m.kf_desc[slot], m.kf_feat_valid[slot])
        # the tracker adopts the keyframe's (BA-adjusted, maybe loop-corrected)
        # pose and its observation row
        return st.replace(m=m, R=m.kf_R[slot], t=m.kf_t[slot], last_obs=m.kf_obs[slot],
                          ref_kf=_i32(slot, dev), last_kf_frame=_i32(frame_id, dev),
                          peak_n_local=_i32(0, dev))

    # ---------------- tracking branch (mode OK / LOST) ----------------

    def run_reloc(cam, vocab, st: FreeState, frame: Frame, frame_id: int):
        """Relocalization: (success 0-d, LocalMapTrack, reference slot 0-d)."""
        with record_function("tracking/relocalize"):
            cand = tk.relocalize_candidates(cam, st.m, frame, vocab, st.bows,
                                            gen_for(st.m.device, SEED + SEED_RELOC, frame_id))
            res = tk.track_local_map(cam, st.m, frame, cand.R, cand.t, cand.obs)
        ok = (cand.best_slot >= 0) & (res.n_inliers >= 50)
        return ok, res, torch.clamp_min(cand.best_slot, 0).to(torch.int32)

    def track_branch(cam, vocab, st: FreeState, frame: Frame, frame_id: int, ts: float,
                     loc_only: bool, hdr: dict):
        dev = st.m.device
        was_ok = hdr["mode"] == MODE_OK
        with record_function("tracking/step"):
            step = tk.track_frame(cam, st.m, frame, st.last, st.last_obs, st.R, st.t, st.vel_R,
                                  st.vel_t, hdr["has_vel"] and was_ok, hdr["ref_kf"])
        track_ok = was_ok and step.n_pre >= MIN_TRACK and step.n_local >= MIN_LOCAL
        need_reloc = not track_ok and hdr["n_kf"] >= 2
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        if track_ok:
            ok = torch.ones((), dtype=torch.bool, device=dev)
            R, t, obs, ref = step.R, step.t, step.obs, st.ref_kf
            n_loc = _i32(step.n_local, dev)
            mp_visible, mp_found = step.mp_visible, step.mp_found
            vel_R, vel_t = step.vel_R, step.vel_t
        else:
            if need_reloc:
                ok, res, ref = run_reloc(cam, vocab, st, frame, frame_id)
                R, t, obs, n_loc = res.R, res.t, res.obs, res.n_inliers.to(torch.int32)
                mp_visible = torch.where(ok, res.mp_visible, st.m.mp_visible)
                mp_found = torch.where(ok, res.mp_found, st.m.mp_found)
            else:
                ok = torch.zeros((), dtype=torch.bool, device=dev)
                R, t, ref, n_loc = eye, zero, _i32(0, dev), _i32(0, dev)
                obs = torch.full((N,), -1, dtype=torch.int32, device=dev)
                mp_visible, mp_found = st.m.mp_visible, st.m.mp_found
            vel_R, vel_t = eye, zero
        peak = torch.where(ok, torch.maximum(st.peak_n_local, n_loc), st.peak_n_local)
        st2 = st.replace(
            m=st.m.replace(mp_visible=mp_visible, mp_found=mp_found), R=R, t=t, vel_R=vel_R,
            vel_t=vel_t, has_vel=torch.full((), track_ok, dtype=torch.bool, device=dev),
            mode=torch.where(ok, MODE_OK, MODE_LOST).to(torch.int32), ref_kf=ref,
            peak_n_local=peak, last=frame, last_obs=obs)

        # the keyframe policy (the System's predicate, on device scalars);
        # localization mode never makes a keyframe
        since = frame_id - st2.last_kf_frame
        want_kf = ok & (not loc_only) & policy.need_new_keyframe(
            since, n_loc, peak, min_frames=MINF, max_frames=MAXF, ref_ratio=KF_RATIO,
            min_track=MIN_TRACK)
        free_slot = (~st2.m.kf_valid).any()
        need_kf = want_kf & free_slot
        # a keyframe wanted with the map full is counted, not dropped silently
        st2 = st2.replace(n_kf_skipped=st2.n_kf_skipped + (want_kf & ~free_slot).to(torch.int32))
        # auto-reset: lost with a young map (1-5 keyframes) made in this run
        # (a frame that inserts a keyframe is tracked, so it never resets)
        n_valid = st2.m.kf_valid.sum()
        need_reset = (~need_kf & ~ok & (st2.last_kf_frame >= 0) & (n_valid >= 1)
                      & (n_valid <= 5) & cfg.free_auto_reset)
        need_kf_h, slot, need_reset_h = torch.stack(
            [need_kf.long(), torch.argmin(st2.m.kf_valid.to(torch.int32)), need_reset.long()]
        ).tolist()
        st3 = run_chain(cam, vocab, st2, frame, slot, frame_id, ts) if need_kf_h else st2

        # the record: identity after a keyframe (this frame is the
        # reference), else Tcr against the reference keyframe
        if need_kf_h:
            Rcr, tcr = eye, zero
        else:
            Rr, tr = st3.m.kf_R[st3.ref_kf.long()], st3.m.kf_t[st3.ref_kf.long()]
            Rcr = R @ Rr.T
            tcr = t - Rcr @ tr
        st4 = write_rec(st3, frame_id, st3.ref_kf, Rcr, tcr, ok, st3.mode, n_loc)
        return do_reset(st4) if need_reset_h else st4

    def do_reset(s: FreeState) -> FreeState:
        """The full reset (Tracking::Reset): clear the map, database, tracker
        and loop state; every prior record is invalidated.  The counters
        (n_resets, n_kf_skipped, n_gba, closure_rec) describe the whole run
        and persist."""
        dev = s.m.device
        return s.replace(
            m=ms.clear_map(s.m), bows=torch.zeros_like(s.bows), R=torch.eye(3, device=dev),
            t=torch.zeros(3, device=dev), vel_R=torch.eye(3, device=dev),
            vel_t=torch.zeros(3, device=dev), has_vel=torch.zeros((), dtype=torch.bool, device=dev),
            mode=_i32(MODE_FIRST, dev), ref_kf=_i32(0, dev), last_kf_frame=_i32(-999, dev),
            peak_n_local=_i32(0, dev), last_obs=torch.full((N,), -1, dtype=torch.int32, device=dev),
            init_fid=_i32(-1, dev), init_ts=torch.zeros((), device=dev),
            streaks=torch.zeros_like(s.streaks), loop_edge_ok=torch.zeros_like(s.loop_edge_ok),
            n_loops=_i32(0, dev), last_loop_nkf=_i32(0, dev), traj_ok=torch.zeros_like(s.traj_ok),
            n_resets=s.n_resets + 1)

    # ---------------- initialization branches --------------------------

    def init_branch_mono(cam, vocab, st: FreeState, frame: Frame, frame_id: int, ts: float,
                         hdr: dict):
        dev = st.m.device
        usable = frame.valid.sum() >= INIT_MIN
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        if hdr["mode"] != MODE_SECOND:
            # stash this frame (the mode says whether it was usable)
            st2 = st.replace(
                init_f=frame, init_fid=torch.where(usable, frame_id, st.init_fid).to(torch.int32),
                init_ts=torch.where(usable, ts, st.init_ts).to(torch.float32),
                mode=torch.where(usable, MODE_SECOND, MODE_FIRST).to(torch.int32))
            return write_rec(st2, frame_id, st2.ref_kf, eye, zero, false, st2.mode, 0)
        f0 = st.init_f
        with record_function("init/mono"):
            res = matching.search_for_initialization(f0, frame, window=100.0)
            x2 = frame.xy[torch.clamp_min(res.idx, 0).long()]
            # 512 hypotheses (the System draws 200); with fewer than 8 matches
            # the sets come from all N (then nothing can pass the gates)
            matched = torch.where(res.matched.sum() >= 8, res.matched, True)
            samples = initializer.sample_minimal_sets(gen_for(dev, SEED + SEED_INIT, frame_id),
                                                      matched, 512)
            init = initializer.initialize_from_samples(samples, f0.xy, x2, res.matched,
                                                       cam.K(dev), 1.0, min_parallax_deg=2.5)
            enough = res.count >= INIT_MIN
            succ = bool(init.success & enough)
        if succ:
            with record_function("init/mono"):
                m, obs1 = policy.build_mono_init_map(st.m, cam, f0, frame, init, res.idx,
                                                     st.init_fid, st.init_ts, frame_id, ts)
                for s in (0, 1):
                    st.bows[s] = voc.bow_vector(vocab, m.kf_desc[s], m.kf_feat_valid[s])
            st2 = st.replace(m=m, R=m.kf_R[1], t=m.kf_t[1], has_vel=false,
                             mode=_i32(MODE_OK, dev), ref_kf=_i32(1, dev),
                             last_kf_frame=_i32(frame_id, dev), peak_n_local=_i32(0, dev),
                             last=frame, last_obs=obs1)
            return write_rec(st2, frame_id, st2.ref_kf, eye, zero, ~false, st2.mode,
                             init.n_good.to(torch.int32))
        # a geometric failure with matches still healthy keeps the stashed
        # frame so the baseline accumulates; match starvation restarts from
        # this frame
        keep = enough | (init.n_good >= 40)
        st2 = st.replace(
            init_f=_where_frame(keep, st.init_f, frame),
            init_fid=torch.where(keep, st.init_fid, frame_id).to(torch.int32),
            init_ts=torch.where(keep, st.init_ts, ts).to(torch.float32),
            mode=torch.where(keep | usable, MODE_SECOND, MODE_FIRST).to(torch.int32))
        return write_rec(st2, frame_id, st2.ref_kf, eye, zero, false, st2.mode,
                         res.count.to(torch.int32))

    def init_branch_depth(cam, vocab, st: FreeState, frame: Frame, frame_id: int, ts: float,
                          hdr: dict):
        dev = st.m.device
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        n_depth = (frame.valid & (frame.depth > 0)).sum()
        go, slot = torch.stack([(n_depth >= 300).long(),
                                torch.argmin(st.m.kf_valid.to(torch.int32))]).tolist()
        if not go:
            return write_rec(st, frame_id, st.ref_kf, eye, zero,
                             torch.zeros((), dtype=torch.bool, device=dev), st.mode, 0)
        with record_function("init/depth"):
            m = policy.build_depth_init_map(st.m, cam, frame, slot, frame_id, ts,
                                            TH_DEPTH * cam.bf / cam.fx)
            st.bows[slot] = voc.bow_vector(vocab, m.kf_desc[slot], m.kf_feat_valid[slot])
        st2 = st.replace(m=m, R=eye, t=zero, has_vel=torch.zeros((), dtype=torch.bool, device=dev),
                         mode=_i32(MODE_OK, dev), ref_kf=_i32(slot, dev),
                         last_kf_frame=_i32(frame_id, dev), peak_n_local=_i32(0, dev),
                         last=frame, last_obs=m.kf_obs[slot])
        return write_rec(st2, frame_id, st2.ref_kf, eye, zero,
                         torch.ones((), dtype=torch.bool, device=dev), st2.mode,
                         n_depth.to(torch.int32))

    init_branch = init_branch_depth if has_depth else init_branch_mono

    # ---------------- the step ----------------------------------------

    def body(cam, vocab, st: FreeState, frame: Frame, frame_id: int, ts: float, loc_only: bool):
        mode, has_vel, ref_kf, n_kf = torch.stack(
            [st.mode, st.has_vel.to(torch.int32), st.ref_kf, st.m.n_kf]).tolist()
        hdr = dict(mode=mode, has_vel=bool(has_vel), ref_kf=ref_kf, n_kf=n_kf)
        if mode <= MODE_SECOND:
            return init_branch(cam, vocab, st, frame, frame_id, ts, hdr)
        return track_branch(cam, vocab, st, frame, frame_id, ts, loc_only, hdr)

    def step_mono(cam, tab, vocab, st, image, frame_id, ts, loc_only):
        with record_function("frontend/extract"):
            frame = make_frame_mono(image, cam, tab, ecfg)
        return body(cam, vocab, st, frame, frame_id, ts, loc_only)

    def step_rgbd(cam, tab, vocab, st, image, depth, frame_id, ts, loc_only):
        with record_function("frontend/extract"):
            frame = make_frame_rgbd(image, depth, cam, tab, ecfg)
        return body(cam, vocab, st, frame, frame_id, ts, loc_only)

    def step_stereo(cam, tab, vocab, st, image_l, image_r, frame_id, ts, loc_only):
        with record_function("frontend/extract"):
            frame = make_frame_stereo(image_l, image_r, cam, tab, ecfg)
        return body(cam, vocab, st, frame, frame_id, ts, loc_only)

    return {"rgbd": step_rgbd, "stereo": step_stereo}.get(cfg.sensor, step_mono)


def make_scan_step(cfg: SlamConfig, chunk: int):
    """Batch mode: ``scan(cam, tab, vocab, st, imgs, frame_ids, tss,
    loc_only)`` runs the per-frame step over `chunk` frames whose images
    (`imgs`: one [chunk, H, W] tensor per input) were uploaded in one copy
    each."""
    step = make_step(cfg)

    def scan_steps(cam, tab, vocab, st: FreeState, imgs, frame_ids, tss, loc_only) -> FreeState:
        for k in range(chunk):
            st = step(cam, tab, vocab, st, *(a[k] for a in imgs), frame_ids[k], tss[k], loc_only)
        return st

    return scan_steps


class FreeRunner:
    """The host side of the free-running loop.

    ``track_mono`` / ``track_rgbd`` / ``track_stereo`` run one frame's step
    (reading only its decision scalars); ``finish()`` reads the rings and
    the map once and returns the trajectory.  With the System it shares
    capacity growth (``grow`` / auto-growth by the read-free upper bound of
    one keyframe per ``min_frames_between_kf`` frames), the auto-reset after
    an early loss, localization mode and map save / load.  With
    ``shard_points`` at a world above one the map's point axis is split
    over the ranks, as in System."""

    def __init__(self, cam: CameraModel, config: SlamConfig | None = None,
                 max_frames: int = 4096, auto_grow: bool = True, device="cuda"):
        cfg = config or SlamConfig()
        if cfg.sensor not in SENSORS:
            raise ValueError(f"unknown sensor {cfg.sensor!r}: one of {SENSORS}")
        if cfg.max_mp < cfg.n_features:
            raise ValueError("the mono bootstrap maps feature index -> point slot: "
                             "max_mp must be >= n_features")
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_frames = max_frames
        self.auto_grow = auto_grow
        self.tab = OrbTables().to(self.device)
        self._mesh = point_mesh(cfg)
        # the vocabulary through LoopCloser's loader (the trained one)
        self._lc = LoopCloser(cam, cfg.max_kf, LoopCloserConfig(fix_scale=cfg.sensor != "mono"),
                              seed=cfg.seed + 1, device=self.device)
        self.vocab = self._lc.vocab
        self.state = self._init_state(self.cfg)
        self._step = make_step(self.cfg)
        self.frame_id = -1
        self._scan_cache: dict = {}
        self._timestamps: list[float] = []
        self._finished = None
        self._loc_only = False
        self._grow_base = 0
        # the P/K ratio, pinned so auto-growth and prewarm_tiers agree
        self._mp_ratio = max(1, cfg.max_mp // cfg.max_kf)
        self.growth_events: list[tuple] = []   # (frame_id, K, P, max_frames)

    def _init_state(self, cfg: SlamConfig) -> FreeState:
        return init_state(cfg, self._lc.cfg.n_words, self.max_frames, self.device, self._mesh)

    # -- mode control ---------------------------------------------------

    def activate_localization_mode(self):
        """Track against the frozen map without making keyframes, from the
        next frame on."""
        self._loc_only = True

    def deactivate_localization_mode(self):
        self._loc_only = False

    # -- capacity growth ------------------------------------------------

    def grow(self, new_max_kf: int | None = None, new_max_mp: int | None = None,
             new_max_frames: int | None = None):
        """Move the state into larger keyframe / map-point tiers and / or
        longer per-frame rings; existing slots keep their indices."""
        st = self.state
        K_old = st.m.K
        if new_max_kf is not None or new_max_mp is not None:
            m = ms.grow_map(st.m, new_K=new_max_kf, new_P=new_max_mp)
            st = st.replace(m=m)
            if m.K > K_old:
                dK = m.K - K_old
                st = st.replace(
                    bows=torch.cat([st.bows, st.bows.new_zeros((dK, st.bows.shape[1]))]),
                    streaks=torch.cat([st.streaks, st.streaks.new_zeros(dK)]))
            self.cfg = dataclasses.replace(self.cfg, max_kf=m.K, max_mp=m.P)
        if new_max_frames is not None and new_max_frames > self.max_frames:
            dF = new_max_frames - self.max_frames
            pad = lambda a: torch.cat([a, a.new_zeros((dF,) + tuple(a.shape[1:]))])
            st = st.replace(traj=pad(st.traj), traj_ref=pad(st.traj_ref), traj_ok=pad(st.traj_ok),
                            ring_mode=pad(st.ring_mode), ring_nlocal=pad(st.ring_nlocal),
                            ring_loop=pad(st.ring_loop))
            self.max_frames = new_max_frames
        self.state = st
        self.growth_events.append((self.frame_id, self.cfg.max_kf, self.cfg.max_mp,
                                   self.max_frames))

    def _maybe_grow(self, up_to: int | None = None):
        """Grow before the read-free bound on insertions (2 bootstrap
        keyframes + one per min_frames_between_kf frames) reaches the
        keyframe tier, the point tier in proportion; double the rings when
        the frame counter reaches them.  `up_to` sizes for the last frame of
        a chunk."""
        fid = self.frame_id if up_to is None else up_to
        if not self.auto_grow:
            if fid >= self.max_frames:
                raise RuntimeError(f"FreeRunner ring capacity exceeded: frame {fid} >= "
                                   f"max_frames={self.max_frames} (auto_grow=False; construct "
                                   "with larger max_frames)")
            return
        while fid >= self.max_frames:
            self.grow(new_max_frames=2 * self.max_frames)
        minf = max(self.cfg.min_frames_between_kf, 1)
        while 2 + (fid - self._grow_base) // minf >= self.cfg.max_kf:
            new_K = 2 * self.cfg.max_kf
            self.grow(new_max_kf=new_K, new_max_mp=self._tier_mp(new_K))

    def _tier_mp(self, K: int) -> int:
        """The point tier that goes with keyframe tier K: the pinned ratio,
        rounded up to a multiple of the ranks a split map is over."""
        n = pts.size(self._mesh)
        return -(-K * self._mp_ratio // n) * n

    def grow_tiers_for(self, n_frames: int) -> list[int]:
        """The keyframe tiers the auto-grow bound passes through over an
        n_frames run (host arithmetic only)."""
        minf = max(self.cfg.min_frames_between_kf, 1)
        bound = 2 + (n_frames - 1 - self._grow_base) // minf
        tiers, K = [], self.cfg.max_kf
        while bound >= K:
            K *= 2
            tiers.append(K)
        return tiers

    def _zeros_input(self, shape, lead=()):
        """A frame's zero inputs (a depth of ones for RGB-D)."""
        h, w = shape
        img = torch.zeros(lead + (h, w), dtype=torch.uint8, device=self.device)
        if self.cfg.sensor == "rgbd":
            return img, torch.ones(lead + (h, w), dtype=torch.float32, device=self.device)
        return (img, img.clone()) if self.cfg.sensor == "stereo" else (img,)

    def prewarm_tiers(self, tiers: list[int] | None = None, n_frames: int | None = None,
                      image_shape=None):
        """Run two frames at each future keyframe tier on throwaway state
        (nothing is shared with ``state``).  The reference compiles its step
        there; torch compiles nothing, so this only warms the allocator and
        the first launches at those shapes.  Pass the `tiers` or the planned
        `n_frames`."""
        if tiers is None:
            if n_frames is None:
                raise ValueError("prewarm_tiers needs tiers or n_frames")
            tiers = self.grow_tiers_for(n_frames)
        shape = image_shape or (int(self.cam.height), int(self.cam.width))
        for K in tiers:
            cfgK = dataclasses.replace(self.cfg, max_kf=K, max_mp=self._tier_mp(K))
            st = self._init_state(cfgK)
            step = make_step(cfgK)
            for fid in (0, 1):
                st = step(self.cam, self.tab, self.vocab, st, *self._zeros_input(shape), fid, 0.0,
                          False)
            self.block()

    # -- per-frame API ----------------------------------------------------

    def _upload(self, a, dtype=None) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device) if dtype is None else t.to(self.device, dtype)

    def _track(self, timestamp: float, *inputs):
        self.frame_id += 1
        self._maybe_grow()
        self._timestamps.append(timestamp)
        self.state = self._step(self.cam, self.tab, self.vocab, self.state, *inputs,
                                self.frame_id, float(timestamp), self._loc_only)

    def track_mono(self, image, timestamp: float):
        self._track(timestamp, self._upload(image))

    def track_rgbd(self, image, depth, timestamp: float):
        self._track(timestamp, self._upload(image), self._upload(depth, torch.float32))

    def track_stereo(self, image_l, image_r, timestamp: float):
        self._track(timestamp, self._upload(image_l), self._upload(image_r))

    # -- batch mode ------------------------------------------------------

    def _scan_fn(self, chunk: int):
        key = (self.cfg.sensor, chunk, self.cfg.max_kf, self.cfg.max_mp, self.cfg.n_features)
        if key not in self._scan_cache:
            self._scan_cache[key] = make_scan_step(self.cfg, chunk)
        return self._scan_cache[key]

    def _track_sequence(self, arrays, timestamps, chunk: int, dtypes):
        """Full chunks of `chunk` frames go through the scan, each input's
        chunk uploaded in one copy; the tail runs frame by frame."""
        F = arrays[0].shape[0]
        if timestamps is None:
            timestamps = [(self.frame_id + 1 + i) / 30.0 for i in range(F)]
        done = 0
        while F - done >= chunk:
            self._maybe_grow(up_to=self.frame_id + chunk)
            imgs = tuple(self._upload(a[done:done + chunk], dt) for a, dt in zip(arrays, dtypes))
            fids = list(range(self.frame_id + 1, self.frame_id + 1 + chunk))
            tss = [float(x) for x in timestamps[done:done + chunk]]
            self.state = self._scan_fn(chunk)(self.cam, self.tab, self.vocab, self.state, imgs,
                                              fids, tss, self._loc_only)
            self.frame_id += chunk
            self._timestamps.extend(timestamps[done:done + chunk])
            done += chunk
        for i in range(done, F):
            self._track(timestamps[i], *(self._upload(a[i], dt) for a, dt in zip(arrays, dtypes)))

    def track_mono_sequence(self, images, timestamps=None, chunk: int = 48):
        """Batch mode: `chunk` frames a call of the scan."""
        self._track_sequence((np.asarray(images),), timestamps, chunk, (None,))

    def track_rgbd_sequence(self, images, depths, timestamps=None, chunk: int = 48):
        self._track_sequence((np.asarray(images), np.asarray(depths, np.float32)), timestamps,
                             chunk, (None, torch.float32))

    def track_stereo_sequence(self, images_l, images_r, timestamps=None, chunk: int = 48):
        self._track_sequence((np.asarray(images_l), np.asarray(images_r)), timestamps, chunk,
                             (None, None))

    def warmup(self, image_shape=None):
        """Two zero frames through the step on throwaway state (nothing is
        shared with ``state``): the reference compiles its program here;
        torch compiles nothing, so this warms the allocator and the first
        launches."""
        shape = image_shape or (int(self.cam.height), int(self.cam.width))
        st = self._init_state(self.cfg)
        for fid in (0, 1):
            st = self._step(self.cam, self.tab, self.vocab, st, *self._zeros_input(shape), fid,
                            0.0, False)
        self.block()

    def warmup_sequence(self, chunk: int = 48, image_shape=None):
        """The scan over `chunk` zero frames on throwaway state (as warmup)."""
        shape = image_shape or (int(self.cam.height), int(self.cam.width))
        st = self._init_state(self.cfg)
        self._scan_fn(chunk)(self.cam, self.tab, self.vocab, st,
                             self._zeros_input(shape, (chunk,)), list(range(chunk)),
                             [0.0] * chunk, False)
        self.block()

    def block(self):
        """Wait for the card's queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- map save / load ---------------------------------------------------

    def save_map(self, path: str):
        """Persist the map: the finished one after ``finish()`` (its global BA
        folded in), else the live state's.  The header's extra holds
        frame_id."""
        from ..io import checkpoint

        m = self._finished["map"] if self._finished is not None else self.state.m
        checkpoint.save_map(path, m, extra={"frame_id": self.frame_id})

    def load_map(self, path: str):
        """Restore a saved map (of either runner or a System) before
        tracking: the runner starts LOST and relocalizes into it.  The
        configured tiers grow to fit the file; the BoW rows are rebuilt from
        its keyframes (one kernel-5 launch over all K slots)."""
        from ..io import checkpoint

        if self.frame_id != -1:
            raise RuntimeError("load_map must precede tracking")
        m, _ = checkpoint.load_map(path, self.device)
        if m.N != self.cfg.n_features:
            raise ValueError(f"the map has N={m.N} features a keyframe, the runner "
                             f"n_features={self.cfg.n_features}")
        m = ms.grow_map(m, new_K=max(m.K, self.cfg.max_kf), new_P=max(m.P, self.cfg.max_mp))
        if self._mesh is not None:
            m = mesh_mod.shard_map_state(m, self._mesh)
        if m.K > self.cfg.max_kf or m.P > self.cfg.max_mp:
            self.cfg = dataclasses.replace(self.cfg, max_kf=m.K, max_mp=m.P)
            self.state = self._init_state(self.cfg)
        # re-pin the P/K ratio to the (maybe larger) loaded tiers, so a later
        # auto-grow (new_P = 2 K ratio) cannot ask grow_map to shrink P
        self._mp_ratio = max(self._mp_ratio, -(-self.cfg.max_mp // self.cfg.max_kf))
        self.state = self.state.replace(m=m, bows=policy.keyframe_bows(self.vocab, m),
                                        mode=_i32(MODE_LOST, self.device))

    # -- one readback ------------------------------------------------------

    def finish(self, resolve_loops: bool = False) -> dict:
        """Read the rings and the map once and recover every frame's pose
        through its (loop-corrected) reference keyframe.  Closures happen
        live during the run; resolve_loops=True also replays detection and
        resolution over the recorded keyframes (for runs with live closing
        off).  A global BA runs here only when closures are not covered by
        live ones.

        Returns a dict: trajectory [(frame_id, 4x4 Tcw or None)], map,
        modes, n_local, loop_diag, n_keyframes, n_mappoints,
        n_loops_closed, n_gba, n_resets, n_kf_skipped_full,
        n_loop_edges_dropped, closure_records, timestamps."""
        if self._finished is not None:
            return self._finished
        st = self.state
        n = self.frame_id + 1
        traj = st.traj[:n].cpu().numpy()
        traj_ref = st.traj_ref[:n].cpu().numpy()
        traj_ok = st.traj_ok[:n].cpu().numpy()
        m = st.m
        n_loops, n_gba = int(st.n_loops), int(st.n_gba)
        if resolve_loops:
            m, extra = self._replay_loops(m, st)
            n_loops += extra
        live_covered = self.cfg.enable_loop_closing and self.cfg.free_live_gba and n_gba >= n_loops
        if n_loops > 0 and self._lc.cfg.run_global_ba and not live_covered:
            m = self._global_ba(m)
        kf_R, kf_t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
        out = []
        for k in range(n):
            if not traj_ok[k]:
                out.append((k, None))
                continue
            Rcr, tcr = traj[k, :9].reshape(3, 3), traj[k, 9:12]
            ref = int(traj_ref[k])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = Rcr @ kf_R[ref]
            T[:3, 3] = Rcr @ kf_t[ref] + tcr
            out.append((k, T))
        # the closure records, oldest first
        crec = st.closure_rec.cpu().numpy()
        C = crec.shape[0]
        if n_loops <= C:
            records = crec[:n_loops]
        else:
            roll = n_loops % C
            records = np.concatenate([crec[roll:], crec[:roll]], 0)
        self._finished = dict(
            trajectory=out, map=m, modes=st.ring_mode[:n].cpu().numpy(),
            n_local=st.ring_nlocal[:n].cpu().numpy(), loop_diag=st.ring_loop[:n].cpu().numpy(),
            n_keyframes=int(m.kf_valid.sum()),
            n_mappoints=int(pts.sum_points(m.mesh, m.mp_valid.sum())),
            n_loops_closed=n_loops, n_gba=n_gba, n_resets=int(st.n_resets),
            n_kf_skipped_full=int(st.n_kf_skipped),
            n_loop_edges_dropped=max(0, n_loops - MAX_LOOP_EDGES), closure_records=records,
            timestamps=self._timestamps)
        return self._finished

    def _global_ba(self, m: ms.MapState) -> ms.MapState:
        """Full-map BA anchored at the oldest keyframe."""
        fid = m.kf_frame_id.cpu().numpy()
        anchor = int(np.argmin(np.where(m.kf_valid.cpu().numpy(), fid, 1 << 30)))
        R, t, X, _ = global_ba_cg(self.cam, m, anchor, self._lc.cfg.global_ba_iters)
        return ms.update_mappoint_geometry(m.replace(kf_R=R, kf_t=t, mp_pos=X))

    def _replay_loops(self, m: ms.MapState, st: FreeState):
        """Loop detection for every keyframe in one batched pass
        (batch_detect_loops) and one read, then the LoopCloser's streak
        bookkeeping and resolution in insertion order, the Sim3 funnel only
        for confirmed candidates.  Returns (map, closures)."""
        lc = self._lc
        kf_valid = m.kf_valid.cpu().numpy()
        fids = m.kf_frame_id.cpu().numpy()
        order = [s for s in np.argsort(fids, kind="stable") if kf_valid[s]]
        cands, oks, covrows = batch_detect_loops(lc.vocab, m, st.bows, lc.cfg.gap_kf)
        closed = 0
        for i, slot in enumerate(order):
            det = LoopDetectOut(st.bows, cands[slot], oks[slot], covrows[slot])
            m, did = lc.resolve_detection(m, int(slot), det, seq_i=i)
            closed += bool(did)
        return m, closed


__all__ = ["FreeRunner", "FreeState", "make_step", "make_scan_step", "init_state"]
