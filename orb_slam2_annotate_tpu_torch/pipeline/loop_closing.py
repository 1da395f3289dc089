"""Loop closing: detection, Sim3, loop correction, global BA (port of
pipeline/loop_closing.py).

``detect_loop_device`` runs on every keyframe: it writes the keyframe's BoW
row into the database (which relocalization reads) and retrieves loop
candidates.  ``LoopCloser.resolve_detection`` keeps the covisibility
consistency streaks and, for a confirmed candidate, runs the ComputeSim3
funnel (entry match, Sim3 RANSAC on kernel 7, guided matching, Sim3 LM on
kernel 8, the loop-neighbourhood projection count, the pair-set RANSAC), the
drift gate, and the correction: the essential graph, the corrected poses
and points, SearchAndFuse across the seam, and a global BA whose result
``maybe_fold_gba`` folds in once the device has finished it.  The stages
are ``torch.profiler.record_function`` spans: loop/detect, loop/sim3,
loop/correct (with loop/pose_graph and loop/fuse inside), loop/gba and
loop/fold.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch.profiler import record_function

from ..geometry import lie
from ..geometry.camera import CameraModel, in_image
from ..kernels.hamming import WindowGate
from ..ops import matching
from ..ops.orb import DESC_WORDS
from ..ops.sorting import stable_topk
from ..solvers import sim3 as sim3_solver
from ..solvers.ba_cg import bundle_adjust_cg
from ..solvers.ba_core import BAProblem
from ..solvers.pose_graph import (PoseGraphProblem, edge_measurement, optimize_pose_graph,
                                  optimize_pose_graph_cg)
from ..worldmap import map_state as ms
from ..worldmap import vocabulary as voc

# the trained 16384-word vocabulary (a byte-identical copy of the reference's
# asset, checked by tests/test_torch_system.py), read by path with numpy
TRAINED_VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "worldmap", "trained_vocab.npz")
MIN_COVIS_LOOP = 100  # essential-graph covisibility edge weight
MAX_LOOP_EDGES = 16   # historic loop edges in an essential-graph solve


@dataclasses.dataclass
class LoopDetectOut:
    db_bows: torch.Tensor     # [K, W] database with the new row written
    cands: torch.Tensor       # [8] candidate slots
    ok: torch.Tensor          # [8] bool
    cand_covis: torch.Tensor  # [8, K] int32 covisibility rows of the candidates


def detect_loop_device(vocab: voc.Vocabulary, db_bows: torch.Tensor, m: ms.MapState, slot: int,
                       gap_kf: int = 10) -> LoopDetectOut:
    """BoW vector of keyframe `slot`, the lowest score among its covisible
    neighbours, and candidates outside its covisible group and the `gap_kf`
    newest keyframes."""
    K = m.K
    bow = voc.bow_vector(vocab, m.kf_desc[slot], m.kf_feat_valid[slot])
    covis_mask = ms.covis_row(m, slot) > 0
    covis_mask[slot] = True
    others = covis_mask & m.kf_valid & (torch.arange(K, device=m.device) != slot)
    scores = voc.l1_scores(db_bows, bow)
    min_score = torch.where(others, scores, float("inf")).min()
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    fid = torch.where(m.kf_valid, m.kf_frame_id, -1)
    order = torch.argsort(-fid, stable=True)
    recent = torch.zeros(K, dtype=torch.bool, device=m.device)
    recent[order[:gap_kf]] = True
    slots, ok = voc.detect_loop_candidates(voc.KeyFrameDatabase(db_bows), bow, m.kf_valid,
                                           covis_mask | recent, min_score)
    db_new = db_bows.clone()
    db_new[slot] = bow
    return LoopDetectOut(db_new, slots, ok, ms.covis_rows(m, slots, ok).to(torch.int32))


@dataclasses.dataclass
class LoopCloserConfig:
    """The reference's LoopCloserConfig fields with the same defaults."""

    n_words: int = 16384
    consistency_th: int = 3
    min_seed_matches: int = 15
    min_seed_inliers: int = 6
    seed_hyp: int = 1024
    seed_th_chi2: float = 100.0
    verify_th_chi2: float = 100.0
    drift_rot_frac: float = 0.25
    drift_rot_abs: float = 0.12
    drift_trans_frac: float = 0.35
    drift_trans_abs_baselines: float = 2.0
    drift_log_scale_max: float = 0.5
    min_ransac_inliers: int = 12
    min_total_matches: int = 25
    max_sim3_candidates: int = 5
    fix_scale: bool = False
    pose_graph_iters: int = 15
    gap_kf: int = 3
    cooldown_kf: int = 10
    run_global_ba: bool = True
    global_ba_iters: int = 10
    use_dist_gba: bool = True




def _pred_octave(max_dist: torch.Tensor, dist: torch.Tensor, top_oct: torch.Tensor) -> torch.Tensor:
    """The scale level a point at `dist` should appear at (PredictScale),
    clipped to the pyramid's top level."""
    ratio = torch.clamp_min(max_dist / torch.clamp_min(dist, 1e-9), 1.0)
    lvl = torch.ceil(torch.log(ratio) / torch.log(torch.tensor(1.2, device=ratio.device)))
    return torch.minimum(torch.clamp_min(lvl.to(torch.int32), 0), top_oct)


def _top_octave(m: ms.MapState) -> torch.Tensor:
    return torch.where(m.kf_feat_valid, m.kf_octave, 0).max()


def build_essential_graph(m: ms.MapState, slot: int, cand: int, s_c, R_c, t_c, s12, R12, t12,
                          loop_a, loop_b, loop_ok,
                          max_covis_edges: int | None = None) -> PoseGraphProblem:
    """The essential graph over all K slots: spanning-tree edges, strong
    covisibility edges (w >= 100, the C_E strongest), historic loop edges
    and the new loop edge carrying the computed Sim3.  Measurements come
    from the pre-correction poses; `slot` starts at its corrected pose and
    `cand` is held fixed."""
    K = m.K
    dev = m.device
    C_E = max_covis_edges or min(4 * K, K * K)
    parents = ms.spanning_tree_parents(m)
    tree_ok = (parents >= 0) & m.kf_valid
    tree_i = torch.clamp_min(parents, 0)
    tree_j = torch.arange(K, dtype=torch.int32, device=dev)
    W = ms.covisibility(m)
    Wu = torch.triu(W, 1) * (m.kf_valid[:, None] & m.kf_valid[None, :])
    w_flat = torch.where(Wu.reshape(-1) >= MIN_COVIS_LOOP, Wu.reshape(-1), 0)
    topw, flat_idx = stable_topk(w_flat, C_E)
    cov_i, cov_j = (flat_idx // K).to(torch.int32), (flat_idx % K).to(torch.int32)
    la, lb = loop_a.to(torch.int32), loop_b.to(torch.int32)
    loop_live = loop_ok & m.kf_valid[la.long()] & m.kf_valid[lb.long()]
    one_i = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    e_i = torch.cat([tree_i, cov_i, la, one_i(slot)])
    e_j = torch.cat([tree_j, cov_j, lb, one_i(cand)])
    e_ok = torch.cat([tree_ok, topw > 0, loop_live, torch.ones(1, dtype=torch.bool, device=dev)])
    E = e_i.shape[0]
    ones = torch.ones(E, device=dev)
    e_s, e_R, e_t = edge_measurement(ones, m.kf_R[e_i.long()], m.kf_t[e_i.long()], ones,
                                     m.kf_R[e_j.long()], m.kf_t[e_j.long()])
    si, Ri, ti = lie.sim3_inverse(torch.as_tensor(s12, device=dev), R12, t12)
    e_s, e_R, e_t = e_s.clone(), e_R.clone(), e_t.clone()
    e_s[-1], e_R[-1], e_t[-1] = si, Ri, ti
    s0 = torch.ones(K, device=dev)
    s0[slot] = s_c
    R0, t0 = m.kf_R.clone(), m.kf_t.clone()
    R0[slot], t0[slot] = R_c, t_c
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[cand] = True
    return PoseGraphProblem(s=s0, R=R0, t=t0, fixed=fixed, valid=m.kf_valid, e_i=e_i, e_j=e_j,
                            e_s=e_s, e_R=e_R, e_t=e_t, e_valid=e_ok, e_weight=ones)


def drift_accumulators(m: ms.MapState, cand: int, slot: int):
    """(accumulated rotation, path length, segments) between the two
    keyframes, walking the valid keyframes in frame-id order."""
    big = torch.iinfo(torch.int32).max
    fid = torch.where(m.kf_valid, m.kf_frame_id, big)
    order = torch.argsort(fid, stable=True)
    f_sorted = fid[order]
    sel = (f_sorted >= m.kf_frame_id[cand]) & (f_sorted <= m.kf_frame_id[slot]) & (f_sorted < big)
    Ra, ta = m.kf_R[order], m.kf_t[order]
    ca = -torch.einsum("kij,ki->kj", Ra, ta)                           # camera centres
    pair_ok = sel[:-1] & sel[1:]
    dR = torch.einsum("kij,kpj->kip", Ra[1:], Ra[:-1])
    tr = dR[:, 0, 0] + dR[:, 1, 1] + dR[:, 2, 2]
    rot = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    step = torch.linalg.norm(ca[1:] - ca[:-1], dim=-1)
    return (torch.sum(rot.abs() * pair_ok), torch.sum(step * pair_ok), torch.sum(pair_ok))


def apply_loop_correction(m: ms.MapState, s_o, R_o, t_o) -> ms.MapState:
    """Write the corrected keyframe poses (SE3 = [R, t/s]) and move every
    point with its first observing keyframe's correction X' = S_new^-1 S_old X."""
    obs_kf, _, obs_cnt, _ = ms.observation_table(m)
    first = obs_kf[:, 0].long()
    has = m.mp_valid & (obs_cnt > 0)
    xc = torch.einsum("pij,pj->pi", m.kf_R[first], m.mp_pos) + m.kf_t[first]
    xw = torch.einsum("pji,pj->pi", R_o[first], (xc - t_o[first]) / s_o[first][:, None])
    return m.replace(kf_R=torch.where(m.kf_valid[:, None, None], R_o, m.kf_R),
                     kf_t=torch.where(m.kf_valid[:, None], t_o / s_o[:, None], m.kf_t),
                     mp_pos=torch.where(has[:, None], xw, m.mp_pos))


def _project_px(cam: CameraModel, y: torch.Tensor) -> torch.Tensor:
    z = torch.clamp_min(y[..., 2], 1e-6)
    return torch.stack([cam.fx * y[..., 0] / z + cam.cx, cam.fy * y[..., 1] / z + cam.cy], dim=-1)


def sim3_guided_match(cam: CameraModel, m: ms.MapState, slot: int, cand: int, s12, R12, t12,
                      radius_scale: float = 1.0) -> torch.Tensor:
    """SearchBySim3: each keyframe's points projected through the Sim3 (or
    its inverse) into the other image and matched in a scale-predicted
    window, both directions in one kernel-3 launch (B = 2); mutually
    agreeing pairs kept.  Returns idx [N]: slot feature -> cand feature."""
    N, P = m.N, m.P
    dev = m.device
    obs1, obs2 = m.kf_obs[slot], m.kf_obs[cand]
    mp1 = torch.clamp(obs1, 0, P - 1).long()
    mp2 = torch.clamp(obs2, 0, P - 1).long()
    has1 = (obs1 >= 0) & m.kf_feat_valid[slot] & m.mp_valid[mp1]
    has2 = (obs2 >= 0) & m.kf_feat_valid[cand] & m.mp_valid[mp2]
    x1 = m.mp_pos[mp1] @ m.kf_R[slot].T + m.kf_t[slot]
    x2 = m.mp_pos[mp2] @ m.kf_R[cand].T + m.kf_t[cand]
    top_oct = _top_octave(m)
    s12 = torch.as_tensor(s12, dtype=torch.float32, device=dev)
    si, Ri, ti = lie.sim3_inverse(s12, R12, t12)
    # problem 0: cand points into the slot image; problem 1: slot points into the cand image
    y = torch.stack([s12 * (x2 @ R12.T) + t12, si * (x1 @ Ri.T) + ti])      # [2,N,3]
    src_maxd = torch.stack([s12 * m.mp_max_dist[mp2], si * m.mp_max_dist[mp1]])
    pred = _pred_octave(src_maxd, torch.linalg.norm(y, dim=-1), top_oct)
    radius = radius_scale * 7.5 * (1.2 ** pred.to(torch.float32))
    ok = torch.stack([has2, has1]) & (y[..., 2] > 0.05)
    dst = torch.tensor([slot, cand], device=dev)
    res = matching.match_gated(
        torch.stack([m.kf_desc[cand], m.kf_desc[slot]]), m.kf_desc[dst], ok,
        m.kf_feat_valid[dst], matching.TH_HIGH, 1.0,
        gate=WindowGate(_project_px(cam, y), radius.contiguous(), m.kf_xy[dst], pred,
                        m.kf_octave[dst], -1, 1))
    idx_c2s, idx_s2c = res.idx[0], res.idx[1]
    j = torch.clamp_min(idx_s2c, 0).long()
    agree = (idx_s2c >= 0) & (idx_c2s[j] == torch.arange(N, device=dev))
    return torch.where(agree, idx_s2c, -1)


def loop_projection_count(cam: CameraModel, m: ms.MapState, slot: int, cand: int, s12, R12, t12):
    """Project the loop neighbourhood's points (the candidate's and its
    covisible keyframes') into `slot` at its corrected pose and match them
    (SearchByProjection with Scw), one kernel-3 launch.  Returns (matched
    count 0-d, feat_pt [N]: the loop point each slot feature matched, -1)."""
    P, N = m.P, m.N
    dev = m.device
    W = ms.covisibility(m)
    nb_mask = (W[cand] > 0) & m.kf_valid
    nb_mask[cand] = True
    O = ms.observation_matrix(m)
    loop_pts = (O & nb_mask[:, None]).any(0) & m.mp_valid
    s12 = torch.as_tensor(s12, dtype=torch.float32, device=dev)
    s_c, R_c, t_c = lie.sim3_compose(s12, R12, t12, torch.ones((), device=dev), m.kf_R[cand],
                                     m.kf_t[cand])
    xc = s_c * (m.mp_pos @ R_c.T) + t_c
    uv = _project_px(cam, xc)
    okp = loop_pts & (xc[:, 2] > 0.05) & in_image(cam, uv)
    pred = _pred_octave(m.mp_max_dist, torch.linalg.norm(xc, dim=1), _top_octave(m))
    MAXC = min(2048, P)
    _, cnd = stable_topk(okp.to(torch.int32), MAXC)
    radius = 20.0 * (1.2 ** pred[cnd].to(torch.float32))
    res = matching.match_gated(
        m.mp_desc[cnd], m.kf_desc[slot], okp[cnd], m.kf_feat_valid[slot],
        (matching.TH_LOW + matching.TH_HIGH) // 2, 1.0,
        gate=WindowGate(uv[cnd], radius, m.kf_xy[slot], pred[cnd], m.kf_octave[slot], -1, 1))
    feat_pt = torch.full((N,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.clamp_min(res.idx, 0).long(), torch.where(res.matched, cnd.to(torch.int32), -1),
        "amax")
    return (feat_pt >= 0).sum(), feat_pt


def fold_gba_device(m: ms.MapState, gba_R, gba_t, gba_X, snap_kf, snap_mp, old_R,
                    old_t) -> ms.MapState:
    """Fold a global-BA result into the (possibly advanced) map: keyframes
    that existed at dispatch take the BA poses, newer ones keep their pose
    relative to their strongest covisible solved keyframe; points solved take
    the BA positions, newer ones move with their reference keyframe."""
    K = m.K
    live_snap = snap_kf & m.kf_valid
    new_kf = m.kf_valid & ~snap_kf
    W = ms.covisibility(m)
    w_par = torch.where(live_snap[None, :], W, -1)
    parent = torch.argmax(w_par, dim=1)
    has_par = w_par.max(1).values > 0
    Rpi, tpi = lie.se3_inverse(old_R[parent], old_t[parent])
    R_rel, t_rel = lie.se3_compose(m.kf_R, m.kf_t, Rpi, tpi)
    prop_R, prop_t = lie.se3_compose(R_rel, t_rel, gba_R[parent], gba_t[parent])
    adopt = (new_kf & has_par)
    kf_R = torch.where(live_snap[:, None, None], gba_R,
                       torch.where(adopt[:, None, None], prop_R, m.kf_R))
    kf_t = torch.where(live_snap[:, None], gba_t, torch.where(adopt[:, None], prop_t, m.kf_t))
    # mp_first_kf holds the keyframe sequence number at the point's creation,
    # which the reference reads as a slot here (it is one while no slot has
    # been reused); copied as it is
    ref = torch.clamp(m.mp_first_kf, 0, K - 1).long()
    xc = torch.einsum("pij,pj->pi", m.kf_R[ref], m.mp_pos) + m.kf_t[ref]
    x_new = torch.einsum("pji,pj->pi", kf_R[ref], xc - kf_t[ref])
    live_mp = snap_mp & m.mp_valid
    new_mp = m.mp_valid & ~snap_mp
    mp_pos = torch.where(live_mp[:, None], gba_X, torch.where(new_mp[:, None], x_new, m.mp_pos))
    return ms.update_mappoint_geometry(m.replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos))


class LoopCloser:
    """The vocabulary and keyframe database, kept up to date on every
    keyframe, and the host half of loop closing: consistency streaks, the
    Sim3 funnel, the correction and the global BA."""

    def __init__(self, cam: CameraModel, max_kf: int, config: LoopCloserConfig | None = None,
                 seed: int = 42, device="cuda"):
        self.cam = cam
        self.cfg = config or LoopCloserConfig()
        self.device = torch.device(device)
        self.vocab = self._default_vocabulary(seed)
        self.db = voc.KeyFrameDatabase.create(max_kf, self.cfg.n_words, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._streaks: dict[int, int] = {}       # candidate slot -> streak length
        self.loop_edges: list[tuple[int, int]] = []
        self.n_loops_closed = 0
        self.n_loop_edges_dropped = 0            # historic edges beyond MAX_LOOP_EDGES
        self.n_stats_overflow = 0                # seam refreshes past MAX_TOUCHED
        self._last_loop_kf = 0
        self._seq = 0
        self._gba_pending = None
        self.n_gba_dispatched = 0
        self.n_gba_folded = 0

    def _default_vocabulary(self, seed: int) -> voc.Vocabulary:
        """The trained vocabulary when it has the configured size, else a
        seeded random one (the reference's rule)."""
        if os.path.exists(TRAINED_VOCAB):
            v = voc.load_vocabulary(TRAINED_VOCAB, device=self.device)
            if v.n_words == self.cfg.n_words and v.words.shape[-1] == DESC_WORDS:
                return v
        return voc.make_vocabulary(self.cfg.n_words, seed, device=self.device)

    def grow_db(self, new_max_kf: int):
        """Grow the database's keyframe axis with the map's capacity."""
        K, W = self.db.bows.shape
        if new_max_kf > K:
            pad = torch.zeros((new_max_kf - K, W), dtype=torch.float32, device=self.device)
            self.db = voc.KeyFrameDatabase(torch.cat([self.db.bows, pad]))

    def dispatch_detection(self, m: ms.MapState, slot: int) -> LoopDetectOut:
        """Run detection for keyframe `slot` and adopt the updated database."""
        with record_function("loop/detect"):
            out = detect_loop_device(self.vocab, self.db.bows, m, slot, self.cfg.gap_kf)
        self.db = voc.KeyFrameDatabase(out.db_bows)
        return out

    def resolve_detection(self, m: ms.MapState, slot: int, det: LoopDetectOut):
        """Consistency streaks over consecutive keyframes, then, for a
        confirmed candidate, the Sim3 and the loop correction.  Returns
        (map, closed).  The cooldown counts keyframes by the map's
        monotonic keyframe counter."""
        cfg = self.cfg
        seq = int(m.n_kf)
        self._seq = seq
        if seq < self._last_loop_kf + cfg.cooldown_kf:
            self._streaks = {}
            return m, False
        cands_np = det.cands.cpu().numpy()
        ok_np = det.ok.cpu().numpy()
        covrows = det.cand_covis.cpu().numpy()
        cands = [(int(c), covrows[i]) for i, (c, o) in enumerate(zip(cands_np, ok_np)) if o]
        new_streaks: dict[int, int] = {}
        confirmed: list[int] = []
        for c, wrow in cands:
            streak = 1
            for prev, n in self._streaks.items():
                if prev == c or wrow[prev] > 0:
                    streak = max(streak, n + 1)
            new_streaks[c] = streak
            if streak >= cfg.consistency_th:
                confirmed.append(c)
        self._streaks = new_streaks
        if not confirmed:
            return m, False
        # every consistent candidate, in score order, until one passes
        res, matched = None, -1
        for c in confirmed[:cfg.max_sim3_candidates]:
            with record_function("loop/sim3"):
                res = self._compute_sim3(m, slot, c)
            if res is not None and not self._drift_plausible(m, slot, c, *res):
                res = None
            if res is not None:
                matched = c
                break
        if res is None:
            return m, False
        m = self._correct_loop(m, slot, matched, *res)
        self._streaks = {}
        self.n_loops_closed += 1
        self._last_loop_kf = self._seq
        return m, True

    def on_keyframe(self, m: ms.MapState, slot: int):
        """Detect and resolve for keyframe `slot`: (map, closed)."""
        return self.resolve_detection(m, int(slot), self.dispatch_detection(m, slot))

    def _drift_plausible(self, m: ms.MapState, slot: int, cand: int, s12, R12, t12) -> bool:
        """Reject a correction larger than the odometry between the two
        keyframes could have drifted (rotation, path and scale budgets)."""
        acc_rot, acc_tr, n_seg = (float(v) for v in drift_accumulators(m, cand, slot))
        if n_seg < 1:
            return False
        dev = m.device
        s_c, R_c, t_c = lie.sim3_compose(torch.as_tensor(s12, dtype=torch.float32, device=dev),
                                         torch.as_tensor(R12, dtype=torch.float32, device=dev),
                                         torch.as_tensor(t12, dtype=torch.float32, device=dev),
                                         torch.ones((), device=dev), m.kf_R[cand], m.kf_t[cand])
        R_c, t_c, s_c = R_c.cpu().numpy(), t_c.cpu().numpy(), float(s_c)
        R1, t1 = m.kf_R[slot].cpu().numpy(), m.kf_t[slot].cpu().numpy()
        c_new = -R_c.T @ (t_c / s_c)
        c_old = -R1.T @ t1
        dR = R_c @ R1.T
        rot_corr = abs(float(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
        tr_corr = float(np.linalg.norm(c_new - c_old))
        cfg = self.cfg
        tr_budget = max(cfg.drift_trans_frac * acc_tr,
                        cfg.drift_trans_abs_baselines * (acc_tr / n_seg))
        return (rot_corr <= cfg.drift_rot_frac * acc_rot + cfg.drift_rot_abs
                and tr_corr <= tr_budget
                and abs(float(np.log(max(float(s12), 1e-9)))) <= cfg.drift_log_scale_max)

    def _compute_sim3(self, m: ms.MapState, slot: int, cand: int):
        """The ComputeSim3 funnel: entry match -> Sim3 RANSAC -> two rounds
        of guided matching and Sim3 LM -> loop-neighbourhood projection count
        -> RANSAC on the projection pairs.  Returns (s, R, t) with
        x_slot ~ s R x_cand + t, or None."""
        cfg, cam = self.cfg, self.cam
        P = m.P
        obs1, obs2 = m.kf_obs[slot], m.kf_obs[cand]
        mp1 = torch.clamp(obs1, 0, P - 1).long()
        has1 = (obs1 >= 0) & m.kf_feat_valid[slot] & m.mp_valid[mp1]
        has2 = (obs2 >= 0) & m.kf_feat_valid[cand] & m.mp_valid[torch.clamp(obs2, 0, P - 1).long()]
        # one-directional best + ratio 0.92 over the pairs both keyframes map
        res = matching.match_gated(m.kf_desc[slot], m.kf_desc[cand], has1, has2, matching.TH_LOW,
                                   0.92, False)
        if int(res.count) < cfg.min_seed_matches:
            return None
        R1, t1, R2, t2 = m.kf_R[slot], m.kf_t[slot], m.kf_R[cand], m.kf_t[cand]
        x1_all = m.mp_pos[mp1] @ R1.T + t1

        def gather_pairs(idx):
            idx2 = torch.clamp_min(idx, 0).long()
            mp2 = torch.clamp(obs2[idx2], 0, P - 1).long()
            return (x1_all, m.mp_pos[mp2] @ R2.T + t2, m.kf_xy[slot], m.kf_xy[cand][idx2],
                    (idx >= 0) & has1)

        x1, x2, uv1, uv2, valid = gather_pairs(res.idx)
        self._gen.manual_seed(int(m.n_kf))
        r = sim3_solver.sim3_ransac(self._gen, cam, x2, x1, uv2, uv1, cfg.seed_hyp, cfg.fix_scale,
                                    valid=valid, th_chi2=cfg.seed_th_chi2,
                                    min_inliers=cfg.min_seed_inliers)
        if not bool(r.success):
            return None
        # the RANSAC inliers seed the guided passes; two rounds, wide then tight
        seed_idx = torch.where((res.idx >= 0) & r.inliers, res.idx, -1)
        s_k, R_k, t_k = r.s, r.R, r.t
        for it in range(2):
            g_idx = sim3_guided_match(cam, m, slot, cand, s_k, R_k, t_k,
                                      radius_scale=3.0 if it == 0 else 1.5)
            x1, x2, uv1, uv2, valid = gather_pairs(torch.where(seed_idx >= 0, seed_idx, g_idx))
            r2 = sim3_solver.optimize_sim3(cam, s_k, R_k, t_k, x2, x1, uv2, uv1, cfg.fix_scale,
                                           valid=valid, chi2_th=cfg.seed_th_chi2)
            if int(r2.n_inliers) >= cfg.min_seed_inliers:
                s_k, R_k, t_k = r2.s, r2.R, r2.t
        n_proj, feat_pt = loop_projection_count(cam, m, slot, cand, s_k, R_k, t_k)
        if int(n_proj) < cfg.min_total_matches:
            return None
        # each slot feature's own point paired with the loop point it matched
        pair_ok = (feat_pt >= 0) & has1
        x2p = m.mp_pos[torch.clamp(feat_pt, 0, P - 1).long()] @ R2.T + t2
        self._gen.manual_seed(int(m.n_kf) + 1)
        r3 = sim3_solver.sim3_ransac(self._gen, cam, x2p, x1_all, _project_px(cam, x2p),
                                     m.kf_xy[slot], cfg.seed_hyp, cfg.fix_scale, valid=pair_ok,
                                     th_chi2=cfg.verify_th_chi2,
                                     min_inliers=cfg.min_ransac_inliers)
        if not bool(r3.success):
            return None
        return float(r3.s), r3.R, r3.t

    def _correct_loop(self, m: ms.MapState, slot: int, cand: int, s12: float, R12,
                      t12) -> ms.MapState:
        """The essential graph, the corrected poses and points, SearchAndFuse
        across the seam, the stats refresh and the global BA's dispatch."""
        cfg = self.cfg
        K = m.K
        dev = m.device
        with record_function("loop/correct"):
            s12_t = torch.tensor(s12, dtype=torch.float32, device=dev)
            s_c, R_c, t_c = lie.sim3_compose(s12_t, R12, t12, torch.ones((), device=dev),
                                             m.kf_R[cand], m.kf_t[cand])
            live = self.loop_edges[-MAX_LOOP_EDGES:]
            self.n_loop_edges_dropped = max(self.n_loop_edges_dropped,
                                            len(self.loop_edges) - MAX_LOOP_EDGES)
            h_a = torch.zeros(MAX_LOOP_EDGES, dtype=torch.int32)
            h_b = torch.zeros(MAX_LOOP_EDGES, dtype=torch.int32)
            h_ok = torch.zeros(MAX_LOOP_EDGES, dtype=torch.bool)
            for i, (a, b) in enumerate(live):
                h_a[i], h_b[i], h_ok[i] = a, b, True
            prob = build_essential_graph(m, slot, cand, s_c, R_c, t_c, s12_t, R12, t12,
                                         h_a.to(dev), h_b.to(dev), h_ok.to(dev))
            # the dense [7K, 7K] solve while small, matrix-free PCG beyond
            solve = optimize_pose_graph if K <= 128 else optimize_pose_graph_cg
            with record_function("loop/pose_graph"):
                s_o, R_o, t_o, _ = solve(prob, cfg.pose_graph_iters)
            m = apply_loop_correction(m, s_o, R_o, t_o)
            # SearchAndFuse: the loop neighbourhood's points into the
            # corrected current-side keyframes
            T_FUSE = min(12, K)
            W2 = ms.covisibility(m)
            w_cur = torch.where(m.kf_valid, W2[slot], -1)
            w_cur[slot] = -1
            _, cur_nb = stable_topk(w_cur, T_FUSE - 1)
            targets = torch.cat([torch.tensor([slot], device=dev), cur_nb])
            tgt_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), w_cur[cur_nb] > 0])
            loop_nb = W2[cand] > 0
            loop_nb[cand] = True
            loop_nb &= m.kf_valid
            loop_pts = (ms.observation_matrix(m) & loop_nb[:, None]).any(0)
            from . import local_mapping

            with record_function("loop/fuse"):
                m = local_mapping.fuse_points_into(m, self.cam, targets, tgt_ok, loop_pts)
            # geometry for every point (all moved), descriptors for the touched
            m = ms.update_mappoint_geometry(m)
            tgt_mask = torch.zeros(K, dtype=torch.int32, device=dev).scatter_reduce(
                0, targets, tgt_ok.to(torch.int32), "amax").bool()
            touched = loop_pts | (ms.observation_matrix(m) & tgt_mask[:, None]).any(0)
            self.n_stats_overflow += max(0, int(touched.sum()) - ms.MAX_TOUCHED)
            m = ms.update_mappoint_stats_touched(m, touched)
        if cfg.run_global_ba:
            self._dispatch_global_ba(m, anchor=cand)
        self.loop_edges.append((slot, cand))
        return m

    def _dispatch_global_ba(self, m: ms.MapState, anchor: int):
        """Queue a full-map BA (the reference's single-device branch); a
        newer loop supersedes one not yet folded.  On the card a CUDA event
        recorded after it says when it is done."""
        with record_function("loop/gba"):
            K, N = m.K, m.N
            dev = m.device
            obs = m.kf_obs
            feat_ok = m.kf_feat_valid & m.kf_valid[:, None]
            e_valid = feat_ok & (obs >= 0) & m.mp_valid[torch.clamp(obs, 0, m.P - 1).long()]
            octv = m.kf_octave.reshape(-1).to(torch.float32)
            cam_fixed = torch.zeros(K, dtype=torch.bool, device=dev)
            cam_fixed[anchor] = True
            prob = BAProblem(
                R=m.kf_R, t=m.kf_t, points=m.mp_pos, cam_fixed=cam_fixed | ~m.kf_valid,
                cam_valid=m.kf_valid, pt_valid=m.mp_valid,
                cam_idx=torch.arange(K, device=dev).repeat_interleave(N),
                pt_idx=torch.clamp_min(obs, 0).reshape(-1), uv=m.kf_xy.reshape(-1, 2),
                ur=m.kf_ur.reshape(-1), inv_sigma2=1.0 / (1.2 ** (2.0 * octv)),
                edge_valid=e_valid.reshape(-1))
            R, t, X, _, cost = bundle_adjust_cg(self.cam, prob, iters=self.cfg.global_ba_iters,
                                                cg_iters=25)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        self._gba_pending = dict(R=R, t=t, X=X, cost=cost, done=done, snap_kf=m.kf_valid,
                                 snap_mp=m.mp_valid, old_R=m.kf_R, old_t=m.kf_t)
        self.n_gba_dispatched += 1

    def maybe_fold_gba(self, m: ms.MapState, force: bool = False) -> ms.MapState:
        """Fold a finished global BA into the current map; unless `force`,
        a BA the card is still running is left for a later keyframe."""
        g = self._gba_pending
        if g is None:
            return m
        if not force and g["done"] is not None and not g["done"].query():
            return m
        self._gba_pending = None
        with record_function("loop/fold"):
            dK, dP = m.K - g["R"].shape[0], m.P - g["X"].shape[0]
            if dK or dP:
                # capacity grew since the dispatch: pad the snapshot
                dev = m.device
                eye = torch.eye(3, device=dev).repeat(dK, 1, 1)
                z3 = torch.zeros((dK, 3), device=dev)
                for k in ("R", "old_R"):
                    g[k] = torch.cat([g[k], eye])
                for k in ("t", "old_t"):
                    g[k] = torch.cat([g[k], z3])
                g["snap_kf"] = torch.cat([g["snap_kf"], torch.zeros(dK, dtype=torch.bool,
                                                                    device=dev)])
                g["X"] = torch.cat([g["X"], torch.zeros((dP, 3), device=dev)])
                g["snap_mp"] = torch.cat([g["snap_mp"], torch.zeros(dP, dtype=torch.bool,
                                                                    device=dev)])
            m = fold_gba_device(m, g["R"], g["t"], g["X"], g["snap_kf"], g["snap_mp"],
                                g["old_R"], g["old_t"])
        self.n_gba_folded += 1
        return m
