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
``maybe_fold_gba`` folds in once the device has finished it.  With
``use_dist_gba`` and a process group of several ranks the global BA is the
distributed one of ``parallel/dist_ba.py``, its points sharded over the
ranks; otherwise the matrix-free ``solvers/ba_cg.py``.  On a map whose
point axis is split over the ranks (worldmap/map_state.py) the distributed
BA takes each rank's live rows as its block, and the matrix-free one runs
on the whole map on every rank; the replicated solves (the pose graph, that
BA) are broadcast from rank 0, so every rank goes on from the same bits.
The stages
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
from ..parallel import dist_ba
from ..parallel import mesh as mesh_mod
from ..parallel import points as pts
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
MAX_LOOP_EDGES = 16   # historic loop edges in an essential-graph solve (the free runner's ring)
MAX_CLOSURE_REC = 32  # the free runner's per-closure record ring
CLOSURE_REC_W = 12    # a record: [frame_id, slot, cand, n_matches, seed_inl, n_proj, pair_inl,
                      # s12, n_loops_after, n_edges_dropped, gba_ran, stats_overflow]


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


def batch_detect_loops(vocab: voc.Vocabulary, m: ms.MapState, bows_all: torch.Tensor,
                       gap_kf: int = 3, chunk: int = 8):
    """Loop detection for every keyframe at once (the offline replay's):
    each keyframe scored against the keyframes inserted before it (rank by
    frame id), without its covisible group and the `gap_kf` keyframes just
    before it, thresholded at its covisible neighbours' lowest score.
    Covisibility is the final map's.  Returns (cands [K,8] int64, ok [K,8]
    bool, cand_covis [K,8,K] int32) indexed by slot; invalid slots get ok
    False.  The [K,K] scores are taken `chunk` rows at a time."""
    K = m.K
    dev = m.device
    W = ms.covisibility(m)
    big = torch.iinfo(torch.int32).max
    order = torch.argsort(torch.where(m.kf_valid, m.kf_frame_id, big), stable=True)
    rank = torch.argsort(order, stable=True)
    S = torch.cat([1.0 - 0.5 * torch.abs(bows_all[None] - bows_all[i:i + chunk, None]).sum(-1)
                   for i in range(0, K, chunk)])                                   # [K,K]
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    covis_mask = (W > 0) | eye
    prefix = m.kf_valid[None, :] & (rank[None, :] < rank[:, None])
    others = covis_mask & prefix & ~eye
    min_score = torch.where(others, S, float("inf")).min(1).values
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    exclude = covis_mask | (rank[None, :] >= rank[:, None] - gap_kf)
    s = torch.where(prefix & ~exclude, S, -1.0)
    ok = s >= torch.clamp_min(min_score, 0.0)[:, None]
    top, cands = stable_topk(torch.where(ok, s, -1.0), 8)
    return cands, (top > 0) & m.kf_valid[:, None], W[cands]


def push_loop_edge(loop_a, loop_b, loop_ok, n_loops, slot, cand):
    """The historic loop-edge ring with (slot, cand) written at n_loops mod
    its capacity: past capacity the oldest edge is recycled (the closure
    record counts them).  Returns new tensors."""
    i = torch.remainder(torch.as_tensor(n_loops, device=loop_a.device), loop_a.shape[0]).long()
    loop_a, loop_b, loop_ok = loop_a.clone(), loop_b.clone(), loop_ok.clone()
    loop_a[i] = torch.as_tensor(slot, dtype=torch.int32, device=loop_a.device)
    loop_b[i] = torch.as_tensor(cand, dtype=torch.int32, device=loop_a.device)
    loop_ok[i] = True
    return loop_a, loop_b, loop_ok


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
    xc = lie.rotate_points(m.kf_R[first], m.mp_pos) + m.kf_t[first]
    xw = lie.rotate_points(R_o[first], (xc - t_o[first]) / s_o[first][:, None], transpose=True)
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
    N = m.N
    dev = m.device
    obs1, obs2 = m.kf_obs[slot], m.kf_obs[cand]
    g_valid, g_pos, g_maxd = ms.point_rows(m, torch.stack([obs1, obs2]), "mp_valid", "mp_pos",
                                           "mp_max_dist")
    has1 = (obs1 >= 0) & m.kf_feat_valid[slot] & g_valid[0]
    has2 = (obs2 >= 0) & m.kf_feat_valid[cand] & g_valid[1]
    x1 = g_pos[0] @ m.kf_R[slot].T + m.kf_t[slot]
    x2 = g_pos[1] @ m.kf_R[cand].T + m.kf_t[cand]
    top_oct = _top_octave(m)
    s12 = torch.as_tensor(s12, dtype=torch.float32, device=dev)
    si, Ri, ti = lie.sim3_inverse(s12, R12, t12)
    # problem 0: cand points into the slot image; problem 1: slot points into the cand image
    y = torch.stack([s12 * (x2 @ R12.T) + t12, si * (x1 @ Ri.T) + ti])      # [2,N,3]
    src_maxd = torch.stack([s12 * g_maxd[1], si * g_maxd[0]])
    pred = ms.predict_octave(src_maxd, lie.norm3(y), top_oct)
    radius = ms.scaled_radius(radius_scale * 7.5, pred)
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
    pred = ms.predict_octave(m.mp_max_dist, lie.norm3(xc), _top_octave(m))
    MAXC = min(2048, P)
    _, cnd = pts.topk_points(m.mesh, okp.to(torch.int32), MAXC)
    c_pred, c_uv, c_ok, c_desc = pts.gather_rows(m.mesh, cnd, pred, uv, okp, m.mp_desc)
    radius = ms.scaled_radius(20.0, c_pred)
    res = matching.match_gated(
        c_desc, m.kf_desc[slot], c_ok, m.kf_feat_valid[slot],
        (matching.TH_LOW + matching.TH_HIGH) // 2, 1.0,
        gate=WindowGate(c_uv, radius, m.kf_xy[slot], c_pred, m.kf_octave[slot], -1, 1))
    feat_pt = torch.full((N,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.clamp_min(res.idx, 0).long(), torch.where(res.matched, cnd.to(torch.int32), -1),
        "amax")
    return (feat_pt >= 0).sum(), feat_pt


@dataclasses.dataclass
class FreeLoopOut:
    """What free_loop_stage returns: the new map, database and loop state,
    whether a loop closed (a host bool), and the funnel diag of the last
    candidate tried: [go, n_matches, seed_inliers, n_proj, pair_inliers,
    drift_ok, streak_max, closed]."""

    m: ms.MapState
    bows: torch.Tensor
    streaks: torch.Tensor
    loop_a: torch.Tensor
    loop_b: torch.Tensor
    loop_ok: torch.Tensor
    n_loops: torch.Tensor
    last_loop_nkf: torch.Tensor
    closed: bool
    diag: torch.Tensor
    closure_rec: torch.Tensor


def _seam_fuse(cam: CameraModel, m: ms.MapState, slot: int, cand: int):
    """SearchAndFuse across a corrected seam: the loop neighbourhood's points
    into `slot` and its 11 strongest covisible keyframes; then geometry for
    every point and the stats of the points it touched.  Returns (map,
    touched points over MAX_TOUCHED, 0-d)."""
    from . import local_mapping

    K = m.K
    dev = m.device
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
    with record_function("loop/fuse"):
        m = local_mapping.fuse_points_into(m, cam, targets, tgt_ok, loop_pts)
    m = ms.update_mappoint_geometry(m)
    tgt_mask = torch.zeros(K, dtype=torch.int32, device=dev).scatter_reduce(
        0, targets, tgt_ok.to(torch.int32), "amax").bool()
    touched = loop_pts | (ms.observation_matrix(m) & tgt_mask[:, None]).any(0)
    over = torch.clamp_min(pts.sum_points(m.mesh, touched.sum()) - ms.MAX_TOUCHED, 0)
    return ms.update_mappoint_stats_touched(m, touched), over


def free_loop_stage(cfg: LoopCloserConfig, cam: CameraModel, vocab: voc.Vocabulary,
                    m: ms.MapState, bows, slot: int, streaks, loop_a, loop_b, loop_ok, n_loops,
                    last_loop_nkf, draw, frame_id: int = -1, closure_rec=None) -> FreeLoopOut:
    """The free runner's whole loop closing for keyframe `slot`: detection
    (writing its BoW row), the consistency streaks over [K] slots, the
    cooldown, then for up to min(max_sim3_candidates, 8) confirmed
    candidates in score order until one closes: the ComputeSim3 funnel with
    no early exit (entry match, Sim3 RANSAC, two guided match + Sim3 LM
    rounds, the projection count, the pair-set RANSAC), the drift gate, and
    on acceptance the correction (essential graph by PCG, corrected poses
    and points, SearchAndFuse, stats), the loop-edge ring and a closure
    record.  `draw(i, stage, valid, n_hyp)` gives candidate i's sampled
    triples, stage 0 for the seed RANSAC and 1 for the pair-set one.

    The reference runs it as one traced program of where-masks and
    ``lax.cond``s; here each decision is one read: the candidates to try
    (one copy of their flags and slots) and each tried candidate's
    acceptance; only a taken branch runs.  Per tried candidate: kernel 3
    four times (entry match, two guided matches, projection count), kernel
    7 twice, kernel 8 twice."""
    K = m.K
    dev = m.device
    MAXL = loop_a.shape[0]
    if closure_rec is None:
        closure_rec = torch.zeros((MAX_CLOSURE_REC, CLOSURE_REC_W), device=dev)
    with record_function("loop/detect"):
        det = detect_loop_device(vocab, bows, m, slot, cfg.gap_kf)
    bows = det.db_bows
    # consistency streaks: a candidate extends the streak of a slot it
    # equals or is covisible with
    covm = (det.cand_covis > 0) | (torch.arange(K, device=dev)[None, :] == det.cands[:, None])
    streak_cand = 1 + torch.where(covm, streaks[None, :], 0).max(1).values
    streak_cand = torch.where(det.ok, streak_cand, 0).to(torch.int32)
    new_streaks = torch.zeros(K, dtype=torch.int32, device=dev).scatter_reduce(
        0, det.cands.long(), streak_cand, "amax")
    in_cooldown = m.n_kf < last_loop_nkf + cfg.cooldown_kf
    new_streaks = torch.where(in_cooldown, 0, new_streaks)
    confirmed = det.ok & (streak_cand >= cfg.consistency_th) & ~in_cooldown
    n_try = min(cfg.max_sim3_candidates, det.cands.shape[0])
    go = confirmed & (det.cands != slot)
    go_h, cands_h = torch.stack([go[:n_try].long(), det.cands[:n_try].long()]).tolist()
    streak_max = streak_cand.max().to(torch.float32)
    diag = torch.zeros(8, device=dev)
    diag[6] = streak_max
    closed = False
    for i in range(n_try):
        if closed or not go_h[i]:
            continue
        cand = cands_h[i]
        with record_function("loop/sim3"):
            f = _free_sim3(cfg, cam, m, slot, cand, lambda stage, valid, n: draw(i, stage, valid, n))
        accept = bool(f["accept"])
        if accept:
            with record_function("loop/correct"):
                prob = build_essential_graph(m, slot, cand, f["s_c"], f["R_c"], f["t_c"],
                                             f["s12"], f["R12"], f["t12"], loop_a, loop_b, loop_ok)
                with record_function("loop/pose_graph"):
                    s_o, R_o, t_o, _ = optimize_pose_graph_cg(prob, cfg.pose_graph_iters)
                    s_o, R_o, t_o = pts.broadcast(m.mesh, s_o, R_o, t_o)
                m = apply_loop_correction(m, s_o, R_o, t_o)
                m, over = _seam_fuse(cam, m, slot, cand)
            loop_a, loop_b, loop_ok = push_loop_edge(loop_a, loop_b, loop_ok, n_loops, slot, cand)
            n_after = n_loops + 1
            f32 = lambda v: torch.as_tensor(v, device=dev).to(torch.float32)
            rec = torch.stack([f32(frame_id), f32(slot), f32(cand), f32(f["n_matches"]),
                               f32(f["seed_inliers"]), f32(f["n_proj"]), f32(f["pair_inliers"]),
                               f32(f["s12"]), f32(n_after), f32(torch.clamp_min(n_after - MAXL, 0)),
                               f32(0.0), f32(over)])
            closure_rec = closure_rec.clone()
            closure_rec[torch.remainder(n_loops, MAX_CLOSURE_REC).long()] = rec
            n_loops, last_loop_nkf, closed = n_after, m.n_kf.clone(), True
        diag = torch.stack([torch.ones((), device=dev), *(f[k].to(torch.float32) for k in (
            "n_matches", "seed_inliers", "n_proj", "pair_inliers", "drift_ok")),
            streak_max, torch.full((), float(closed), device=dev)])
    if closed:
        new_streaks = torch.zeros_like(new_streaks)
    return FreeLoopOut(m, bows, new_streaks, loop_a, loop_b, loop_ok, n_loops, last_loop_nkf,
                       closed, diag, closure_rec)


def _free_sim3(cfg: LoopCloserConfig, cam: CameraModel, m: ms.MapState, slot: int, cand: int,
               draw) -> dict:
    """free_loop_stage's ComputeSim3 funnel and drift gate for one candidate,
    every stage run (the gates are device masks): the Sim3 (s12, R12, t12),
    the corrected pose of `slot` (s_c, R_c, t_c), the funnel's counts and
    the 0-d acceptance."""
    has1, has2, pos1, pos2 = _pair_rows(m, slot, cand)
    res = matching.match_gated(m.kf_desc[slot], m.kf_desc[cand], has1, has2, matching.TH_LOW,
                               0.92, False)
    n_matches = res.count
    R1, t1, R2, t2 = m.kf_R[slot], m.kf_t[slot], m.kf_R[cand], m.kf_t[cand]
    x1_all = pos1 @ R1.T + t1

    def gather_pairs(idx):
        idx2 = torch.clamp_min(idx, 0).long()
        return (x1_all, pos2[idx2] @ R2.T + t2, m.kf_xy[slot], m.kf_xy[cand][idx2],
                (idx >= 0) & has1)

    x1, x2, uv1, uv2, valid = gather_pairs(res.idx)
    valid = valid & (n_matches >= cfg.min_seed_matches)
    r = sim3_solver.sim3_from_samples(cam, draw(0, valid, cfg.seed_hyp), x2, x1, uv2, uv1,
                                      cfg.fix_scale, valid, cfg.seed_th_chi2,
                                      min_inliers=cfg.min_seed_inliers)
    seed_idx = torch.where((res.idx >= 0) & r.inliers, res.idx, -1)
    s_k, R_k, t_k = r.s, r.R, r.t
    for it in range(2):
        g_idx = sim3_guided_match(cam, m, slot, cand, s_k, R_k, t_k,
                                  radius_scale=3.0 if it == 0 else 1.5)
        x1, x2, uv1, uv2, vg = gather_pairs(torch.where(seed_idx >= 0, seed_idx, g_idx))
        r2 = sim3_solver.optimize_sim3(cam, s_k, R_k, t_k, x2, x1, uv2, uv1, cfg.fix_scale,
                                       valid=vg, chi2_th=cfg.seed_th_chi2)
        keep = r2.n_inliers >= cfg.min_seed_inliers
        s_k, R_k, t_k = (torch.where(keep, a, b) for a, b in ((r2.s, s_k), (r2.R, R_k), (r2.t, t_k)))
    n_proj, feat_pt = loop_projection_count(cam, m, slot, cand, s_k, R_k, t_k)
    pair_ok = (feat_pt >= 0) & has1
    x2p = ms.point_rows(m, feat_pt, "mp_pos")[0] @ R2.T + t2
    r3 = sim3_solver.sim3_from_samples(cam, draw(1, pair_ok, cfg.seed_hyp), x2p, x1_all,
                                       _project_px(cam, x2p), m.kf_xy[slot], cfg.fix_scale, pair_ok,
                                       cfg.verify_th_chi2, min_inliers=cfg.min_ransac_inliers)
    s12, R12, t12 = r3.s, r3.R, r3.t
    # the drift gate, _drift_plausible's formulas on the card
    acc_rot, acc_tr, n_seg = drift_accumulators(m, cand, slot)
    s_c, R_c, t_c = lie.sim3_compose(s12, R12, t12, torch.ones((), device=m.device), R2, t2)
    c_new = -R_c.T @ (t_c / torch.clamp_min(s_c, 1e-9))
    c_old = -R1.T @ t1
    dR = R_c @ R1.T
    rot_corr = torch.abs(torch.arccos(torch.clamp((dR[0, 0] + dR[1, 1] + dR[2, 2] - 1.0) / 2.0,
                                                  -1.0, 1.0)))
    tr_corr = torch.linalg.norm(c_new - c_old)
    tr_budget = torch.maximum(cfg.drift_trans_frac * acc_tr,
                              cfg.drift_trans_abs_baselines * (acc_tr / torch.clamp_min(n_seg, 1)))
    drift_ok = ((n_seg >= 1) & (rot_corr <= cfg.drift_rot_frac * acc_rot + cfg.drift_rot_abs)
                & (tr_corr <= tr_budget)
                & (torch.abs(torch.log(torch.clamp_min(s12, 1e-9))) <= cfg.drift_log_scale_max))
    accept = ((n_matches >= cfg.min_seed_matches) & r.success & (n_proj >= cfg.min_total_matches)
              & r3.success & drift_ok)
    return dict(accept=accept, s12=s12, R12=R12, t12=t12, s_c=s_c, R_c=R_c, t_c=t_c,
                n_matches=n_matches, seed_inliers=r.n_inliers, n_proj=n_proj,
                pair_inliers=r3.n_inliers, drift_ok=drift_ok)


def _pair_rows(m: ms.MapState, slot: int, cand: int):
    """(has1, has2, pos1, pos2): which features of keyframes `slot` and
    `cand` hold a valid point, and those points' positions [N, 3]."""
    obs = torch.stack([m.kf_obs[slot], m.kf_obs[cand]])
    valid, pos = ms.point_rows(m, obs, "mp_valid", "mp_pos")
    has = (obs >= 0) & m.kf_feat_valid[[slot, cand]] & valid
    return has[0], has[1], pos[0], pos[1]


def full_map_ba_problem(m: ms.MapState, anchor) -> BAProblem:
    """The global BA over every valid keyframe and point, keyframe `anchor`
    (an int or a 0-d tensor) and the invalid slots held fixed.  On a split
    map, this rank's block: its own points and the edges that observe them
    (point ids local), every camera."""
    K, N = m.K, m.N
    dev = m.device
    obs = m.kf_obs
    feat_ok = m.kf_feat_valid & m.kf_valid[:, None]
    own, loc = pts.owned_rows(m.mesh, obs, feat_ok)
    e_valid = own & m.mp_valid[loc]
    cam_fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    cam_fixed[anchor] = True
    return BAProblem(
        R=m.kf_R, t=m.kf_t, points=m.mp_pos, cam_fixed=cam_fixed | ~m.kf_valid,
        cam_valid=m.kf_valid, pt_valid=m.mp_valid,
        cam_idx=torch.arange(K, device=dev).repeat_interleave(N),
        pt_idx=torch.where(own, loc, torch.clamp(obs, 0, m.P_local - 1)).reshape(-1),
        uv=m.kf_xy.reshape(-1, 2),
        ur=m.kf_ur.reshape(-1), inv_sigma2=ms.inv_level_sigma2(m.kf_octave.reshape(-1)),
        edge_valid=e_valid.reshape(-1))


def global_ba_cg(cam: CameraModel, m: ms.MapState, anchor, iters: int, cg_iters: int = 30):
    """``bundle_adjust_cg`` over the whole map: (R, t, points, cost), the
    points in m's layout.  On a map split over ranks it runs on the whole
    map on every rank and rank 0's result is kept (the order of its edge
    sums is not fixed on the card), each rank taking its own rows."""
    R, t, X, _, cost = bundle_adjust_cg(cam, full_map_ba_problem(pts.full_map(m), anchor),
                                        iters=iters, cg_iters=cg_iters)
    if m.n_shards > 1:
        R, t, X, cost = pts.broadcast(m.mesh, R, t, X, cost)
        X = X[m.mesh.rank::m.n_shards]
    return R, t, X, cost


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
    xc = lie.rotate_points(m.kf_R[ref], m.mp_pos) + m.kf_t[ref]
    x_new = lie.rotate_points(kf_R[ref], xc - kf_t[ref], transpose=True)
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

    def resolve_detection(self, m: ms.MapState, slot: int, det: LoopDetectOut,
                          seq_i: int | None = None):
        """Consistency streaks over consecutive keyframes, then, for a
        confirmed candidate, the Sim3 and the loop correction.  Returns
        (map, closed).  The cooldown counts keyframes by the map's
        monotonic keyframe counter, or by `seq_i` when an offline replay
        over a finished map gives it."""
        cfg = self.cfg
        seq = int(m.n_kf) if seq_i is None else seq_i
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
        has1, has2, pos1, pos2 = _pair_rows(m, slot, cand)
        # one-directional best + ratio 0.92 over the pairs both keyframes map
        res = matching.match_gated(m.kf_desc[slot], m.kf_desc[cand], has1, has2, matching.TH_LOW,
                                   0.92, False)
        if int(res.count) < cfg.min_seed_matches:
            return None
        R1, t1, R2, t2 = m.kf_R[slot], m.kf_t[slot], m.kf_R[cand], m.kf_t[cand]
        x1_all = pos1 @ R1.T + t1

        def gather_pairs(idx):
            idx2 = torch.clamp_min(idx, 0).long()
            return (x1_all, pos2[idx2] @ R2.T + t2, m.kf_xy[slot], m.kf_xy[cand][idx2],
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
        x2p = ms.point_rows(m, feat_pt, "mp_pos")[0] @ R2.T + t2
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
                s_o, R_o, t_o = pts.broadcast(m.mesh, s_o, R_o, t_o)
            m = apply_loop_correction(m, s_o, R_o, t_o)
            # SearchAndFuse: the loop neighbourhood's points into the
            # corrected current-side keyframes
            m, over = _seam_fuse(self.cam, m, slot, cand)
            self.n_stats_overflow += int(over)
        if cfg.run_global_ba:
            self._dispatch_global_ba(m, anchor=cand)
        self.loop_edges.append((slot, cand))
        return m

    def _dispatch_global_ba(self, m: ms.MapState, anchor: int):
        """Queue a full-map BA; a newer loop supersedes one not yet folded.
        With ``use_dist_gba`` and a process group of several ranks its
        points are sharded over the ranks (``dist_ba``): a split map's live
        rows are each rank's block as they stand, a replicated map is
        re-laid out on the host.  Otherwise it is ``bundle_adjust_cg``, the
        reference's single-device branch (on a split map: on the whole map,
        rank 0's result on every rank, each keeping its rows).  On the card
        a CUDA event recorded after it says when it is done."""
        with record_function("loop/gba"):
            n = mesh_mod.world_size()
            if m.n_shards > 1 and self.cfg.use_dist_gba:
                step = dist_ba.make_distributed_ba(m.mesh, iters=self.cfg.global_ba_iters,
                                                   live=True)
                R, t, X, cost = step(self.cam, full_map_ba_problem(m, anchor))
            elif self.cfg.use_dist_gba and n > 1 and m.n_shards == 1:
                prob = full_map_ba_problem(m, anchor)
                # the host-side re-layout reads the map: acceptable for the
                # rare closure, as in the reference
                sprob, perm = dist_ba.shard_ba_problem(prob, n, return_perm=True)
                step = dist_ba.make_distributed_ba(mesh_mod.map_mesh(),
                                                   iters=self.cfg.global_ba_iters)
                R, t, Xs, cost = step(self.cam, sprob)
                X = Xs[torch.from_numpy(perm).to(Xs.device)]   # back to the map's order
            else:
                R, t, X, cost = global_ba_cg(self.cam, m, anchor, self.cfg.global_ba_iters,
                                             cg_iters=25)
            done = None
            if m.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        self._gba_pending = dict(R=R, t=t, X=X, cost=cost, done=done, snap_kf=m.kf_valid,
                                 snap_mp=m.mp_valid, old_R=m.kf_R, old_t=m.kf_t)
        self.n_gba_dispatched += 1

    def maybe_fold_gba(self, m: ms.MapState, force: bool = False) -> ms.MapState:
        """Fold a finished global BA into the current map; unless `force`,
        a BA the card is still running is left for a later keyframe.  Above
        a world of one the BA is folded once it is done on every rank, so
        all ranks fold at the same keyframe."""
        g = self._gba_pending
        if g is None:
            return m
        if not force and g["done"] is not None and not mesh_mod.all_ranks(g["done"].query()):
            return m
        self._gba_pending = None
        with record_function("loop/fold"):
            dK, dP = m.K - g["R"].shape[0], m.P_local - g["X"].shape[0]
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
