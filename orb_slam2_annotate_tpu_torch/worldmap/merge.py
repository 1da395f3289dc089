"""Multi-session map merging (port of worldmap/merge.py).

Session B is merged into session A: a cross-map keyframe pair is found by
BoW and verified by a Sim3 from matched map points, B is moved into A's
world by that Sim3 and written into A's free slots, and the seam is refined
by fusing duplicate points both ways and a joint bundle adjustment.

On the card: the BoW rows of both maps (kernel 5, a launch a map) and one
[Kb, Ka] score matrix; per verified pair the mutual masked match (kernel
3a), the Sim3 RANSAC with 1024 hypotheses (kernel 7) and its LM polish
(kernel 8); the re-indexing into A's slots, one indexed write a field; the
point statistics (kernel 3b); two fuses (kernel 3a) and the joint BA.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..geometry.camera import CameraModel
from ..ops import matching
from ..ops.sorting import stable_topk
from ..parallel import points as pts
from ..solvers import sim3 as sim3_solver
from . import map_state as ms
from . import vocabulary as voc

# B's keyframes keep their frame ids, offset so that they stay apart from A's
FRAME_ID_OFFSET = 100000
N_HYPOTHESES = 1024


@dataclasses.dataclass
class MergeResult:
    map: ms.MapState
    success: bool
    kf_a: int          # anchor keyframe slot in A
    kf_b: int          # matched keyframe slot in B
    scale: float       # scale of the Sim3 applied to B


def find_cross_map_pair(m_a: ms.MapState, m_b: ms.MapState, vocab: voc.Vocabulary,
                        top_k: int = 1):
    """BoW-matched keyframe pairs, best first: (score, slot_a, slot_b) for
    top_k == 1 (None without keyframes), else a list of up to top_k.  Equal
    scores keep the reference's flat order (b major, a minor)."""
    va = torch.nonzero(m_a.kf_valid).flatten()
    vb = torch.nonzero(m_b.kf_valid).flatten()
    if len(va) == 0 or len(vb) == 0:
        return None if top_k == 1 else []
    bows_a = voc.bow_rows(vocab, m_a.kf_desc[va], m_a.kf_feat_valid[va])      # [Ka, W]
    bows_b = voc.bow_rows(vocab, m_b.kf_desc[vb], m_b.kf_feat_valid[vb])      # [Kb, W]
    S = 1.0 - 0.5 * torch.cdist(bows_b, bows_a, p=1.0)                        # [Kb, Ka]
    score, flat = stable_topk(S.reshape(-1), min(max(top_k, 1), S.numel()))
    score, flat = score.cpu().numpy(), flat.cpu().numpy()
    va, vb, Ka = va.cpu().numpy(), vb.cpu().numpy(), len(va)
    pairs = [(float(sc), int(va[o % Ka]), int(vb[o // Ka])) for sc, o in zip(score, flat)]
    return pairs[0] if top_k == 1 else pairs


def solve_inter_map_sim3(m_a: ms.MapState, m_b: ms.MapState, cam: CameraModel, kf_a: int,
                         kf_b: int, fix_scale: bool = False, min_inliers: int = 20):
    """The Sim3 (s, R, t) mapping B's world into A's, from the points of the
    keyframe pair, or None.  The RANSAC sets are drawn from a generator
    seeded with 0 each call, as the reference draws from PRNGKey(0)."""
    gen = torch.Generator(device=m_a.device).manual_seed(0)
    clip_a = lambda i: torch.clamp(i, 0, m_a.P - 1).long()
    clip_b = lambda i: torch.clamp(i, 0, m_b.P - 1).long()
    obs_a, obs_b = m_a.kf_obs[kf_a], m_b.kf_obs[kf_b]
    has_a = (obs_a >= 0) & m_a.kf_feat_valid[kf_a] & m_a.mp_valid[clip_a(obs_a)]
    has_b = (obs_b >= 0) & m_b.kf_feat_valid[kf_b] & m_b.mp_valid[clip_b(obs_b)]
    res = matching.match_masked(m_a.kf_desc[kf_a], m_b.kf_desc[kf_b],
                                has_a[:, None] & has_b[None, :], max_dist=matching.TH_LOW,
                                ratio=0.75, mutual=True)
    if int(res.count) < min_inliers:
        return None
    idx_b = torch.clamp_min(res.idx, 0).long()
    pa = m_a.mp_pos[clip_a(obs_a)]
    pb = m_b.mp_pos[clip_b(obs_b[idx_b])]
    # camera-frame coordinates in each keyframe
    xa = pa @ m_a.kf_R[kf_a].T + m_a.kf_t[kf_a]
    xb = pb @ m_b.kf_R[kf_b].T + m_b.kf_t[kf_b]
    # as the reference: both directions are scored in A's image
    uv = m_a.kf_xy[kf_a]
    r = sim3_solver.sim3_ransac(gen, cam, xb, xa, uv, uv, N_HYPOTHESES, fix_scale,
                                valid=res.matched)
    if not bool(r.success) or int(r.n_inliers) < min_inliers:
        return None
    # the LM polish on the inliers (OptimizeSim3, Optimizer.cc:1116)
    r2 = sim3_solver.optimize_sim3(cam, r.s, r.R, r.t, xb, xa, uv, uv, fix_scale,
                                   valid=res.matched & r.inliers)
    if int(r2.n_inliers) >= min_inliers:
        r = r2
    # B camera -> A camera to B world -> A world: T_a^-1 o S_c o T_b
    one = torch.ones((), device=m_a.device)
    S1 = lie.sim3_compose(*lie.sim3_inverse(one, m_a.kf_R[kf_a], m_a.kf_t[kf_a]), r.s, r.R, r.t)
    return lie.sim3_compose(*S1, one, m_b.kf_R[kf_b], m_b.kf_t[kf_b])


def place_session(m_a: ms.MapState, m_b: ms.MapState, s, R, t):
    """B moved by the Sim3 (s, R, t) into A's free slots, lowest first:
    points x' = s R x + t, poses T_b o S^-1 as SE3 [R, t / s].  Returns (map,
    kf_map [Kb] A's slot of each of B's keyframe slots, -1 for invalid
    ones).  Only the fields the reference writes are written."""
    dev = m_a.device
    kf_free = torch.nonzero(~m_a.kf_valid).flatten()
    mp_free = torch.nonzero(~m_a.mp_valid).flatten()
    kf_used = torch.nonzero(m_b.kf_valid).flatten()
    mp_used = torch.nonzero(m_b.mp_valid).flatten()
    if len(kf_free) < len(kf_used) or len(mp_free) < len(mp_used):
        raise ValueError(f"A lacks capacity for B: {len(kf_free)} free keyframe slots for "
                         f"{len(kf_used)}, {len(mp_free)} free point slots for {len(mp_used)}")
    kf_tgt, mp_tgt = kf_free[:len(kf_used)], mp_free[:len(mp_used)]
    mp_map = torch.full((m_b.P + 1,), -1, dtype=torch.int32, device=dev)     # P_b: no point
    mp_map[mp_used] = mp_tgt.to(torch.int32)
    obs_b = m_b.kf_obs[kf_used]
    obs_re = mp_map[torch.where(obs_b >= 0, obs_b, m_b.P).long()]

    si, Ri, ti = lie.sim3_inverse(s, R, t)
    one = torch.ones(len(kf_used), device=dev)
    sc, Rc, tc = lie.sim3_compose(one, m_b.kf_R[kf_used], m_b.kf_t[kf_used],
                                  si.expand(len(kf_used)), Ri.expand(len(kf_used), 3, 3),
                                  ti.expand(len(kf_used), 3))

    def put(a, idx, v):
        a = a.clone()
        a[idx] = v.to(a.dtype)
        return a

    kf_fields = dict(kf_R=Rc, kf_t=tc / sc[:, None],
                     kf_valid=torch.ones(len(kf_used), dtype=torch.bool, device=dev),
                     kf_frame_id=m_b.kf_frame_id[kf_used] + FRAME_ID_OFFSET, kf_obs=obs_re)
    kf_fields.update({k: getattr(m_b, k)[kf_used] for k in (
        "kf_timestamp", "kf_xy", "kf_ur", "kf_depth", "kf_octave", "kf_angle", "kf_desc",
        "kf_feat_valid")})
    mp_fields = dict(mp_pos=lie.sim3_apply(s, R, t, m_b.mp_pos[mp_used]),
                     mp_valid=torch.ones(len(mp_used), dtype=torch.bool, device=dev),
                     mp_desc=m_b.mp_desc[mp_used], mp_first_kf=m_b.mp_first_kf[mp_used])
    merged = m_a.replace(**{k: put(getattr(m_a, k), kf_tgt, v) for k, v in kf_fields.items()},
                         **{k: put(getattr(m_a, k), mp_tgt, v) for k, v in mp_fields.items()},
                         n_kf=m_a.n_kf + m_b.n_kf)
    kf_map = torch.full((m_b.K,), -1, dtype=torch.int64, device=dev)
    kf_map[kf_used] = kf_tgt
    return merged, kf_map


def merge_maps(m_a: ms.MapState, m_b: ms.MapState, cam: CameraModel,
               vocab: voc.Vocabulary | None = None, fix_scale: bool = False) -> MergeResult:
    """Merge session B into session A (B Sim3-aligned into A's world).  The
    top 8 BoW pairs are verified in order; the first whose Sim3 holds wins.
    On failure A is returned as it was.  A must have free keyframe and
    point slots for B's (ValueError otherwise).  Maps whose point axis is
    split over ranks are merged whole on every rank (a rare offline step,
    so ``full_map`` is fine here), rank 0's result is kept and split again
    as A was."""
    if m_a.n_shards > 1 or m_b.n_shards > 1:
        from ..parallel.mesh import shard_map_state

        mesh = m_a.mesh or m_b.mesh
        res = merge_maps(pts.full_map(m_a), pts.full_map(m_b), cam, vocab, fix_scale)
        names = [f.name for f in dataclasses.fields(ms.MapState)]
        merged = res.map.replace(**dict(zip(names, pts.broadcast(
            mesh, *(getattr(res.map, k) for k in names)))))
        if m_a.n_shards > 1:
            merged = shard_map_state(merged, m_a.mesh)
        return dataclasses.replace(res, map=merged)
    if vocab is None:
        vocab = voc.make_vocabulary(device=m_a.device)
    S, kf_a, kf_b = None, -1, -1
    for score, ka, kb in find_cross_map_pair(m_a, m_b, vocab, top_k=8):
        if score <= 0:
            break
        S = solve_inter_map_sim3(m_a, m_b, cam, ka, kb, fix_scale)
        if S is not None:
            kf_a, kf_b = ka, kb
            break
    if S is None:
        return MergeResult(m_a, False, kf_a, kf_b, 1.0)
    merged, kf_map = place_session(m_a, m_b, *S)
    merged = ms.update_mappoint_stats(merged)
    merged = refine_seam(merged, cam, kf_a, int(kf_map[kf_b]))
    return MergeResult(merged, True, kf_a, kf_b, float(S[0]))


def refine_seam(m: ms.MapState, cam: CameraModel, kf_a: int, kf_b_new: int) -> ms.MapState:
    """Fuse duplicate points across the seam both ways (A's points into B's
    seam keyframe and its 7 strongest covisible ones, then B's into A's),
    refresh the point statistics, then a joint BA anchored at A's seam
    keyframe (the loop closer's SearchAndFuse + global BA,
    LoopClosing.cc:689,756).  The covisibility and observations are those
    of the map before both fuses, as in the reference."""
    from ..pipeline import local_mapping as lm
    from ..pipeline.loop_closing import full_map_ba_problem
    from ..solvers.ba_cg import bundle_adjust_cg

    K, dev = m.K, m.device
    W = ms.covisibility(m)
    O = ms.observation_matrix(m)
    T_FUSE = min(8, K)

    def fuse_into(dst: int, src: int, mm: ms.MapState) -> ms.MapState:
        w_dst = torch.where(mm.kf_valid, W[dst], -1)
        w_dst[dst] = -1
        _, nb = stable_topk(w_dst, T_FUSE - 1)
        targets = torch.cat([torch.tensor([dst], device=dev), nb])
        tgt_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), w_dst[nb] > 0])
        src_nb = W[src] > 0
        src_nb[src] = True
        src_pts = (O & (src_nb & mm.kf_valid)[:, None]).any(0)
        return lm.fuse_points_into(mm, cam, targets, tgt_ok, src_pts)

    m = fuse_into(kf_b_new, kf_a, m)      # A's points into B's seam keyframes
    m = fuse_into(kf_a, kf_b_new, m)      # B's points into A's
    m = ms.update_mappoint_stats(m)
    R, t, X, _, _ = bundle_adjust_cg(cam, full_map_ba_problem(m, kf_a), iters=10)
    return ms.update_mappoint_stats(m.replace(kf_R=R, kf_t=t, mp_pos=X))
