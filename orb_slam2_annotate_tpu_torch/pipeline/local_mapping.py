"""Local mapping: keyframe insertion, depth points (RGB-D / stereo),
recent-point culling, triangulation, local BA, keyframe culling, and the
projection fuse that loop closing's SearchAndFuse runs (port of
pipeline/local_mapping.py; the keyframe chain's own fuse,
``fuse_neighbors``, is not ported yet).

The reference's ``.at[]`` writes that route filler indices to a dump row
(K) or column (P) keep that dump slot here explicitly: torch raises on an
out-of-range index where JAX drops the write.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..geometry.camera import CameraModel, backproject, in_image, project
from ..geometry.twoview import triangulate_dlt
from ..ops import matching
from ..ops.sorting import nanmedian, stable_topk
from ..solvers import ba_core
from ..worldmap import map_state as ms
from .frame import Frame
from .tracking import inv_sigma2

SCALE = 1.2
N_LEVELS = 8
LBA_ITERS_ROBUST = 4
LBA_ITERS_FINAL = 6


def insert_keyframe_from_frame(m: ms.MapState, frame: Frame, slot: int, R, t, obs,
                               frame_id: int, timestamp: float) -> ms.MapState:
    """Insert the tracked frame as a keyframe into the free slot `slot`."""
    return ms.insert_keyframe(m, slot, R, t, frame_id, timestamp, frame.xy, frame.ur,
                              frame.depth, frame.octave, frame.angle, frame.desc, frame.valid,
                              torch.where(frame.valid, obs, -1))


def _new_points(m: ms.MapState, slots: torch.Tensor, take: torch.Tensor,
                pos: torch.Tensor) -> ms.MapState:
    """Points at `pos` [n,3] in the free `slots` [n] where `take`: valid,
    created by the newest keyframe (mp_first_kf = n_kf - 1), seen and
    found once."""
    def put(a, v):
        return a.index_put((slots,), torch.where(take.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                                                 a[slots]))

    ones = torch.ones_like(m.mp_visible[slots])
    return m.replace(mp_pos=put(m.mp_pos, pos),
                     mp_valid=m.mp_valid.index_put((slots,), m.mp_valid[slots] | take),
                     mp_first_kf=put(m.mp_first_kf, (m.n_kf - 1).expand(slots.shape[0])
                                     .to(torch.int32)),
                     mp_visible=put(m.mp_visible, ones), mp_found=put(m.mp_found, ones))


def create_depth_mappoints(m: ms.MapState, cam: CameraModel, slot: int,
                           max_depth: float) -> ms.MapState:
    """RGB-D / stereo: a point for every valid feature of keyframe `slot`
    without one whose depth is in (0, max_depth), in the free slots taken in
    order (feature n -> the n-th free slot).  Point statistics are left
    stale for the caller to refresh."""
    depth = m.kf_depth[slot]
    need = m.kf_feat_valid[slot] & (m.kf_obs[slot] < 0) & (depth > 0) & (depth < max_depth)
    slots = ms.free_mp_slots(m, m.N)
    take = need & ~m.mp_valid[slots]
    xw = (backproject(cam, m.kf_xy[slot], depth) - m.kf_t[slot]) @ m.kf_R[slot]   # R^T (xc - t)
    kf_obs = m.kf_obs.clone()
    kf_obs[slot] = torch.where(take, slots.to(torch.int32), m.kf_obs[slot])
    return _new_points(m, slots, take, xw).replace(kf_obs=kf_obs)


def cull_recent_mappoints(m: ms.MapState) -> ms.MapState:
    """Drop recent points (created within the last 4 keyframes) with a low
    found/visible ratio and at most 2 observations."""
    age = (m.n_kf - 1) - m.mp_first_kf
    recent = m.mp_valid & (m.mp_first_kf >= 0) & (age <= 4)
    found_ratio = m.mp_found.float() / torch.clamp_min(m.mp_visible.float(), 1.0)
    bad = recent & (found_ratio < 0.15) & (ms.mp_observation_counts(m) <= 2)
    obs = m.kf_obs
    obs_bad = (obs >= 0) & bad[torch.clamp(obs, 0, m.P - 1).long()]
    return m.replace(mp_valid=m.mp_valid & ~bad, kf_obs=torch.where(obs_bad, -1, obs))


def _fundamental_between(cam: CameraModel, R1, t1, R2, t2):
    """F12 with x1^T F12 x2 = 0 for pixel coordinates; R2 [...,3,3], t2 [...,3]."""
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = -(R12 @ t2[..., None])[..., 0] + t1
    Kinv = torch.linalg.inv(cam.K(R1.device))
    return Kinv.T @ (lie.hat(t12) @ R12) @ Kinv


def _kf_frame(m: ms.MapState, s) -> Frame:
    """Keyframe slot `s` as a Frame; a tensor of slots gives batched fields."""
    return Frame(xy=m.kf_xy[s], xy_raw=m.kf_xy[s], ur=m.kf_ur[s], depth=m.kf_depth[s],
                 octave=m.kf_octave[s], angle=m.kf_angle[s],
                 response=torch.zeros_like(m.kf_angle[s]), desc=m.kf_desc[s],
                 valid=m.kf_feat_valid[s])


def _median_depth(m: ms.MapState, s, R, t) -> torch.Tensor:
    """Median depth of the points keyframe(s) `s` observe at pose(s) R [...,3,3], t [...,3]."""
    obs = m.kf_obs[s]
    has = (obs >= 0) & m.kf_feat_valid[s]
    z = (m.mp_pos[torch.clamp(obs, 0, m.P - 1).long()] @ R.transpose(-1, -2)
         + t[..., None, :])[..., 2]
    return torch.nan_to_num(nanmedian(torch.where(has, z, torch.full_like(z, float("nan")))),
                            nan=1.0)


def create_new_mappoints(m: ms.MapState, cam: CameraModel, slot: int,
                         n_neighbors: int = 20) -> ms.MapState:
    """Triangulate new points between the new keyframe and its best covisible
    neighbours that pass the baseline / median-depth gate; each unmatched
    feature keeps its largest-parallax valid pair."""
    K, P, N = m.K, m.P, m.N
    dev = m.device
    n_neighbors = min(n_neighbors, K - 1)
    w_row = ms.covis_row(m, slot)
    R1, t1 = m.kf_R[slot], m.kf_t[slot]
    c1 = -R1.T @ t1
    med_depth_s = _median_depth(m, slot, R1, t1)
    cam_c = -torch.einsum("kij,ki->kj", m.kf_R, m.kf_t)
    base_ok = torch.linalg.norm(cam_c - c1, dim=-1) / torch.clamp_min(med_depth_s, 1e-6) > 0.01
    w_slot = torch.where(m.kf_valid & base_ok, w_row, -1)
    w_slot[slot] = -1
    _, nbrs = stable_topk(w_slot, n_neighbors)
    nbr_ok = w_slot[nbrs] > 0

    f1 = _kf_frame(m, slot)
    has1 = m.kf_obs[slot] >= 0
    inv_s2 = inv_sigma2(torch.arange(N_LEVELS, device=dev))
    Kc = cam.K(dev)
    P1 = Kc @ torch.cat([R1, t1[:, None]], dim=1)
    x1 = m.kf_xy[slot]
    oct1 = m.kf_octave[slot].float()
    s2_1 = SCALE ** (2.0 * oct1)

    # every neighbour in one matcher launch (kernel 3, B = n_neighbors)
    R2s, t2s = m.kf_R[nbrs], m.kf_t[nbrs]                                # [NB,3,3], [NB,3]
    c2s = -(R2s.transpose(1, 2) @ t2s[:, :, None])[:, :, 0]
    ok_baseline = torch.linalg.norm(c2s - c1, dim=-1) / torch.clamp_min(
        _median_depth(m, nbrs, R2s, t2s), 1e-6) > 0.01
    f2 = _kf_frame(m, nbrs)
    res = matching.search_for_triangulation(f1, f2, _fundamental_between(cam, R1, t1, R2s, t2s),
                                            inv_s2, inv_s2, exclude1=has1,
                                            exclude2=m.kf_obs[nbrs] >= 0)
    idxs = torch.where(res.matched & (ok_baseline & nbr_ok)[:, None], res.idx, -1)   # [NB,N]

    goods, Xs, cosps = [], [], []
    for i in range(n_neighbors):
        # triangulate and gate this neighbour's pairs
        R2, t2, c2, idx = R2s[i], t2s[i], c2s[i], idxs[i]
        idc = torch.clamp_min(idx, 0).long()
        P2 = Kc @ torch.cat([R2, t2[:, None]], dim=1)
        x2 = f2.xy[i, idc]
        X = triangulate_dlt(P1, P2, x1, x2)
        xc1 = X @ R1.T + t1
        xc2 = X @ R2.T + t2
        e1 = ((project(cam, xc1) - x1) ** 2).sum(1)
        e2 = ((project(cam, xc2) - x2) ** 2).sum(1)
        oct2 = f2.octave[i, idc].float()
        r1v, r2v = X - c1, X - c2
        d1, d2 = torch.linalg.norm(r1v, dim=1), torch.linalg.norm(r2v, dim=1)
        cosp = (r1v * r2v).sum(1) / torch.clamp_min(d1 * d2, 1e-9)
        ratio_d = d1 / torch.clamp_min(d2, 1e-9)
        ratio_o = (SCALE ** oct1) / (SCALE ** oct2)
        scale_ok = (ratio_d < ratio_o * SCALE * 1.5) & (ratio_d * SCALE * 1.5 > ratio_o)
        good = ((idx >= 0) & torch.isfinite(X).all(1) & (xc1[:, 2] > 0) & (xc2[:, 2] > 0)
                & (e1 < 5.991 * s2_1) & (e2 < 5.991 * (SCALE ** (2.0 * oct2)))
                & (cosp < 0.9998) & scale_ok)
        goods.append(good)
        Xs.append(X)
        cosps.append(cosp)
    good_all = torch.stack(goods)
    X_all, cosp_all = torch.stack(Xs), torch.stack(cosps)

    best_nb = torch.argmin(torch.where(good_all, cosp_all, torch.full_like(cosp_all, float("inf"))),
                           dim=0)
    good = good_all.any(0)
    best_idx = torch.gather(idxs, 0, best_nb[None])[0]
    X = X_all[best_nb, torch.arange(N, device=dev)]
    nb_sel = nbrs[best_nb]

    slots = ms.free_mp_slots(m, N)
    take = good & ~m.mp_valid[slots]
    new_ids = torch.where(take, slots.to(torch.int32), -1)
    kf_obs = m.kf_obs.clone()
    kf_obs[slot] = torch.where(take, new_ids, m.kf_obs[slot])
    lin = nb_sel * N + torch.clamp_min(best_idx, 0).long()
    kf_obs = kf_obs.reshape(-1).scatter_reduce(0, lin, new_ids, "amax").reshape(K, N)
    return _new_points(m, slots, take, X).replace(kf_obs=kf_obs)


def local_bundle_adjustment(m: ms.MapState, cam: CameraModel, slot: int, n_opt: int = 16,
                            n_fixed: int = 16) -> ms.MapState:
    """Covisible-window BA: the new keyframe + its best covisible keyframes
    move, other observers of their points are fixed."""
    K, P, N = m.K, m.P, m.N
    dev = m.device
    n_opt, n_fixed = min(n_opt, K), min(n_fixed, K)
    w_slot = torch.where(m.kf_valid, ms.covis_row(m, slot), -1)
    w_slot[slot] = -1
    _, nb = stable_topk(w_slot, n_opt - 1)
    slot_t = torch.tensor([slot], device=dev)
    opt_kfs = torch.cat([slot_t, nb])
    opt_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), w_slot[nb] > 0])
    pts_mask = ms.point_mask_rows(m, opt_kfs, opt_ok) & m.mp_valid

    all_ok = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    sees_local = (pts_mask[torch.clamp(m.kf_obs, 0, P - 1).long()] & all_ok).any(1)
    is_opt = torch.zeros(K, dtype=torch.int32, device=dev).scatter_reduce(
        0, opt_kfs, opt_ok.to(torch.int32), "amax").bool()
    fixed_cand = sees_local & m.kf_valid & ~is_opt
    _, fx = stable_topk(fixed_cand.to(torch.int32), n_fixed)
    fx_ok = fixed_cand[fx]

    cams_all = torch.cat([opt_kfs, fx])
    cams_ok = torch.cat([opt_ok, fx_ok])
    cam_fixed = torch.cat([torch.zeros(n_opt, dtype=torch.bool, device=dev),
                           torch.ones(n_fixed, dtype=torch.bool, device=dev)])
    C = n_opt + n_fixed
    no_frontier = ~fx_ok.any()
    big = torch.iinfo(torch.int32).max
    oldest = torch.argmin(torch.where(opt_ok, m.kf_frame_id[opt_kfs], big))
    cam_fixed = cam_fixed.clone()
    cam_fixed[oldest] = cam_fixed[oldest] | no_frontier

    P_BA = min(2048, P)
    _, psel = stable_topk(pts_mask.to(torch.int32), P_BA)
    psel_ok = pts_mask[psel]
    g2l = torch.full((P,), -1, dtype=torch.int32, device=dev)
    g2l[psel] = torch.where(psel_ok, torch.arange(P_BA, dtype=torch.int32, device=dev), -1)

    obs_grid = m.kf_obs[cams_all]
    feat_ok = m.kf_feat_valid[cams_all] & cams_ok[:, None]
    pt_loc = torch.where(feat_ok & (obs_grid >= 0), g2l[torch.clamp(obs_grid, 0, P - 1).long()], -1)
    e_valid = feat_ok & (pt_loc >= 0)
    prob = ba_core.GridBA(
        R=m.kf_R[cams_all], t=m.kf_t[cams_all], points=m.mp_pos[psel],
        cam_fixed=cam_fixed | ~cams_ok, cam_valid=cams_ok, pt_valid=psel_ok, pt_loc=pt_loc,
        uv=m.kf_xy[cams_all], ur=m.kf_ur[cams_all],
        inv_sigma2=inv_sigma2(m.kf_octave[cams_all]), edge_valid=e_valid)
    R1, t1, X1, inl1, _ = ba_core.bundle_adjust_grid(cam, prob, iters=LBA_ITERS_ROBUST)
    prob2 = dataclasses.replace(prob, R=R1, t=t1, points=X1, edge_valid=e_valid & inl1)
    R2, t2, X2, inl2, _ = ba_core.bundle_adjust_grid(cam, prob2, iters=LBA_ITERS_FINAL)

    # write back poses, points and observations; filler entries go to a dump row
    upd_cam = cams_ok & ~cam_fixed
    cam_tgt = torch.where(upd_cam, cams_all, K)
    kf_R = torch.cat([m.kf_R, m.kf_R[:1]]).index_put((cam_tgt,), R2)[:K]
    kf_t = torch.cat([m.kf_t, m.kf_t[:1]]).index_put((cam_tgt,), t2)[:K]
    pt_tgt = torch.where(psel_ok, psel, P)
    mp_pos = torch.cat([m.mp_pos, m.mp_pos[:1]]).index_put((pt_tgt,), X2)[:P]
    obs_rows = torch.where(e_valid & ~inl2, -1, m.kf_obs[cams_all])
    obs_tgt = torch.where(cams_ok, cams_all, K)
    kf_obs = torch.cat([m.kf_obs, m.kf_obs[:1]]).index_put((obs_tgt,), obs_rows)[:K]
    return m.replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos, kf_obs=kf_obs)


def window_touched_points(m: ms.MapState, slot: int) -> torch.Tensor:
    """[P] mask of points observed by the new keyframe's covisible window (24)."""
    n_win = min(24, m.K)
    w_slot = torch.where(m.kf_valid, ms.covis_row(m, slot), -1)
    w_slot[slot] = -1
    _, nb = stable_topk(w_slot, n_win - 1)
    kfs = torch.cat([torch.tensor([slot], device=m.device), nb])
    ok = torch.cat([torch.ones(1, dtype=torch.bool, device=m.device), w_slot[nb] > 0])
    return ms.point_mask_rows(m, kfs, ok)


def _fuse_targets_core(m: ms.MapState, cam: CameraModel, targets: torch.Tensor,
                       tgt_ok: torch.Tensor, src_masks: torch.Tensor,
                       ratio: float = 0.9) -> ms.MapState:
    """Projection fuse (ORBmatcher::Fuse + MapPoint::Replace as a remap
    table).  targets [T] keyframe slots, tgt_ok [T], src_masks [T,P]: each
    target's source points (the first 1024 that pass the view tests) are
    projected into it and matched in a window (all T targets in one kernel-3
    launch, B = T); a matched feature without a point gains the association,
    one with another point close in 3D merges the two (the point with more
    observations wins).  The reference's add / merge switches and gates are
    at the values its only ported caller, ``fuse_points_into``, uses."""
    K, P, N = m.K, m.P, m.N
    dev = m.device
    T = targets.shape[0]
    MAXC = min(1024, P)
    tl = targets.long()
    R, t = m.kf_R[tl], m.kf_t[tl]                                      # [T,3,3], [T,3]
    xc = torch.einsum("pj,tij->tpi", m.mp_pos, R) + t[:, None]          # [T,P,3]
    uv = project(cam, xc)
    centre = -torch.einsum("tji,tj->ti", R, t)                          # -R^T t
    dvec = m.mp_pos[None] - centre[:, None]
    dist = torch.linalg.norm(dvec, dim=-1)
    vcos = (dvec * m.mp_normal[None]).sum(-1) / torch.clamp_min(dist, 1e-9)
    okp = (src_masks & (xc[..., 2] > 0.05) & in_image(cam, uv) & (dist >= m.mp_min_dist)
           & (dist <= m.mp_max_dist) & (vcos > 0.5))
    dist_ratio = torch.clamp_min(m.mp_max_dist / torch.clamp_min(dist, 1e-9), 1.0)
    top_oct = torch.where(m.kf_feat_valid, m.kf_octave, 0).max()
    pred_oct = torch.minimum(torch.clamp_min(
        torch.ceil(torch.log(dist_ratio) / torch.log(torch.tensor(SCALE))).to(torch.int32), 0),
        top_oct)
    cand = stable_topk(okp.to(torch.int32), MAXC)[1].contiguous()        # [T,MAXC]
    take = lambda a: torch.gather(a, 1, cand if a.dim() == 2 else cand[..., None].expand(
        -1, -1, a.shape[-1]))
    cvalid = take(okp)
    c_oct = take(pred_oct)
    c_uv = take(uv)
    radius = 3.0 * (SCALE ** c_oct.to(torch.float32))
    res = matching.search_map_points(m.mp_desc[cand], cvalid, c_uv, c_oct, radius,
                                     _kf_frame(m, tl), ratio=ratio, max_dist=matching.TH_LOW)
    tgt = torch.clamp_min(res.idx, 0).long()                            # [T,MAXC]
    f_oct = torch.gather(m.kf_octave[tl], 1, tgt)
    sig2 = SCALE ** (2.0 * f_oct.to(torch.float32))
    f_xy = torch.gather(m.kf_xy[tl], 1, tgt[..., None].expand(-1, -1, 2))
    e2 = ((c_uv - f_xy) ** 2).sum(-1)
    z_pt = take(xc[..., 2])
    f_depth = torch.gather(m.kf_depth[tl], 1, tgt)
    depth_ok = (f_depth <= 0) | ((z_pt - f_depth).abs() < 0.05 * f_depth)
    ok = res.matched & (e2 < 2.0 * sig2) & depth_ok
    feat_pt = torch.full((T, N), -1, dtype=torch.int32, device=dev).scatter_reduce(
        1, tgt, torch.where(ok, cand.to(torch.int32), -1), "amax")
    prop = torch.where(tgt_ok[:, None], feat_pt, -1)

    # resolve each proposal against the feature's existing point
    existing = m.kf_obs[tl]
    n_obs = ms.mp_observation_counts(m)
    add_mask = (existing < 0) & (prop >= 0)
    merge_mask = (existing >= 0) & (prop >= 0) & (existing != prop)
    ex = torch.clamp_min(existing, 0).long()
    pr = torch.clamp_min(prop, 0).long()
    p_ex = m.mp_pos[ex]
    d3 = torch.linalg.norm(p_ex - m.mp_pos[pr], dim=-1)
    depth_scale = torch.clamp_min(torch.linalg.norm(p_ex - centre[:, None], dim=-1), 1e-3)
    merge_mask &= d3 < 0.015 * depth_scale
    ex_wins = n_obs[ex] >= n_obs[pr]
    loser = torch.where(ex_wins, pr, ex)
    winner = torch.where(ex_wins, ex, pr)
    remap = torch.arange(P + 1, dtype=torch.int32, device=dev)           # P = dump slot
    remap = remap.index_put((torch.where(merge_mask, loser, P).reshape(-1),),
                            torch.where(merge_mask, winner, P).to(torch.int32).reshape(-1))[:P]
    remap = remap[remap.long()]                                         # resolve 2-chains

    rows = torch.where(add_mask, prop, existing)
    kf_obs = torch.cat([m.kf_obs, m.kf_obs[:1]]).index_put((torch.where(tgt_ok, tl, K),),
                                                           rows)[:K]
    live = remap == torch.arange(P, dtype=torch.int32, device=dev)
    kf_obs = torch.where(kf_obs >= 0, remap[torch.clamp_min(kf_obs, 0).long()], -1)
    return m.replace(kf_obs=kf_obs, mp_valid=m.mp_valid & live)


def fuse_points_into(m: ms.MapState, cam: CameraModel, targets: torch.Tensor, tgt_ok: torch.Tensor,
                     src_mask: torch.Tensor) -> ms.MapState:
    """SearchAndFuse for loop closing: one shared set of source points (the
    loop neighbourhood's) fused into every target keyframe [T].  The point
    statistics are left stale: the caller refreshes the points it touched."""
    T = targets.shape[0]
    src_masks = (src_mask & m.mp_valid)[None].expand(T, m.P)
    return _fuse_targets_core(m, cam, targets, tgt_ok, src_masks, ratio=0.8)


@dataclasses.dataclass
class CullInfo:
    """Reparenting data for frame records whose reference keyframe was culled."""

    slots: torch.Tensor    # [max_cull] int32 dropped slots
    ok: torch.Tensor       # [max_cull] bool
    new_ref: torch.Tensor  # [max_cull] int32 surviving replacement slot
    R_rel: torch.Tensor    # [max_cull,3,3]  Trel = T_old * T_new^-1
    t_rel: torch.Tensor    # [max_cull,3]

    @staticmethod
    def zeros(max_cull: int = 4, device=None) -> "CullInfo":
        z = torch.zeros(max_cull, dtype=torch.int32, device=device)
        return CullInfo(z, torch.zeros(max_cull, dtype=torch.bool, device=device), z,
                        torch.zeros((max_cull, 3, 3), device=device),
                        torch.zeros((max_cull, 3), device=device))


def cull_keyframes(m: ms.MapState, protect_slot: int, max_cull: int = 4,
                   update_stats: bool = True) -> tuple[ms.MapState, CullInfo]:
    """Redundant-keyframe culling: a keyframe of `protect_slot`'s covisible
    window (24) whose points are >= 90% seen by at least 3 other keyframes at
    the same or a finer scale is dropped, up to `max_cull`, most redundant
    first; the 3 newest keyframes and `protect_slot` stay, and nothing is
    dropped while the map holds 8 keyframes or fewer."""
    K, P, N = m.K, m.P, m.N
    dev = m.device
    C_WIN = min(24, K)
    obs_kf, obs_ft, _, obs_mask = ms.observation_table(m)
    obs_oct = m.kf_octave[obs_kf.long(), obs_ft.long()]                 # [P, MAX_OBS]

    w_slot = torch.where(m.kf_valid, ms.covis_row(m, protect_slot), -1)
    w_slot[protect_slot] = -1
    _, win = stable_topk(w_slot, C_WIN)
    win_ok = w_slot[win] > 0
    obs_w = m.kf_obs[win]                                               # [C_WIN, N]
    pid = torch.clamp(obs_w, 0, P - 1).long()
    has = (obs_w >= 0) & m.kf_feat_valid[win] & win_ok[:, None]
    fine = obs_mask[pid] & (obs_oct[pid] <= m.kf_octave[win][..., None] + 1) & (
        obs_kf[pid] != win[:, None, None])                              # [C_WIN, N, MAX_OBS]
    red = has & (fine.sum(-1) >= 3)
    ratio_win = red.sum(1) / torch.clamp_min(has.sum(1), 1)
    # window ratios back to [K]; invalid window entries go to the dump row K
    ratio = torch.zeros(K + 1, device=dev).index_put((torch.where(win_ok, win, K),),
                                                     ratio_win)[:K]

    fid = m.kf_frame_id
    order = torch.argsort(-torch.where(m.kf_valid, fid, -1), stable=True)
    newest = torch.zeros(K, dtype=torch.bool, device=dev)
    newest[order[:3]] = True
    cand = m.kf_valid & ~newest & (ratio >= 0.9)
    cand[protect_slot] = False
    cand &= m.kf_valid.sum() > 8

    score = torch.where(cand, ratio, -1.0)
    _, drop = stable_topk(score, max_cull)
    drop_ok = score[drop] > 0
    kf_valid = m.kf_valid.clone()
    kf_valid[drop] = torch.where(drop_ok, False, m.kf_valid[drop])
    row_clear = torch.zeros(K, dtype=torch.bool, device=dev)
    row_clear[drop] = drop_ok                                           # top-k slots are distinct
    kf_obs = torch.where(row_clear[:, None], -1, m.kf_obs)

    # new reference: the strongest surviving covisible keyframe, else the newest survivor
    W_drop = torch.where(kf_valid[None, :], ms.covis_rows(m, drop, drop_ok), -1)
    newest_valid = torch.argmax(torch.where(kf_valid, fid, -1))
    ref = torch.argmax(W_drop, dim=1)
    ref = torch.where(W_drop.gather(1, ref[:, None])[:, 0] > 0, ref, newest_valid)
    R_old, t_old = m.kf_R[drop], m.kf_t[drop]
    R_new, t_new = m.kf_R[ref], m.kf_t[ref]
    R_rel = R_old @ R_new.transpose(1, 2)
    t_rel = t_old - (R_rel @ t_new[:, :, None])[:, :, 0]
    info = CullInfo(drop.to(torch.int32), drop_ok, ref.to(torch.int32), R_rel, t_rel)

    m = m.replace(kf_valid=kf_valid, kf_obs=kf_obs)
    if update_stats:
        m = ms.update_mappoint_stats(m)
    return m, info


def keyframe_chain(m: ms.MapState, cam: CameraModel, frame: Frame, slot: int, R, t, obs,
                   frame_id: int, timestamp: float, max_depth: float | None = None,
                   do_kf_cull: bool = True) -> tuple[ms.MapState, CullInfo]:
    """The per-keyframe mapping chain: insert -> (depth points, unless
    max_depth is None) -> recent-point cull -> triangulate -> local BA ->
    (keyframe cull) -> windowed stats refresh.  Returns the map and the
    CullInfo (all zero when culling is off)."""
    m = insert_keyframe_from_frame(m, frame, slot, R, t, obs, frame_id, timestamp)
    if max_depth is not None:
        m = create_depth_mappoints(m, cam, slot, max_depth)
    m = cull_recent_mappoints(m)
    m = create_new_mappoints(m, cam, slot)
    m = local_bundle_adjustment(m, cam, slot)
    if do_kf_cull:
        m, info = cull_keyframes(m, slot, update_stats=False)
    else:
        info = CullInfo.zeros(device=m.device)
    return ms.update_mappoint_stats_touched(m, window_touched_points(m, slot)), info
