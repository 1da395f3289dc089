"""Local mapping: keyframe insertion, depth points (RGB-D / stereo),
recent-point culling, triangulation, neighbour fuse, local BA, keyframe
culling, and the projection fuse that loop closing's SearchAndFuse runs
(port of pipeline/local_mapping.py).  ``keyframe_chain`` puts a
``torch.profiler.record_function`` span on each stage (mapping/insert,
mapping/depth_points, mapping/cull_recent, mapping/triangulate,
mapping/fuse, mapping/local_ba, mapping/kf_cull, mapping/stats).

The reference's ``.at[]`` writes that route filler indices to a dump row
(K) or column (P) keep that dump slot here explicitly: torch raises on an
out-of-range index where JAX drops the write.

On a map whose point axis is split over ranks (worldmap/map_state.py) the
per-point tests run on each rank's own rows; point selections are top-k
over all ranks, their rows gathered, the keyframe-side work (matching,
triangulation, the grid BA) runs on every rank and each rank writes back
the rows it owns (parallel/points.py).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..geometry import lie
from ..geometry.camera import CameraModel, backproject, in_image, project
from ..geometry.twoview import triangulate_dlt
from ..ops import matching
from ..ops.sorting import nanmedian, stable_topk
from ..parallel import points as pts
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
    """Points at `pos` [n,3] in the free `slots` [n] (global ids) where
    `take`: valid, created by the newest keyframe (mp_first_kf = n_kf - 1),
    seen and found once."""
    def put(a, v):
        return pts.put_rows(m.mesh, a, slots, v, take)

    ones = torch.ones(slots.shape[0], dtype=m.mp_visible.dtype, device=m.device)
    return m.replace(mp_pos=put(m.mp_pos, pos), mp_valid=put(m.mp_valid, True),
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
    take = need & ~ms.point_rows(m, slots, "mp_valid")[0]
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
    obs_bad = (obs >= 0) & pts.gather_rows(m.mesh, obs, bad)[0]
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
    z = (ms.point_rows(m, obs, "mp_pos")[0] @ R.transpose(-1, -2)
         + t[..., None, :])[..., 2]
    return torch.nan_to_num(nanmedian(torch.where(has, z, torch.full_like(z, float("nan")))),
                            nan=1.0)


def create_new_mappoints(m: ms.MapState, cam: CameraModel, slot: int,
                         n_neighbors: int = 20, update_stats: bool = False) -> ms.MapState:
    """Triangulate new points between the new keyframe and its best covisible
    neighbours that pass the baseline / median-depth gate; each unmatched
    feature keeps its largest-parallax valid pair.  With `update_stats` it
    ends in the windowed stats refresh (the reference's default; here off by
    default, as the keyframe chain refreshes once at its end unless fuse
    needs fresh stats)."""
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
    oct1 = m.kf_octave[slot]
    s2_1 = ms.scale_power(oct1, SCALE, twice=True)

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
        oct2 = f2.octave[i, idc]
        r1v, r2v = X - c1, X - c2
        d1, d2 = torch.linalg.norm(r1v, dim=1), torch.linalg.norm(r2v, dim=1)
        cosp = (r1v * r2v).sum(1) / torch.clamp_min(d1 * d2, 1e-9)
        ratio_d = d1 / torch.clamp_min(d2, 1e-9)
        ratio_o = ms.scale_power(oct1, SCALE) / ms.scale_power(oct2, SCALE)
        scale_ok = (ratio_d < ratio_o * SCALE * 1.5) & (ratio_d * SCALE * 1.5 > ratio_o)
        good = ((idx >= 0) & torch.isfinite(X).all(1) & (xc1[:, 2] > 0) & (xc2[:, 2] > 0)
                & (e1 < 5.991 * s2_1) & (e2 < 5.991 * ms.scale_power(oct2, SCALE, twice=True))
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
    take = good & ~ms.point_rows(m, slots, "mp_valid")[0]
    new_ids = torch.where(take, slots.to(torch.int32), -1)
    kf_obs = m.kf_obs.clone()
    kf_obs[slot] = torch.where(take, new_ids, m.kf_obs[slot])
    lin = nb_sel * N + torch.clamp_min(best_idx, 0).long()
    kf_obs = kf_obs.reshape(-1).scatter_reduce(0, lin, new_ids, "amax").reshape(K, N)
    m = _new_points(m, slots, take, X).replace(kf_obs=kf_obs)
    if update_stats:
        m = ms.update_mappoint_stats_touched(m, window_touched_points(m, slot))
    return m


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

    all_ok, all_loc = pts.owned_rows(m.mesh, torch.clamp(m.kf_obs, max=P - 1),
                                     m.kf_feat_valid & m.kf_valid[:, None])
    sees_local = pts.any_points(m.mesh, (pts_mask[all_loc] & all_ok).any(1))
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
    top, psel = pts.topk_points(m.mesh, pts_mask.to(torch.int32), P_BA)
    psel_ok = top > 0
    # global point id -> BA point index, on every rank
    g2l = torch.full((P,), -1, dtype=torch.int32, device=dev)
    g2l[psel] = torch.where(psel_ok, torch.arange(P_BA, dtype=torch.int32, device=dev), -1)

    obs_grid = m.kf_obs[cams_all]
    feat_ok = m.kf_feat_valid[cams_all] & cams_ok[:, None]
    pt_loc = torch.where(feat_ok & (obs_grid >= 0), g2l[torch.clamp(obs_grid, 0, P - 1).long()], -1)
    e_valid = feat_ok & (pt_loc >= 0)
    prob = ba_core.GridBA(
        R=m.kf_R[cams_all], t=m.kf_t[cams_all], points=ms.point_rows(m, psel, "mp_pos")[0],
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
    mp_pos = pts.put_rows(m.mesh, m.mp_pos, psel, X2, psel_ok)
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
    at the values both of its callers use.

    One point can lose in several targets, each time to another winner.  The
    reference's ``.at[].set`` keeps the last write on the CPU, i.e. the merge
    pair with the largest flat position t * N + n; the port picks that pair
    by an explicit ``amax`` over the positions, so the card and the CPU keep
    the same winner (torch leaves duplicate ``index_put`` writes unordered).
    src_masks are local ([T, P_local]); the remap table is built on every
    rank from the gathered proposals."""
    K, P, N = m.K, m.P, m.N
    mesh = m.mesh
    dev = m.device
    T = targets.shape[0]
    MAXC = min(1024, P)
    tl = targets.long()
    R, t = m.kf_R[tl], m.kf_t[tl]                                      # [T,3,3], [T,3]
    xc = torch.einsum("pj,tij->tpi", m.mp_pos, R) + t[:, None]          # [T,P,3]
    uv = project(cam, xc)
    centre = -torch.einsum("tji,tj->ti", R, t)                          # -R^T t
    dvec = m.mp_pos[None] - centre[:, None]
    # the gates below in the CPU's bits on every device (lie.norm3, the dot's
    # sums in order, ms.predict_octave, ms.scale_power)
    dist = lie.norm3(dvec)
    dn = dvec * m.mp_normal[None]
    vcos = (dn[..., 0] + dn[..., 1] + dn[..., 2]) / torch.clamp_min(dist, 1e-9)
    okp = (src_masks & (xc[..., 2] > 0.05) & in_image(cam, uv) & (dist >= m.mp_min_dist)
           & (dist <= m.mp_max_dist) & (vcos > 0.5))
    top_oct = torch.where(m.kf_feat_valid, m.kf_octave, 0).max()
    pred_oct = ms.predict_octave(m.mp_max_dist, dist, top_oct, SCALE)
    cand = pts.topk_points(mesh, okp.to(torch.int32), MAXC)[1].contiguous()   # [T,MAXC]
    cvalid, c_oct, c_uv, z_pt = pts.gather_rows(mesh, cand, okp, pred_oct, uv, xc[..., 2],
                                                batch=True)
    radius = 3.0 * ms.scale_power(c_oct, SCALE)
    res = matching.search_map_points(ms.point_rows(m, cand, "mp_desc")[0], cvalid, c_uv, c_oct,
                                     radius,
                                     _kf_frame(m, tl), ratio=ratio, max_dist=matching.TH_LOW)
    tgt = torch.clamp_min(res.idx, 0).long()                            # [T,MAXC]
    f_oct = torch.gather(m.kf_octave[tl], 1, tgt)
    sig2 = ms.scale_power(f_oct, SCALE, twice=True)
    f_xy = torch.gather(m.kf_xy[tl], 1, tgt[..., None].expand(-1, -1, 2))
    e2 = ((c_uv - f_xy) ** 2).sum(-1)
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
    g_obs, g_pos = pts.gather_rows(mesh, torch.stack([ex, pr]), n_obs, m.mp_pos)
    p_ex = g_pos[0]
    d3 = lie.norm3(p_ex - g_pos[1])
    depth_scale = torch.clamp_min(lie.norm3(p_ex - centre[:, None]), 1e-3)
    merge_mask &= d3 < 0.015 * depth_scale
    ex_wins = g_obs[0] >= g_obs[1]
    loser = torch.where(ex_wins, pr, ex)
    winner = torch.where(ex_wins, ex, pr)
    # each loser's surviving merge pair: the largest flat position (P = dump slot)
    last = torch.full((P + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.where(merge_mask, loser, P).reshape(-1), torch.arange(T * N, device=dev),
        "amax")[:P]
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    remap = torch.where(last >= 0, winner.reshape(-1)[torch.clamp_min(last, 0)].to(torch.int32), ar)
    remap = remap[remap.long()]                                         # resolve 2-chains

    rows = torch.where(add_mask, prop, existing)
    kf_obs = torch.cat([m.kf_obs, m.kf_obs[:1]]).index_put((torch.where(tgt_ok, tl, K),),
                                                           rows)[:K]
    live = (remap == ar)[(mesh.rank if mesh else 0)::m.n_shards]       # this rank's rows
    kf_obs = torch.where(kf_obs >= 0, remap[torch.clamp_min(kf_obs, 0).long()], -1)
    return m.replace(kf_obs=kf_obs, mp_valid=m.mp_valid & live)


def fuse_neighbors(m: ms.MapState, cam: CameraModel, slot: int) -> ms.MapState:
    """Two-way fuse with the covisible neighbours (SearchInNeighbors): the
    targets are keyframe `slot` and its 10 best covisible keyframes; the
    neighbours' points fuse into `slot`, and `slot`'s points into each
    neighbour, all targets in one kernel-3 launch (B = T).  The point stats
    are left to the caller's windowed refresh (the reference's
    ``update_stats=False``, as its keyframe chain calls it)."""
    P = m.P_local
    dev = m.device
    n_neighbors = min(10, m.K - 1)
    w_slot = torch.where(m.kf_valid, ms.covis_row(m, slot), -1)
    w_slot[slot] = -1
    _, nbrs = stable_topk(w_slot, n_neighbors)
    nbr_ok = w_slot[nbrs] > 0
    targets = torch.cat([torch.tensor([slot], device=dev), nbrs])
    tgt_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nbr_ok])

    own = m.kf_obs[slot]
    own_pts = pts.scatter_owned(m.mesh, P, torch.clamp_min(own, 0), own >= 0)
    # the reference's static loop of per-neighbour scatters, as one over [n_neighbors, N]
    o = m.kf_obs[nbrs]
    nbr_pts = pts.scatter_owned(m.mesh, P, torch.clamp_min(o, 0), (o >= 0) & nbr_ok[:, None])
    src_masks = torch.cat([(nbr_pts & m.mp_valid)[None],
                           (own_pts & m.mp_valid)[None].expand(n_neighbors, P)])
    return _fuse_targets_core(m, cam, targets, tgt_ok, src_masks)


def fuse_points_into(m: ms.MapState, cam: CameraModel, targets: torch.Tensor, tgt_ok: torch.Tensor,
                     src_mask: torch.Tensor) -> ms.MapState:
    """SearchAndFuse for loop closing: one shared set of source points (the
    loop neighbourhood's) fused into every target keyframe [T].  The point
    statistics are left stale: the caller refreshes the points it touched."""
    T = targets.shape[0]
    src_masks = (src_mask & m.mp_valid)[None].expand(T, m.P_local)
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
    own, pid = pts.owned_rows(m.mesh, torch.clamp(obs_w, 0, P - 1))
    has = (obs_w >= 0) & m.kf_feat_valid[win] & win_ok[:, None]
    fine = obs_mask[pid] & (obs_oct[pid] <= m.kf_octave[win][..., None] + 1) & (
        obs_kf[pid] != win[:, None, None])                              # [C_WIN, N, MAX_OBS]
    # each rank counts the observations of its own points; summed
    red = has & (pts.sum_points(m.mesh, torch.where(own, fine.sum(-1), 0)) >= 3)
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
                   do_cull_recent: bool = True, stats_in_triangulate: bool = False,
                   do_fuse: bool = False, do_local_ba: bool = True,
                   do_kf_cull: bool = True) -> tuple[ms.MapState, CullInfo]:
    """The per-keyframe mapping chain: insert -> (depth points, unless
    max_depth is None) -> (recent-point cull) -> triangulate (with a stats
    refresh when `stats_in_triangulate`) -> (fuse) -> (local BA) ->
    (keyframe cull) -> windowed stats refresh, each stage in its own span.
    Returns the map and the CullInfo (all zero when culling is off)."""
    with record_function("mapping/insert"):
        m = insert_keyframe_from_frame(m, frame, slot, R, t, obs, frame_id, timestamp)
    if max_depth is not None:
        with record_function("mapping/depth_points"):
            m = create_depth_mappoints(m, cam, slot, max_depth)
    if do_cull_recent:
        with record_function("mapping/cull_recent"):
            m = cull_recent_mappoints(m)
    with record_function("mapping/triangulate"):
        m = create_new_mappoints(m, cam, slot, update_stats=stats_in_triangulate)
    if do_fuse:
        with record_function("mapping/fuse"):
            m = fuse_neighbors(m, cam, slot)
    if do_local_ba:
        with record_function("mapping/local_ba"):
            m = local_bundle_adjustment(m, cam, slot)
    if do_kf_cull:
        with record_function("mapping/kf_cull"):
            m, info = cull_keyframes(m, slot, update_stats=False)
    else:
        info = CullInfo.zeros(device=m.device)
    with record_function("mapping/stats"):
        m = ms.update_mappoint_stats_touched(m, window_touched_points(m, slot))
    return m, info
