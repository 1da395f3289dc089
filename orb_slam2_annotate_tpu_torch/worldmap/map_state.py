"""Map state as a dataclass of tensors (port of worldmap/map_state.py).

Same fields, shapes and slot semantics as the reference's MapState
NamedTuple: K keyframe slots, P map-point slots, N features per keyframe,
descriptors as int32 bit patterns.  Functions return new states (some
fields may share storage with the input); the reference's silent index
rules are written out: scatters that JAX drops go to an explicit dump
column or row, and gathers are clipped to range.

A map may hold only this rank's rows of the point axis (``mesh`` set by
``parallel.mesh.shard_map_state``): global point id g at local row g // n
of rank g % n.  ``P`` is then still the global count and ``P_local`` the
rows held here; every function below takes such a map, computing on its
own rows and exchanging what an op needs across points
(parallel/points.py).  Point masks and per-point arrays they take and
return are local ([P_local]); point ids are global.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.hamming import distinctive_descriptors
from ..ops.orb import DESC_WORDS
from ..ops.sorting import int32_saturated, stable_topk
from ..parallel import points as pts

MAX_OBS = 32
MAX_TOUCHED = 4096


@dataclasses.dataclass
class MapState:
    kf_R: torch.Tensor          # [K,3,3] world->cam
    kf_t: torch.Tensor          # [K,3]
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] i32
    kf_timestamp: torch.Tensor  # [K] f32
    kf_xy: torch.Tensor         # [K,N,2]
    kf_ur: torch.Tensor         # [K,N]
    kf_depth: torch.Tensor      # [K,N]
    kf_octave: torch.Tensor     # [K,N] i32
    kf_angle: torch.Tensor      # [K,N]
    kf_desc: torch.Tensor       # [K,N,16] i32
    kf_feat_valid: torch.Tensor # [K,N] bool
    kf_obs: torch.Tensor        # [K,N] i32 map-point id (-1 none)
    mp_pos: torch.Tensor        # [P,3]
    mp_valid: torch.Tensor      # [P] bool
    mp_desc: torch.Tensor       # [P,16] i32
    mp_normal: torch.Tensor     # [P,3]
    mp_min_dist: torch.Tensor   # [P]
    mp_max_dist: torch.Tensor   # [P]
    mp_visible: torch.Tensor    # [P] i32
    mp_found: torch.Tensor      # [P] i32
    mp_first_kf: torch.Tensor   # [P] i32
    n_kf: torch.Tensor          # 0-d i32

    # the mesh the point axis is split over (parallel/mesh.py); None: whole
    mesh = None

    @property
    def K(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def n_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def P_local(self) -> int:
        """Point rows held by this rank."""
        return self.mp_valid.shape[0]

    @property
    def P(self) -> int:
        """Point slots over all ranks."""
        return self.mp_valid.shape[0] * self.n_shards

    @property
    def N(self) -> int:
        return self.kf_obs.shape[1]

    @property
    def device(self):
        return self.kf_valid.device

    def replace(self, **kw) -> "MapState":
        out = dataclasses.replace(self, **kw)
        out.mesh = self.mesh
        return out


POINT_FIELDS = tuple(f.name for f in dataclasses.fields(MapState) if f.name.startswith("mp_"))


# fill value of each field in a fresh slot (empty_map / grow_map)
_FILL = dict(kf_t=0.0, kf_valid=False, kf_frame_id=-1, kf_timestamp=0.0, kf_xy=0.0, kf_ur=-1.0,
             kf_depth=0.0, kf_octave=0, kf_angle=0.0, kf_desc=0, kf_feat_valid=False,
             kf_obs=-1, mp_pos=0.0, mp_valid=False, mp_desc=0, mp_normal=0.0,
             mp_min_dist=0.0, mp_max_dist=float("inf"), mp_visible=1, mp_found=1,
             mp_first_kf=-1)


def empty_map(max_kf: int = 256, max_mp: int = 16384, n_feat: int = 1024,
              device=None, mesh=None) -> MapState:
    """A map with no keyframe and no point; with a `mesh` of n ranks, this
    rank's max_mp / n point rows (max_mp must be a multiple of n)."""
    n = pts.size(mesh)
    if max_mp % n:
        raise ValueError(f"max_mp={max_mp} is not a multiple of the {n} ranks of the mesh")
    K, P, N = max_kf, max_mp // n, n_feat
    f32, i32, b = torch.float32, torch.int32, torch.bool
    shapes = dict(kf_t=((K, 3), f32), kf_valid=((K,), b), kf_frame_id=((K,), i32),
                  kf_timestamp=((K,), f32), kf_xy=((K, N, 2), f32), kf_ur=((K, N), f32),
                  kf_depth=((K, N), f32), kf_octave=((K, N), i32), kf_angle=((K, N), f32),
                  kf_desc=((K, N, DESC_WORDS), i32), kf_feat_valid=((K, N), b),
                  kf_obs=((K, N), i32), mp_pos=((P, 3), f32), mp_valid=((P,), b),
                  mp_desc=((P, DESC_WORDS), i32), mp_normal=((P, 3), f32),
                  mp_min_dist=((P,), f32), mp_max_dist=((P,), f32), mp_visible=((P,), i32),
                  mp_found=((P,), i32), mp_first_kf=((P,), i32))
    fields = {k: torch.full(s, _FILL[k], dtype=d, device=device) for k, (s, d) in shapes.items()}
    out = MapState(kf_R=torch.eye(3, device=device).repeat(K, 1, 1),
                   n_kf=torch.zeros((), dtype=i32, device=device), **fields)
    out.mesh = mesh if n > 1 else None
    return out


def clear_map(m: MapState) -> MapState:
    """A map of the same shapes holding empty_map's fill values, on m's
    device (the free runner's auto-reset)."""
    return empty_map(m.K, m.P, m.N, device=m.device, mesh=m.mesh)


def grow_map(m: MapState, new_K: int | None = None, new_P: int | None = None) -> MapState:
    """Enlarged capacity; existing slots keep their indices (in the split
    layout the new ids' rows follow each rank's own)."""
    K, P, n = m.K, m.P, m.n_shards
    new_K = K if new_K is None else new_K
    new_P = P if new_P is None else new_P
    if new_K < K or new_P < P:
        raise ValueError("grow_map cannot shrink")
    if new_P % n:
        raise ValueError(f"new_P={new_P} is not a multiple of the {n} ranks of the mesh")
    if new_K == K and new_P == P:
        return m
    fresh = empty_map(new_K - K if new_K > K else 1, (new_P - P) // n if new_P > P else 1, m.N,
                      device=m.device)
    out = {}
    for f in dataclasses.fields(MapState):
        a = getattr(m, f.name)
        if f.name == "n_kf":
            out[f.name] = a
            continue
        grows = (new_K > K) if f.name.startswith("kf_") else (new_P > P)
        out[f.name] = torch.cat([a, getattr(fresh, f.name)]) if grows else a
    return m.replace(**out)


def insert_keyframe(m: MapState, slot: int, R, t, frame_id, timestamp, xy, ur, depth, octave,
                    angle, desc, feat_valid, obs) -> MapState:
    """Write a keyframe into `slot`.  obs: [N] map-point ids (-1 none)."""
    def put(a, v):
        a = a.clone()
        a[slot] = v
        return a

    return m.replace(
        kf_R=put(m.kf_R, R), kf_t=put(m.kf_t, t), kf_valid=put(m.kf_valid, True),
        kf_frame_id=put(m.kf_frame_id, frame_id), kf_timestamp=put(m.kf_timestamp, timestamp),
        kf_xy=put(m.kf_xy, xy), kf_ur=put(m.kf_ur, ur), kf_depth=put(m.kf_depth, depth),
        kf_octave=put(m.kf_octave, octave), kf_angle=put(m.kf_angle, angle),
        kf_desc=put(m.kf_desc, desc), kf_feat_valid=put(m.kf_feat_valid, feat_valid),
        kf_obs=put(m.kf_obs, obs), n_kf=m.n_kf + 1)


def free_mp_slots(m: MapState, count: int) -> torch.Tensor:
    """Global ids of `count` free map-point slots, lowest first (int64)."""
    _, idx = pts.topk_points(m.mesh, (~m.mp_valid).to(torch.int32), count)
    return idx


def point_rows(m: MapState, gid: torch.Tensor, *names: str) -> tuple:
    """The fields `names` (mp_*) of global point ids `gid` (clipped to
    [0, P - 1]), on every rank, in one exchange."""
    return pts.gather_rows(m.mesh, gid, *(getattr(m, k) for k in names))



def _scatter_max_bool(size: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(size, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, idx.reshape(-1), val.reshape(-1).to(torch.int32), "amax").bool()


def observation_matrix(m: MapState) -> torch.Tensor:
    """O[K,P_local] bool: keyframe k observes (local) point p."""
    K, P = m.K, m.P_local
    valid, rows = pts.owned_rows(m.mesh, m.kf_obs, m.kf_feat_valid & m.kf_valid[:, None])
    lin = torch.arange(K, device=m.device)[:, None] * P + rows
    return _scatter_max_bool(K * P, lin, valid).reshape(K, P)


def covisibility(m: MapState, O: torch.Tensor | None = None) -> torch.Tensor:
    """W[K,K] int32 shared-point counts, diagonal zeroed.  The reference's
    int8 product becomes a float32 product of the 0/1 matrix (torch has no
    integer matmul on CUDA): exact, as counts stay below 2^24 and TF32 is
    off; on a split map each rank's product over its own columns, summed."""
    if O is None:
        O = observation_matrix(m)
    Of = O.to(torch.float32)
    W = pts.sum_points(m.mesh, Of @ Of.T).to(torch.int32)
    return W.fill_diagonal_(0)


def spanning_tree_parents(m: MapState, W: torch.Tensor | None = None) -> torch.Tensor:
    """parent[k] = earlier slot with the most shared points (-1 for roots)."""
    if W is None:
        W = covisibility(m)
    ar = torch.arange(m.K, device=m.device)
    earlier = (ar[None, :] < ar[:, None]) & m.kf_valid[None, :]
    Wm = torch.where(earlier, W, -1)
    has = Wm.max(1).values > 0
    return torch.where(has & m.kf_valid, torch.argmax(Wm, dim=1), -1).to(torch.int32)


def point_mask_rows(m: MapState, rows: torch.Tensor, rows_ok: torch.Tensor) -> torch.Tensor:
    """[P_local] bool: union of the points observed by keyframe slots `rows`."""
    obs = m.kf_obs[rows]
    ok, idx = pts.owned_rows(m.mesh, torch.clamp(obs, max=m.P - 1),
                             m.kf_feat_valid[rows] & (rows_ok & m.kf_valid[rows])[:, None])
    return _scatter_max_bool(m.P_local, idx, ok)


def covis_rows(m: MapState, rows: torch.Tensor, rows_ok: torch.Tensor | None = None) -> torch.Tensor:
    """[S, K] int32 shared-point counts of keyframe slots `rows`, self-columns 0."""
    S, P = rows.shape[0], m.P_local
    obs = torch.clamp(m.kf_obs[rows], max=m.P - 1)
    kv = m.kf_valid[rows] if rows_ok is None else rows_ok & m.kf_valid[rows]
    ok, loc = pts.owned_rows(m.mesh, obs, m.kf_feat_valid[rows] & kv[:, None])
    lin = torch.arange(S, device=m.device)[:, None] * P + loc
    pm = _scatter_max_bool(S * P, lin, ok).reshape(S, P)
    all_ok, all_loc = pts.owned_rows(m.mesh, torch.clamp(m.kf_obs, max=m.P - 1),
                                     m.kf_feat_valid & m.kf_valid[:, None])
    hit = pm[:, all_loc]                                              # [S,K,N]
    W = pts.sum_points(m.mesh, (hit & all_ok[None]).sum(-1)).to(torch.int32)
    W[torch.arange(S, device=m.device), rows.long()] = 0
    return W


def covis_row(m: MapState, slot) -> torch.Tensor:
    """One covisibility row W[slot] as a [K] int32 vector."""
    rows = torch.as_tensor(slot, device=m.device).reshape(1)
    return covis_rows(m, rows, torch.ones(1, dtype=torch.bool, device=m.device))[0]


def observation_table(m: MapState):
    """(obs_kf [P_local,32], obs_ft [P_local,32], obs_cnt [P_local],
    obs_mask [P_local,32]): up to MAX_OBS (keyframe, feature) pairs per
    point, lowest keyframe first; duplicate same-keyframe features collapse
    to the lowest feature index."""
    K, P, N = m.K, m.P_local, m.N
    dev = m.device
    valid, loc = pts.owned_rows(m.mesh, m.kf_obs, m.kf_feat_valid & m.kf_valid[:, None])
    pt = torch.where(valid, loc, P)                                   # P = dump column
    lin = torch.arange(K, device=dev)[:, None] * (P + 1) + pt
    feat = torch.where(valid, torch.arange(N, device=dev, dtype=torch.int32)[None, :], N)
    F = torch.full((K * (P + 1),), N, dtype=torch.int32, device=dev)
    F = F.scatter_reduce(0, lin.reshape(-1), feat.reshape(-1), "amin")
    Ft = F.reshape(K, P + 1)[:, :P].T                                 # [P,K]
    has = Ft < N
    kcap = min(MAX_OBS, K)
    score = torch.where(has, K - torch.arange(K, device=dev, dtype=torch.int32)[None, :], 0)
    top, ks = stable_topk(score, kcap)
    mask0 = top > 0
    obs_kf = torch.where(mask0, ks, 0).to(torch.int32)
    obs_ft = torch.where(mask0, torch.gather(Ft, 1, ks), 0).to(torch.int32)
    if kcap < MAX_OBS:
        pad = (0, MAX_OBS - kcap)
        obs_kf = torch.nn.functional.pad(obs_kf, pad)
        obs_ft = torch.nn.functional.pad(obs_ft, pad)
    obs_cnt = torch.clamp(has.sum(1), max=MAX_OBS).to(torch.int32)
    obs_mask = torch.arange(MAX_OBS, device=dev)[None, :] < obs_cnt[:, None]
    # row-major, as kernel 3b takes them: with K >= MAX_OBS the tables keep
    # Ft's transposed strides
    return obs_kf.contiguous(), obs_ft.contiguous(), obs_cnt, obs_mask


def _geometry_from_table(m: MapState, pos, obs_kf, obs_ft, obs_mask):
    """Normal + scale-invariance band for points with tables [Q, MAX_OBS]."""
    # -R t, as the JAX package computes it (its map_state.py:417 transposes
    # kf_R before an einsum that already contracts the first index); the
    # camera centre is -R^T t.  Kept for parity with the reference, which
    # stays as it is (ROADMAP.md §3).
    cam_centers = -torch.einsum("kij,kj->ki", m.kf_R, m.kf_t)
    centers = cam_centers[obs_kf.long()]
    dirs = pos[:, None, :] - centers
    norms = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs / torch.clamp_min(norms, 1e-9)
    normal = torch.where(obs_mask[..., None], dirs_n, torch.zeros_like(dirs_n)).sum(1)
    normal = normal / torch.clamp_min(torch.linalg.norm(normal, dim=-1, keepdim=True), 1e-9)
    ref_dist = torch.linalg.norm(pos - centers[:, 0], dim=-1)
    ref_oct = m.kf_octave[obs_kf[:, 0].long(), obs_ft[:, 0].long()]
    scale = scale_power(ref_oct)
    n_levels = 1 + torch.max(torch.where(m.kf_feat_valid, m.kf_octave, 0))
    max_dist = ref_dist * scale
    min_dist = max_dist / scale_power(n_levels - 1)
    return normal, 0.8 * min_dist, 1.2 * max_dist


def _stats_from_table(m: MapState, pos, obs_kf, obs_ft, obs_cnt, obs_mask):
    """Distinctive descriptor (least median distance) + normal + depth band."""
    new_desc, _ = distinctive_descriptors(m.kf_desc, obs_kf, obs_ft, obs_cnt)
    normal, min_d, max_d = _geometry_from_table(m, pos, obs_kf, obs_ft, obs_mask)
    return new_desc, normal, min_d, max_d


def update_mappoint_stats_touched(m: MapState, touched: torch.Tensor,
                                  max_touched: int = MAX_TOUCHED) -> MapState:
    """Refresh descriptors / normals / depth bands of up to max_touched
    touched points (the lowest ids first, over all ranks; a rank runs
    kernel 3b on the selected rows it owns, the others count 0
    observations); validity is refreshed for every point."""
    P = m.P_local
    max_touched = min(max_touched, m.P)
    obs_kf, obs_ft, obs_cnt, _ = observation_table(m)
    sel_score = (touched & m.mp_valid).to(torch.int32)
    top, psel = pts.topk_points(m.mesh, sel_score, max_touched)
    own, psel = pts.owned_rows(m.mesh, psel, top > 0)
    cnt = torch.where(own, obs_cnt[psel], 0)
    new_desc, normal, min_d, max_d = _stats_from_table(
        m, m.mp_pos[psel], obs_kf[psel], obs_ft[psel], cnt,
        torch.arange(MAX_OBS, device=m.device)[None, :] < cnt[:, None])
    upd = cnt > 0
    tgt = torch.where(upd, psel, P)                                   # P = dump row

    def put(a, v):
        return torch.cat([a, a[:1]]).index_put((tgt,), v)[:P]

    return m.replace(mp_desc=put(m.mp_desc, new_desc), mp_normal=put(m.mp_normal, normal),
                     mp_min_dist=put(m.mp_min_dist, min_d), mp_max_dist=put(m.mp_max_dist, max_d),
                     mp_valid=m.mp_valid & (obs_cnt > 0))


def update_mappoint_stats(m: MapState) -> MapState:
    """Refresh the stats of every valid point from its observations."""
    obs_kf, obs_ft, obs_cnt, obs_mask = observation_table(m)
    new_desc, normal, min_d, max_d = _stats_from_table(m, m.mp_pos, obs_kf, obs_ft, obs_cnt,
                                                       obs_mask)
    upd = m.mp_valid & (obs_cnt > 0)
    return m.replace(
        mp_desc=torch.where(upd[:, None], new_desc, m.mp_desc),
        mp_normal=torch.where(upd[:, None], normal, m.mp_normal),
        mp_min_dist=torch.where(upd, min_d, m.mp_min_dist),
        mp_max_dist=torch.where(upd, max_d, m.mp_max_dist),
        mp_valid=m.mp_valid & (obs_cnt > 0))


def predict_octave(max_dist: torch.Tensor, dist: torch.Tensor, top_oct, scale: float = 1.2):
    """PredictScale: the pyramid level a point at `dist` should appear at,
    ceil(log(max_dist / dist) / log(scale)) clipped to [0, top_oct].  A point
    seen from where its stats were taken sits on a level's boundary, so the
    level follows the last bit of each step; every step here gives the same
    bits on the card and the CPU: the log correctly rounded (through
    float64), the division by a tensor on the data's device (the card
    multiplies by the reciprocal of a CPU scalar), the level converted as XLA
    converts (``int32_saturated``: a new point's max_dist is +inf)."""
    ratio = torch.clamp_min(max_dist / torch.clamp_min(dist, 1e-9), 1.0)
    # log(scale) as the CPU's float32 log gives it, made on the data's device (a copy
    # from the host would synchronize)
    log_scale = torch.full((), float(torch.log(torch.tensor(scale))), device=ratio.device)
    lvl = torch.ceil(torch.log(ratio.double()).float() / log_scale)
    return torch.minimum(torch.clamp_min(int32_saturated(lvl), 0), top_oct)


def scale_power(octave: torch.Tensor, scale: float = 1.2, twice: bool = False) -> torch.Tensor:
    """scale ** octave (or ** (2 octave)) as the CPU's torch.pow gives it
    for the float32 scale (correctly rounded), from a table made in float64
    on the octaves' device: the same bits on the card, whose float32 pow
    rounds otherwise."""
    dev = octave.device
    k = torch.arange(0, 64, dtype=torch.float64, device=dev) * (2.0 if twice else 1.0)
    base = torch.full((), float(torch.tensor(scale, dtype=torch.float32)), dtype=torch.float64,
                      device=dev)
    return (base ** k).float()[octave.long()]


def scaled_radius(base, octave: torch.Tensor, scale: float = 1.2) -> torch.Tensor:
    """A search radius at each octave: base * scale ** octave (base a number or
    a tensor), the power from ``scale_power``."""
    return base * scale_power(octave, scale)


def inv_level_sigma2(octave: torch.Tensor, scale: float = 1.2) -> torch.Tensor:
    """1 / sigma^2 of a keypoint at each octave: 1 / scale ** (2 octave), the
    power from ``scale_power``."""
    return 1.0 / scale_power(octave, scale, twice=True)


def mp_observation_counts(m: MapState) -> torch.Tensor:
    """n_obs[P_local]: number of keyframes observing each point."""
    return observation_matrix(m).sum(0).to(torch.int32)


def observation_overflow(m: MapState):
    """(points with more than MAX_OBS observations, observations the
    MAX_OBS table drops), both 0-d."""
    n_obs = mp_observation_counts(m)
    over = m.mp_valid & (n_obs > MAX_OBS)
    return tuple(pts.sum_points(m.mesh, torch.stack([over.sum(),
                                                     torch.where(over, n_obs - MAX_OBS, 0).sum()])))


def update_mappoint_geometry(m: MapState) -> MapState:
    """Refresh normals and depth bands (and observation-based validity) of
    every point, leaving descriptors as they are: after a loop correction or
    a global BA every point moved, but no descriptor changed."""
    obs_kf, obs_ft, obs_cnt, obs_mask = observation_table(m)
    normal, min_d, max_d = _geometry_from_table(m, m.mp_pos, obs_kf, obs_ft, obs_mask)
    upd = m.mp_valid & (obs_cnt > 0)
    return m.replace(mp_normal=torch.where(upd[:, None], normal, m.mp_normal),
                     mp_min_dist=torch.where(upd, min_d, m.mp_min_dist),
                     mp_max_dist=torch.where(upd, max_d, m.mp_max_dist),
                     mp_valid=m.mp_valid & (obs_cnt > 0))
