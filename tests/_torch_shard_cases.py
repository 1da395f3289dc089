"""The cases of tests/test_torch_shard_points.py: each ``rank_<mode>`` runs on
one rank of a gloo group (tests/_torch_dist_worker.py MODE ...), the live
map's point axis split over the group; ``run_system`` / ``run_free`` are
also what the test runs at a world of one, so both sides run the same code.

Ranks compare what they can on their own (the primitives against their
plain ops, the split map's functions against the whole map's on the same
input) and raise on a mismatch; the rest goes back in their outputs.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
from orb_slam2_annotate_tpu_torch.io import synthetic as tsyn
from orb_slam2_annotate_tpu_torch.ops.sorting import stable_topk
from orb_slam2_annotate_tpu_torch.parallel import mesh as tmesh
from orb_slam2_annotate_tpu_torch.parallel import points as pts
from orb_slam2_annotate_tpu_torch.worldmap import map_state as ms

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
# tests/test_torch_system.py's sizes
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=8,
             init_min_matches=60)


def frames(n: int, step: float = 0.06):
    """tests/test_torch_system.py's slice: PlaneScene(1) on an orbit, as
    uint8 images (as JAX's tests/test_dist_ba.py feeds its System)."""
    scene = tsyn.PlaneScene(seed=1)
    return [np.clip(scene.render(CAM, R, t, h=240, w=320)[0], 0, 255).astype(np.uint8)
            for R, t in tsyn.orbit_trajectory(n, step=step)]


def traj_array(traj) -> np.ndarray:
    """[(frame_id, 4x4 or None)] as [F, 4, 4] with NaN for lost frames."""
    return np.stack([np.full((4, 4), np.nan, np.float32) if T is None else T for _, T in traj])


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def same(a, b, what: str):
    """Raise unless a and b are equal bit for bit."""
    a, b = (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (a, b))
    if a.shape != b.shape or not np.array_equal(bits(a), bits(b)):
        raise AssertionError(f"{what}: split and whole differ")


def same_map(m_split, m_whole, what: str):
    for k, v in convert.map_state_to_numpy(m_whole).items():
        same(convert.map_state_to_numpy(m_split)[k], v, f"{what}: {k}")


def run_system(cfg, n_frames: int = 14, save: str | None = None):
    """The port's System on the slice: (trajectory [F,4,4], whole map as
    numpy, the System)."""
    from orb_slam2_annotate_tpu_torch.pipeline import System

    slam = System(CAM, cfg, device="cpu")
    for k, img in enumerate(frames(n_frames)):
        slam.track_mono(img, k / 30.0)
    traj = traj_array(slam.frame_trajectory())
    if save:
        slam.save_map(save)
    return traj, convert.map_state_to_numpy(slam.map), slam


def run_free(cfg, n_frames: int = 14):
    """The port's FreeRunner on the slice: (trajectory, whole map as numpy)."""
    from orb_slam2_annotate_tpu_torch.pipeline import device_loop as dl

    r = dl.FreeRunner(CAM, cfg, max_frames=n_frames, auto_grow=False, device="cpu")
    for k, img in enumerate(frames(n_frames, step=0.05)):
        r.track_mono(img, k / 30.0)
    out = r.finish()
    return traj_array(out["trajectory"]), convert.map_state_to_numpy(out["map"])


# tests/test_torch_rgbd.py's cell: PlaneScene seed 2, bf = 250 x 0.08, th_depth 100; the
# stereo pairs' right camera one baseline (bf / fx) to the right
DEPTH_ARGS = dict(ARGS, bf=250.0 * 0.08)
DEPTH_CAM = CameraModel.create(**DEPTH_ARGS)
DEPTH_KW = dict(n_features=512, n_levels=4, max_kf=32, max_mp=8192, max_frames_between_kf=4,
                th_depth=100.0)


def depth_frames(n: int, sensor: str):
    """(left uint8, depth f32 or right uint8) of the depth cell's first n frames."""
    scene = tsyn.PlaneScene(seed=2)
    b = DEPTH_CAM.bf / DEPTH_CAM.fx
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8)
    out = []
    for R, t in tsyn.orbit_trajectory(n, step=0.06):
        img, dep = scene.render(DEPTH_CAM, R, t, h=240, w=320)
        if sensor == "stereo":
            t_r = np.asarray(t, np.float32) - np.array([b, 0, 0], np.float32)
            dep = u8(scene.render(DEPTH_CAM, R, t_r, h=240, w=320)[0])
        out.append((u8(img), dep))
    return out


def run_depth(kind: str, shard: bool, n_frames: int = 12):
    """The depth cell through the System (kind "rgbd" / "stereo") or the
    FreeRunner ("free_rgbd"): (trajectory, whole map as numpy, the map)."""
    from orb_slam2_annotate_tpu_torch.pipeline import System, device_loop, mono_slice_config

    sensor = kind.replace("free_", "")
    cfg = mono_slice_config(**DEPTH_KW, sensor=sensor, shard_points=shard)
    if kind.startswith("free_"):
        r = device_loop.FreeRunner(DEPTH_CAM, cfg, max_frames=n_frames, auto_grow=False,
                                   device="cpu")
        for k, (img, dep) in enumerate(depth_frames(n_frames, sensor)):
            r.track_rgbd(img, dep, k / 30.0)
        out = r.finish()
        return traj_array(out["trajectory"]), convert.map_state_to_numpy(out["map"]), out["map"]
    slam = System(DEPTH_CAM, cfg, device="cpu")
    track = slam.track_rgbd if sensor == "rgbd" else slam.track_stereo
    for k, (img, other) in enumerate(depth_frames(n_frames, sensor)):
        track(img, other, k / 30.0)
    return traj_array(slam.frame_trajectory()), convert.map_state_to_numpy(slam.map), slam.map


def _spec(d) -> dict:
    return json.loads(str(d["spec"])) if "spec" in d else {}


def _whole_map(d, prefix="m_"):
    return convert.map_state_from_numpy({k[len(prefix):]: v for k, v in d.items()
                                         if k.startswith(prefix)}, device="cpu")


# ---- the primitives ------------------------------------------------------


def rank_prims(d, out_dir) -> dict:
    """Every primitive against its plain op on random inputs (the same on
    every rank), exactly: ties, -1 ids and ids past the end, negative zeros,
    the all-rows path, duplicate adds, growth and the round trip."""
    mesh = tmesh.map_mesh()
    n, r = mesh.size, mesh.rank
    rng = np.random.RandomState(7)
    P = 60                                            # a multiple of 2 and 3
    f = torch.from_numpy(rng.randn(P, 3).astype(np.float32))
    f[::7] = -0.0
    f[3, 1] = float("nan")
    i = torch.from_numpy(rng.randint(-5, 5, (P,)).astype(np.int32))
    b = torch.from_numpy(rng.rand(P) > 0.5)
    desc = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (P, 16)).astype(np.int32))
    whole = (f, i, b, desc)
    local = tuple(a[r::n].contiguous() for a in whole)
    for shape in ((17,), (3, 9), (200,)):                 # 200 > P: the all-rows path
        gid = torch.from_numpy(rng.randint(-1, P + 4, shape))
        for got, a in zip(pts.gather_rows(mesh, gid, *local), whole):
            same(got, a[torch.clamp(gid, 0, P - 1)], f"gather_rows {shape} {a.dtype}")
    for got, a in zip(pts.all_rows(mesh, *local), whole):
        same(got, a, f"all_rows {a.dtype}")
    # batched: [B, P, 2] gathered by [B, k]
    fb = torch.from_numpy(rng.randn(4, P, 2).astype(np.float32))
    gb = torch.from_numpy(rng.randint(0, P, (4, 11)))
    same(pts.gather_rows(mesh, gb, fb[:, r::n].contiguous(), batch=True)[0],
         torch.gather(fb, 1, gb[..., None].expand(-1, -1, 2)), "gather_rows batch")
    # put: distinct ids with -1 entries and an ok mask; the plain dump-row write
    gid = torch.from_numpy(rng.permutation(P)[:25]).to(torch.int64)
    gid[::6] = -1
    ok = torch.from_numpy(rng.rand(25) > 0.3)
    val = torch.from_numpy(rng.randn(25, 3).astype(np.float32))
    tgt = torch.where(ok & (gid >= 0), gid, P)
    plain = torch.cat([f, f[:1]]).index_put((tgt,), val)[:P]
    same(pts.all_rows(mesh, pts.put_rows(mesh, local[0], gid, val, ok))[0], plain, "put_rows")
    # index_add with duplicates
    gid = torch.from_numpy(rng.randint(0, P, (40,)))
    add = torch.from_numpy(rng.randint(0, 3, (40,)).astype(np.int32))
    same(pts.all_rows(mesh, pts.index_add_rows(mesh, local[1], gid, add))[0],
         i.index_add(0, gid, add), "index_add_rows")
    okm = torch.from_numpy(rng.rand(40) > 0.5)
    plain = torch.zeros(P, dtype=torch.int32).scatter_reduce(0, gid, okm.to(torch.int32),
                                                             "amax").bool()
    same(pts.all_rows(mesh, pts.scatter_owned(mesh, P // n, gid, okm))[0], plain, "scatter_owned")
    # top-k: integer scores with ties, float scores with ties and -0.0, batched
    si = torch.from_numpy(rng.randint(0, 4, (P,)).astype(np.int32))
    sf = torch.from_numpy(rng.randint(-2, 3, (3, P)).astype(np.float32))
    sf[0, ::5] = -0.0
    for s in (si, sf):
        for k in (1, 7, P // n + 3, P):
            v, g = pts.topk_points(mesh, s[..., r::n].contiguous(), k)
            v0, g0 = stable_topk(s, k)
            same(v, v0, f"topk_points values k={k}")
            same(g, g0, f"topk_points ids k={k}")
    same(pts.sum_points(mesh, b[r::n].sum()), b.sum(), "sum_points")
    same(pts.any_points(mesh, torch.tensor([r == 1, False, True])),
         torch.tensor([n > 1, False, True]), "any_points")
    same(pts.broadcast(mesh, torch.full((2,), float(r)))[0], torch.zeros(2), "broadcast")
    # the map: empty (with its mesh), grown, cleared; a whole map split and back
    m = ms.empty_map(4, P, 8, mesh=mesh)
    assert m.P == P and m.P_local == P // n and m.mesh is mesh
    g = ms.grow_map(m, new_K=6, new_P=2 * P)
    assert g.P == 2 * P and g.P_local == 2 * P // n and g.mesh is mesh and g.K == 6
    assert ms.clear_map(g).mesh is mesh and ms.clear_map(g).P == 2 * P
    whole_m = ms.empty_map(4, P - 1, 8)                   # P - 1: not a multiple of n
    whole_m = whole_m.replace(mp_pos=torch.from_numpy(rng.randn(P - 1, 3).astype(np.float32)),
                              mp_valid=torch.from_numpy(rng.rand(P - 1) > 0.4))
    split = tmesh.shard_map_state(whole_m, mesh)
    assert split.P == -(-(P - 1) // n) * n
    same_map(split, ms.grow_map(whole_m, new_P=split.P), "shard_map_state round trip")
    grown = ms.grow_map(split, new_P=2 * split.P)
    same_map(grown, ms.grow_map(whole_m, new_P=2 * split.P), "grow_map")
    for bad in (lambda: ms.empty_map(4, P + 1, 8, mesh=mesh), lambda: ms.grow_map(m, new_P=P + 1)):
        if n > 1:
            try:
                bad()
            except ValueError:
                continue
            raise AssertionError("a point count that is not a multiple of the ranks was taken")
    return {"P_local": np.int32(m.P_local)}


# ---- the map functions ----------------------------------------------------


def rank_modules(d, out_dir) -> dict:
    """Each map function on the split map against the whole map's, on the
    map, frame and pose in in.npz (a System's state after the slice)."""
    from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as lm
    from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as lc
    from orb_slam2_annotate_tpu_torch.pipeline import policy
    from orb_slam2_annotate_tpu_torch.pipeline import tracking as tk
    from orb_slam2_annotate_tpu_torch.worldmap import merge
    from orb_slam2_annotate_tpu_torch.worldmap import vocabulary as voc

    mesh = tmesh.map_mesh()
    full = _whole_map(d)
    frame = convert.frame_from_numpy({k[2:]: v for k, v in d.items() if k.startswith("f_")},
                                     device="cpu")
    R, t, obs = (torch.from_numpy(d[k]) for k in ("R", "t", "obs"))
    slot, cand = int(d["slot"]), int(d["cand"])
    free = int(torch.argmin(full.kf_valid.to(torch.int32)))
    fs = tmesh.shard_map_state(full, mesh)
    assert fs.P == full.P and fs.P_local == full.P // mesh.size
    for k in ms.POINT_FIELDS:
        assert getattr(fs, k).shape[0] == full.P // mesh.size, k
    # tests/test_torch_pipeline.py's track_local_map and keyframe chain, on
    # the map as JAX holds it (tests/test_torch_shard_points.py compares them)
    a, b = (tk.track_local_map(CAM, x, frame, R, t, obs) for x in (fs, full))
    for k in ("R", "t", "obs", "n_inliers", "n_local_kf"):
        same(getattr(a, k), getattr(b, k), f"track_local_map {k}")
    for k in ("mp_visible", "mp_found"):
        same(pts.all_rows(mesh, getattr(a, k))[0], getattr(b, k), f"track_local_map {k}")
    out = {"tlm_" + k: getattr(a, k).numpy() for k in ("R", "t", "obs", "n_inliers", "n_local_kf")}
    out.update({"tlm_" + k: pts.all_rows(mesh, getattr(a, k))[0].numpy()
                for k in ("mp_visible", "mp_found")})
    sR, st, sobs = (torch.from_numpy(d[k]) for k in ("step_R", "step_t", "step_obs"))
    a, b = (lm.keyframe_chain(x, CAM, frame, free, sR, st, sobs, 14, 14 / 30.0,
                              do_kf_cull=False)[0] for x in (fs, full))
    same_map(a, b, "keyframe_chain (reference's stages)")
    out.update({"chain_" + k: v for k, v in convert.map_state_to_numpy(a).items()},
               chain_slot=np.int32(free))
    # the rest on the map cut to its first 2048 point slots, which hold
    # every point, so that the case stays short
    assert int(full.kf_obs.max()) < 2048
    m = full.replace(**{k: getattr(full, k)[:2048] for k in ms.POINT_FIELDS})
    s = tmesh.shard_map_state(m, mesh)
    col = lambda O: pts.all_rows(mesh, O.T.contiguous())[0].T        # [K, P_local] -> [K, P]
    rows = torch.tensor([slot, cand, 0])
    same(col(ms.observation_matrix(s)), ms.observation_matrix(m), "observation_matrix")
    same(ms.covisibility(s), ms.covisibility(m), "covisibility")
    same(ms.covis_rows(s, rows), ms.covis_rows(m, rows), "covis_rows")
    same(ms.covis_row(s, slot), ms.covis_row(m, slot), "covis_row")
    same(ms.spanning_tree_parents(s), ms.spanning_tree_parents(m), "spanning_tree_parents")
    ok = torch.tensor([True, False, True])
    same(pts.all_rows(mesh, ms.point_mask_rows(s, rows, ok))[0], ms.point_mask_rows(m, rows, ok),
         "point_mask_rows")
    for a, b in zip(pts.all_rows(mesh, *ms.observation_table(s)), ms.observation_table(m)):
        same(a, b, "observation_table")
    same(pts.all_rows(mesh, ms.mp_observation_counts(s))[0], ms.mp_observation_counts(m),
         "mp_observation_counts")
    same(torch.stack(ms.observation_overflow(s)), torch.stack(ms.observation_overflow(m)),
         "observation_overflow")
    same(ms.free_mp_slots(s, 300), ms.free_mp_slots(m, 300), "free_mp_slots")
    touched = torch.from_numpy(np.random.RandomState(3).rand(m.P) > 0.5)
    loc = touched[mesh.rank::mesh.size]
    same_map(ms.update_mappoint_stats_touched(s, loc, 64),
             ms.update_mappoint_stats_touched(m, touched, 64), "update_mappoint_stats_touched")
    same_map(ms.update_mappoint_stats(s), ms.update_mappoint_stats(m), "update_mappoint_stats")
    same_map(ms.update_mappoint_geometry(s), ms.update_mappoint_geometry(m),
             "update_mappoint_geometry")
    # tracking
    eye, zero = torch.eye(3), torch.zeros(3)
    for fn in (tk.track_frame, tk.track_frame_device):
        a, b = (fn(CAM, x, frame, frame, obs, R, t, eye, zero, True, slot) for x in (s, m))
        for k in ("R", "t", "obs", "n_pre", "n_local", "vel_R", "R_cr"):
            same(torch.as_tensor(getattr(a, k)), torch.as_tensor(getattr(b, k)),
                 f"{fn.__name__} {k}")
    vocab = voc.make_vocabulary(64, 3)
    bows = policy.keyframe_bows(vocab, m)
    a, b = (tk.relocalize_candidates(CAM, x, frame, vocab, bows,
                                     torch.Generator().manual_seed(5)) for x in (s, m))
    for k in ("best_slot", "best_score", "R", "t", "obs"):
        same(getattr(a, k), getattr(b, k), f"relocalize_candidates {k}")
    # the keyframe chain, every stage on (fuse, culls, local BA, stats in triangulation)
    a, b = (lm.keyframe_chain(x, CAM, frame, free, R, t, obs, 99, 3.3, do_fuse=True,
                              stats_in_triangulate=True) for x in (s, m))
    same_map(a[0], b[0], "keyframe_chain")
    for k in ("slots", "ok", "new_ref", "R_rel", "t_rel"):
        same(getattr(a[1], k), getattr(b[1], k), f"keyframe_chain cull {k}")
    a, b = (lm.cull_keyframes(x, slot, max_cull=4)[0] for x in (s, m))
    same_map(a, b, "cull_keyframes")
    a, b = (lm.create_depth_mappoints(x, CAM, slot, 3.0) for x in (s, m))
    same_map(a, b, "create_depth_mappoints")
    # loop closing's map functions
    s12, R12, t12 = torch.tensor(1.02), torch.eye(3), torch.tensor([0.01, -0.02, 0.0])
    same(lc.sim3_guided_match(CAM, s, slot, cand, s12, R12, t12),
         lc.sim3_guided_match(CAM, m, slot, cand, s12, R12, t12), "sim3_guided_match")
    for a, b in zip(lc.loop_projection_count(CAM, s, slot, cand, s12, R12, t12),
                    lc.loop_projection_count(CAM, m, slot, cand, s12, R12, t12)):
        same(a, b, "loop_projection_count")
    so = torch.ones(m.K) * 1.01
    Ro, to = m.kf_R.clone(), m.kf_t + 0.01
    same_map(lc.apply_loop_correction(s, so, Ro, to), lc.apply_loop_correction(m, so, Ro, to),
             "apply_loop_correction")
    a, b = (lc._seam_fuse(CAM, x, slot, cand) for x in (s, m))
    same_map(a[0], b[0], "_seam_fuse")
    same(a[1], b[1], "_seam_fuse over")
    gX = m.mp_pos + 0.003
    same_map(lc.fold_gba_device(s, m.kf_R, m.kf_t + 0.01, gX[mesh.rank::mesh.size], m.kf_valid,
                                s.mp_valid, m.kf_R, m.kf_t),
             lc.fold_gba_device(m, m.kf_R, m.kf_t + 0.01, gX, m.kf_valid, m.mp_valid, m.kf_R,
                                m.kf_t), "fold_gba_device")
    a, b = (lc.detect_loop_device(vocab, bows, x, slot) for x in (s, m))
    for k in ("db_bows", "cands", "ok", "cand_covis"):
        same(getattr(a, k), getattr(b, k), f"detect_loop_device {k}")
    # the merge: the map into a copy of itself with its keyframes moved up
    b_map = m.replace(n_kf=m.n_kf.clone())
    a_res = merge.merge_maps(s, b_map, CAM, vocab)
    b_res = merge.merge_maps(m, b_map, CAM, vocab)
    assert a_res.success == b_res.success and a_res.map.n_shards == mesh.size
    same_map(a_res.map, b_res.map, "merge_maps")
    return {"covis": ms.covisibility(s).numpy(), **out}


# ---- the System and the FreeRunner ----------------------------------------


def rank_system(d, out_dir) -> dict:
    """The System with shard_points=True: synchronous (saving its map) and
    pipelined."""
    from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

    spec = _spec(d)
    n = spec.get("n_frames", 14)
    mesh = tmesh.map_mesh()
    cfg = mono_slice_config(**SIZES, shard_points=True)
    traj, m, slam = run_system(cfg, n, save=os.path.join(out_dir, f"map_w{mesh.size}.npz"))
    assert slam.map.mesh == mesh and slam.map.P_local == slam.map.P // mesh.size
    out = {"traj": traj, **{"m_" + k: v for k, v in m.items()},
           "local_rows": np.array([getattr(slam.map, k).shape[0] for k in ms.POINT_FIELDS]),
           **{"kf_" + k: v for k, v in _kf_fields(slam.map).items()}}
    traj2, m2, _ = run_system(mono_slice_config(**SIZES, shard_points=True, async_depth=2), n)
    out.update({"async_traj": traj2, **{"async_m_" + k: v for k, v in m2.items()}})
    return out


def rank_load(d, out_dir) -> dict:
    """A map file (in.npz's spec "load") loaded into a split System."""
    from orb_slam2_annotate_tpu_torch.pipeline import System, mono_slice_config

    loaded = System(CAM, mono_slice_config(**SIZES, shard_points=True), device="cpu")
    loaded.load_map(_spec(d)["load"])
    assert loaded.map.mesh == tmesh.map_mesh() and loaded.state == "LOST"
    return {"load_m_" + k: v for k, v in convert.map_state_to_numpy(loaded.map).items()}


def _kf_fields(m) -> dict:
    """The replicated fields of a map (its keyframes and counter)."""
    return {f.name: getattr(m, f.name).numpy() for f in dataclasses.fields(m)
            if not f.name.startswith("mp_")}


def rank_depth(d, out_dir) -> dict:
    """The depth cells (in.npz's spec "kinds") with shard_points=True."""
    out = {}
    for kind in _spec(d)["kinds"]:
        traj, m, live = run_depth(kind, shard=True)
        assert live.mesh == tmesh.map_mesh() and live.P_local == live.P // live.mesh.size
        out.update({f"{kind}_traj": traj, **{f"{kind}_m_" + k: v for k, v in m.items()},
                    **{f"{kind}_kf_" + k: v for k, v in _kf_fields(live).items()}})
    return out


def rank_free(d, out_dir) -> dict:
    from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig

    spec = _spec(d)
    traj, m = run_free(SlamConfig(**spec["cfg"], shard_points=True), spec.get("n_frames", 14))
    return {"traj": traj, **{"m_" + k: v for k, v in m.items()}}


# ---- the global BA on the live shards --------------------------------------


def rank_gba(d, out_dir) -> dict:
    """LoopCloser._dispatch_global_ba on the map in in.npz: split with the
    distributed BA on the live shards, replicated with its host re-layout,
    and split with the matrix-free BA on the whole map; each then folded."""
    from orb_slam2_annotate_tpu_torch.pipeline.loop_closing import LoopCloser, LoopCloserConfig

    mesh = tmesh.map_mesh()
    m = _whole_map(d)
    iters, anchor = int(d["iters"]), int(d["anchor"])
    out = {}
    for name, mm, dist_gba in (("live", tmesh.shard_map_state(m, mesh), True),
                               ("relayout", m, True),
                               ("cg", tmesh.shard_map_state(m, mesh), False)):
        lcl = LoopCloser(CAM, m.K, LoopCloserConfig(n_words=64, global_ba_iters=iters,
                                                    use_dist_gba=dist_gba), device="cpu")
        lcl._dispatch_global_ba(mm, anchor=anchor)
        g = lcl._gba_pending
        X = g["X"] if mm.mesh is None else pts.all_rows(mesh, g["X"])[0]
        out.update({f"{name}_R": g["R"].numpy(), f"{name}_t": g["t"].numpy(),
                    f"{name}_X": X.numpy(), f"{name}_cost": g["cost"].numpy()})
        folded = lcl.maybe_fold_gba(mm, force=True)
        out.update({f"{name}_fold_" + k: v
                    for k, v in convert.map_state_to_numpy(folded).items()})
    return out

