"""Relocalization, the keyframe database and keyframe culling of the port
against the JAX package, on a kidnapped monocular run: PlaneScene seed 1 at
320x240 (512 features, 4 levels), a 64-frame sweep of
``orbit_trajectory(step=0.06)``, then a jump back to frame 4 and three frames
from there.  The reference System runs with its defaults minus loop closing
(relocalization and keyframe culling on); its state right before the jump
is handed to the port through convert.py.

Tolerances: covisibility, spanning-tree parents, overflow counts, loop
candidates, culled slots, kf_valid / kf_obs and replacement slots are
exactly equal; BoW rows within 1e-6; CullInfo poses within 1e-5 (products
of two stored rotations).  relocalize_candidates draws its PnP minimal sets
from a torch.Generator, so it is compared by outcome: the same winning slot,
inlier counts within 3% and the pose within 1e-3.  The whole-system run:
both relocalize at the jump and end OK, and the port's Sim3-aligned ATE is
<= max(1.5 x ATE_jax, ATE_jax + 0.01 m) and < 0.08 m
(test_torch_system.py's bound).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation as jeval
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu.pipeline import frame as jfr
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.pipeline import system as jsys
from orb_slam2_annotate_tpu.pipeline import tracking as jtk
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert, kernels
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config
from orb_slam2_annotate_tpu_torch.pipeline import system as tsys
from orb_slam2_annotate_tpu_torch.pipeline import tracking as ttk
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=8,
             init_min_matches=60)
N_SWEEP, JUMP = 64, 4
SEQ = list(range(N_SWEEP)) + [JUMP, JUMP + 1, JUMP + 2, JUMP + 3]


def nd(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def T(a):
    return torch.from_numpy(np.array(a))


def count_relocalizations(slam):
    """Wrap the instance's _try_relocalize to record its results."""
    hits = []
    orig = slam._try_relocalize

    def wrapped(frame):
        ok = orig(frame)
        hits.append(ok)
        return ok

    slam._try_relocalize = wrapped
    return hits


def run(slam, images):
    hits = count_relocalizations(slam)
    poses = [slam.track_mono(img, k / 30.0) for k, img in enumerate(images)]
    return poses, hits


def ate(slam, gt_poses):
    traj = dict(slam.frame_trajectory())
    ids = [k for k, Tcw in traj.items() if Tcw is not None]
    est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt = np.stack([-gt_poses[SEQ[k]][0].T @ gt_poses[SEQ[k]][1] for k in ids])
    return jeval.ate_rmse(est, gt, with_scale=True)[0], len(ids)


@pytest.fixture(scope="module")
def kidnap():
    """The reference System's whole kidnapped run, with its state (as numpy)
    right before the jump frame."""
    scene = synthetic.PlaneScene(seed=1)
    gt = synthetic.orbit_trajectory(N_SWEEP, step=0.06)
    images = [scene.render(CAM, *gt[f], h=240, w=320)[0] for f in SEQ]
    slam = System(CAM, SlamConfig(enable_loop_closing=False, **SIZES))
    hits = count_relocalizations(slam)
    poses = []
    for k, img in enumerate(images):
        if k == N_SWEEP:
            before = dict(map=nd(slam.map), bows=np.asarray(slam.loop_closer.db.bows),
                          frame=nd(jfr.make_frame_mono(jnp.asarray(img), CAM,
                                                       slam.cfg.extractor)),
                          frame_id=slam.frame_id + 1, kf_valid=slam._kf_valid_host.copy())
        poses.append(slam.track_mono(img, k / 30.0))
    return dict(slam=slam, poses=poses, hits=hits, gt=gt, images=images, before=before,
                vocab=slam.loop_closer.vocab)


def jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_reference_relocalizes(kidnap):
    assert True in kidnap["hits"] and kidnap["poses"][N_SWEEP] is not None
    assert kidnap["slam"].state == "OK"
    assert kidnap["before"]["kf_valid"].sum() > 8     # culling was armed


def test_covisibility_and_spanning_tree(kidnap):
    d = kidnap["before"]["map"]
    m_j, m_t = jmap(d), convert.map_state_from_numpy(d, device="cpu")
    W = np.asarray(jms.covisibility(m_j))
    np.testing.assert_array_equal(tms.covisibility(m_t).numpy(), W)
    assert W.max() > 100
    np.testing.assert_array_equal(tms.spanning_tree_parents(m_t).numpy(),
                                  np.asarray(jms.spanning_tree_parents(m_j)))
    assert (tms.spanning_tree_parents(m_t) >= 0).sum() >= 8
    got = tms.observation_overflow(m_t)
    ref = jms.observation_overflow(m_j)
    assert (int(got[0]), int(got[1])) == (int(ref[0]), int(ref[1]))


def test_detect_loop_device(kidnap):
    d = kidnap["before"]["map"]
    slot = int(np.argmax(np.where(d["kf_valid"], d["kf_frame_id"], -1)))
    bows = kidnap["before"]["bows"]
    ref = jlc.detect_loop_device(kidnap["vocab"], jnp.asarray(bows), jmap(d), slot, 3)
    vocab = convert.vocabulary_from_numpy(nd(kidnap["vocab"]), device="cpu")
    got = tlc.detect_loop_device(vocab, T(bows),
                                 convert.map_state_from_numpy(d, device="cpu"), slot, 3)
    np.testing.assert_allclose(got.db_bows.numpy(), np.asarray(ref.db_bows), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.cands.numpy(), np.asarray(ref.cands))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.cand_covis.numpy(), np.asarray(ref.cand_covis))


def test_relocalize_candidates(kidnap):
    b = kidnap["before"]
    ref = jtk.relocalize_candidates(CAM, jmap(b["map"]), jfr.Frame(**b["frame"]), kidnap["vocab"],
                                    jnp.asarray(b["bows"]), jax.random.PRNGKey(b["frame_id"]))
    got = ttk.relocalize_candidates(TCAM, convert.map_state_from_numpy(b["map"], device="cpu"),
                                    convert.frame_from_numpy(b["frame"], device="cpu"),
                                    convert.vocabulary_from_numpy(nd(kidnap["vocab"]), "cpu"),
                                    T(b["bows"]), torch.Generator().manual_seed(b["frame_id"]))
    assert int(ref.best_slot) >= 0
    assert int(got.best_slot) == int(ref.best_slot)
    assert abs(int(got.best_score) - int(ref.best_score)) <= 0.03 * int(ref.best_score)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(ref.obs))


@pytest.fixture(scope="module")
def redundant_map(kidnap):
    """The pre-jump map with one keyframe row copied into three free slots:
    every point of that keyframe (and of each copy) is then seen by 3 other
    keyframes at its own scale, so culling must drop them."""
    d = {k: v.copy() for k, v in kidnap["before"]["map"].items()}
    fid = np.where(d["kf_valid"], d["kf_frame_id"], -1)
    order = np.argsort(-fid, kind="stable")
    protect, original = int(order[0]), int(order[4])
    free = np.flatnonzero(~d["kf_valid"])[:3]
    for k in d:
        if k.startswith("kf_"):
            d[k][free] = d[k][original]
    return d, protect, original, free


@pytest.mark.parametrize("update_stats", [False, True])
def test_cull_keyframes(redundant_map, update_stats):
    d, protect, original, free = redundant_map
    ref_m, ref_i = jlm.cull_keyframes(jmap(d), jnp.asarray(protect), update_stats=update_stats)
    got_m, got_i = tlm.cull_keyframes(convert.map_state_from_numpy(d, device="cpu"), protect,
                                      update_stats=update_stats)
    ref_i = nd(ref_i)
    assert ref_i["ok"].sum() >= 2 and original in ref_i["slots"][ref_i["ok"]]
    got = convert.cull_info_to_numpy(got_i)
    for k in ("slots", "ok", "new_ref"):
        np.testing.assert_array_equal(got[k], ref_i[k], err_msg=k)
    for k in ("R_rel", "t_rel"):
        np.testing.assert_allclose(got[k], ref_i[k], atol=1e-5, err_msg=k)
    g = convert.map_state_to_numpy(got_m)
    for k, v in nd(ref_m).items():
        if np.issubdtype(v.dtype, np.floating):
            fin = np.isfinite(v)
            np.testing.assert_array_equal(np.isfinite(g[k]), fin, err_msg=k)
            np.testing.assert_allclose(g[k][fin], v[fin], atol=1e-4, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], v, err_msg=k)


def test_cull_info_reparents_records(redundant_map):
    d, protect, _, _ = redundant_map
    _, info = jlm.cull_keyframes(jmap(d), jnp.asarray(protect), update_stats=False)
    info = nd(info)
    ok = info["ok"]
    rng = np.random.RandomState(5)
    refs = list(info["slots"][ok]) + [protect, protect]
    rec_args = [(k, k / 30.0, int(s), rng.randn(3, 3).astype(np.float32),
                 rng.randn(3).astype(np.float32), k == 3) for k, s in enumerate(refs)]
    holder_j = types.SimpleNamespace(records=[jsys.FrameRecord(*a) for a in rec_args])
    holder_t = types.SimpleNamespace(records=[tsys.FrameRecord(*a) for a in rec_args])
    args = (info["slots"][ok], info["new_ref"][ok], info["R_rel"][ok], info["t_rel"][ok])
    System._reparent_records(holder_j, *args)
    t_info = convert.cull_info_from_numpy(info, device="cpu")
    tok = t_info.ok.numpy()
    TSystem._reparent_records(holder_t, t_info.slots.numpy()[tok], t_info.new_ref.numpy()[tok],
                              t_info.R_rel.numpy()[tok], t_info.t_rel.numpy()[tok])
    for a, b, (_, _, slot, R_cr, _, lost) in zip(holder_t.records, holder_j.records, rec_args):
        assert dataclasses.astuple(a)[:3] == dataclasses.astuple(b)[:3]
        np.testing.assert_allclose(a.R_cr, b.R_cr, atol=1e-6)
        np.testing.assert_allclose(a.t_cr, b.t_cr, atol=1e-6)
        # lost records keep their slot; the others leave the culled slots
        assert (a.ref_kf_slot == slot) if lost else (a.ref_kf_slot not in info["slots"][ok])
        assert lost or slot == protect or not np.array_equal(a.R_cr, R_cr)


def test_kidnapped_run_matches_jax_system(kidnap):
    port = TSystem(TCAM, mono_slice_config(**SIZES), device="cpu")
    for w in kernels.WRAPPERS:
        w.launches = 0
    poses, hits = run(port, kidnap["images"])
    assert True in hits and poses[N_SWEEP] is not None, "the port did not relocalize at the jump"
    assert port.state == "OK" and kidnap["slam"].state == "OK"
    ate_j, n_j = ate(kidnap["slam"], kidnap["gt"])
    ate_t, n_t = ate(port, kidnap["gt"])
    assert n_t >= 0.7 * len(SEQ), f"port tracked {n_t}/{len(SEQ)} (reference {n_j})"
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_t, ate_j)
    assert ate_t < 0.08
    assert all(w.launches == 0 for w in kernels.WRAPPERS)    # CPU tensors: plain twins
