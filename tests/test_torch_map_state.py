"""Parity of the port's map state functions with worldmap/map_state.py on a
real map: the JAX System's state after 14 frames of the slice (PlaneScene
seed 1, 320x240, 512 features, 4 levels), handed to the port through
convert.py.

Tolerances: every integer, bool and descriptor field is exactly equal;
float fields agree within 1e-4 (they only rearrange data or take short
sums of the same values).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
SLICE = dict(enable_loop_closing=False, enable_relocalization=False, enable_kf_culling=False,
             enable_fuse=False, async_depth=0, shard_points=False)


def jax_map_dict(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def assert_map_equal(m_t, m_j, atol=1e-4, fields=None):
    got = convert.map_state_to_numpy(m_t)
    ref = jax_map_dict(m_j)
    for k in fields or ref:
        if np.issubdtype(ref[k].dtype, np.floating):
            finite = np.isfinite(ref[k])
            np.testing.assert_array_equal(np.isfinite(got[k]), finite, err_msg=k)
            np.testing.assert_allclose(got[k][finite], ref[k][finite], atol=atol, rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def jmap():
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=16, max_mp=2048, max_frames_between_kf=4,
                     init_min_matches=60, **SLICE)
    slam = System(CAM, cfg)
    scene = synthetic.PlaneScene(seed=1)
    for k, (R, t) in enumerate(synthetic.orbit_trajectory(14, step=0.06)):
        slam.track_mono(scene.render(CAM, R, t, h=240, w=320)[0], k / 30.0)
    assert slam.state == "OK" and slam.n_keyframes >= 3
    return slam.map


@pytest.fixture
def tmap(jmap):
    return convert.map_state_from_numpy(jax_map_dict(jmap), device="cpu")


def test_convert_round_trip_and_empty(jmap, tmap):
    assert_map_equal(tmap, jmap, atol=0.0)
    assert_map_equal(tms.empty_map(8, 64, 32), jms.empty_map(8, 64, 32), atol=0.0)
    assert_map_equal(tms.grow_map(tmap, new_K=24, new_P=4096),
                     jms.grow_map(jmap, new_K=24, new_P=4096), atol=0.0)


def test_insert_keyframe(jmap, tmap):
    rng = np.random.RandomState(0)
    N = jmap.N
    args = dict(R=np.eye(3, dtype=np.float32), t=rng.randn(3).astype(np.float32),
                xy=rng.rand(N, 2).astype(np.float32), ur=np.full(N, -1.0, np.float32),
                depth=np.zeros(N, np.float32), octave=rng.randint(0, 4, N).astype(np.int32),
                angle=rng.rand(N).astype(np.float32),
                desc=rng.randint(0, 2**32, (N, 16), dtype=np.uint64).astype(np.uint32),
                feat_valid=rng.rand(N) < 0.9, obs=rng.randint(-1, 2048, N).astype(np.int32))
    slot = int(np.argmin(np.asarray(jmap.kf_valid)))
    ref = jms.insert_keyframe(jmap, jnp.asarray(slot), args["R"], args["t"], 99, 3.3, args["xy"],
                              args["ur"], args["depth"], args["octave"], args["angle"],
                              args["desc"], args["feat_valid"], args["obs"])
    targs = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
             for k, v in args.items()}
    got = tms.insert_keyframe(tmap, slot, targs["R"], targs["t"], 99, 3.3, targs["xy"], targs["ur"],
                              targs["depth"], targs["octave"], targs["angle"], targs["desc"],
                              targs["feat_valid"], targs["obs"])
    assert_map_equal(got, ref, atol=0.0)


def test_slots_masks_covisibility(jmap, tmap):
    np.testing.assert_array_equal(tms.free_mp_slots(tmap, 512).numpy(),
                                  np.asarray(jms.free_mp_slots(jmap, 512)))
    rows = np.array([1, 0, 3, 2, 15], np.int32)
    ok = np.array([True, True, False, True, True])
    np.testing.assert_array_equal(
        tms.point_mask_rows(tmap, torch.from_numpy(rows), torch.from_numpy(ok)).numpy(),
        np.asarray(jms.point_mask_rows(jmap, jnp.asarray(rows), jnp.asarray(ok))))
    np.testing.assert_array_equal(
        tms.covis_rows(tmap, torch.from_numpy(rows), torch.from_numpy(ok)).numpy(),
        np.asarray(jms.covis_rows(jmap, jnp.asarray(rows), jnp.asarray(ok))))
    for slot in (0, 1, 2):
        np.testing.assert_array_equal(tms.covis_row(tmap, slot).numpy(),
                                      np.asarray(jms.covis_row(jmap, slot)))
    np.testing.assert_array_equal(tms.observation_matrix(tmap).numpy(),
                                  np.asarray(jms.observation_matrix(jmap)))
    np.testing.assert_array_equal(tms.mp_observation_counts(tmap).numpy(),
                                  np.asarray(jms.mp_observation_counts(jmap)))


def test_observation_table(jmap, tmap):
    for a, b in zip(tms.observation_table(tmap), jms.observation_table(jmap)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_duplicate_observations_collapse(jmap, tmap):
    """Two features of one keyframe observing the same point: the table keeps
    the lowest feature index, the counts keep one keyframe."""
    obs = np.asarray(jmap.kf_obs).copy()
    k = 1
    i, j = np.flatnonzero(obs[k] >= 0)[:2]
    obs[k, j] = obs[k, i]
    jm2 = jmap._replace(kf_obs=jnp.asarray(obs))
    tm2 = dataclasses.replace(tmap, kf_obs=torch.from_numpy(obs))
    for a, b in zip(tms.observation_table(tm2), jms.observation_table(jm2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tms.mp_observation_counts(tm2).numpy(),
                                  np.asarray(jms.mp_observation_counts(jm2)))


def test_stats_refresh(jmap, tmap):
    assert_map_equal(tms.update_mappoint_stats(tmap), jms.update_mappoint_stats(jmap))
    touched = np.asarray(jmap.mp_valid) & (np.arange(jmap.P) % 3 == 0)
    assert_map_equal(tms.update_mappoint_stats_touched(tmap, torch.from_numpy(touched)),
                     jms.update_mappoint_stats_touched(jmap, jnp.asarray(touched)))
    assert_map_equal(tms.update_mappoint_stats_touched(tmap, torch.from_numpy(touched), 100),
                     jms.update_mappoint_stats_touched(jmap, jnp.asarray(touched), 100))
