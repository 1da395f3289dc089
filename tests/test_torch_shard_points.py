"""The live map's point axis split over ranks (``shard_points=True`` at a world
above one; parallel/points.py), on the CPU: ranks are processes of a gloo
group (tests/_torch_dist_worker.py, cases in tests/_torch_shard_cases.py),
the JAX side the 8 virtual CPU devices of tests/conftest.py.

Held exactly (bit for bit): the primitives against their plain ops at worlds
2 and 3; every map function on the split map against the whole map's (the
ranks check it); the System's slice (tests/test_torch_system.py's 14
frames), its pipelined run (async_depth 2) and the FreeRunner at a world of
two against a world of one, with both ranks' keyframe state equal; the map
files written at either world (their arrays), each loaded at the other;
loop closing's matrix-free global BA on a split map against a world of one.
The distributed global BA on the live shards equals the host re-layout
branch bit for bit, and is held to a world of one within DIST_FULL_TOL (the
returned cost within 1e-5 relative; chip_smoke.py): its state is a float32
draw of the two ranks' sums (up to 4.8e-3 m from a world of one's on this
map, as for the re-layout branch).
Against JAX's own sharded run: track_local_map and keyframe_chain at
tests/test_torch_pipeline.py's tolerances, the System's tracked count equal
and its ATE within max(0.2 x, 0.003 m) (tests/test_dist_ba.py), and the
pipelined run at tests/test_torch_async.py's ATE bound against the
synchronous one.  Every group has 60 s timeouts and every rank a 120 s limit.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation as jeval
from orb_slam2_annotate_tpu.io import synthetic as jsyn
from orb_slam2_annotate_tpu.parallel import mesh as jmesh
from orb_slam2_annotate_tpu.pipeline import SlamConfig as JSlamConfig
from orb_slam2_annotate_tpu.pipeline import System as JSystem
from orb_slam2_annotate_tpu.pipeline import frame as jfr
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu.pipeline import tracking as jtk
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.io import checkpoint
from orb_slam2_annotate_tpu_torch.parallel import dist_ba as tdist
from orb_slam2_annotate_tpu_torch.parallel import mesh as tmesh
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig, mono_slice_config
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc

import _torch_shard_cases as cases
from test_torch_dist_ba import loop_map

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
CAM = CameraModel.create(**cases.ARGS)
DIST_FULL_TOL = 1e-5
GBA_ITERS = 5
FREE_KW = dict(n_features=512, n_levels=4, max_kf=32, max_mp=8192, max_frames_between_kf=6,
               init_min_matches=60, enable_loop_closing=False)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(mode, out_dir, inputs, world=2):
    """Start `mode` of the worker on `world` gloo ranks (it runs while the
    test computes its side); `wait_ranks` collects it."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "in.npz"), **inputs)
    return launch_ranks(mode, out_dir, world)


def launch_ranks(mode, out_dir, world):
    """Start the ranks of `mode` on DIR/in.npz at a free port."""
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), port,
                               str(out_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
             for r in range(world)]
    return mode, out_dir, procs


def run_ranks(mode, out_dir, inputs, world=2):
    """Run `mode` of the worker on `world` gloo ranks; their outputs."""
    return wait_ranks(start_ranks(mode, out_dir, inputs, world))


def wait_ranks(started, retry=True):
    """The outputs of started ranks, each given 120 s."""
    mode, out_dir, procs = started
    world = len(procs)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank of {mode!r} did not finish in 120 s")
    if retry and any(p.returncode != 0 and "EADDRINUSE" in log for p, log in zip(procs, logs)):
        # the port was taken (by another group's sockets) between its pick
        # and rank 0's bind: the same group again on another port
        return wait_ranks(launch_ranks(mode, out_dir, world), retry=False)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {mode!r} failed:\n{log[-3000:]}"
    return [dict(np.load(os.path.join(out_dir, f"out{r}.npz"))) for r in range(world)]


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(cases.bits(a), cases.bits(b), err_msg=what)


def assert_same_map(got: dict, ref: dict, prefix="m_"):
    for k, v in ref.items():
        assert_same(got[prefix + k], v, k)


def ate(traj, poses):
    ok = np.isfinite(traj[:, 0, 0])
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in traj[ok]])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in np.nonzero(ok)[0]])
    return jeval.ate_rmse(est, gt, with_scale=True)[0], int(ok.sum())


@pytest.mark.parametrize("world", [2, 3])
def test_primitives(world, tmp_path):
    outs = run_ranks("prims", tmp_path, {}, world)
    assert [int(o["P_local"]) for o in outs] == [60 // world] * world


# ---- the System slice ------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The rank groups that need nothing from this process, started with the
    module so that they run while it computes: the System, the FreeRunner
    and the global BA at a world of two."""
    m = loop_map()
    gba_in = {"iters": np.int32(GBA_ITERS), "anchor": np.int32(0),
              **{"m_" + k: v for k, v in convert.map_state_to_numpy(m).items()}}
    return dict(system=start_ranks("system", tmp_path_factory.mktemp("world_two"), {}),
                free=start_ranks("free", tmp_path_factory.mktemp("free"),
                                 {"spec": json.dumps({"cfg": FREE_KW})}),
                gba=start_ranks("gba", tmp_path_factory.mktemp("gba"), gba_in), loop_map=m)


@pytest.fixture(scope="module")
def world_one(started, tmp_path_factory):
    """The port's System slice at a world of one (synchronous, saving its
    map, and pipelined)."""
    d = tmp_path_factory.mktemp("world_one")
    path = str(d / "map_w1.npz")
    traj, m, _ = cases.run_system(mono_slice_config(**cases.SIZES), save=path)
    traj2, m2, _ = cases.run_system(mono_slice_config(**cases.SIZES, async_depth=2))
    return dict(traj=traj, m=m, path=path, async_traj=traj2, async_m=m2)


@pytest.fixture(scope="module")
def world_two(started, world_one, tmp_path_factory):
    """The System slice at a world of two, and the world-one map file loaded
    at a world of two."""
    load = start_ranks("load", tmp_path_factory.mktemp("load"),
                       {"spec": json.dumps({"load": world_one["path"]})})
    outs = wait_ranks(started["system"])
    return outs, os.path.join(started["system"][1], "map_w2.npz"), wait_ranks(load)


def test_system_world_two_equals_world_one(world_one, world_two):
    outs = world_two[0]
    assert np.isfinite(world_one["traj"][:, 0, 0]).sum() >= 3
    for o in outs:
        assert_same(o["traj"], world_one["traj"], "trajectory")
        assert_same_map(o, world_one["m"])
        # each rank holds P / 2 rows of every point field
        assert list(o["local_rows"]) == [cases.SIZES["max_mp"] // 2] * len(o["local_rows"])
    # the replicated state is the same on both ranks
    for k in outs[0]:
        if k.startswith("kf_"):
            assert_same(outs[1][k], outs[0][k], k)


def test_system_pipelined_world_two(world_one, world_two):
    outs = world_two[0]
    poses = jsyn.orbit_trajectory(14, step=0.06)
    for o in outs:
        assert_same(o["async_traj"], world_one["async_traj"], "pipelined trajectory")
        assert_same_map(o, world_one["async_m"], prefix="async_m_")
    # against the synchronous split run, as tests/test_torch_async.py holds them
    ate_a, n_a = ate(outs[0]["async_traj"], poses)
    ate_s, n_s = ate(outs[0]["traj"], poses)
    assert n_a >= 3 and ate_a <= max(1.5 * ate_s, ate_s + 0.01), (ate_a, ate_s)


def test_save_and_load_map_across_world_sizes(world_one, world_two):
    _, path2, loaded = world_two
    # the files of both worlds hold the same arrays, byte for byte (their zip
    # entries' dates differ)
    with np.load(world_one["path"]) as z1, np.load(path2) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        for k in z1.files:
            assert z1[k].tobytes() == z2[k].tobytes(), k
    # the world-one file loaded at a world of two, and the world-two file at one
    for o in loaded:
        assert_same_map(o, world_one["m"], prefix="load_m_")
    m, extra = checkpoint.load_map(path2, "cpu")
    assert_same_map({"m_" + k: v for k, v in convert.map_state_to_numpy(m).items()},
                    world_one["m"])


def test_free_runner_world_two_equals_world_one(started):
    traj, m = cases.run_free(SlamConfig(**FREE_KW))
    outs = wait_ranks(started["free"])
    assert np.isfinite(traj[:, 0, 0]).sum() >= 3
    for o in outs:
        assert_same(o["traj"], traj, "trajectory")
        assert_same_map(o, m)


# ---- the map functions and JAX's sharded run ------------------------------


@pytest.fixture(scope="module")
def jax_state():
    """The JAX System with shard_points=True (its map's point axis on the
    8-device mesh) after the slice's 14 frames, the next frame, and the
    tracking inputs the cases below start from."""
    cfg = JSlamConfig(**cases.SIZES, enable_loop_closing=False, shard_points=True, seed=0)
    slam = JSystem(CAM, cfg)
    images = cases.frames(15)
    for k, img in enumerate(images[:14]):
        slam.track_mono(img, k / 30.0)
    assert slam.state == "OK" and slam.vel is not None
    frame = jfr.make_frame_mono(jnp.asarray(images[14]), CAM, cfg.extractor)
    R1, t1, obs1, _ = jtk.track_with_motion_model(CAM, slam.map, frame, slam.last_frame,
                                                   slam.last_obs, slam.R, slam.t, th=30.0)
    step = jtk.track_frame(CAM, slam.map, frame, slam.last_frame, slam.last_obs, slam.R, slam.t,
                           slam.vel[0], slam.vel[1], jnp.asarray(True),
                           jnp.asarray(slam.ref_kf, jnp.int32))
    nd = lambda x: {k: np.asarray(v) for k, v in x._asdict().items()}
    return dict(slam=slam, frame=frame, m=nd(slam.map), f=nd(frame), R=np.asarray(R1),
                t=np.asarray(t1), obs=np.asarray(obs1), step=step,
                traj=cases.traj_array(slam.frame_trajectory()))


@pytest.fixture(scope="module")
def modules_started(jax_state, tmp_path_factory):
    s = jax_state
    step = s["step"]
    ins = {**{"m_" + k: v for k, v in s["m"].items()}, **{"f_" + k: v for k, v in s["f"].items()},
           "R": s["R"], "t": s["t"], "obs": s["obs"], "slot": np.int32(s["slam"].ref_kf),
           "cand": np.int32(0), "step_R": np.asarray(step.R), "step_t": np.asarray(step.t),
           "step_obs": np.asarray(step.obs)}
    return start_ranks("modules", tmp_path_factory.mktemp("modules"), ins)


@pytest.fixture(scope="module")
def jax_refs(jax_state, modules_started):
    """track_local_map and keyframe_chain on JAX's map placed on its 8-device
    mesh (computed while the ranks run)."""
    s = jax_state
    step = s["step"]
    m_sh = jmesh.shard_map_state(s["slam"].map, jmesh.map_mesh())
    assert len(m_sh.mp_pos.sharding.device_set) == len(jax.devices()) == 8
    tlm = jtk.track_local_map(CAM, m_sh, s["frame"], jnp.asarray(s["R"]), jnp.asarray(s["t"]),
                              jnp.asarray(s["obs"]))
    chain, slot, _ = jlm.keyframe_chain(m_sh, CAM, s["frame"], step.R, step.t, step.obs, 14,
                                        14 / 30.0, 0.0, has_depth=False, do_cull_recent=True,
                                        stats_in_triangulate=False, do_fuse=False,
                                        do_local_ba=True, do_kf_cull=False)
    return tlm, chain, int(slot)


@pytest.fixture(scope="module")
def modules(modules_started, jax_refs):
    return wait_ranks(modules_started)


def test_map_functions_world_two(modules):
    # the ranks checked every map function against the whole map's; both
    # saw the same covisibility
    assert modules[0]["covis"].sum() > 0
    assert_same(modules[1]["covis"], modules[0]["covis"])


def test_track_local_map_against_jax_sharded(jax_refs, modules):
    ref = jax_refs[0]
    got = modules[0]
    assert int(got["tlm_n_inliers"]) == int(ref.n_inliers) > 30
    assert int(got["tlm_n_local_kf"]) == int(ref.n_local_kf)
    np.testing.assert_allclose(got["tlm_R"], np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got["tlm_t"], np.asarray(ref.t), atol=1e-4)
    for k in ("obs", "mp_visible", "mp_found"):
        np.testing.assert_array_equal(got["tlm_" + k], np.asarray(getattr(ref, k)), err_msg=k)


def test_keyframe_chain_against_jax_sharded(jax_refs, modules):
    from test_torch_pipeline import STATS, assert_ba_map

    _, ref, slot = jax_refs
    got = modules[0]
    assert int(got["chain_slot"]) == slot
    m = convert.map_state_from_numpy({k[6:]: v for k, v in got.items() if k.startswith("chain_")
                                      and k != "chain_slot"}, device="cpu")
    assert_ba_map(m, ref, slot, skip=STATS)


def test_system_against_jax_sharded(jax_state, world_two):
    outs = world_two[0]
    poses = jsyn.orbit_trajectory(14, step=0.06)
    ate_j, n_j = ate(jax_state["traj"], poses)
    ate_t, n_t = ate(outs[0]["traj"], poses)
    assert n_t == n_j >= 3
    assert abs(ate_t - ate_j) < max(0.2 * ate_j, 0.003), (ate_t, ate_j)


# ---- the global BA on the live shards --------------------------------------


@pytest.fixture(scope="module")
def gba(started):
    return started["loop_map"], GBA_ITERS, wait_ranks(started["gba"])


def test_global_ba_live_shards_against_host_relayout(gba):
    # the distributed BA on the live shards is the host re-layout branch's,
    # bit for bit: the same blocks, edges in another order but the same sums
    m, _, outs = gba
    for o in outs:
        for k in ("R", "t", "X", "cost"):
            assert_same(o["live_" + k], o["relayout_" + k], k)
        for k in convert.map_state_to_numpy(m):
            assert_same(o["live_fold_" + k], o["relayout_fold_" + k], k)
        assert not np.array_equal(o["live_fold_mp_pos"], m.mp_pos.numpy())
    for k in outs[0]:
        if k != "rank":
            assert_same(outs[1][k], outs[0][k], k)


def test_global_ba_live_shards_bit_for_bit_one_process_over_their_blocks(gba):
    # one process given both ranks' live blocks (each rank's map built from
    # the whole map) sums what the ranks sum in their order: their bits
    m, iters, outs = gba
    blocks = [tlc.full_map_ba_problem(tmesh.shard_map_state(m, tmesh.Mesh(None, 2, r)), 0)
              for r in range(2)]
    R, t, Xs, cost = tdist.make_distributed_ba(tmesh.Mesh(None, 1, 0), iters=iters, live=True,
                                               shards=2)(cases.CAM, blocks)
    X = torch.stack(Xs, 1).reshape(-1, 3)       # point g on block g % 2 at row g // 2
    for o in outs:
        for k, v in (("R", R), ("t", t), ("X", X), ("cost", cost)):
            assert_same(o["live_" + k], v.numpy(), k)


def test_global_ba_live_shards_against_world_one(gba):
    m, iters, outs = gba
    step = tdist.make_distributed_ba(tmesh.Mesh(None, 1, 0), iters=iters)
    _, _, _, cost = step(cases.CAM, tdist.shard_ba_problem(tlc.full_map_ba_problem(m, 0), 1))
    got = float(outs[0]["live_cost"])
    assert abs(got - float(cost)) <= DIST_FULL_TOL * float(cost), (got, float(cost))
    # the matrix-free branch on the whole map is the world-one dispatch bit for bit
    lc = tlc.LoopCloser(cases.CAM, m.K, tlc.LoopCloserConfig(n_words=64, global_ba_iters=iters),
                        device="cpu")
    lc._dispatch_global_ba(m, anchor=0)
    g = lc._gba_pending
    for k in ("R", "t", "X", "cost"):
        assert_same(outs[0]["cg_" + k], g[k].numpy(), k)
    folded = convert.map_state_to_numpy(lc.maybe_fold_gba(m, force=True))
    assert_same_map(outs[0], folded, prefix="cg_fold_")
