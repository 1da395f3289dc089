"""The port's parallel/ package (mesh.py, dist_ba.py) and the distributed
branch of LoopCloser._dispatch_global_ba against the JAX package, on the
CPU: ranks are processes of a gloo group (tests/_torch_dist_worker.py), the
JAX side a mesh of 2 of the virtual CPU devices (tests/conftest.py).

Tolerances: shard_ba_problem's arrays and permutation exactly equal (n = 1,
2, 4, 8); each shard's normal equations within 1e-5 x the largest entry of
each block (the cost likewise); the distributed LM on 2 ranks (and
a world of one) against JAX's on 2 devices (and 1): rotations within 1e-4,
translations and points within 1e-3 m (one float32 LU of a badly
conditioned system in the case where the cost rises; the converging case
agrees to ~2e-5), cost within 1e-5 relative, and the two ranks' results
bit for bit equal; one process given the ranks' blocks (worlds 2 and 3,
and 2 ranks of two blocks each) equal bit for bit to the ranks; the
LoopCloser's distributed branch on 2 ranks equal bit
for bit to a direct 2-rank call on the sharded full-map problem
un-permuted, and its fold to fold_gba_device of that.  Every process group
has 60 s timeouts and every rank a 120 s limit.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orb_slam2_annotate_tpu.parallel import dist_ba as jdist
from orb_slam2_annotate_tpu.solvers import ba_core as jba
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.parallel import dist_ba as tdist
from orb_slam2_annotate_tpu_torch.parallel import mesh as tmesh
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

from test_solvers import CAM, make_ba_problem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
TCAM = TCam(**{f.name: float(getattr(CAM, f.name)) for f in dataclasses.fields(TCam)})


def problem(seed=11, n_cams=5, n_pts=64, noise=0.3, stereo=0.3, outliers=0.05):
    """tests/test_solvers.make_ba_problem with stereo edges, outliers, a
    second fixed camera and some invalid edges."""
    prob, Rs, ts, X = make_ba_problem(n_cams=n_cams, n_pts=n_pts, seed=seed, noise=noise)
    rng = np.random.RandomState(seed)
    E = prob.cam_idx.shape[0]
    ci, pi = np.asarray(prob.cam_idx), np.asarray(prob.pt_idx)
    Xc = np.einsum("eij,ej->ei", Rs[ci], X[pi]) + ts[ci]
    ur = np.full(E, -1.0, np.float32)
    st = rng.rand(E) < stereo
    ur[st] = 500 * Xc[st, 0] / Xc[st, 2] + 320 - float(CAM.bf) / Xc[st, 2] + rng.randn(st.sum()) * 0.5
    uv = np.asarray(prob.uv).copy()
    out = rng.rand(E) < outliers
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    fixed = np.zeros(n_cams, bool)
    fixed[[0, 2]] = True
    return prob._replace(ur=jnp.asarray(ur), uv=jnp.asarray(uv.astype(np.float32)),
                         cam_fixed=jnp.asarray(fixed),
                         edge_valid=jnp.asarray(rng.rand(E) > 0.05))


def to_port(jp):
    return convert.ba_problem_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                                         device="cpu")


def jax_distributed(sp, n_dev, iters):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("mp",))
    pt, rep = NamedSharding(mesh, P("mp")), NamedSharding(mesh, P())
    sp = sp._replace(**{k: jax.device_put(getattr(sp, k), pt) for k in
                        ("points", "pt_valid", "cam_idx", "pt_idx", "uv", "ur", "inv_sigma2",
                         "edge_valid")},
                     **{k: jax.device_put(getattr(sp, k), rep) for k in
                        ("R", "t", "cam_fixed", "cam_valid")})
    return [np.asarray(a) for a in jdist.make_distributed_ba(mesh, iters=iters)(CAM, sp)]


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(mode, tmp_path, inputs=None, world=2, retry=True):
    """Run `mode` of the worker on `world` gloo ranks; their outputs."""
    if inputs is not None:
        np.savez(tmp_path / "in.npz", **inputs)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), port,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
             for r in range(world)]
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
        return run_ranks(mode, tmp_path, world=world, retry=False)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {mode!r} failed:\n{log[-3000:]}"
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


def cam_inputs(cam):
    return {"cam_" + f.name: np.float32(getattr(cam, f.name)) for f in dataclasses.fields(TCam)}


def close_rel(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_ba_problem_matches_reference(n):
    jp = problem(n_pts=61)
    js, jperm = jdist.shard_ba_problem(jp, n, return_perm=True)
    ts, tperm = tdist.shard_ba_problem(to_port(jp), n, return_perm=True)
    np.testing.assert_array_equal(tperm, jperm)
    for k, v in convert.ba_problem_to_numpy(ts).items():
        ref = np.asarray(getattr(js, k))
        assert v.shape == ref.shape, k
        np.testing.assert_array_equal(v, ref.astype(v.dtype), err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_each_shards_normal_equations_match_reference(n):
    jp = problem(seed=5)
    js = jdist.shard_ba_problem(jp, n)
    Pl, El = js.points.shape[0] // n, js.cam_idx.shape[0] // n
    for s in range(n):
        ps, es = slice(s * Pl, (s + 1) * Pl), slice(s * El, (s + 1) * El)
        blk = js._replace(points=js.points[ps], pt_valid=js.pt_valid[ps],
                          cam_valid=jnp.ones_like(js.cam_valid),
                          pt_idx=js.pt_idx[es] - s * Pl,
                          **{k: getattr(js, k)[es] for k in ("cam_idx", "uv", "ur", "inv_sigma2",
                                                             "edge_valid")})
        ref = jba.build_normal_eqs(CAM, blk, True)
        out = tba.build_normal_eqs(TCAM, tdist.shard_block(to_port(js), n, s), True)
        for name, a, b in zip(("Hcc", "Hpp", "B", "gc", "gp", "cost"), ref, out):
            close_rel(a, b.numpy(), 1e-5)


def ba_inputs(jp, n, iters):
    sp = jdist.shard_ba_problem(jp, n)
    return sp, {**cam_inputs(TCAM), "iters": np.int32(iters),
                **{"prob_" + k: np.asarray(v) for k, v in sp._asdict().items()}}


def check_against_reference(outs, ref, tmp_path=None):
    for o in outs[1:]:
        for k in ("R", "t", "X", "cost"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"ranks differ in {k}")
    R, t, X, cost = ref
    o = outs[0]
    np.testing.assert_allclose(o["R"], R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(o["t"], t, rtol=0, atol=1e-3)
    np.testing.assert_allclose(o["X"], X, rtol=0, atol=1e-3)
    np.testing.assert_allclose(o["cost"], cost, rtol=1e-5)


@pytest.mark.parametrize("case", ["converging", "cost_rises"])
def test_distributed_ba_on_two_ranks_matches_reference(case, tmp_path):
    # "cost_rises": far-off poses and robust weights off make the first
    # steps raise the cost, where the reference's accept rule (copied)
    # keeps a step taken from a state that beat every earlier one
    jp = problem(seed=11) if case == "converging" else problem(seed=3, noise=2.5, outliers=0.0)
    iters = 8 if case == "converging" else 3
    sp, inputs = ba_inputs(jp, 2, iters)
    ref = jax_distributed(sp, 2, iters)
    outs = run_ranks("ba", tmp_path, inputs)
    check_against_reference(outs, ref)
    R, t, X, cost = (torch.from_numpy(outs[0][k]) for k in ("R", "t", "X", "cost"))
    final = float(tba.edge_cost(TCAM, to_port(sp).replace(R=R, t=t, points=X)))
    if case == "converging":
        assert final < float(cost)
    else:
        # the state returned costs more than the cost returned
        assert final > float(cost)


def test_distributed_ba_at_a_world_of_one_matches_reference():
    jp = problem(seed=7)
    sp = jdist.shard_ba_problem(jp, 1)
    ref = jax_distributed(sp, 1, 6)
    step = tdist.make_distributed_ba(tmesh.map_mesh(), iters=6)
    out = step(TCAM, to_port(sp))
    check_against_reference([{k: v.numpy() for k, v in zip(("R", "t", "X", "cost"), out)}], ref)
    assert tmesh.map_mesh().size == 1 and tmesh.world_size() == 1


@pytest.mark.parametrize("world,shards", [(2, 2), (3, 3), (2, 4)])
def test_a_world_of_one_with_the_ranks_blocks_gives_their_bits(world, shards, tmp_path):
    """The camera system is summed block by block in block order, so one
    process given the ranks' blocks returns the ranks' R, t, X and cost bit
    for bit."""
    jp = problem(seed=11)
    sp, inputs = ba_inputs(jp, shards, 8)
    outs = run_ranks("ba", tmp_path, {**inputs, "shards": np.int32(shards)}, world=world)
    one = tdist.make_distributed_ba(tmesh.Mesh(None, 1, 0), iters=8, shards=shards)(
        TCAM, to_port(sp))
    for k, v in zip(("R", "t", "X", "cost"), one):
        for o in outs:
            np.testing.assert_array_equal(o[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("world,shards,live", [(2, 3, False), (2, 3, True)])
def test_distributed_ba_refuses_blocks_the_ranks_cannot_split(world, shards, live):
    with pytest.raises(ValueError):
        tdist.make_distributed_ba(tmesh.Mesh(None, world, 0), shards=shards, live=live)


def test_distributed_ba_refuses_a_live_block_list_of_another_length():
    blk = to_port(jdist.shard_ba_problem(problem(seed=7), 1))
    with pytest.raises(ValueError):
        tdist.make_distributed_ba(tmesh.Mesh(None, 1, 0), shards=2, live=True)(TCAM, [blk])


@pytest.mark.parametrize("mode", ["allreduce", "env"])
def test_init_multi_host_two_processes(mode, tmp_path):
    # the counterpart of tests/test_multihost.py: two processes form a group
    # from the arguments, or from torch's environment, and sum over it
    outs = run_ranks(mode, tmp_path)
    for r, o in enumerate(outs):
        assert int(o["world"]) == 2 and int(o["rank"]) == r
        np.testing.assert_array_equal(o["sum"], np.full(4, 3.0, np.float32))


def test_init_multi_host_without_a_coordinator_does_nothing(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tmesh.init_multi_host()
    assert not torch.distributed.is_initialized()
    m = tmesh.map_mesh()
    assert (m.group, m.size, m.rank, m.axis) == (None, 1, 0, "mp")
    assert tmesh.shard_map_state("map", m) == "map"
    with pytest.raises(ValueError):
        tmesh.map_mesh(2)
    # above a world of one a rank keeps the rows it owns (point g on rank g % n)
    whole = tms.empty_map(2, 6, 4, device="cpu")
    whole = whole.replace(mp_pos=torch.arange(18.0).reshape(6, 3))
    half = tmesh.shard_map_state(whole, tmesh.Mesh(None, 2, 1))
    assert (half.P, half.P_local) == (6, 3)
    np.testing.assert_array_equal(half.mp_pos.numpy(), whole.mp_pos[1::2].numpy())


def loop_map(seed=4, K=8, N=128, n_pts=96):
    """A map of K keyframe slots (6 live) all observing n_pts points, with
    perturbed poses and points: the global BA's input."""
    prob, Rs, ts, X = make_ba_problem(n_cams=6, n_pts=n_pts, seed=seed)
    m = tms.empty_map(K, 256, N, device="cpu")
    kv = torch.zeros(K, dtype=torch.bool)
    kv[:6] = True
    uv = np.array(prob.uv).reshape(6, n_pts, 2)
    kf_xy = torch.zeros(K, N, 2)
    kf_xy[:6, :n_pts] = torch.from_numpy(uv)
    obs = torch.full((K, N), -1, dtype=torch.int32)
    obs[:6, :n_pts] = torch.arange(n_pts, dtype=torch.int32)
    feat = obs >= 0
    R = torch.eye(3).repeat(K, 1, 1)
    t = torch.zeros(K, 3)
    R[:6], t[:6] = torch.from_numpy(np.array(prob.R)), torch.from_numpy(np.array(prob.t))
    pos = torch.zeros(256, 3)
    pos[:n_pts] = torch.from_numpy(np.array(prob.points))
    mpv = torch.zeros(256, dtype=torch.bool)
    mpv[:n_pts] = True
    first = torch.full((256,), -1, dtype=torch.int32)
    first[:n_pts] = 0
    return m.replace(kf_R=R, kf_t=t, kf_valid=kv, kf_xy=kf_xy, kf_obs=obs, kf_feat_valid=feat,
                     mp_pos=pos, mp_valid=mpv, mp_first_kf=first, n_kf=torch.tensor(6, dtype=torch.int32))


def test_loop_closer_distributed_branch_on_two_ranks(tmp_path):
    m = loop_map()
    iters = 5
    ins = {**cam_inputs(TCAM), "iters": np.int32(iters), "anchor": np.int32(0),
           **{"m_" + k: v for k, v in convert.map_state_to_numpy(m).items()}}
    outs = run_ranks("loop", tmp_path, ins)
    for k, v in outs[0].items():
        if k != "rank":
            np.testing.assert_array_equal(outs[1][k], v, err_msg=f"ranks differ in {k}")
    # the direct call on the sharded full-map problem, un-permuted
    sp, perm = tdist.shard_ba_problem(tlc.full_map_ba_problem(m, 0), 2, return_perm=True)
    (tmp_path / "direct").mkdir()
    direct = run_ranks("ba", tmp_path / "direct",
                       {**cam_inputs(TCAM), "iters": np.int32(iters),
                        **{"prob_" + k: v for k, v in convert.ba_problem_to_numpy(sp).items()}})
    o, d = outs[0], direct[0]
    np.testing.assert_array_equal(o["R"], d["R"])
    np.testing.assert_array_equal(o["t"], d["t"])
    np.testing.assert_array_equal(o["X"], d["X"][perm])
    np.testing.assert_array_equal(o["cost"], d["cost"])
    folded = tlc.fold_gba_device(m, *(torch.from_numpy(a) for a in (d["R"], d["t"], d["X"][perm])),
                                 m.kf_valid, m.mp_valid, m.kf_R, m.kf_t)
    for k, v in convert.map_state_to_numpy(folded).items():
        np.testing.assert_array_equal(o["fold_" + k], v, err_msg=k)
    # the BA moved the map toward the truth
    assert float(o["cost"]) > 0 and not np.array_equal(o["fold_mp_pos"], np.asarray(m.mp_pos))


def test_loop_closer_folds_on_every_rank_at_once(tmp_path):
    """Each rank reads its own clock on whether its global BA is done; the
    fold waits until it is done on every rank, so the ranks fold at the
    same keyframe and go on from the same map."""
    m = loop_map()
    ins = {**cam_inputs(TCAM), "iters": np.int32(3), "anchor": np.int32(0),
           **{"m_" + k: v for k, v in convert.map_state_to_numpy(m).items()}}
    outs = run_ranks("fold_agree", tmp_path, ins)
    for o in outs:
        assert (bool(o["all_true"]), bool(o["rank0_only"]), bool(o["none"])) == (True, False, False)
        assert int(o["folded_while_rank1_runs"]) == 0 and int(o["folded_once_done"]) == 1
    for k in outs[0]:
        if k.startswith("fold_"):
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    assert not np.array_equal(outs[0]["fold_mp_pos"], np.asarray(m.mp_pos))
