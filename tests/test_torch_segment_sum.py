"""Kernel 11's plain twin and plan (kernels/segment_sum.py), on the CPU.

The kernel walks each segment's rows in the plan's order (ascending row,
from +0.0); the twin is the CPU's serial index_add.  These tests hold, bit
for bit with no tolerance: the twin against np.add.at (float32, unbuffered,
in index order) on values where the order of addition decides the bits
(1e8, 1, -1e8 patterns), at every width the solvers use; a float32 walk of
the plan (the kernel's order, emulated in numpy) against the twin; the plan
against numpy's stable argsort and searchsorted; empty segments, dropped
rows, repeated ids and -0.0; the pose graph's four H blocks as one sum over
their concatenation against four index_adds in sequence; the old
index_put_(accumulate=True) of build_normal_eqs at one thread against the
twin; the wrapper's CPU dispatch (no launch); and that leaving rows of ±0
out of a plan (the solvers' zero-weight edges) changes no bit, on random
rows and on every solver's whole output (both pose graphs, the matrix-free,
dense and distributed BA on a map's full problem with padded edges).
"""

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.kernels import segment_sum as k11
from orb_slam2_annotate_tpu_torch.parallel import dist_ba as tdist
from orb_slam2_annotate_tpu_torch.parallel import mesh as tmesh
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.solvers import ba_cg as tcg
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba
from orb_slam2_annotate_tpu_torch.solvers import pose_graph as tpg

import test_torch_pose_graph as pg_cases

torch.set_num_threads(1)

WIDTHS = (3, 6, 7, 9, 18, 36, 49)     # gp; gc; g; Hpp; B; Hcc; the pose graph's H and D


def order_sensitive(rng, E, D):
    """Values whose float32 sum depends on the order of addition."""
    pat = np.array([1e8, 1.0, -1e8, 3e-3, -7e7, 1e-8, -0.0], np.float32)
    return (rng.choice(pat, (E, D)) * rng.uniform(0.5, 2.0, (E, D))).astype(np.float32)


def add_at(S, idx, vals):
    out = np.zeros((S,) + vals.shape[1:], np.float32)
    keep = (idx >= 0) & (idx < S)
    np.add.at(out, idx[keep], vals[keep])
    return out


def bits_equal(a, b):
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def walk_plan(plan, vals):
    """The kernel's order in numpy: each segment from +0.0, one float32 add
    a row, in the plan's order."""
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    v = vals.reshape(vals.shape[0], -1)
    out = np.zeros((plan.S, v.shape[1]), np.float32)
    for s in range(plan.S):
        acc = np.zeros(v.shape[1], np.float32)
        for e in perm[off[s]:off[s + 1]]:
            acc = (acc + v[e]).astype(np.float32)
        out[s] = acc
    return out.reshape((plan.S,) + vals.shape[1:])


@pytest.mark.parametrize("D", WIDTHS)
def test_twin_is_np_add_at_bit_for_bit(D):
    rng = np.random.default_rng(D)
    E, S = 4000, 53
    idx = rng.integers(0, S, E)
    vals = order_sensitive(rng, E, D)
    ref = add_at(S, idx, vals)
    # the order decides the bits on these values: another order differs
    perm = rng.permutation(E)
    assert not bits_equal(add_at(S, idx[perm], vals[perm]), ref)
    plan = k11.segment_plan(torch.from_numpy(idx), S)
    out = k11.segment_sum(plan, torch.from_numpy(vals)).numpy()
    assert bits_equal(out, ref)
    assert bits_equal(walk_plan(plan, vals), ref)


@pytest.mark.parametrize("threads", [1, 4])
def test_twin_order_holds_at_any_thread_count(threads):
    rng = np.random.default_rng(11)
    E, S, D = 20000, 512, 36
    idx = rng.integers(0, S, E)
    vals = order_sensitive(rng, E, D).reshape(E, 6, 6)
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        out = k11.segment_sum(k11.segment_plan(torch.from_numpy(idx), S), torch.from_numpy(vals))
    finally:
        torch.set_num_threads(old)
    assert out.shape == (S, 6, 6)
    assert bits_equal(out.numpy(), add_at(S, idx, vals))


def test_empty_segments_dropped_rows_repeated_ids_and_negative_zero():
    S = 9
    idx = np.array([4, -1, 4, 9, 2, 4, 12, 2, 0, -7, 4, 8], np.int64)
    vals = np.array([1e8, 5.0, 1.0, 3.0, -0.0, -1e8, 2.0, -0.0, 7.5, 1.0, 1.0, -0.0],
                    np.float32)[:, None] * np.ones((1, 3), np.float32)
    plan = k11.segment_plan(torch.from_numpy(idx), S)
    out = k11.segment_sum(plan, torch.from_numpy(vals)).numpy()
    ref = add_at(S, idx, vals)
    assert bits_equal(out, ref)
    assert bits_equal(walk_plan(plan, vals), ref)
    # ((1e8 + 1) - 1e8) + 1 in float32 is the order's own answer, 1, not 2
    assert (out[4] == 1.0).all()
    # empty segments and -0.0 sums are +0.0
    for s in (1, 3, 5, 6, 7, 2, 8):
        assert not np.signbit(out[s]).any() and (out[s] == 0).all()
    # dropped rows (-1, 9, 12, -7) reach no segment: they sit last in the plan
    assert plan.offsets[-1].item() == 8
    assert set(plan.perm[8:].tolist()) == {1, 3, 6, 9}


@pytest.mark.parametrize("S", [1, 7, 128, 5000])
def test_plan_against_numpy(S):
    rng = np.random.default_rng(S)
    E = 3000
    idx = rng.integers(-3, S + 3, E).astype(np.int32)
    plan = k11.segment_plan(torch.from_numpy(idx), S)
    key = np.where((idx >= 0) & (idx < S), idx, S)
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(plan.key.numpy(), key)
    np.testing.assert_array_equal(plan.perm.numpy(), order)
    np.testing.assert_array_equal(plan.offsets.numpy(),
                                  np.searchsorted(key[order], np.arange(S + 1), side="left"))
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32 and plan.E == E


def test_pose_graph_four_blocks_are_one_concatenated_sum():
    """H of solvers/pose_graph.optimize_pose_graph: four index_adds in
    sequence (the (i,i), (j,j), (i,j), (j,i) blocks) equal one segment sum
    over their concatenation."""
    rng = np.random.default_rng(5)
    K, E = 12, 300
    ei = torch.from_numpy(rng.integers(0, K, E))
    ej = torch.from_numpy(rng.integers(0, K, E))
    blocks = [torch.from_numpy(order_sensitive(rng, E, 49).reshape(E, 7, 7)) for _ in range(4)]
    H = torch.zeros((K * K, 7, 7))
    for (a, b), v in zip(((ei, ei), (ej, ej), (ei, ej), (ej, ei)), blocks):
        H = H.index_add(0, a * K + b, v)
    plan = k11.segment_plan(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]), K * K)
    one = k11.segment_sum(plan, torch.cat(blocks))
    assert bits_equal(one.numpy(), H.numpy())


def test_index_put_accumulate_at_one_thread_is_the_twin():
    """build_normal_eqs summed with index_put_(accumulate=True) over (pi, ci)
    before kernel 11; at one thread (the tests') that is the twin's order,
    so no CPU number moved."""
    rng = np.random.default_rng(3)
    P, C, E = 40, 9, 2500
    pi, ci = rng.integers(0, P, E), rng.integers(0, C, E)
    vals = torch.from_numpy(order_sensitive(rng, E, 18).reshape(E, 6, 3))
    old = torch.zeros((P, C, 6, 3)).index_put_((torch.from_numpy(pi), torch.from_numpy(ci)), vals,
                                               accumulate=True)
    plan = k11.segment_plan(torch.from_numpy(pi * C + ci), P * C)
    new = k11.segment_sum(plan, vals).reshape(P, C, 6, 3)
    assert bits_equal(new.numpy(), old.numpy())


def test_wrapper_takes_the_twin_for_cpu_tensors():
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 16, 200))
    vals = torch.from_numpy(order_sensitive(rng, 200, 7))
    plan = k11.segment_plan(idx, 16)
    before = k11.segment_sum.launches
    out = k11.segment_sum(plan, vals)
    assert k11.segment_sum.launches == before
    assert out.device.type == "cpu" and out.dtype == torch.float32 and out.shape == (16, 7)
    assert bits_equal(out.numpy(), k11.segment_sum_plain(plan, vals).numpy())
    # a strided view sums as its contiguous copy
    wide = torch.from_numpy(order_sensitive(rng, 200, 14))[:, ::2]
    assert bits_equal(k11.segment_sum(plan, wide).numpy(),
                      k11.segment_sum(plan, wide.contiguous()).numpy())


def test_rows_of_zeros_left_out_change_no_bit():
    """A sum from +0.0 never becomes -0.0, and x + ±0 is x otherwise: the
    ±0 rows may be dropped from a plan (their index -1), whatever their sign."""
    rng = np.random.default_rng(21)
    E, S, D = 6000, 40, 9
    idx = rng.integers(0, S, E)
    vals = order_sensitive(rng, E, D)
    zero = rng.random(E) < 0.6
    vals[zero] = np.where(rng.random((zero.sum(), D)) < 0.5, np.float32(0.0), np.float32(-0.0))
    # segments of nothing but -0.0, and segments that cancel to zero
    vals[(idx == 3) | (idx == 4)] = np.float32(-0.0)
    sel = np.nonzero(idx == 4)[0][:2]
    vals[sel[0]], vals[sel[1]], zero[sel] = np.float32(2.5), np.float32(-2.5), False
    full = add_at(S, idx, vals)
    plan = k11.segment_plan(torch.from_numpy(np.where(zero, -1, idx)), S)
    got = k11.segment_sum(plan, torch.from_numpy(vals)).numpy()
    assert bits_equal(got, full) and bits_equal(walk_plan(plan, vals), full)
    assert plan.offsets[-1].item() == int((~zero).sum())
    assert not np.signbit(full[3]).any() and not np.signbit(full[4]).any()


def _map_problem():
    """The full-map BA problem of tests/test_torch_pose_graph.py's graph map:
    two empty keyframe slots whose padded edges are clamped onto point 0,
    points behind some cameras."""
    m = convert.map_state_from_numpy({k: np.asarray(v) for k, v in
                                      pg_cases.graph_map()._asdict().items()}, device="cpu")
    return tlc.full_map_ba_problem(m, 0)


SOLVES = {
    "optimize_pose_graph": lambda: tpg.optimize_pose_graph(pg_cases.essential_graphs()[1], 15),
    "optimize_pose_graph_cg":
        lambda: tpg.optimize_pose_graph_cg(pg_cases.essential_graphs()[1], 15),
    "bundle_adjust_cg": lambda: tcg.bundle_adjust_cg(pg_cases.TCAM, _map_problem(), 10, 25),
    "bundle_adjust": lambda: tba.bundle_adjust(pg_cases.TCAM, _map_problem(), 10),
    "distributed BA": lambda: tdist.make_distributed_ba(tmesh.Mesh(None, 1, 0))(
        pg_cases.TCAM, tdist.shard_ba_problem(_map_problem(), 1)),
}


@pytest.mark.parametrize("solver", list(SOLVES))
def test_solvers_give_the_same_bits_with_every_row_summed(solver, monkeypatch):
    """Each solver's output with its zero-weight edges left out of the sums
    equals, bit for bit, its output with every row summed (those edges,
    whose terms are ±0, added into row 0)."""
    got = SOLVES[solver]()
    real = k11.segment_plan
    for mod in (tpg, tcg, tba):
        monkeypatch.setattr(mod, "segment_plan", lambda idx, S: real(torch.clamp_min(idx, 0), S))
    ref = SOLVES[solver]()
    for a, b in zip(got, ref):
        a, b = a.numpy(), b.numpy()
        assert bits_equal(a, b) if a.dtype == np.float32 else np.array_equal(a, b)
