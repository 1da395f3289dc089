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

The kernel's schedule (the walk, a chain a thread; or tiles of G
consecutive segments zero-filled first, stages of R rows, a carry row for a
segment that goes on into the next stage) is walked in numpy as
csrc/segment_sum.cu runs it (``walk_schedule``) and held to np.add.at bit
for bit at the solvers' seven call shapes (E, S, D and the longest segment
of the runs on the card) and at the edge cases: one segment of 5,000 rows,
every row in one segment, S = 1, D = 1 and 64, E = 0, every row dropped,
B's S with no live row; each call shape's path, the tiles' and stages'
sizes and the plan's checks (once, at build) are held to their rules.
The index and rows come from ``_segment_cases.py``, which chip_smoke.py
shares.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.kernels import _build
from orb_slam2_annotate_tpu_torch.kernels import segment_sum as k11
from orb_slam2_annotate_tpu_torch.parallel import dist_ba as tdist
from orb_slam2_annotate_tpu_torch.parallel import mesh as tmesh
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.solvers import ba_cg as tcg
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba
from orb_slam2_annotate_tpu_torch.solvers import pose_graph as tpg

import test_torch_pose_graph as pg_cases
from _segment_cases import order_sensitive, shape_case

torch.set_num_threads(1)

WIDTHS = (3, 6, 7, 9, 18, 36, 49)     # gp; gc; g; Hpp; B; Hcc; the pose graph's H and D


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
    a row, in the plan's order (all segments at once, a row a step)."""
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    D = int(np.prod(vals.shape[1:]))
    v = np.ascontiguousarray(vals.reshape(vals.shape[0], D), np.float32)
    out = np.zeros((plan.S, D), np.float32)
    n = np.diff(off)
    for step in range(int(n.max(initial=0))):
        m = step < n
        out[m] = (out[m] + v[perm[off[:-1][m] + step]]).astype(np.float32)
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


# --- the kernel's schedule -------------------------------------------------

def walk_schedule(plan, vals):
    """csrc/segment_sum.cu's order in numpy.  Where the kernel walks
    (``walk_width``) it adds each segment's rows serially from +0.0
    (``walk_plan``); else tile
    by tile (G consecutive
    segments), +0.0 over the tile's output, then stage by stage (R rows of
    the tile, ``k11.stage_rows``), each (segment, column) chain of the
    segments a stage touches that have rows in it adding those rows in
    ascending order from +0.0, or from the carry row that the stage before
    left for a segment going on; one float32 add a row; an empty segment
    keeps its zeros.  Also holds that every segment with rows is written
    once and that a stage hands at most one segment on."""
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    D = int(np.prod(vals.shape[1:]))
    v = np.ascontiguousarray(vals.reshape(vals.shape[0], D), np.float32)
    if D <= plan.walk_d:
        return walk_plan(plan, vals)
    R, G = k11.stage_rows(D, plan.hint), plan.G
    out = np.full((plan.S, D), np.nan, np.float32)
    written = np.zeros(plan.S, np.int64)
    for s0 in range(0, plan.S, G):
        n = min(G, plan.S - s0)
        out[s0:s0 + n] = np.float32(0.0)
        soff = off[s0:s0 + n + 1]
        r0, r1 = soff[0], soff[-1]
        nst = max(1, -(-(r1 - r0) // R))
        carry = np.zeros(D, np.float32)
        for k in range(nst):
            a, b = r0 + k * R, min(r0 + (k + 1) * R, r1)
            is_open = (soff[1:] > a) | (soff[:-1] >= a)
            lo = int(np.argmax(is_open)) if is_open.any() else n
            hi = n if k == nst - 1 else int(np.searchsorted(soff[:-1], b, side="left"))
            segs = np.arange(lo, hi)
            beg, end = soff[segs], soff[segs + 1]
            live = beg < end
            segs, beg, end = segs[live], beg[live], end[live]
            j0, j1 = np.maximum(beg, a), np.minimum(end, b)
            acc = np.where((beg < a)[:, None], carry[None, :], np.float32(0.0)).astype(np.float32)
            rows = v[perm[a:b]]
            for step in range(int((j1 - j0).max(initial=0))):
                m = step < j1 - j0
                acc[m] = (acc[m] + rows[j0[m] + step - a]).astype(np.float32)
            done = end <= b
            out[s0 + segs[done]] = acc[done]
            written[s0 + segs[done]] += 1
            assert (~done).sum() <= 1
            if (~done).any():
                carry = acc[~done][0]
    assert (written == (np.diff(off) > 0)).all() and not np.isnan(out).any()
    return out.reshape((plan.S,) + vals.shape[1:])


# (E slots, S, D, live rows, longest segment) of each call shape on the card:
# the closure's pose graph (g over the K keyframes, H over the K x K blocks)
# and the global BA on phase 15's map (131,072 edge slots, 27,117 kept)
CALL_SHAPES = {
    "pose graph g": (1100, 128, 7, 300, 6),
    "pose graph H (four blocks)": (4400, 128 * 128, 49, 1200, 10),
    "global BA Hcc": (131072, 128, 36, 27117, 461),
    "global BA gc": (131072, 128, 6, 27117, 461),
    "global BA Hpp": (131072, 16384, 9, 27117, 10),
    "global BA gp and the PCG point sum": (131072, 16384, 3, 27117, 10),
    "normal equations B": (131072, 16384 * 128, 18, 27117, 1),
}
EDGE_SHAPES = {
    "one segment of 5,000 rows": (12000, 300, 6, 9000, 5000),
    "every row in one segment": (6000, 40, 36, 6000, 6000),
    "S = 1": (3000, 1, 9, 2500, 2500),
    "D = 1": (5000, 700, 1, 4000, 30),
    "D = 64": (3000, 90, 64, 2800, 200),
    "E = 0": (0, 50, 7, 0, 0),
    "every row dropped": (4000, 64, 6, 0, 0),
    "B's S with no live row": (131072, 16384 * 128, 18, 0, 0),
}


@pytest.mark.parametrize("name", list(CALL_SHAPES) + list(EDGE_SHAPES))
def test_schedule_is_np_add_at_bit_for_bit(name):
    E, S, D, live, longest = {**CALL_SHAPES, **EDGE_SHAPES}[name]
    idx = shape_case(len(name), E, S, live, longest)
    counts = np.bincount(idx[idx >= 0], minlength=S)
    assert counts.sum() == live and (counts.max() if live else 0) == longest
    vals = order_sensitive(np.random.default_rng(E + D), E, D)
    plan = k11.segment_plan(torch.from_numpy(idx), S)
    ref = add_at(S, idx, vals)
    assert bits_equal(walk_schedule(plan, vals), ref)
    assert bits_equal(k11.segment_sum(plan, torch.from_numpy(vals)).numpy(), ref)


@pytest.mark.parametrize("E,S,live,longest", [(3000, 7, 2900, 1500), (20000, 5000, 9000, 40),
                                              (6000, 1, 6000, 6000), (0, 9, 0, 0),
                                              (4000, 64, 0, 0), (900, 30000, 800, 1)])
def test_tiles_and_stages(E, S, live, longest):
    """The kernel's split: tiles of G consecutive segments, about
    TARGET_TILES of them (at most MAX_G segments a tile); stages of at most
    the row hint, which is at least half a tile's rows were every row
    kept, or the mean segment (up to MAX_STAGE_ROWS); all from E and
    S, with no read of the plan's tensors."""
    idx = shape_case(S, E, S, live, longest)
    plan = k11.segment_plan(torch.from_numpy(idx), S)
    G, hint = plan.G, plan.hint
    assert G == k11.tile_width(S) == min(k11.MAX_G, max(1, -(-S // k11.TARGET_TILES)))
    tiles = -(-S // G)
    assert tiles <= k11.TARGET_TILES or G == k11.MAX_G
    assert G == 1 or -(-S // (G - 1)) > k11.TARGET_TILES
    assert hint == k11.row_hint(E, S) >= k11.MIN_ROW_HINT
    assert hint >= E * G / (2 * S) and hint >= min(E / S, k11.MAX_STAGE_ROWS)
    # every segment lies in one tile, and the tiles' rows are the plan's rows in order
    off = plan.offsets.numpy()
    starts = np.arange(0, S, G)
    assert np.array_equal(np.r_[off[starts], off[S]], off[np.r_[starts, S]])
    assert (np.diff(off[np.r_[starts, S]]) >= 0).all() and off[S] == live


def test_plan_checks_run_once_at_build(monkeypatch):
    """The plan checks its tensors when it is built (the dataclass is
    frozen); a launch checks only vals (``check_vals``)."""
    calls = []
    real = _build.check_tensor
    monkeypatch.setattr(_build, "check_tensor", lambda *a: calls.append(a[1]) or real(*a))
    rng = np.random.default_rng(4)
    plan = k11.segment_plan(torch.from_numpy(rng.integers(-1, 20, 500)), 20)
    assert calls == ["key", "perm", "offsets"]
    vals = torch.from_numpy(order_sensitive(rng, 500, 6).reshape(500, 2, 3))
    assert k11.check_vals(plan, vals) == 6
    for _ in range(3):
        k11.segment_sum(plan, vals)
    assert calls == ["key", "perm", "offsets"]
    with pytest.raises(TypeError):
        k11.check_vals(plan, vals.double())
    with pytest.raises(ValueError):
        k11.check_vals(plan, vals[:499])
    with pytest.raises(ValueError):
        k11.check_vals(plan, vals.new_zeros((500, k11.MAX_D + 1)))
    with pytest.raises(TypeError):
        dataclasses.replace(plan, perm=plan.perm.long())
    with pytest.raises(ValueError):
        dataclasses.replace(plan, offsets=plan.offsets[:-1])
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.S = 3


@pytest.mark.parametrize("name", list(CALL_SHAPES))
def test_path_of_each_call_shape(name):
    """The walk takes the points', the keyframes' and the pose graph's H
    sums (short segments, outputs of at most WALK_ITEMS floats); the staged
    tiles the cameras' (long segments) and B (37.7 M floats, mostly
    zeros)."""
    E, S, D, live, longest = CALL_SHAPES[name]
    walk = name not in ("global BA Hcc", "global BA gc", "normal equations B")
    plan = k11.segment_plan(torch.from_numpy(shape_case(1, E, S, live, longest)), S)
    assert plan.walk_d == k11.walk_width(E, S)
    assert (D <= plan.walk_d) is walk


@pytest.mark.parametrize("D", [1, 3, 6, 7, 9, 18, 36, 49, 64, 300])
def test_stage_rows(D):
    """A stage holds at least one row and at most STAGE_BYTES of rows,
    MAX_STAGE_ROWS rows and the plan's row hint (one row when a row is
    wider), so that the ring fits in shared memory."""
    for name, (E, S, _, _, _) in CALL_SHAPES.items():
        hint = k11.row_hint(E, S)
        R = k11.stage_rows(D, hint)
        assert 1 <= R <= min(k11.MAX_STAGE_ROWS, hint)
        assert R == 1 or R * 4 * D <= k11.STAGE_BYTES
        G = k11.tile_width(S)
        smem = k11.NS * R * D * 4 + 8 * D + 2 * k11.NS * R * 4 + 32 + (2 * G + 1) * 4
        assert smem <= 227 * 1024
