"""Kernels 1 and 3's arithmetic orders, walked on the CPU in numpy float32 or
torch, bit for bit against their unchanged plain twins.

Kernel 1 (``csrc/fast_nms.cu``): the separable resize, tile by tile (64 x 16
and a 4-pixel halo; the row pass over the input columns the column pass
reads, in chunks where the footprint passes the shared-memory width),
against ``ops/pyramid.resize_stack`` at 8 levels, at VGA and at 250 x 333;
the FAST strength by window doubling behind the compass pretest against
``ops/fast.fast_score_map`` on random, integer, plateau and rendered images
(strengths exactly at 7 and 20 among them); the launch's work items
(``kernels/fast_nms._segments``) writing every stack pixel exactly once.

Kernel 3 (``csrc/hamming.cu``): the column splits of ``kernels/hamming._split``,
a warp's row against 32 columns at a time, only the gated pairs merged (lane i
from the chunk's column i on, by distance and then index) with the split's
ungated columns as one MAX_DIST term, the splits' records merged in the order
of the last to arrive, the column keys (d << 22 | row) of the gated pairs, the
epipolar test's division only near its threshold, and the finish's ratio
test, column-min dedup and mutual check, against
``kernels/hamming.hamming_match_plain`` on window (columns exactly on the
circle among them), epipolar, mask and ungated problems, in both the matching
and the "every column counts" settings (max_dist >= MAX_DIST, ratio > 1); and
the AND-popcount identity of the kernel's mma distances.
"""

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch.io import synthetic
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
from orb_slam2_annotate_tpu_torch.kernels import fast_nms as k1
from orb_slam2_annotate_tpu_torch.kernels import hamming as k3
from orb_slam2_annotate_tpu_torch.ops import fast, pyramid
from orb_slam2_annotate_tpu_torch.ops.hamming import MAX_DIST

torch.set_num_threads(1)
f32 = np.float32
TX, TY, HALO, TCAP = 64, 16, 4, 144
NO_DIST = MAX_DIST + 1
KEY_INIT = MAX_DIST << 22


# ---- kernel 1 --------------------------------------------------------------

def plateau_image(h=480, w=640, seed=22):
    """Flat blocks 0, 7, 8, 20 or 21 grey levels apart (chip_smoke.k1_cases')."""
    rng = np.random.default_rng(seed)
    steps = np.array([-21, -20, -8, -7, 0, 7, 8, 20, 21], f32)
    img = np.full((h, w), 100.0, f32)
    for _ in range(4000 * h * w // (480 * 640)):
        bh, bw = rng.integers(1, 12, 2)
        y, x = rng.integers(0, h - bh), rng.integers(0, w - bw)
        img[y:y + bh, x:x + bw] = 100.0 + rng.choice(steps)
    return img


@pytest.fixture(scope="module")
def frame():
    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    R, t = synthetic.orbit_trajectory(5, step=0.05)[4]
    img, _ = synthetic.PlaneScene(seed=1).render(cam, R, t, h=480, w=640)
    return np.clip(img, 0, 255).astype(np.uint8).astype(f32)


def resize_tiles(img, lt, tcap):
    """The kernel's resize, tile by tile: [L,H0,W0] with every tile's halo
    value checked against the same pixel from a neighbouring tile."""
    H0, W0 = img.shape
    out = np.full((len(lt.shapes), H0, W0), np.nan, f32)
    rf, rw = lt.row_first.numpy(), lt.row_w.numpy()
    cf, cw = lt.col_first.numpy(), lt.col_w.numpy()
    for l, ((h, w), (ty, tx)) in enumerate(zip(lt.shapes, lt.taps)):
        for y0 in range(0, h, TY):
            for x0 in range(0, w, TX):
                ya, yb = max(y0 - HALO, 0), min(y0 + TY + HALO, h) - 1
                xa, xb = max(x0 - HALO, 0), min(x0 + TX + HALO, w) - 1
                ys = np.arange(ya, yb + 1)
                cx = xa
                while cx <= xb:
                    X0 = min(cf[l, cx], W0 - 1)
                    xs = np.arange(cx, xb + 1)
                    fit = np.minimum(cf[l, xs] + tx - 1, W0 - 1) - X0 < tcap
                    ce = cx + int(fit.sum()) - 1
                    assert fit[:ce - cx + 1].all()
                    nX = min(cf[l, ce] + tx - 1, W0 - 1) - X0 + 1
                    X = X0 + np.arange(nX)
                    t = np.zeros((len(ys), nX), f32)
                    for ky in range(ty):
                        src = img[np.minimum(rf[l, ys] + ky, H0 - 1)][:, X]
                        t = t + rw[l, ys, ky][:, None] * src
                    xc = np.arange(cx, ce + 1)
                    acc = np.zeros((len(ys), len(xc)), f32)
                    for kx in range(tx):
                        acc = acc + cw[l, xc, kx][None, :] * t[:, np.minimum(cf[l, xc] + kx, W0 - 1) - X0]
                    seen = out[l][np.ix_(ys, xc)]
                    old = ~np.isnan(seen)
                    assert np.array_equal(seen[old].view(np.int32), acc[old].view(np.int32))
                    out[l][np.ix_(ys, xc)] = acc
                    cx = ce + 1
        out[l, h:, :] = 0.0
        out[l, :, w:] = 0.0
    return out


@pytest.mark.parametrize("size,tcap", [((480, 640), TCAP), ((250, 333), TCAP), ((250, 333), 24)])
def test_separable_resize_bits(frame, size, tcap):
    """Row pass then column pass, tile by tile (tcap 24: every level above 1
    in chunks), equal to resize_stack bit for bit at all 8 levels."""
    h, w = size
    img = np.ascontiguousarray(frame[:h, :w])
    lt = pyramid.level_tables(h, w, 8, 1.2, "cpu")
    want = pyramid.resize_stack(torch.from_numpy(img), lt).numpy()
    got = resize_tiles(img, lt, tcap)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def arc_doubling(d):
    """d [16,...] -> (bright, dark) the kernel's way: the 9-arc minimum as
    min(m8[s], d[s + 8]) by doubling, and the dark polarity as -(min_s of the
    9-arc maximum)."""
    r = lambda x, k: torch.roll(x, -k, 0)
    m2 = torch.minimum(d, r(d, 1))
    m4 = torch.minimum(m2, r(m2, 2))
    bright = torch.minimum(torch.minimum(m4, r(m4, 4)), r(d, 8)).max(0).values
    M2 = torch.maximum(d, r(d, 1))
    M4 = torch.maximum(M2, r(M2, 2))
    dark = -torch.maximum(torch.maximum(M4, r(M4, 4)), r(d, 8)).min(0).values
    return bright, dark


def fast_kernel_order(img, thr_lo, thr_hi):
    """fast_score_map's outputs from the doubling arcs behind the compass
    pretest: a polarity whose compass points 0, 4, 8, 12 have no adjacent
    pair above thr_lo is left out."""
    h, w = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) for dy, dx in fast.CIRCLE])
    d = ring - img[None]
    c = d[[0, 4, 8, 12]]
    pair = lambda e: (e & torch.roll(e, -1, 0)).any(0)
    bright_ok, dark_ok = pair(c > thr_lo), pair(-c > thr_lo)
    bright, dark = arc_doubling(d)
    neg = torch.full_like(bright, -float("inf"))
    v = torch.maximum(torch.where(bright_ok, bright, neg), torch.where(dark_ok, dark, neg))
    # the lemma the pretest rests on: a polarity that fails it is <= thr_lo
    assert not (bright[~bright_ok] > thr_lo).any() and not (dark[~dark_ok] > thr_lo).any()
    yy, xx = torch.arange(h)[:, None], torch.arange(w)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    score = torch.where((v > thr_lo) & interior, v, torch.zeros_like(v))
    return score, (v > thr_hi) & interior


def test_every_9_arc_holds_adjacent_compass_points():
    for s in range(16):
        arc = {(s + i) % 16 for i in range(9)}
        assert any({a, (a + 4) % 16} <= arc for a in (0, 4, 8, 12))


@pytest.mark.parametrize("kind", ["uniform", "integers", "plateaus", "frame", "frame levels"])
def test_fast_doubling_pretest_bits(frame, kind):
    rng = np.random.default_rng(5)
    if kind == "uniform":
        imgs = [rng.uniform(0, 255, (120, 160)).astype(f32)]
    elif kind == "integers":
        imgs = [rng.integers(90, 130, (120, 160)).astype(f32)]
    elif kind == "plateaus":
        imgs = [plateau_image()]
    elif kind == "frame":
        imgs = [frame]
    else:
        lt = pyramid.level_tables(480, 640, 8, 1.2, "cpu")
        stack = pyramid.resize_stack(torch.from_numpy(frame), lt)
        imgs = [stack[l, :h, :w].numpy() for l, (h, w) in enumerate(lt.shapes) if l > 0]
    for img in imgs:
        t = torch.from_numpy(np.ascontiguousarray(img))
        want = fast.fast_score_map(t, 7.0, 20.0)
        got = fast_kernel_order(t, 7.0, 20.0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if kind == "plateaus":
            # strengths exactly at the thresholds occur, and score 0 / not hi
            s_raw = torch.maximum(*arc_doubling(torch.stack(
                [torch.roll(t, shifts=(-dy, -dx), dims=(0, 1)) for dy, dx in fast.CIRCLE]) - t[None]))
            assert int((s_raw == 7.0).sum()) > 0 and int((s_raw == 20.0).sum()) > 0


@pytest.mark.parametrize("h,w,levels", [(480, 640, 8), (240, 320, 4), (250, 333, 8), (64, 64, 1)])
def test_work_items_write_each_pixel_once(h, w, levels):
    """Segments of _segments: the tiles of level L - 1 - s, then bands of
    8 padding rows a level; tiles write their level's pixels, bands the rest
    of each row (or the whole row below the level)."""
    lt = pyramid.level_tables(h, w, levels, 1.2, "cpu")
    seg = list(k1._segments(lt.shapes, h, w))
    L = len(lt.shapes)
    count = np.zeros((L, h, w), np.int32)
    for item in range(seg[2 * L]):
        s = 0
        while item >= seg[s + 1]:
            s += 1
        lev = L - 1 - s if s < L else s - L
        lh, lw = lt.shapes[lev]
        if s >= L:
            for y in range((item - seg[s]) * 8, min((item - seg[s]) * 8 + 8, h)):
                count[lev, y, (lw if y < lh else 0):] += 1
        else:
            tiles_x = -(-lw // TX)
            t = item - seg[s]
            x0, y0 = (t % tiles_x) * TX, (t // tiles_x) * TY
            count[lev, y0:min(y0 + TY, lh), x0:min(x0 + TX, lw)] += 1
    assert (count == 1).all()


# ---- kernel 3 --------------------------------------------------------------

def popc(x):
    """Bits set in each int32 of x, summed over the last axis."""
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1).astype(np.int64)


def test_and_popcount_identity():
    rng = np.random.default_rng(3)
    a = rng.integers(-2**31, 2**31, (64, 16), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (64, 16), dtype=np.int64).astype(np.int32)
    for x, y in ((a, b), (a, a), (a, ~a), (np.zeros_like(a), b)):
        assert np.array_equal(popc(x ^ y), popc(x) + popc(y) - 2 * popc(x & y))


def merge(st, o):
    """The kernel's merge of two states (best, index, second) of disjoint
    column sets: lower distance, then lower index wins."""
    (b, i, sec), (ob, oi, osec) = st, o
    if ob < b or (ob == b and oi < i):
        return ob, oi, min(osec, b)
    return b, i, min(sec, ob)


def kernel_walk(desc1, desc2, rv, cv, max_dist, ratio, mutual, gate, seed=0):
    """The kernel's algorithm on [B?,...] inputs: returns (idx, dist) as the
    wrapper shapes them; the last split of each row block to arrive drawn
    from `seed`."""
    rng = np.random.default_rng(seed)
    B = max([t.shape[0] for t in (desc1, desc2) if t.dim() == 3] +
            [t.shape[0] for t in (rv, cv) if t is not None and t.dim() == 2] + [0])
    nb = B or 1
    N1, N2 = desc1.shape[-2], desc2.shape[-2]
    cs, S, RB = k3._split(nb, N1, N2)
    full = lambda t, n: (torch.ones(n, dtype=torch.bool) if t is None else t)
    at = lambda t, b: (t[b] if t.dim() == (3 if t.dtype == torch.int32 else 2) else t)
    cand = full(rv, N1)[..., :, None] & full(cv, N2)[..., None, :]
    g = k3.gate_mask(gate)
    if g is not None:
        cand = cand & g
    cand = cand.expand(nb, N1, N2).numpy() if cand.dim() == 3 else \
        np.broadcast_to(cand.numpy(), (nb, N1, N2))
    idx = np.zeros((nb, N1), np.int64)
    dist = np.zeros((nb, N1), np.int64)
    for b in range(nb):
        d1 = at(desc1, b).numpy()
        d2 = at(desc2, b).numpy()
        # popc(row) + popc(column) - 2 popc(row AND column), the mma's
        dd = popc(d1)[:, None] + popc(d2)[None, :] - 2 * np.stack([popc(d1[i] & d2) for i in range(N1)])
        g_b = cand[b]
        keys = np.full(N2, KEY_INIT, np.int64)
        rec = np.zeros((S, N1, 3), np.int64)
        for s in range(S):
            c0, ncols = s * cs, min(cs, N2 - s * cs)
            for i in range(N1):
                st = (NO_DIST, 2**31 - 1, NO_DIST)
                for cb in range(0, ncols, 32):
                    cols = [c for c in range(32) if cb + c < ncols and g_b[i, c0 + cb + c]]
                    for c in sorted(cols, key=lambda c: (c - i) % 32):   # lane i from column i on
                        j = c0 + cb + c
                        d = int(dd[i, j])
                        st = merge(st, (d, j, NO_DIST))
                        keys[j] = min(keys[j], (d << 22) | i)
                ung = [j for j in range(c0, c0 + ncols) if not g_b[i, j]]
                if ung:
                    st = merge(st, (MAX_DIST, ung[0], MAX_DIST if len(ung) > 1 else NO_DIST))
                rec[s, i] = st
        for r0 in range(0, N1, 256):
            last = int(rng.integers(S))
            for i in range(r0, min(r0 + 256, N1)):
                st = tuple(rec[last, i])
                for s in range(S):
                    if s != last:
                        st = merge(st, tuple(rec[s, i]))
                best, bidx, second = st[0], st[1], min(st[2], MAX_DIST)
                ok = best <= max_dist and f32(best) < f32(ratio) * f32(second)
                key = int(keys[bidx]) if ok else KEY_INIT
                if ok:
                    ok = (key & (2**22 - 1)) == i if mutual else best <= key >> 22
                idx[b, i] = bidx if ok else -1
                dist[b, i] = best if ok else MAX_DIST
    if not B:
        idx, dist = idx[0], dist[0]
    return torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(dist.astype(np.int32))


def test_epipolar_division_precheck():
    """The kernel's epipolar test v^2 / den < thr, decided by v^2 x (1 / den)
    beyond 2^-20 of thr and by the division only near it, equals the division's
    on quotients at, and a few float steps around, thr (and on huge, tiny,
    infinite and NaN operands)."""
    rng = np.random.default_rng(7)
    n = 200_000
    den = np.exp(rng.uniform(np.log(1e-12), np.log(1e6), n)).astype(f32)
    thr = (f32(3.84) * (f32(1) / (f32(1) / f32(1.44) ** rng.integers(0, 8, n).astype(f32)))).astype(f32)
    v2 = (thr * den).astype(f32)
    v2 = np.where(rng.random(n) < 0.5, v2, v2 * rng.uniform(0.5, 2.0, n).astype(f32)).astype(f32)
    for k in range(-3, 4):                      # a few float steps around the product
        v2 = np.where(rng.random(n) < 0.1, np.nextafter(v2, f32(np.inf) if k > 0 else f32(0)), v2)
    special = np.array([0, 1e-38, 1e30, 3e38, np.inf, np.nan], f32)
    v2 = np.concatenate([v2, np.repeat(special, 6)]).astype(f32)
    den = np.concatenate([den, np.tile(np.array([1e-12, 1.0, 1e20, np.inf, 1e-12, 1.0], f32), 6)])
    thr = np.concatenate([thr, np.tile(np.array([3.84, np.inf, 1e-31, 5.5, np.nan, 3.84], f32), 6)])
    with np.errstate(all="ignore"):
        exact = v2 / den < thr
        qa = v2 * (f32(1) / den)
        fast = thr > f32(1e-30)
        lo = np.where(fast, thr * f32(1 - 2 ** -20), -np.inf).astype(f32)
        hi = np.where(fast, thr * f32(1 + 2 ** -20), np.inf).astype(f32)
        kernel = (qa < lo) | (~(qa > hi) & exact)
    assert np.array_equal(kernel, exact)
    # the near band is where the division runs: every case there, none far off
    assert ((qa >= lo) & (qa <= hi)).any() and ((qa < lo) | (qa > hi)).any()


def match_cases():
    """Problems on synthetic keypoints: descriptors drawn near a few seeds
    (distances spread over 0-512), positions on a 640 x 480 frame."""
    rng = np.random.default_rng(11)
    T = torch.from_numpy

    def descs(n, seeds):
        base = seeds[rng.integers(0, len(seeds), n)]
        flip = rng.random((n, 16, 32)) < rng.uniform(0.02, 0.5, (n, 1, 1))
        bits = (flip * (1 << np.arange(32, dtype=np.int64))).sum(-1)
        return (base ^ bits.astype(np.uint32).view(np.int32)).astype(np.int32)

    seeds = rng.integers(-2**31, 2**31, (12, 16), dtype=np.int64).astype(np.int32)
    N1, N2 = 300, 700
    d1, d2 = T(descs(N1, seeds)), T(descs(N2, seeds))
    xy1 = T(rng.uniform([0, 0], [640, 480], (N1, 2)).astype(f32))
    xy2 = T(rng.uniform([0, 0], [640, 480], (N2, 2)).astype(f32))
    xy1[:20] = xy2[:20] + T(rng.normal(0, 3, (20, 2)).astype(f32))
    # the columns level by level, as a frame's keypoints come
    oc1, oc2 = T(rng.integers(0, 8, N1).astype(np.int32)), T(np.sort(rng.integers(0, 8, N2)).astype(np.int32))
    rad = T((f32(15) * f32(1.2) ** oc1.numpy().astype(f32)).astype(f32))
    # columns exactly on, and one float step either side of, row 0's circle
    r0 = float(rad[0])
    for k, s in enumerate((1.0, np.nextafter(f32(1), f32(2)), np.nextafter(f32(1), f32(0)))):
        xy2[300 + k] = xy1[0] + T(np.array([r0 * s, 0.0], f32))
    rv = T(rng.random(N1) < 0.9)
    cv = T(rng.random(N2) < 0.9)
    win = k3.WindowGate(xy1, rad, xy2, oc1, oc2, -1, 1)
    # an epipolar problem: a camera pair 0.3 m apart, frame points on a plane
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float64)
    t = np.array([0.3, 0.02, 0.05])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F12 = torch.from_numpy((np.linalg.inv(K).T @ tx @ np.linalg.inv(K)).T.astype(f32).copy())
    F3 = torch.stack([F12, F12 * 1.5, F12.T.contiguous()])
    isig2 = T((f32(1) / f32(1.2) ** (2 * np.arange(8))).astype(f32))
    epi = k3.EpipolarGate(F3, xy1, torch.stack([xy2, xy2.flip(0), xy2 * 0.5]),
                          torch.stack([oc2, oc2.flip(0), oc2]), isig2)
    same = d2[:1].expand(N1, 16).contiguous()
    # one group of 32 columns whose nearest lies exactly on row 0's circle
    # (radius 10 about (100, 100)), the others a float step or more beyond
    ring = 110.0 + np.arange(32) * float(np.spacing(f32(110)))
    on_x = T(np.stack([ring, np.full(32, 100.0)], 1).astype(f32))
    on_y = T(np.stack([np.full(32, 100.0), ring], 1).astype(f32))
    at100 = T(np.full((1, 2), 100.0, f32))
    return {
        "window, the nearest column on the circle in x": (d2[:1], d2[:32].contiguous(), None, None,
                                                          k3.WindowGate(at100, 10.0, on_x)),
        "window, the nearest column on the circle in y": (d2[:1], d2[:32].contiguous(), None, None,
                                                          k3.WindowGate(at100, 10.0, on_y)),
        "window + octave": (d1, d2, rv, cv, win),
        "window, scalar radius, B = 2": (torch.stack([d1, d1]), torch.stack([d2, d2.flip(0)]), None,
                                         torch.stack([cv, cv]), k3.WindowGate(
                                             torch.stack([xy1, xy1]), 40.0,
                                             torch.stack([xy2, xy2.flip(0)]))),
        "epipolar, B = 3": (d1, torch.stack([d2, d2.flip(0), d2]), rv, None, epi),
        "no gate": (d1, d2, rv, cv, None),
        "dense mask": (d1, d2, None, None, k3.MaskGate(k3.gate_mask(win))),
        "every row invalid": (d1, d2, torch.zeros_like(rv), cv, win),
        "N1 = 1, N2 = 1": (d1[:1], d2[:1].contiguous(), None, None, None),
        "every descriptor equal": (same, d2[:1].expand(N2, 16).contiguous(), None, None, win),
        "rows repeat columns (ties)": (d2[rng.integers(0, 8, N1)].contiguous(), d2, None, None, None),
    }


@pytest.mark.parametrize("name", list(match_cases()))
def test_matcher_walk_bits(name):
    da, db, rv, cv, gate = match_cases()[name]
    for max_dist, ratio, mutual in ((134, 1.0, False), (184, 0.9, True), (134, 0.75, False),
                                    (512, 1.5, False), (600, 2.0, True)):
        want = k3.hamming_match_plain(da, db, rv, cv, max_dist, ratio, mutual, gate)
        got = kernel_walk(da, db, rv, cv, max_dist, ratio, mutual, gate)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (max_dist, ratio, mutual)
