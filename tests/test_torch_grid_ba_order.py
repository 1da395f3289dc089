"""Kernel 12's Cholesky and Schur blocks in their two schedules, walked in
numpy in float32 (each product rounded before its sum or difference, IEEE
division and square root), on the CPU: the first design's (``gba_chol`` by
16-column blocks over every row, identity rows and padding included, with
separate triangular solves; ``gba_schur`` a CTA a camera c whose 8 warps
take every d <= c in turn) and the current one's (``csrc/grid_ba.cu``: the
free cameras' rows alone, by 32-column panels, the diagonal block a lane a
row with the next pivot shuffled first, the rows below a thread a row, the
forward solve as the factor's last row, a zero dividend taken as a product;
the full system instead where that forward solve is not finite; the back
solve over every row by 16-row blocks, a chain with helper rows, identity
rows read through the row map; a CTA a camera c and group of 8 d, a warp
a pair, each lane stepping to its own next point that d sees).  The two give the same bits:
the step, the failure flag, the factor and y, S and the right-hand side, on
random systems at C = 1, 5, 11, 16 and 32, with cameras that are not free
and padding, one not positive definite (the step all NaN), a NaN and an
infinite forward solve (the full system), one free camera and none.
"""

import numpy as np
import pytest

f32 = np.float32
NB, PW = 16, 32
FMAX = np.finfo(f32).max


def rows_of(C):
    """The reduced system's rows: 6C padded to a multiple of 16."""
    return (6 * C + NB - 1) // NB * NB


def div_rn(a, b):
    """The kernel's division: a zero dividend by a finite nonzero divisor as
    the product (the same signed zero), else IEEE's."""
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    with np.errstate(all="ignore"):
        prod, quot = a * b, a / b
    return np.where((a == 0) & (b != 0) & (np.abs(b) <= FMAX), prod, quot).astype(f32)


def assemble(S, rhs, free):
    """The system as both designs assemble it: [M + 1, M], the lower triangle
    (free cameras' blocks, identity rows for the rest and the padding), row M
    the right-hand side; upper entries 0 (never read)."""
    C = free.shape[0]
    n, M = 6 * C, rows_of(C)
    i, j = np.meshgrid(np.arange(M), np.arange(M), indexing="ij")
    ci, cj = np.minimum(i, n - 1) // 6, np.minimum(j, n - 1) // 6
    use = (i < n) & (j < n) & free[ci] & free[cj]
    val = np.where(use, S[ci, cj, (i % 6) * 6 + j % 6], (i == j).astype(f32))
    A = np.zeros((M + 1, M), f32)
    A[:M] = np.where(j <= i, val, 0.0)
    jj = np.arange(M)
    A[M] = np.where((jj < n) & free[np.minimum(jj, n - 1) // 6],
                    rhs.reshape(-1)[np.minimum(jj, n - 1)], 0.0)
    return A


def step_of(x, fail, free):
    n = 6 * free.shape[0]
    fr = np.repeat(free, 6)
    return np.where(fr, np.float32(np.nan) if fail else x[:n], 0.0).astype(f32)


def chol_first(A0):
    """The first design: 16-column blocks (a warp the diagonal block, a thread a
    row below, the trailing update an entry at a time), then L y = v and L^T x
    = y by 16-row blocks.  Returns (x, fail, L, y)."""
    M = A0.shape[1]
    A = A0[:M].copy()
    v = A0[M].copy()
    fail = False
    with np.errstate(all="ignore"):
        for k0 in range(0, M, NB):
            for j in range(NB):
                piv = A[k0 + j, k0 + j]
                ljj = np.sqrt(piv)
                fail |= not piv > 0
                A[k0 + j, k0 + j] = ljj
                A[k0 + j + 1:k0 + NB, k0 + j] = A[k0 + j + 1:k0 + NB, k0 + j] / ljj
                for m in range(j + 1, NB):
                    ls = slice(k0 + m, k0 + NB)
                    A[ls, k0 + m] = A[ls, k0 + m] - A[ls, k0 + j] * A[k0 + m, k0 + j]
            r = slice(k0 + NB, M)
            x = np.zeros((M - k0 - NB, NB), f32)
            for j in range(NB):
                s = A[r, k0 + j].copy()
                for m in range(j):
                    s = s - x[:, m] * A[k0 + j, k0 + m]
                x[:, j] = s / A[k0 + j, k0 + j]
                A[r, k0 + j] = x[:, j]
            for m in range(NB):
                A[r, r] = A[r, r] - np.outer(A[r, k0 + m], A[r, k0 + m])
        for k0 in range(0, M, NB):
            vi = v[k0:k0 + NB].copy()
            for j in range(NB):
                yj = vi[j] / A[k0 + j, k0 + j]
                vi[j] = yj
                vi[j + 1:] = vi[j + 1:] - A[k0 + j + 1:k0 + NB, k0 + j] * yj
            v[k0:k0 + NB] = vi
            for m in range(NB):
                v[k0 + NB:] = v[k0 + NB:] - A[k0 + NB:, k0 + m] * v[k0 + m]
        y = v.copy()
        for k0 in range(M - NB, -1, -NB):
            vi = v[k0:k0 + NB].copy()
            for j in range(NB - 1, -1, -1):
                xj = vi[j] / A[k0 + j, k0 + j]
                vi[j] = xj
                vi[:j] = vi[:j] - A[k0 + j, k0:k0 + j] * xj
            v[k0:k0 + NB] = vi
            for m in range(NB):
                v[:k0] = v[:k0] - A[k0 + m, :k0] * v[k0 + m]
    return v, fail, np.tril(A), y


def factor_panels(A0):
    """The current design's factorization: 32-column panels (warp 0's diagonal
    block, identity past the width w; the rows below and row M a thread a row;
    the panel's terms on the trailing matrix).  A0 [M + 1, M] as assemble()
    lays it out.  Returns (A with L below the diagonal and y as row M, fail)."""
    M = A0.shape[1]
    A = A0.copy()
    fail = False
    lanes = np.arange(PW)
    with np.errstate(all="ignore"):
        for p0 in range(0, M, PW):
            w = min(PW, M - p0)
            a = np.where((lanes[:, None] < w) & (lanes[None, :] < w),
                         np.pad(A[p0:p0 + w, p0:p0 + w], ((0, PW - w), (0, PW - w))),
                         np.eye(PW, dtype=f32)).astype(f32)
            a = np.where(lanes[None, :] <= lanes[:, None], a, 0.0).astype(f32)
            Dt = np.zeros((PW, PW), f32)
            piv = a[0, 0]
            for jj in range(PW):
                ljj = np.sqrt(piv)
                fail |= jj < w and not piv > 0
                q = div_rn(a[:, jj], ljj)
                l = np.where(lanes == jj, ljj, np.where(lanes > jj, q, f32(0))).astype(f32)
                a[:, jj] = l
                if jj + 1 < PW:
                    piv = a[jj + 1, jj + 1] - l[jj + 1] * l[jj + 1]
                Dt[jj] = l
                for c in range(jj + 1, PW):
                    a[:, c] = a[:, c] - l * l[c]
            A[p0:p0 + w, p0:p0 + w] = np.where(lanes[:w, None] >= lanes[None, :w], a[:w, :w],
                                               A[p0:p0 + w, p0:p0 + w])
            t0 = p0 + w
            rows = slice(t0, M + 1)
            ar = np.zeros((M + 1 - t0, PW), f32)
            ar[:, :w] = A[rows, p0:p0 + w]
            for jj in range(PW):
                lr = div_rn(ar[:, jj], Dt[jj, jj])
                ar[:, jj] = lr
                for c in range(jj + 1, PW):
                    ar[:, c] = ar[:, c] - lr * Dt[jj, c]
            A[rows, p0:p0 + w] = ar[:, :w]
            for m in range(w):
                A[t0:, t0:] = A[t0:, t0:] - np.outer(ar[:, m], ar[:-1, m])
    return A, fail


def back_blocks(L, y):
    """L^T x = y by 16-row blocks from the last: the chain (block b + 1's terms
    on block b, then its own steps) and the helper rows (blocks b + 2 and up).
    L(r, i) and y(i) give the coefficients of the Mf = len(y) rows."""
    Mf = len(y)
    nbk = Mf // NB
    x = np.zeros(Mf, f32)
    hv = y.copy()
    with np.errstate(all="ignore"):
        for b in range(nbk - 1, -1, -1):
            i = slice(b * NB, b * NB + NB)
            acc = hv[i].copy()
            if b + 1 < nbk:
                for m in range(NB):
                    K = (b + 1) * NB + m
                    acc = acc - L[K, i] * x[K]
            for j in range(NB - 1, -1, -1):
                xj = div_rn(acc[j], L[b * NB + j, b * NB + j])
                acc[:j] = acc[:j] - L[b * NB + j, b * NB:b * NB + j] * xj
                acc[j] = xj
            x[i] = acc
            lim = (b - 1) * NB                    # the helper rows: blocks <= b - 2
            if lim > 0:
                for m in range(NB):
                    hv[:lim] = hv[:lim] - L[b * NB + m, :lim] * x[b * NB + m]
    return x


def chol_panels(S, rhs, free):
    """The current design: the free cameras' rows alone (identity rows and
    padding left out), factored by panels; where that forward solve is not
    finite and no pivot failed, the full system instead; then the back solve
    over every row, an identity row's coefficients (1, +0, y = +0) through the
    row map.  Returns (x, fail, L, y) in the full layout."""
    A0 = assemble(S, rhs, free)
    Mf = A0.shape[1]
    frow = np.nonzero(np.repeat(free, 6))[0]          # the compact rows' full rows
    nf = len(frow)
    Mc = (nf + NB - 1) // NB * NB
    Ac = np.zeros((Mc + 1, Mc), f32)
    Ac[:Mc, :Mc] = np.eye(Mc, dtype=f32)
    Ac[:nf, :nf] = np.tril(A0[np.ix_(frow, frow)])
    Ac[Mc, :nf] = A0[Mf, frow]
    A, fail = factor_panels(Ac)
    cmap = np.full(Mf, -1)
    cmap[frow] = np.arange(nf)
    if not fail and not np.isfinite(A[Mc]).all():
        A, fail = factor_panels(A0)
        cmap = np.arange(Mf)
    M = A.shape[1]
    Lv = np.eye(Mf, dtype=f32)
    ok = cmap >= 0
    Lv[np.ix_(ok, ok)] = A[np.ix_(cmap[ok], cmap[ok])]
    Lv = np.tril(Lv)
    yv = np.zeros(Mf, f32)
    yv[ok] = A[M, cmap[ok]]
    return back_blocks(Lv, yv), fail, Lv, yv


def bits_equal(a, b):
    """Equal bit for bit; every NaN alike (the card writes one NaN)."""
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(a.view(np.int32)[~na], b.view(np.int32)[~nb])


def system(C, seed, free=None, spd=True):
    """Schur blocks [C, C, 36] (c >= d) and right-hand side [C, 6] of a random
    float32 system over C cameras, SPD unless `spd` is False."""
    rng = np.random.default_rng(seed)
    n = 6 * C
    J = rng.normal(0, 1, (n + 8, n))
    S = J.T @ J * rng.uniform(0.5, 2.0) + np.diag(rng.uniform(1e-3, 1.0, n))
    if not spd:
        S -= 2.0 * np.linalg.eigvalsh(S).max() * np.eye(n) * (np.arange(n) == n // 2)
    S = S.astype(f32)
    blocks = S.reshape(C, 6, C, 6).transpose(0, 2, 1, 3).reshape(C, C, 36)
    free = np.ones(C, bool) if free is None else free
    return blocks, rng.normal(0, 1, (C, 6)).astype(f32), free


CASES = {
    "C 1": system(1, 1),
    "C 5": system(5, 2),
    "C 11 (a half panel last)": system(11, 3),
    "C 16": system(16, 4),
    "C 32": system(32, 5),
    "C 32, cameras 0, 7, 8 and 20-31 not free": system(
        32, 6, free=~np.isin(np.arange(32), [0, 7, 8] + list(range(20, 32)))),
    "C 11, cameras 1 and 10 not free, padding": system(11, 7, free=~np.isin(np.arange(11), [1, 10])),
    "C 16, not positive definite": system(16, 8, spd=False),
}


EXTRA = ("C 11, a NaN right-hand side entry", "C 16, an infinite forward solve",
         "C 32, cameras 0-30 not free", "no free camera")


def extra_case(name):
    if name == "C 11, a NaN right-hand side entry":
        S, rhs, free = system(11, 9, free=~np.isin(np.arange(11), [4]))
        rhs[6, 2] = np.nan
    elif name == "C 16, an infinite forward solve":
        S, rhs, free = system(16, 10, free=~np.isin(np.arange(16), [2, 3, 9]))
        S = (S * 1e-4).astype(f32)
        rhs[5, 0] = 3e38
    elif name == "C 32, cameras 0-30 not free":
        S, rhs, free = system(32, 11, free=np.arange(32) == 31)
    else:
        S, rhs, free = system(5, 12, free=np.zeros(5, bool))
    return S, rhs, free


@pytest.mark.parametrize("name", list(CASES) + list(EXTRA))
def test_cholesky_schedules_agree_bit_for_bit(name):
    S, rhs, free = CASES[name] if name in CASES else extra_case(name)
    A0 = assemble(S, rhs, free)
    x1, fail1, L1, y1 = chol_first(A0)
    x2, fail2, L2, y2 = chol_panels(S, rhs, free)
    assert fail1 == fail2 == name.endswith("not positive definite")
    if not fail1:
        assert bits_equal(L1, L2) and bits_equal(y1, y2)
    assert bits_equal(x1, x2)
    dc1, dc2 = step_of(x1, fail1, free), step_of(x2, fail2, free)
    assert bits_equal(dc1, dc2)
    if name == "C 16, an infinite forward solve":
        assert not np.isfinite(y1).all()
    if fail1:
        assert np.isnan(dc1[np.repeat(free, 6)]).all() and (dc1[~np.repeat(free, 6)] == 0).all()
    elif np.isfinite(rhs).all() and np.isfinite(dc1).all():
        # a solve: the free cameras' block, backward error at float32's level
        n, M = 6 * free.shape[0], A0.shape[1]
        fr = np.repeat(free, 6)
        Sf = np.tril(A0[:n, :n]).astype(np.float64)
        Sf = (Sf + np.tril(Sf, -1).T)[np.ix_(fr, fr)]
        x, r = dc1[fr].astype(np.float64), A0[M, :n][fr].astype(np.float64)
        if len(x):
            err = np.abs(Sf @ x - r).max() / (np.abs(Sf).sum(1).max() * np.abs(x).max() + np.abs(r).max())
            assert err < 1e-5


# ---- gba_schur's (c, d) sums

def dot3(a0, b0, a1, b1, a2, b2):
    """fmaf(a2, b2, fmaf(a1, b1, a0 * b0)), the product exact in float64."""
    t = (a0 * b0).astype(f32)
    t = (a1.astype(np.float64) * b1 + t).astype(f32)
    return (a2.astype(np.float64) * b2 + t).astype(f32)


def schur_problem(C, P, seed, n_fixed=0):
    rng = np.random.default_rng(seed)
    seen = rng.random((C, P)) < 0.5
    seen[:, rng.random(P) < 0.1] = False
    mask = (seen.astype(np.uint64) << np.arange(C, dtype=np.uint64)[:, None]).sum(0).astype(np.uint32)
    B = rng.normal(0, 1, (C, 18, P)).astype(f32)
    Hinv = rng.normal(0, 0.5, (9, P)).astype(f32)
    gp = rng.normal(0, 1, (3, P)).astype(f32)
    Hcc = rng.normal(0, 1, (C, 21)).astype(f32)
    gc = rng.normal(0, 1, (C, 6)).astype(f32)
    free = np.arange(C) >= n_fixed
    return mask, B, Hinv, gp, Hcc, gc, free, f32(rng.uniform(1e-5, 10.0))


def listed(mask, c):
    """Camera c's points, ascending (both designs' ballot compaction), their masks,
    and BH [18, total]."""
    lst = np.nonzero(mask & np.uint32(1 << c))[0]
    return lst, mask[lst]


def bh_of(B, Hinv, c, lst):
    b, h = B[c][:, lst], Hinv[:, lst]
    out = np.zeros((18, len(lst)), f32)
    for i in range(6):
        for j in range(3):
            out[3 * i + j] = dot3(b[3 * i], h[j], b[3 * i + 1], h[3 + j], b[3 * i + 2], h[6 + j])
    return out


def up6(i, l):
    i, l = min(i, l), max(i, l)
    return i * 6 - i * (i - 1) // 2 + (l - i)


def pair_sum(c, d, lst, msk, BH, B, gp, Hcc, gc, lk, skip):
    """S_cd (and the rhs for d == c) as one warp forms it: lane l's chains over
    the listed points l, l + 32, .. that d sees, then the xor butterfly.  The
    first design steps every lane through idx = l + 32 m, adding where d sees
    the point; with `skip` (the current one) each lane steps to its own next
    point that d sees, so a step adds in every lane with one left."""
    total = len(lst)
    acc = np.zeros((32, 36), f32)
    racc = np.zeros((32, 6), f32)
    diag = c == d
    lanes = np.arange(32)
    sees = ((msk >> np.uint32(d)) & 1).astype(bool)
    if skip:
        chains = [[i for i in range(l, total, 32) if sees[i]] for l in lanes]
        steps = max(len(ch) for ch in chains)
        at = [(np.array([ch[m] if m < len(ch) else 0 for ch in chains]),
               np.array([m < len(ch) for ch in chains])) for m in range(steps)]
    else:
        at = [(np.minimum(lanes + 32 * m, total - 1),
               (lanes + 32 * m < total) & sees[np.minimum(lanes + 32 * m, total - 1)])
              for m in range((total + 31) // 32)]
    for ii, on in at:
        p = lst[ii]
        bd = np.where(on[None, :], B[d][:, p], f32(0))
        bh = BH[:, ii]
        for i in range(6):
            for l in range(6):
                t = (bh[3 * i] * bd[3 * l] + bh[3 * i + 1] * bd[3 * l + 1]) + bh[3 * i + 2] * bd[3 * l + 2]
                acc[:, 6 * i + l] = np.where(on, acc[:, 6 * i + l] + t, acc[:, 6 * i + l])
            if diag:
                t = (bh[3 * i] * gp[0, p] + bh[3 * i + 1] * gp[1, p]) + bh[3 * i + 2] * gp[2, p]
                racc[:, i] = np.where(on, racc[:, i] + t, racc[:, i])
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[lanes ^ o]
        racc = racc + racc[lanes ^ o]
    S = np.zeros(36, f32)
    for i in range(6):
        for l in range(6):
            if diag:
                h = Hcc[c, up6(i, l)]
                hd = h + (lk * h + f32(1e-9)) if i == l else h
                S[6 * i + l] = hd - acc[0, 6 * i + l]
            else:
                S[6 * i + l] = -acc[0, 6 * i + l]
    r = (-gc[c] + racc[0]).astype(f32) if diag else None
    return S, r


def schur_first(mask, B, Hinv, gp, Hcc, gc, free, lk):
    """CTA c (free), warp w the d = w, w + 8, .. <= c (free)."""
    C = free.shape[0]
    S, rhs = {}, {}
    for c in range(C):
        if not free[c]:
            continue
        lst, msk = listed(mask, c)
        BH = bh_of(B, Hinv, c, lst)
        for w in range(8):
            for d in range(w, c + 1, 8):
                if free[d]:
                    S[c, d], r = pair_sum(c, d, lst, msk, BH, B, gp, Hcc, gc, lk, False)
                    if r is not None:
                        rhs[c] = r
    return S, rhs


def schur_groups(mask, B, Hinv, gp, Hcc, gc, free, lk):
    """CTA (c, g) (free c, some free d in the group), warp w the d = 8 g + w
    (free, <= c), each lane stepping to its own next point that d sees."""
    C = free.shape[0]
    S, rhs = {}, {}
    for c in range(C):
        for g in range((C + 7) // 8):
            d0 = 8 * g
            if not free[c] or d0 > c or not free[d0:min(c, d0 + 7) + 1].any():
                continue
            lst, msk = listed(mask, c)
            BH = bh_of(B, Hinv, c, lst)
            for w in range(8):
                d = d0 + w
                if d <= c and free[d]:
                    S[c, d], r = pair_sum(c, d, lst, msk, BH, B, gp, Hcc, gc, lk, True)
                    if r is not None:
                        rhs[c] = r
    return S, rhs


@pytest.mark.parametrize("C, P, n_fixed", [(1, 300, 0), (5, 700, 0), (16, 256, 3), (32, 128, 9)])
def test_schur_splits_agree_bit_for_bit(C, P, n_fixed):
    prob = schur_problem(C, P, 40 + C, n_fixed)
    S1, r1 = schur_first(*prob)
    S2, r2 = schur_groups(*prob)
    free = prob[6]
    pairs = {(c, d) for c in range(C) for d in range(c + 1) if free[c] and free[d]}
    assert set(S1) == set(S2) == pairs and set(r1) == set(r2) == set(np.nonzero(free)[0])
    for key in pairs:
        assert bits_equal(S1[key], S2[key]), key
    for c in r1:
        assert bits_equal(r1[c], r2[c]), c
