"""Kernel 11's inputs shared by the CPU tests and ``chip_smoke.py`` (which
holds the kernel on the card to its CPU twin on them): an index with a
given longest segment, and rows whose sums depend on the order of
addition."""

import numpy as np


def order_sensitive(rng, E, D):
    """Rows [E, D] f32 whose sums depend on the order of addition: 1e8, 1,
    -1e8, 3e-3, -7e7, 1e-8 and -0.0, each scaled by a draw in [0.5, 2)."""
    pat = np.array([1e8, 1.0, -1e8, 3e-3, -7e7, 1e-8, -0.0], np.float32)
    return (rng.choice(pat, (E, D)) * rng.uniform(0.5, 2.0, (E, D))).astype(np.float32)


def shape_case(seed, E, S, live, longest):
    """An index [E] over S segments with `live` kept rows (the rest -1) in
    a random row order: one segment of `longest` rows, the others drawn
    uniformly, a row past the first `longest` of its segment drawn again."""
    rng = np.random.default_rng(seed)
    ids = np.empty(live, np.int64)
    if live:
        big = rng.integers(0, S)
        ids[:longest] = big
        rest = rng.integers(0, max(S - 1, 1), live - longest)
        rest += rest >= big
        while rest.size:
            order = np.argsort(rest, kind="stable")
            srt = rest[order]
            over = order[np.arange(srt.size) - np.searchsorted(srt, srt) >= longest]
            if not over.size:
                break
            again = rng.integers(0, S - 1, over.size)
            rest[over] = again + (again >= big)
        ids[longest:] = rest
    idx = np.full(E, -1, np.int64)
    idx[rng.permutation(E)[:live]] = ids
    return idx
