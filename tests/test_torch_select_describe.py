"""The algorithms of kernels 2 and 5 in plain torch, against the JAX
package, on the CPU.

Kernel 2's first stage picks each cell's first maximal priority, and its
second ranks every cell winner by counting the level's cells with a greater
priority, or an equal one at a lower index.  ``select_ranked`` below does
the same in plain torch; it must equal ``ops/select.select_keypoints`` (a
stable sort) and the JAX ``select_keypoints`` (``lax.top_k``) exactly, at
every level shape and budget of a VGA 8-level pyramid, on tie-heavy scores.
Kernel 2's whole plain twin (``extract`` after kernel 1) is held to the JAX
``extract`` with ``test_extract_end_to_end``'s tolerances: >= 99% of
keypoints at the same xy and octave, >= 98% of them in the same angle bin
with bit-identical descriptors.

Kernel 5 takes the argmin of popc(b) - 2 popc(a AND b) as the packed key
((popc(b) - 2 popc(a AND b)) << 20 | word); ``assign_and_popc`` below
does that in int64 and must equal the JAX ``assign_words`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.ops import extractor as jext
from orb_slam2_annotate_tpu.ops import pyramid as jpyr
from orb_slam2_annotate_tpu.ops import select as jsel
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.worldmap import vocabulary as jvoc
from orb_slam2_annotate_tpu_torch.kernels import assign_words as k5
from orb_slam2_annotate_tpu_torch.kernels import fast_nms as k1
from orb_slam2_annotate_tpu_torch.kernels import orb_describe as k2
from orb_slam2_annotate_tpu_torch.ops import orb as torb
from orb_slam2_annotate_tpu_torch.ops import pyramid as tpyr
from orb_slam2_annotate_tpu_torch.ops import select as tsel
from orb_slam2_annotate_tpu_torch.ops.hamming import unpack_signs

torch.set_num_threads(1)


def select_ranked(score: torch.Tensor, is_hi: torch.Tensor, budget: int):
    """Kernel 2's selection: per-cell first argmax, then each cell's rank by
    count; the cells of rank < k fill slots 0..k-1."""
    h, w = score.shape
    cs = tsel._pick_cell_size(h, w, budget)
    gh, gw = h // cs, w // cs
    cells = lambda a: a[: gh * cs, : gw * cs].reshape(gh, cs, gw, cs).permute(0, 2, 1, 3) \
        .reshape(gh * gw, cs * cs)
    s, hi = cells(score), cells(is_hi)
    prio = torch.where(s > 0, s + torch.where(hi, 1e6, 0.0), torch.full_like(s, -1.0))
    n = gh * gw
    flat = torch.arange(cs * cs)
    is_max = prio == prio.max(1, keepdim=True).values
    best = torch.where(is_max, flat, cs * cs).min(1).values          # first maximum
    p = prio[torch.arange(n), best]
    idx = torch.arange(n)
    before = (p[None, :] > p[:, None]) | ((p[None, :] == p[:, None]) & (idx[None, :] < idx[:, None]))
    rank = before.sum(1)
    k = min(budget, n)
    xy = torch.zeros(budget, 2)
    resp = torch.zeros(budget)
    valid = torch.zeros(budget, dtype=torch.bool)
    sel = rank < k
    slot = rank[sel]
    c, b = idx[sel], best[sel]
    xy[slot] = torch.stack([(c % gw * cs + b % cs).float(), (c // gw * cs + b // cs).float()], 1)
    resp[slot] = s[c, b]
    valid[slot] = p[sel] > 0
    return xy, resp, valid


VGA_LEVELS = list(zip(tpyr.pyramid_shapes(480, 640, 8, 1.2), tpyr.features_per_level(1024, 8, 1.2)))


@pytest.mark.parametrize("shape,budget", VGA_LEVELS + [((48, 64), 100)],
                         ids=[f"level{l}" for l in range(8)] + ["fewer_cells_than_budget"])
def test_rank_count_selection_is_top_k(shape, budget):
    h, w = shape
    rng = np.random.RandomState(h * 1000 + w)
    score = rng.randint(0, 4, (h, w)).astype(np.float32)     # ties everywhere
    score[rng.rand(h, w) < 0.7] = 0.0
    is_hi = rng.rand(h, w) < 0.3
    ref = jsel.select_keypoints(jnp.asarray(score), jnp.asarray(is_hi), budget)
    plain = tsel.select_keypoints(torch.from_numpy(score), torch.from_numpy(is_hi), budget)
    got = select_ranked(torch.from_numpy(score), torch.from_numpy(is_hi), budget)
    for g, p, r in zip(got, plain, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if shape == (48, 64):
        assert (h // 8) * (w // 8) < budget and not got[2][(h // 8) * (w // 8):].any()


CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)


@pytest.mark.parametrize("h,w,n_levels", [(240, 320, 4), (80, 96, 2)],
                         ids=["qvga_4_levels", "small_pads_levels"])
def test_describe_twin_after_kernel1_matches_jax_extract(h, w, n_levels):
    poses = synthetic.orbit_trajectory(2, step=0.06)
    img, _ = synthetic.PlaneScene(seed=1).render(CAM, *poses[0], h=240, w=320)
    img = img[:h, :w].astype(np.float32)
    cfg = jext.ExtractorConfig(n_features=512, n_levels=n_levels)
    fj = jext.extract(jnp.asarray(img), cfg)
    dt = k2.describe_tables(h, w, n_levels, 1.2, 512, "cpu")
    stacks = k1.fast_nms(torch.from_numpy(img), dt.lt, cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
    xy, resp, octave, angle, desc, valid = k2.orb_describe(*stacks, dt, torb.OrbTables())
    assert xy.shape == (512, 2) and desc.shape == (512, 16)
    same_kp = (xy.numpy() == np.asarray(fj.xy)).all(1) & (octave.numpy() == np.asarray(fj.octave))
    assert same_kp.mean() >= 0.99
    ok = same_kp & (torb.angle_bins(angle) == torb.angle_bins(torch.from_numpy(np.array(fj.angle)))
                    ).numpy()
    assert ok.mean() >= 0.98
    np.testing.assert_array_equal(desc.numpy()[ok], np.asarray(fj.desc).view(np.int32)[ok])
    np.testing.assert_array_equal(valid.numpy()[same_kp], np.asarray(fj.valid)[same_kp])
    if n_levels == 2:    # level 1 has fewer cells than its budget: zero slots
        budgets = jpyr.features_per_level(512, 2, 1.2)
        assert tuple(dt.budgets) == tuple(budgets)
        gh, gw = dt.grids[1]
        k = min(budgets[1], gh * gw)
        assert k < budgets[1]
        pad = slice(budgets[0] + k, budgets[0] + budgets[1])
        assert (octave[pad] == 1).all()
        for t in (valid, xy, resp, angle, desc):
            assert not t[pad].any()


def assign_and_popc(desc: torch.Tensor, words: torch.Tensor, valid: torch.Tensor):
    """Kernel 5's arithmetic: popc(a AND b) as a 0/1 bit product (exact
    counts), the packed key and its minimum in int64."""
    bits = lambda x: (unpack_signs(x) < 0).float()     # bit set <=> sign -1
    a, b = bits(desc), bits(words)
    both = (a @ b.T).long()                             # popc(a AND b)
    pb = b.sum(1).long()
    key = ((pb[None, :] - 2 * both) << 20) | torch.arange(words.shape[0])[None, :]
    w = key.min(1).values & ((1 << 20) - 1)
    return torch.where(valid, w, -1).to(torch.int32)


@pytest.fixture(scope="module")
def trained():
    v = jvoc.load_vocabulary(jlc.os.path.join(jlc.os.path.dirname(jvoc.__file__),
                                              "trained_vocab.npz"))
    return np.asarray(v.words)


@pytest.mark.parametrize("case", ["trained", "duplicated_words", "ragged_1000x16383"])
def test_and_popcount_key_equals_jax_assign_words(trained, case):
    rng = np.random.RandomState({"trained": 0, "duplicated_words": 1, "ragged_1000x16383": 2}[case])
    words = {"trained": trained, "duplicated_words": np.repeat(trained, 2, axis=0),
             "ragged_1000x16383": trained[:16383]}[case]
    n = 1000 if case.startswith("ragged") else 1024
    d = trained[rng.randint(0, trained.shape[0], n)].copy()
    flips = rng.rand(n, 16, 32) < 0.1
    d ^= (flips.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    d[: n // 8] = trained[rng.randint(0, trained.shape[0], n // 8)]     # exact words: ties at 0
    valid = rng.rand(n) > 0.1
    ref = np.asarray(jvoc.assign_words(jvoc.Vocabulary(jnp.asarray(words),
                                                       jnp.ones(words.shape[0], jnp.float32)),
                                       jnp.asarray(d), jnp.asarray(valid)))
    dt, wt = (torch.from_numpy(np.array(x.view(np.int32))) for x in (d, words))
    vt = torch.from_numpy(valid)
    np.testing.assert_array_equal(assign_and_popc(dt, wt, vt).numpy(), ref)
    np.testing.assert_array_equal(k5.assign_words(dt, wt, vt).numpy(), ref)
    if case == "duplicated_words":
        assert (ref[valid] % 2 == 0).all()      # the lower of two equal words
