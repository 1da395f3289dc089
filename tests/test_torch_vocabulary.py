"""Parity of the port's vocabulary, BoW scoring and keyframe database with
worldmap/vocabulary.py, on seeded numpy descriptors and the reference's
trained 16384-word vocabulary (read by path in the port).

Tolerances: word assignments (kernel 5's plain twin, ties to the lowest
word), candidate slots and ok flags are exactly equal; BoW vectors and L1
scores agree within 1e-6 (integer counts, but an f32 normalising sum taken
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.ops.orb import DESC_WORDS
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.worldmap import vocabulary as jvoc
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.kernels import assign_words as k5
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.worldmap import vocabulary as tvoc

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def descs(rng, n, vocab_words=None, flip=0.0):
    """[n,16] uint32 descriptors: random, or words of the vocabulary with a
    fraction `flip` of their bits flipped."""
    if vocab_words is None:
        return rng.randint(0, 2**32, (n, DESC_WORDS), np.uint64).astype(np.uint32)
    d = vocab_words[rng.randint(0, vocab_words.shape[0], n)].copy()
    mask = rng.rand(n, DESC_WORDS, 32) < flip
    d ^= (mask.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return d


@pytest.fixture(scope="module")
def vocabs():
    ref = jvoc.load_vocabulary(jlc.os.path.join(jlc.os.path.dirname(jvoc.__file__),
                                                "trained_vocab.npz"))
    got = tvoc.load_vocabulary(tlc.TRAINED_VOCAB)
    return ref, got


def test_trained_vocabulary_loads_by_path(vocabs):
    ref, got = vocabs
    assert got.words.dtype == torch.int32 and got.n_words == 16384
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32), np.asarray(ref.words))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(ref.idf))
    back = convert.vocabulary_to_numpy(convert.vocabulary_from_numpy(
        {"words": np.asarray(ref.words), "idf": np.asarray(ref.idf)}, device="cpu"))
    np.testing.assert_array_equal(back["words"], np.asarray(ref.words))
    assert back["words"].dtype == np.uint32


def test_make_vocabulary_same_draws():
    ref = jvoc.make_vocabulary(512, 7)
    got = tvoc.make_vocabulary(512, 7)
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32), np.asarray(ref.words))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(ref.idf))


@pytest.mark.parametrize("kind", ["random", "near_words", "trained_idf_ties"])
def test_assign_words_and_bow(vocabs, kind):
    ref_v, got_v = vocabs
    rng = np.random.RandomState({"random": 0, "near_words": 1, "trained_idf_ties": 2}[kind])
    n = 512
    if kind == "random":
        d = descs(rng, n)
    elif kind == "near_words":
        d = descs(rng, n, np.asarray(ref_v.words), flip=0.08)
    else:
        # half the rows repeat other rows: equal descriptors, equal words
        d = descs(rng, n, np.asarray(ref_v.words), flip=0.3)
        d[n // 2:] = d[: n // 2]
    valid = rng.rand(n) > 0.1
    w_ref = np.asarray(jvoc.assign_words(ref_v, jnp.asarray(d), jnp.asarray(valid)))
    dt, vt = T(d.view(np.int32)), T(valid)
    w_got = tvoc.assign_words(got_v, dt, vt).numpy()
    np.testing.assert_array_equal(w_got, w_ref)
    # the twin without the cached signs gives the same words
    np.testing.assert_array_equal(k5.assign_words_plain(dt, got_v.words, vt).numpy(), w_ref)
    bow_ref = np.asarray(jvoc.bow_vector(ref_v, jnp.asarray(d), jnp.asarray(valid)))
    bow_got = tvoc.bow_vector(got_v, dt, vt).numpy()
    np.testing.assert_allclose(bow_got, bow_ref, atol=1e-6, rtol=0)
    assert k5.assign_words.launches == 0


@pytest.fixture(scope="module")
def database(vocabs):
    """12 keyframe BoW rows of seeded descriptors, 4 of them near copies of
    a query, plus the query's BoW and a covisibility matrix."""
    ref_v, _ = vocabs
    rng = np.random.RandomState(3)
    words = np.asarray(ref_v.words)
    base = descs(rng, 300, words, flip=0.15)
    rows = []
    for k in range(12):
        d = base.copy() if k in (2, 5, 6, 9) else descs(rng, 300, words, flip=0.15)
        flips = rng.rand(*d.shape, 32) < (0.02 + 0.01 * k)
        d ^= (flips.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        rows.append(np.asarray(jvoc.bow_vector(ref_v, jnp.asarray(d), jnp.ones(300, bool))))
    bows = np.zeros((16, 16384), np.float32)
    bows[:12] = np.stack(rows)
    q = np.asarray(jvoc.bow_vector(ref_v, jnp.asarray(base), jnp.ones(300, bool)))
    covis = rng.randint(0, 40, (16, 16)) * (rng.rand(16, 16) < 0.3)
    covis = np.triu(covis, 1)
    covis = (covis + covis.T).astype(np.int32)
    kf_valid = np.zeros(16, bool)
    kf_valid[:12] = True
    kf_valid[6] = False
    return bows, q, covis, kf_valid


def test_l1_scores(database):
    bows, q, _, _ = database
    ref = np.asarray(jvoc.l1_scores(jnp.asarray(bows), jnp.asarray(q)))
    np.testing.assert_allclose(tvoc.l1_scores(T(bows), T(q)).numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_covis", [False, True])
def test_detect_relocalization_candidates(database, with_covis):
    bows, q, covis, kf_valid = database
    c = covis if with_covis else None
    s_ref, ok_ref = jvoc.detect_relocalization_candidates(
        jvoc.KeyFrameDatabase(jnp.asarray(bows)), jnp.asarray(q), jnp.asarray(kf_valid),
        None if c is None else jnp.asarray(c))
    db = convert.database_from_numpy({"bows": bows}, device="cpu")
    s_got, ok_got = tvoc.detect_relocalization_candidates(db, T(q), T(kf_valid),
                                                          None if c is None else T(c))
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok_got.numpy(), ok_ref)
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    assert ok_ref.any()
    if not with_covis:  # the near copies of the query lead
        assert np.asarray(s_ref)[0] in (2, 5, 9)


def test_detect_loop_candidates(database):
    bows, q, _, kf_valid = database
    exclude = np.zeros(16, bool)
    exclude[[5, 11]] = True
    min_score = np.float32(0.02)
    s_ref, ok_ref = jvoc.detect_loop_candidates(
        jvoc.KeyFrameDatabase(jnp.asarray(bows)), jnp.asarray(q), jnp.asarray(kf_valid),
        jnp.asarray(exclude), jnp.asarray(min_score))
    s_got, ok_got = tvoc.detect_loop_candidates(tvoc.KeyFrameDatabase(T(bows)), T(q), T(kf_valid),
                                                T(exclude), T(min_score))
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok_got.numpy(), ok_ref)
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    assert ok_ref.sum() >= 2


def test_database_rows_and_growth(database):
    bows, q, _, _ = database
    db = tvoc.KeyFrameDatabase.create(4, 16384).add(1, T(q))
    assert torch.equal(db.bows[1], T(q)) and float(db.bows.sum()) == pytest.approx(1.0, abs=1e-5)
    assert float(db.erase(1).bows.abs().sum()) == 0.0
    lc = tlc.LoopCloser(None, 4, device="cpu")
    assert lc.vocab.n_words == 16384 and lc.db.bows.shape == (4, 16384)
    lc.grow_db(8)
    assert lc.db.bows.shape == (8, 16384) and float(lc.db.bows.abs().sum()) == 0.0
