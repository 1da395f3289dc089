"""The free runner's stages in the port (worldmap/map_state.clear_map,
pipeline/policy.keyframe_bows, pipeline/loop_closing.push_loop_edge,
batch_detect_loops and free_loop_stage) against the JAX package, on numpy
inputs made from a seed.

Maps: the constructed-drift map of tests/test_torch_loop_closing.py (N =
128 features; keyframe 11 revisits keyframe 0's scene with a drift of
(0.25, 0.1, -0.15) m) and a teleport copy whose keyframe 11 sits 2 m off,
which the drift gate rejects.  Here every one of the K = 12 slots holds a
keyframe, and keyframe k shares its first 6 + 5 k descriptors (keyframes 0
and 11: 8) with a common pool, so that every BoW score is clearly positive
and no two are equal: with disjoint word sets a score is 0 in exact
arithmetic, and which side of 0 the float sum lands depends on its order,
which torch cannot take from XLA.

Tolerances: clear_map, push_loop_edge, batch_detect_loops (cands, ok,
cand_covis) exactly equal; keyframe_bows: the word assignment exactly equal
and the rows within 1e-6 (bow_vector's bound in
tests/test_torch_vocabulary.py).  free_loop_stage is fed the reference's
own draws (jax.random's sampled triples, ROADMAP's RANSAC-parity rule) and
held to the reference in three cases (closes, rejected by the drift gate,
in cooldown): the closed flag, streaks, loop-edge ring, n_loops and
last_loop_nkf exactly equal, the database row within 1e-6, the diag's
counts exactly equal (its streak and flags too), the closure record's
integer entries exactly equal and its s12 within 1e-4 (kernel 8's
tolerance); after the correction kf_obs and mp_valid exactly equal, and
keyframe poses and point positions within 1e-3 (the bound
tests/test_torch_loop_closing.py puts on the whole closure).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.ops.orb import DESC_WORDS as DW
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.pipeline import policy as jpolicy
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu.worldmap import vocabulary as jvoc
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.pipeline import policy as tpolicy
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

torch.set_num_threads(1)

ARGS = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
K, P, N = 12, 2048, 128
SLOT, CAND = 11, 0
SEED_KEY = 13


def T(a):
    return torch.from_numpy(np.array(a))


def port_map(m) -> tms.MapState:
    return convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                        device="cpu")


def drift_map(drift):
    """Keyframes 0-10 sweep away and back over their own random scenes;
    keyframe 11 truly sits at keyframe 0's pose and sees its scene, but is
    estimated `drift` off and holds its own copies of the points."""
    rng = np.random.RandomState(7)
    m = jms.empty_map(K, P, N)
    X0 = rng.uniform([-2, -2, 4], [2, 2, 8], (N, 3)).astype(np.float32)
    desc0 = rng.randint(0, 2**32, (N, DW), np.uint64).astype(np.uint32)
    pool = np.random.RandomState(11).randint(0, 2**32, (64, DW), np.uint64).astype(np.uint32)
    desc0[:8] = pool[:8]

    def add_kf(m, slot, t, Xw, desc):
        Xc = Xw + t
        uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 160, 400 * Xc[:, 1] / Xc[:, 2] + 120],
                      1).astype(np.float32)
        base = slot * N
        m = jms.insert_keyframe(
            m, jnp.asarray(slot), jnp.eye(3), jnp.asarray(t), slot, float(slot), jnp.asarray(uv),
            jnp.full((N,), -1.0), jnp.zeros((N,)), jnp.zeros((N,), jnp.int32), jnp.zeros((N,)),
            jnp.asarray(desc), jnp.ones((N,), bool), jnp.arange(base, base + N, dtype=jnp.int32))
        return m._replace(mp_pos=m.mp_pos.at[base:base + N].set(jnp.asarray(Xw)),
                          mp_valid=m.mp_valid.at[base:base + N].set(True),
                          mp_desc=m.mp_desc.at[base:base + N].set(jnp.asarray(desc)))

    m = add_kf(m, 0, np.zeros(3, np.float32), X0, desc0)
    for k in range(1, 11):
        Xk = rng.uniform([-2, -2, 4], [2, 2, 8], (N, 3)).astype(np.float32)
        dk = rng.randint(0, 2**32, (N, DW), np.uint64).astype(np.uint32)
        dk[:6 + 5 * k] = pool[:6 + 5 * k]
        m = add_kf(m, k, np.array([-0.3 * min(k, 11 - k), 0, 0], np.float32), Xk, dk)
    drift = np.asarray(drift, np.float32)
    m = add_kf(m, SLOT, drift, X0 - drift, desc0)
    return jms.update_mappoint_stats(m)


@pytest.fixture(scope="module")
def maps():
    return {"drift": drift_map([0.25, 0.1, -0.15]), "teleport": drift_map([2.0, 0.0, 0.0])}


@pytest.fixture(scope="module")
def vocab():
    lc = jlc.LoopCloser(CAM, K, jlc.LoopCloserConfig())
    return lc.vocab, convert.vocabulary_from_numpy(
        {"words": np.asarray(lc.vocab.words), "idf": np.asarray(lc.vocab.idf)}, device="cpu")


def test_clear_map_agrees(maps):
    m = maps["drift"]
    ref = jms.clear_map(m)
    got = tms.clear_map(port_map(m))
    back = convert.map_state_to_numpy(got)
    for k, v in ref._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        assert back[k].shape == np.asarray(getattr(m, k)).shape
    assert got.device == torch.device("cpu")


def tms_words(tv, m, k):
    from orb_slam2_annotate_tpu_torch.worldmap import vocabulary as tvoc

    return tvoc.assign_words(tv, T(np.asarray(m.kf_desc[k]).view(np.int32)),
                             T(np.asarray(m.kf_feat_valid[k]))).numpy()


def test_keyframe_bows_agrees(maps, vocab):
    jv, tv = vocab
    m = maps["drift"]
    # slot 5 culled: its row must be zero
    m = m._replace(kf_valid=m.kf_valid.at[5].set(False))
    ref = np.asarray(jpolicy.keyframe_bows(jv, m))
    got = tpolicy.keyframe_bows(tv, port_map(m)).numpy()
    for k in range(K):
        np.testing.assert_array_equal(
            tms_words(tv, m, k), np.asarray(jvoc.assign_words(jv, m.kf_desc[k],
                                                               m.kf_feat_valid[k])))
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert not got[5].any() and got[0].sum() == pytest.approx(1.0, abs=1e-5)


def test_push_loop_edge_recycles_the_oldest_past_the_ring():
    L = tlc.MAX_LOOP_EDGES
    assert L == jlc.MAX_LOOP_EDGES == 16
    assert (tlc.MAX_CLOSURE_REC, tlc.CLOSURE_REC_W) == (jlc.MAX_CLOSURE_REC, jlc.CLOSURE_REC_W)
    ja, jb, jk = jnp.zeros(L, jnp.int32), jnp.zeros(L, jnp.int32), jnp.zeros(L, bool)
    ta, tb, tk = torch.zeros(L, dtype=torch.int32), torch.zeros(L, dtype=torch.int32), \
        torch.zeros(L, dtype=torch.bool)
    for n in range(L + 5):
        slot, cand = 3 * n + 7, n
        ja, jb, jk = jlc.push_loop_edge(ja, jb, jk, jnp.asarray(n), jnp.asarray(slot),
                                        jnp.asarray(cand))
        ta, tb, tk = tlc.push_loop_edge(ta, tb, tk, torch.tensor(n), slot, cand)
        for a, b in ((ta, ja), (tb, jb), (tk, jk)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ta[0]) == 3 * L + 7 and int(ta[5]) == 3 * 5 + 7


@pytest.mark.parametrize("gap_kf", [3, 0])
def test_batch_detect_loops_agrees(maps, vocab, gap_kf):
    jv, tv = vocab
    m = maps["drift"]
    bows = jpolicy.keyframe_bows(jv, m)
    ref = jlc.batch_detect_loops(jv, m, bows, gap_kf)
    got = tlc.batch_detect_loops(tv, port_map(m), T(np.asarray(bows)), gap_kf)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # keyframe 11 finds keyframe 0 among its candidates
    ok, cands = np.asarray(ref[1]), np.asarray(ref[0])
    assert CAND in cands[SLOT][ok[SLOT]]


def reference_samples(key, valid: np.ndarray, n_hyp: int) -> np.ndarray:
    """The triples jax.random draws inside the reference's sim3_ransac."""
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, valid.shape[0], (3,), replace=False, p=probs))(keys))


@pytest.fixture(scope="module")
def jax_stage():
    cfg = jlc.LoopCloserConfig()
    return cfg, jax.jit(lambda *a: jlc.free_loop_stage(cfg, *a[:12], frame_id=a[12],
                                                       closure_rec=a[13]))


CASES = {
    # keyframe 0 already streaked twice: the third detection confirms it
    "closes": ("drift", 2, 0),
    "drift gate": ("teleport", 2, 0),
    # the last closure 2 keyframes ago: no candidate is tried
    "cooldown": ("drift", 2, 10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_free_loop_stage_agrees(maps, vocab, jax_stage, case):
    name, streak0, last_nkf = CASES[case]
    jv, tv = vocab
    cfg, jfn = jax_stage
    m = maps[name]
    frame_id = 40
    bows = jpolicy.keyframe_bows(jv, m._replace(kf_valid=m.kf_valid.at[SLOT].set(False)))
    streaks = np.zeros(K, np.int32)
    streaks[CAND] = streak0
    L = jlc.MAX_LOOP_EDGES
    loop = (np.zeros(L, np.int32), np.zeros(L, np.int32), np.zeros(L, bool))
    loop[0][0], loop[1][0], loop[2][0] = 9, 2, True       # one historic edge
    n_loops, crec = np.int32(1), np.zeros((jlc.MAX_CLOSURE_REC, jlc.CLOSURE_REC_W), np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED_KEY), frame_id)
    ref = jfn(CAM, jv, m, bows, jnp.asarray(SLOT), jnp.asarray(streaks), *map(jnp.asarray, loop),
              jnp.asarray(n_loops), jnp.asarray(np.int32(last_nkf)), key,
              jnp.asarray(np.int32(frame_id)), jnp.asarray(crec))
    (rm, rbows, rstreaks, ra, rb, rk, rn, rlast, rclosed, rdiag, rcrec) = ref

    draws = []

    def draw(i, stage, valid, n):
        ks = jax.random.split(jax.random.fold_in(key, i))
        draws.append((i, stage))
        return T(reference_samples(ks[stage], valid.numpy(), n))

    tcfg = tlc.LoopCloserConfig()
    got = tlc.free_loop_stage(tcfg, TCAM, tv, port_map(m), T(np.asarray(bows)), SLOT, T(streaks),
                              *map(T, loop), torch.tensor(n_loops), torch.tensor(np.int32(last_nkf)),
                              draw, frame_id=frame_id, closure_rec=T(crec))
    want_closed = case == "closes"
    assert got.closed == bool(rclosed) == want_closed
    np.testing.assert_array_equal(got.streaks.numpy(), np.asarray(rstreaks))
    for a, b in ((got.loop_a, ra), (got.loop_b, rb), (got.loop_ok, rk), (got.n_loops, rn),
                 (got.last_loop_nkf, rlast)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got.bows.numpy(), np.asarray(rbows), atol=1e-6, rtol=0)
    d_got, d_ref = got.diag.numpy(), np.asarray(rdiag)
    np.testing.assert_array_equal(d_got, d_ref)
    if case == "cooldown":
        assert not draws and d_ref[0] == 0
    else:
        assert d_ref[0] == 1 and d_ref[5] == float(case == "closes")
    c_got, c_ref = got.closure_rec.numpy(), np.asarray(rcrec)
    np.testing.assert_array_equal(np.delete(c_got, 7, 1), np.delete(c_ref, 7, 1))
    np.testing.assert_allclose(c_got[:, 7], c_ref[:, 7], atol=1e-4, rtol=0)
    gm = convert.map_state_to_numpy(got.m)
    for k in ("kf_obs", "mp_valid", "kf_valid", "n_kf"):
        np.testing.assert_array_equal(gm[k], np.asarray(getattr(rm, k)), err_msg=k)
    for k in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(gm[k], np.asarray(getattr(rm, k)), atol=1e-3, rtol=0,
                                   err_msg=k)
    if want_closed:
        assert c_ref[1, 1] == SLOT and c_ref[1, 2] == CAND and c_ref[1, 8] == 2
        assert np.linalg.norm(gm["kf_t"][SLOT]) < 0.08     # keyframe 11 back at keyframe 0
