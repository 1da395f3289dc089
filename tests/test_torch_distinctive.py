"""Parity of the port's distinctive descriptor (kernel 3b's plain twin,
``kernels/hamming.distinctive_descriptors_plain``) with the descriptor that
worldmap/map_state.py ``_stats_from_table`` computes.

Tolerance: none, the descriptors are integers and must be equal.  ``best``
(the winning observation slot, which the reference does not return) is held
to a numpy recount of the same rule: the least median distance to the
point's other observations, the element of rank (cnt - 1) // 2, the first
slot on ties, slot 0 when cnt = 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, seed, settings
from hypothesis import strategies as st

from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch.kernels import hamming as tk3

torch.set_num_threads(1)

MAX_OBS = 32


def jax_descriptors(kf_desc, obs_kf, obs_ft, obs_cnt):
    """_stats_from_table's descriptor on a map holding these keyframe rows."""
    K, N, _ = kf_desc.shape
    m = jms.empty_map(K, 4, N)._replace(kf_desc=jnp.asarray(kf_desc.view(np.uint32)))
    mask = np.arange(MAX_OBS)[None, :] < obs_cnt[:, None]
    out = jms._stats_from_table(m, jnp.zeros((len(obs_cnt), 3), jnp.float32), jnp.asarray(obs_kf),
                                jnp.asarray(obs_ft), jnp.asarray(obs_cnt), jnp.asarray(mask))
    return np.asarray(out[0]).view(np.int32)


def numpy_best(kf_desc, obs_kf, obs_ft, obs_cnt):
    bits = np.unpackbits(kf_desc.view(np.uint8), axis=-1)             # [K,N,512]
    best = np.zeros(len(obs_cnt), np.int32)
    for q, c in enumerate(obs_cnt):
        if c == 0:
            continue
        b = bits[obs_kf[q, :c], obs_ft[q, :c]].astype(np.int32)
        d = (b[:, None, :] != b[None, :, :]).sum(-1)
        med = np.sort(d, axis=1)[:, (c - 1) // 2]
        best[q] = int(np.argmin(med))
    return best


def check(kf_desc, obs_kf, obs_ft, obs_cnt):
    args = [torch.from_numpy(a) for a in (kf_desc, obs_kf, obs_ft, obs_cnt)]
    desc, best = tk3.distinctive_descriptors_plain(*args)
    assert desc.dtype == torch.int32 and best.dtype == torch.int32
    np.testing.assert_array_equal(desc.numpy(), jax_descriptors(kf_desc, obs_kf, obs_ft, obs_cnt))
    np.testing.assert_array_equal(best.numpy(), numpy_best(kf_desc, obs_kf, obs_ft, obs_cnt))
    # on the CPU the wrapper is the twin and launches nothing
    n0 = tk3.distinctive_descriptors.launches
    for a, b in zip(tk3.distinctive_descriptors(*args), (desc, best)):
        assert torch.equal(a, b)
    assert tk3.distinctive_descriptors.launches == n0
    return best.numpy()


def random_desc(rng, *shape):
    return rng.randint(-2**31, 2**31, (*shape, 16), dtype=np.int64).astype(np.int32)


def table(rng, Q, K, N, cnt):
    obs_kf = rng.randint(0, K, (Q, MAX_OBS)).astype(np.int32)
    obs_ft = rng.randint(0, N, (Q, MAX_OBS)).astype(np.int32)
    return obs_kf, obs_ft, np.asarray(cnt, np.int32)


def test_ragged_counts():
    # every count from 0 to 32, twice, on noisy copies of a few source rows
    # so that the medians differ from point to point
    rng = np.random.RandomState(0)
    K, N = 6, 40
    src = random_desc(rng, 4)
    flips = (rng.rand(K, N, 16, 32) < 0.2) * (1 << np.arange(32, dtype=np.int64))
    kf_desc = (src[rng.randint(0, 4, (K, N))].view(np.uint32)
               ^ flips.sum(-1).astype(np.uint32)).view(np.int32)
    cnt = np.concatenate([np.arange(MAX_OBS + 1)] * 2)
    best = check(kf_desc, *table(rng, len(cnt), K, N, cnt))
    assert best[0] == 0 and len(set(best.tolist())) > 5


def test_ties_and_repeated_descriptors():
    rng = np.random.RandomState(1)
    K, N = 3, 8
    kf_desc = random_desc(rng, K, N)
    kf_desc[1, :] = kf_desc[0, 0]          # keyframe 1 holds one descriptor 8 times
    kf_desc[2, 1] = kf_desc[2, 0]
    obs_kf = np.zeros((6, MAX_OBS), np.int32)
    obs_ft = np.zeros((6, MAX_OBS), np.int32)
    obs_kf[0, :5] = 1                      # five equal rows: every median 0, slot 0 wins
    obs_ft[0, :5] = np.arange(5)
    obs_kf[1, :2], obs_ft[1, :2] = 2, [3, 4]   # cnt 2: both medians 0, slot 0 wins
    obs_kf[2, :4], obs_ft[2, :4] = 2, [5, 0, 1, 6]   # a repeated pair in slots 1, 2
    obs_kf[3, :3], obs_ft[3, :3] = [0, 1, 2], [0, 3, 2]  # slots 0 and 1 equal rows
    obs_kf[4, :32] = np.arange(32) % 3     # all 32 slots, with repeats
    obs_ft[4, :32] = np.arange(32) % 8
    cnt = np.array([5, 2, 4, 3, 32, 0], np.int32)   # and cnt = 0: slot 0
    best = check(kf_desc, obs_kf, obs_ft, cnt)
    assert best[0] == 0 and best[1] == 0 and best[5] == 0


@seed(20260101)
@settings(max_examples=25, deadline=None, database=None)
@given(data=st.data())
def test_random_tables(data):
    # a few source descriptors, each observation a noisy copy of one of them,
    # so that medians tie and descriptors repeat
    rng = np.random.RandomState(data.draw(st.integers(0, 2**31 - 1), label="seed"))
    n_src = data.draw(st.integers(1, 6), label="sources")
    noise = data.draw(st.sampled_from([0.0, 0.02, 0.3]), label="noise")
    cnt = np.asarray(data.draw(st.lists(st.integers(0, MAX_OBS), min_size=8, max_size=8),
                               label="counts"), np.int32)
    K, N = 4, 16
    src = random_desc(rng, n_src)
    flips = (rng.rand(K, N, 16, 32) < noise) * (1 << np.arange(32, dtype=np.int64))
    kf_desc = (src[rng.randint(0, n_src, (K, N))].view(np.uint32)
               ^ flips.sum(-1).astype(np.uint32)).view(np.int32)
    check(kf_desc, *table(rng, 8, K, N, cnt))


@pytest.mark.parametrize("Q", [1, 4096])
def test_shapes(Q):
    # the refresh's own shape (MAX_TOUCHED points) and a single point
    rng = np.random.RandomState(2)
    kf_desc = random_desc(rng, 8, 64)
    obs_kf, obs_ft, cnt = table(rng, Q, 8, 64, rng.randint(0, MAX_OBS + 1, Q))
    desc, best = tk3.distinctive_descriptors_plain(
        *(torch.from_numpy(a) for a in (kf_desc, obs_kf, obs_ft, cnt)))
    assert desc.shape == (Q, 16) and best.shape == (Q,)
    sel = best.numpy()
    np.testing.assert_array_equal(desc.numpy(), kf_desc[obs_kf[np.arange(Q), sel],
                                                         obs_ft[np.arange(Q), sel]])
    assert ((sel >= 0) & ((sel < np.maximum(cnt, 1)))).all()
