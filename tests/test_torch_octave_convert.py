"""Device-independent gates of the map-point search (tracking, fuse, loop
closing): the predicted octave (``map_state.predict_octave``), its float ->
int32 conversion (``ops/sorting.int32_saturated``), the distance
(``geometry/lie.norm3``) and the scale powers (``map_state.scale_power``).

XLA converts a float to an integer by saturating (NaN to 0, +-inf and
out-of-range values to the range's ends); torch leaves it to the device (the
CPU gives INT_MIN for +inf, the card INT_MAX), and a new map point's
``mp_max_dist`` is +inf until its first stats refresh.  Held exactly, after
the callers' clip to [0, top octave], against jnp's conversion and the
reference's PredictScale expression.  ``norm3`` and ``scale_power`` give the
CPU's torch.linalg.norm and torch.pow bits exactly (so the card, which
computes both otherwise, matches the CPU): held bit for bit on random
vectors at four scales and on every octave.
"""

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam2_annotate_tpu_torch.geometry.lie import norm3
from orb_slam2_annotate_tpu_torch.ops.sorting import int32_saturated
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

torch.set_num_threads(1)

VALUES = np.array([np.inf, -np.inf, np.nan, 3.5e9, -3.5e9, 0.0, 2.0, 7.0, -3.0, 1e9, 2.5],
                  np.float32)


def test_int32_saturated_matches_xla_after_the_clip():
    ref = np.asarray(jnp.asarray(VALUES).astype(jnp.int32))
    got = int32_saturated(torch.from_numpy(VALUES)).numpy()
    np.testing.assert_array_equal(np.clip(got, 0, 7), np.clip(ref, 0, 7))
    np.testing.assert_array_equal(got[5:9], VALUES[5:9].astype(np.int32))


def test_predict_octave_matches_the_reference():
    """A point whose max distance is +inf (no stats refresh yet) is predicted
    at the top octave, as the reference predicts it (its expression in
    pipeline/loop_closing.py, PredictScale); the rest level by level."""
    rng = np.random.default_rng(19)
    max_dist = np.concatenate([[np.inf, 4.0, 4.0, 1.0],
                               rng.uniform(0.5, 8.0, 2000)]).astype(np.float32)
    dist = np.concatenate([[2.0, 2.0, 1.0, 3.0], rng.uniform(0.3, 6.0, 2000)]).astype(np.float32)
    ratio = jnp.maximum(jnp.asarray(max_dist) / jnp.maximum(jnp.asarray(dist), 1e-9), 1.0)
    ref = np.asarray(jnp.clip(jnp.ceil(jnp.log(ratio) / jnp.log(1.2)).astype(jnp.int32), 0, 7))
    got = tms.predict_octave(torch.from_numpy(max_dist), torch.from_numpy(dist), torch.tensor(7))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0] == 7


def test_norm3_and_scale_power_give_the_cpus_bits():
    gen = torch.Generator().manual_seed(19)
    for scale in (1e-3, 1.0, 10.0, 1e3):
        v = torch.randn(200_000, 3, generator=gen) * torch.rand(200_000, 1, generator=gen) * scale
        assert torch.equal(norm3(v), torch.linalg.norm(v, dim=-1))
        v3 = v.reshape(40, 5000, 3)
        assert torch.equal(norm3(v3), torch.linalg.norm(v3, dim=-1))
    octv = torch.randint(0, 8, (11, 1024), generator=gen, dtype=torch.int32)
    assert torch.equal(tms.scale_power(octv), 1.2 ** octv.to(torch.float32))
    assert torch.equal(tms.scale_power(octv, twice=True), 1.2 ** (2.0 * octv.to(torch.float32)))
