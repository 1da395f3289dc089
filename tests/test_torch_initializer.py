"""Parity of the port's two-view initializer with solvers/initializer.py.

``torch.Generator`` cannot reproduce ``jax.random``, so the test draws the
RANSAC minimal sets with jax.random exactly as initializer.py:53-58 does and
feeds them to the port's deterministic core.  Tolerances: R and t agree
within 1e-4 (measured ~1e-5: float32 SVDs from two LAPACKs); ``good``, the
good count and the success flags are equal.  Triangulated points agree
within 2e-4 of their depth: the DLT amplifies the ~1e-5 baseline
difference by the depth-to-baseline ratio (~13 for this pair).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.ops import extractor as jext
from orb_slam2_annotate_tpu.ops import matching as jm
from orb_slam2_annotate_tpu.solvers import initializer as jinit
from orb_slam2_annotate_tpu_torch.solvers import initializer as tinit

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def matches():
    poses = synthetic.orbit_trajectory(10, step=0.06)
    scene = synthetic.PlaneScene(seed=1)
    cfg = jext.ExtractorConfig(n_features=512, n_levels=4)
    f0, f1 = (jext.extract(jnp.asarray(scene.render(CAM, *poses[k], h=240, w=320)[0]), cfg)
              for k in (0, 8))
    res = jm.search_for_initialization(f0, f1, window=100.0)
    x2 = f1.xy[jnp.clip(res.idx, 0)]
    return np.asarray(f0.xy), np.asarray(x2), np.asarray(res.matched)


def jax_samples(key, match_mask, n_ransac=200):
    """The minimal sets initialize_two_view draws (initializer.py:53-58)."""
    N = match_mask.shape[0]
    probs = jnp.asarray(match_mask).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, n_ransac)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(k, N, (8,), replace=False, p=probs))(keys))


@pytest.mark.parametrize("seed,min_parallax", [(0, 2.5), (1, 1.0), (7, 2.5)])
def test_initialize_from_samples(matches, seed, min_parallax):
    x1, x2, mm = matches
    assert mm.sum() >= 60
    key = jax.random.PRNGKey(seed)
    ref = jinit.initialize_two_view(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mm), 200, 1.0,
                                    CAM.K, min_parallax_deg=min_parallax)
    got = tinit.initialize_from_samples(T(jax_samples(key, mm)), T(x1), T(x2), T(mm),
                                        T(np.asarray(CAM.K)), 1.0, min_parallax_deg=min_parallax)
    assert bool(got.success) == bool(ref.success)
    assert bool(got.used_homography) == bool(ref.used_homography)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(ref.good))
    assert int(got.n_good) == int(ref.n_good)
    g = np.asarray(ref.good)
    X_ref = np.asarray(ref.points)[g]
    err = np.abs(got.points.numpy()[g] - X_ref) / np.maximum(np.abs(X_ref[:, 2:3]), 1.0)
    assert err.max() <= 2e-4


def test_sample_minimal_sets(matches):
    _, _, mm = matches
    gen = torch.Generator().manual_seed(0)
    s = tinit.sample_minimal_sets(gen, T(mm), 200).numpy()
    assert s.shape == (200, 8)
    assert mm[s].all()
    assert all(len(set(row)) == 8 for row in s)
