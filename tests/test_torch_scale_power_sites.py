"""The port's scale powers read through ``map_state.scale_power``, on the
CPU for octaves 0..63: the table and the helpers built on it
(``scaled_radius``: tracking's and loop closing's search radii;
``inv_level_sigma2``: tracking's ``inv_sigma2`` and the full-map BA's) give
the bits of the float32 ``1.2 ** k`` / ``1.2 ** (2 k)`` expressions they
replaced (torch's CPU pow), at the bases and octaves each site uses; the
sites that call ``scale_power`` directly (triangulation's gates and scale
ratio, the points' depth band) keep the rest of their arithmetic, so equal
powers give them equal bits, shown here for their compound forms.  So the
CPU path, and its parity with the JAX package, is unchanged; on the card
only the table's bits are used (chip_smoke.py phase 3 holds the card's
values to these).
"""

import pytest
import torch

from orb_slam2_annotate_tpu_torch.pipeline import tracking
from orb_slam2_annotate_tpu_torch.worldmap import map_state as ms

K = torch.arange(64, dtype=torch.int32)
KF = K.to(torch.float32)
SCALE = tracking.SCALE


def same_bits(a, b):
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
    diff = a.view(torch.int32) != b.view(torch.int32)
    assert not bool(diff.any()), f"bits differ at {torch.nonzero(diff).flatten().tolist()}"


@pytest.mark.parametrize("twice", [False, True])
def test_scale_power_is_the_cpu_pow(twice):
    old = SCALE ** ((2.0 if twice else 1.0) * KF)
    same_bits(ms.scale_power(K, SCALE, twice), old)
    same_bits(ms.scale_power(KF, SCALE, twice), old)      # float octaves index the same rows
    same_bits(ms.scale_power(K.long(), 1.2, twice), old)


def test_inv_sigma2_sites():
    """tracking.inv_sigma2 (the pose LM, local BA, the keyframe chain) and the
    full-map BA's inverse sigma^2 (loop_closing.full_map_ba_problem)."""
    old = 1.0 / (1.2 ** (2.0 * KF))
    same_bits(tracking.inv_sigma2(K), old)
    same_bits(ms.inv_level_sigma2(K.reshape(8, 8).reshape(-1)), old)


@pytest.mark.parametrize("base", [15.0, 30.0, 7.5, 11.25, 22.5, 20.0, 1.0])
def test_scaled_radius_sites(base):
    """The motion model's th (15, widened 30), the Sim3 guided match's
    radius_scale x 7.5 (1, 1.5, 3), the loop projection count's 20."""
    same_bits(ms.scaled_radius(base, K, SCALE), base * (SCALE ** KF))
    same_bits(ms.scaled_radius(base, K), base * (1.2 ** KF))


@pytest.mark.parametrize("th", [1.0, 3.0, 5.0])
def test_local_map_radius(th):
    """track_local_map: th x r0 (2.5 or 4 by the viewing angle)."""
    r0 = torch.where(torch.arange(64) % 2 == 0, 2.5, 4.0)
    same_bits(ms.scaled_radius(th * r0, K, SCALE), th * r0 * (SCALE ** KF))


def test_triangulation_gates_and_ratio():
    """local_mapping.create_new_mappoints: the reprojection gates' sigma^2 and
    the octaves' scale ratio."""
    same_bits(ms.scale_power(K, SCALE, twice=True), SCALE ** (2.0 * KF))
    e = torch.linspace(0.0, 1e4, 64)
    assert torch.equal(e < 5.991 * ms.scale_power(K, SCALE, twice=True),
                       e < 5.991 * (SCALE ** (2.0 * KF)))
    o1, o2 = torch.meshgrid(K, K, indexing="ij")
    same_bits(ms.scale_power(o1, SCALE) / ms.scale_power(o2, SCALE),
              (SCALE ** o1.float()) / (SCALE ** o2.float()))


def test_depth_band_powers():
    """map_state._geometry_from_table: the reference octave's scale and the
    top level's ratio."""
    same_bits(ms.scale_power(K), 1.2 ** KF)
    max_dist = torch.linspace(0.5, 40.0, 64)
    for n_levels in range(1, 65):
        nl = torch.tensor(n_levels, dtype=torch.int32)
        same_bits(max_dist / ms.scale_power(nl - 1), max_dist / (1.2 ** (nl - 1).to(torch.float32)))
