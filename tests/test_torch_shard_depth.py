"""The live map's point axis split over ranks (``shard_points=True``) with
depth, on the CPU: the RGB-D and stereo System and the RGB-D FreeRunner on
tests/test_torch_rgbd.py's cell (12 frames; the stereo pairs' right camera
one baseline to the right), at a world of two (gloo ranks of
tests/_torch_dist_worker.py, cases in tests/_torch_shard_cases.py) against
a world of one.

Held exactly (bit for bit), as tests/test_torch_shard_points.py holds the
mono cells: each rank's trajectory and gathered map equal the world-one
run's, and both ranks' replicated keyframe state is equal.  Every group has
60 s timeouts and every rank a 120 s limit.
"""

import json

import numpy as np
import pytest
import torch

import _torch_shard_cases as cases
from test_torch_shard_points import assert_same, assert_same_map, start_ranks, wait_ranks

torch.set_num_threads(1)

KINDS = ("rgbd", "stereo", "free_rgbd")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The two rank groups, started first so that they run while the test
    computes the world-one side."""
    return [start_ranks("depth", tmp_path_factory.mktemp(f"depth_{i}"),
                        {"spec": json.dumps({"kinds": list(kinds)})})
            for i, kinds in enumerate((KINDS[:2], KINDS[2:]))]


@pytest.fixture(scope="module")
def runs(split):
    whole = {kind: cases.run_depth(kind, shard=False)[:2] for kind in KINDS}
    outs = [o for group in split for o in wait_ranks(group)]
    return whole, outs


@pytest.mark.parametrize("kind", KINDS)
def test_depth_world_two_equals_world_one(runs, kind):
    whole, outs = runs
    traj, m = whole[kind]
    assert np.isfinite(traj[:, 0, 0]).sum() >= 10
    assert int(m["kf_valid"].sum()) >= 3 and int(m["mp_valid"].sum()) > 200
    ranks = [o for o in outs if f"{kind}_traj" in o]
    assert len(ranks) == 2
    for o in ranks:
        assert_same(o[f"{kind}_traj"], traj, f"{kind} trajectory")
        assert_same_map(o, m, prefix=f"{kind}_m_")
    # the replicated state is the same on both ranks
    for k in ranks[0]:
        if k.startswith(f"{kind}_kf_"):
            assert_same(ranks[1][k], ranks[0][k], k)
