"""What kernel 4's design rests on, held on the CPU against the plain twin
and solvers/pose_opt.py:

- the cost reuse: within a round, each iteration's linearization-point cost
  equals the previous iteration's accepted candidate's cost bit for bit, or
  the unchanged cost after a rejection (so the kernel sums the cost once a
  round);
- the twin against JAX at the card's new cases: N = 4096 slots, no valid
  edge, one valid edge;
- the kernel's shared memory at MAX_N within an H100 CTA's, and the twin
  at B = 0.

A one-edge problem has no determined pose (two residual rows, six
unknowns; the damped steps wander the four free directions by rounding), so
there the two are held to what the problem determines: the inlier mask,
the count, and the edge's chi2 under its gate at both returned poses.
"""

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.solvers import pose_opt as jpo
from orb_slam2_annotate_tpu_torch.kernels import pose_lm as tk4
from orb_slam2_annotate_tpu_torch.solvers import pose_opt as tpo

from test_torch_pose_opt import CAM_J, CAM_SJ, CAM_ST, CAM_T, PROBLEMS, T, assert_pose_agrees, \
    jax_pose, make_obs

torch.set_num_threads(1)


def run_twin(cam, obs, R0, t0):
    return tk4.optimize_pose_plain(cam, T(R0), T(t0), *(T(obs[k]) for k in (
        "xw", "uv", "ur", "inv_sigma2", "valid")))


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_linearization_cost_is_the_accepted_cost(monkeypatch, name):
    """Every iteration after a round's first linearizes at the pose it
    accepted (or kept): its cost is that candidate's cost (or the kept
    cost), bit for bit."""
    obs, R0, t0 = make_obs(40 + list(PROBLEMS).index(name), **PROBLEMS[name])
    lin_costs, cand_costs = [], []
    real_lin, real_costs = tk4.pose_linearize_plain, tk4.pose_costs_plain

    def lin(*a):
        H, g, c = real_lin(*a)
        lin_costs.append(c.clone())
        return H, g, c

    def costs(*a):
        out = real_costs(*a)
        cand_costs.append(out.clone())
        return out

    monkeypatch.setattr(tk4, "pose_linearize_plain", lin)
    monkeypatch.setattr(tk4, "pose_costs_plain", costs)
    run_twin(CAM_ST, obs, R0, t0)
    rounds, iters = 4, 5
    assert len(lin_costs) == len(cand_costs) == rounds * iters
    accepted = rejected = 0
    for r in range(rounds):
        for i in range(1, iters):
            k = r * iters + i
            prev, cands = lin_costs[k - 1], cand_costs[k - 1]
            improves = cands < prev
            if bool(improves.any()):
                want = cands[int(torch.argmax(improves.to(torch.uint8)))]
                accepted += 1
            else:
                want = prev
                rejected += 1
            assert torch.equal(lin_costs[k], want), (r, i)
    assert accepted > 0


def test_twin_matches_jax_at_4096_slots():
    obs, R0, t0 = make_obs(50, n=4096, stereo_frac=0.3)
    got = run_twin(CAM_ST, obs, R0, t0)
    assert got[2].shape == (4096,) and int(got[3]) == int(got[2].sum()) > 2000
    assert_pose_agrees(CAM_ST, obs, got, jax_pose(CAM_SJ, obs, R0, t0))


@pytest.mark.parametrize("seed", [51, 52])
def test_twin_matches_jax_without_a_valid_edge(seed):
    """No edge: H = 0 and g = 0, every step is zero and every candidate
    costs what the pose does, so both return the start pose exactly."""
    obs, R0, t0 = make_obs(seed)
    obs["valid"] = np.zeros_like(obs["valid"])
    got = run_twin(CAM_T, obs, R0, t0)
    ref = jax_pose(CAM_J, obs, R0, t0)
    for a, b, start in ((got[0], ref[0], R0), (got[1], ref[1], t0)):
        assert np.array_equal(a.numpy(), np.asarray(b)) and np.array_equal(a.numpy(), start)
    assert not got[2].any() and not np.asarray(ref[2]).any() and int(got[3]) == int(ref[3]) == 0


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_twin_matches_jax_with_one_valid_edge(stereo):
    obs, R0, t0 = make_obs(53, stereo_frac=1.0 if stereo else 0.0)
    one = np.zeros_like(obs["valid"])
    one[np.flatnonzero(obs["valid"])[0]] = True
    obs["valid"] = one
    cam_t, cam_j = (CAM_ST, CAM_SJ) if stereo else (CAM_T, CAM_J)
    got = run_twin(cam_t, obs, R0, t0)
    ref = jax_pose(cam_j, obs, R0, t0)
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert int(got[3]) == int(ref[3]) == 1
    e = np.flatnonzero(one)
    gate = jpo.CHI2_STEREO if stereo else jpo.CHI2_MONO
    for R, t in ((got[0], got[1]), (T(np.asarray(ref[0])), T(np.asarray(ref[1])))):
        r, _, _, ok = tk4.residual_jac(cam_t, R, t, T(obs["xw"][e]), T(obs["uv"][e]), T(obs["ur"][e]))
        assert bool(ok.all()) and float((r * r).sum() * obs["inv_sigma2"][e][0]) <= gate


def test_launch_shape_at_the_limit():
    """A CTA's slots (32 B each) at MAX_N beside the static part fit in an
    H100 CTA's shared memory (chip_smoke.py holds the static part to
    STATIC_SMEM)."""
    assert tk4.MAX_N * tk4.SLOT_BYTES + tk4.STATIC_SMEM <= tk4.SMEM_PER_CTA


def test_batched_twin_without_a_problem():
    obs, R0, t0 = make_obs(54)
    out = tk4.optimize_pose_batched(CAM_T, T(R0)[:0], T(t0)[:0], T(obs["xw"])[None][:0],
                                    T(obs["uv"]), T(obs["ur"]), T(obs["inv_sigma2"]),
                                    T(obs["valid"])[None][:0])
    assert [tuple(a.shape) for a in out] == [(0, 3, 3), (0, 3), (0, 512), (0,)]
    assert out[2].dtype == torch.bool and out[3].dtype == torch.int32


def test_optimize_pose_entry_at_4096_slots():
    """solvers/pose_opt.optimize_pose (the tracking entry) at the kernel's
    limit equals the batched twin's problem 0."""
    obs, R0, t0 = make_obs(55, n=4096)
    got = tpo.optimize_pose(CAM_T, T(R0), T(t0), tpo.PoseObs(**{k: T(v) for k, v in obs.items()}))
    ref = run_twin(CAM_T, obs, R0, t0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
