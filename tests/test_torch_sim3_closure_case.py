"""Kernel 8's twin (``kernels/sim3.sim3_lm_solve`` on CPU tensors) against
the JAX package's ``optimize_sim3`` on a captured input: the closing
attempt's second optimize_sim3 of chip_smoke.py's loop cell (phase 6),
whose scale powers are read through ``map_state.scale_power`` as the tree
reads them (``tests/data/k8_closure_routed.pt``, sim3_lm_solve's arguments
as ``torch.save`` wrote them; chip_smoke.K8_CLOSURE_CASE).  Its LM normal
matrix has a condition number near 9e6 at the solution, so float32 solves
of it part on different devices (chip_smoke.py holds the kernel there by
its robust cost); on the CPU the twin holds to JAX at test_torch_sim3.py's
tolerances: the same count, masks apart on at most 1% of pairs, s, R, t
within 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.solvers import sim3 as jsim3
from orb_slam2_annotate_tpu_torch.kernels import sim3 as ksim3

CASE = os.path.join(os.path.dirname(__file__), "data", "k8_closure_routed.pt")


def test_kernel8_twin_on_the_routed_closure_input_agrees_with_jax():
    args = torch.load(CASE, weights_only=True)
    x1, x2, uv1, uv2, valid, is1, is2, s0, R0, t0, fx, fy, cx, cy, fix_scale, chi2_th, iters = args
    assert is1 is None and is2 is None
    cam = CameraModel.create(fx=fx, fy=fy, cx=cx, cy=cy, width=320, height=240)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jsim3.optimize_sim3(cam, j(s0), j(R0), j(t0), j(x1), j(x2), j(uv1), j(uv2), fix_scale,
                              iters=iters, valid=j(valid), chi2_th=chi2_th)
    s, R, t, inlier, n = ksim3.sim3_lm_solve(*args)
    assert int(n) == int(ref.n_inliers)
    assert (inlier.numpy() != np.asarray(ref.inliers)).mean() <= 0.01
    for a, b in ((ref.s, s), (ref.R, R), (ref.t, t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0.0, atol=1e-4)
