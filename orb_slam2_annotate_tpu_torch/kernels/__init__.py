"""Python wrappers of the hand-written CUDA kernels in ../csrc.

Each wrapper takes its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``<wrapper>.launches`` counts launches.
"""

from . import fast_nms, hamming, orb_describe, pose_lm

WRAPPERS = (fast_nms.fast_nms, orb_describe.orb_describe, hamming.hamming_match,
            hamming.hamming_pairwise_batched, pose_lm.pose_linearize, pose_lm.pose_costs)

__all__ = ["fast_nms", "hamming", "orb_describe", "pose_lm", "WRAPPERS"]
