"""Python wrappers of the hand-written CUDA kernels in ../csrc.

Each wrapper takes its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``<wrapper>.launches`` counts launches.
"""

from . import (assign_words, chol_solve, fast_nms, grid_ba, hamming, lu_solve, orb_describe,
               pnp_score, pose_lm, remap, segment_sum, sim3, stereo)

WRAPPERS = (fast_nms.fast_nms, orb_describe.orb_describe, hamming.hamming_match,
            hamming.distinctive_descriptors, pose_lm.optimize_pose_batched,
            assign_words.assign_words, pnp_score.pnp_hypotheses, sim3.sim3_ransac_solve,
            sim3.sim3_lm_solve, stereo.stereo_match, remap.remap_pair,
            segment_sum.segment_sum, grid_ba.grid_ba_solve, chol_solve.chol_solve,
            lu_solve.lu_solve)

__all__ = ["assign_words", "chol_solve", "fast_nms", "grid_ba", "hamming", "lu_solve",
           "orb_describe", "pnp_score", "pose_lm", "remap", "segment_sum", "sim3", "stereo",
           "WRAPPERS"]
