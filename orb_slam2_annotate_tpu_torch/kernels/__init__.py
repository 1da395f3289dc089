"""Python wrappers of the hand-written CUDA kernels in ../csrc.

Each wrapper takes its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``<wrapper>.launches`` counts launches.
"""

from . import assign_words, fast_nms, hamming, orb_describe, pnp_score, pose_lm, remap, sim3, stereo

WRAPPERS = (fast_nms.fast_nms, orb_describe.orb_describe, hamming.hamming_match,
            hamming.distinctive_descriptors, pose_lm.optimize_pose_batched,
            assign_words.assign_words, pnp_score.pnp_hypotheses, sim3.sim3_ransac_solve,
            sim3.sim3_lm_solve, stereo.stereo_match, remap.remap_pair)

__all__ = ["assign_words", "fast_nms", "hamming", "orb_describe", "pnp_score", "pose_lm", "remap", "sim3",
           "stereo", "WRAPPERS"]
