from . import ba_cg, ba_core, initializer, pnp, pose_graph, pose_opt, sim3

__all__ = ["ba_cg", "ba_core", "initializer", "pnp", "pose_graph", "pose_opt", "sim3"]
