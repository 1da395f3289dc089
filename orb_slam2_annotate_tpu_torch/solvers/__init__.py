from . import ba_core, initializer, pnp, pose_opt

__all__ = ["ba_core", "initializer", "pnp", "pose_opt"]
