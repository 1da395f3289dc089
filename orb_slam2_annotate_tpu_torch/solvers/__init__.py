from . import ba_core, initializer, pose_opt

__all__ = ["ba_core", "initializer", "pose_opt"]
