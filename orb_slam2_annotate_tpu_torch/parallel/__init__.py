from . import dist_ba, mesh

__all__ = ["dist_ba", "mesh"]
