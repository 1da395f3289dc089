from . import dist_ba, mesh, points

__all__ = ["dist_ba", "mesh", "points"]
