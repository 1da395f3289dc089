from . import viewer
from .viewer import draw_frame, draw_map

__all__ = ["viewer", "draw_frame", "draw_map"]
