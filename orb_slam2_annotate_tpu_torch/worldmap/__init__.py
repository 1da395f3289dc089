from . import map_state

__all__ = ["map_state"]
