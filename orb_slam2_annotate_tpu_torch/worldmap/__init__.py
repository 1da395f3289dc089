from . import map_state, vocabulary

__all__ = ["map_state", "vocabulary"]
