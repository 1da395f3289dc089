from . import camera, lie, smallsolve, twoview
from .camera import CameraModel

__all__ = ["camera", "lie", "smallsolve", "twoview", "CameraModel"]
