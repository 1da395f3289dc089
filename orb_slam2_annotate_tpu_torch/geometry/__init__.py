from . import camera, lie, rectify, smallsolve, twoview
from .camera import CameraModel

__all__ = ["camera", "lie", "rectify", "smallsolve", "twoview", "CameraModel"]
