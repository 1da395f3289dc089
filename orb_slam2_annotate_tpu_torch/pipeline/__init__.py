from . import frame, local_mapping, loop_closing, policy, system, tracking
from .frame import Frame, make_frame_mono
from .system import SlamConfig, System, mono_slice_config

__all__ = ["frame", "local_mapping", "loop_closing", "policy", "system", "tracking", "Frame", "make_frame_mono",
           "SlamConfig", "System", "mono_slice_config"]
