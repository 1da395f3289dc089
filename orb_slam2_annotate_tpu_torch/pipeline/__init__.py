from . import frame, local_mapping, loop_closing, policy, system, tracking
from .frame import Frame, make_frame_mono, make_frame_rgbd, make_frame_stereo
from .system import SlamConfig, System, mono_slice_config

__all__ = ["frame", "local_mapping", "loop_closing", "policy", "system", "tracking", "Frame", "make_frame_mono",
           "make_frame_rgbd", "make_frame_stereo",
           "SlamConfig", "System", "mono_slice_config"]
