from . import telemetry
from .telemetry import Telemetry, profile_trace

__all__ = ["telemetry", "Telemetry", "profile_trace"]
