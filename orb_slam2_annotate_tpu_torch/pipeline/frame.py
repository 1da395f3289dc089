"""Per-frame measurement record (port of pipeline/frame.py, mono only)."""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.camera import CameraModel, undistort_pixels
from ..ops.extractor import ExtractorConfig, extract
from ..ops.orb import OrbTables


@dataclasses.dataclass
class Frame:
    xy: torch.Tensor        # [N,2] undistorted level-0 pixels
    xy_raw: torch.Tensor    # [N,2] raw pixels
    ur: torch.Tensor        # [N] virtual right u (<0 mono)
    depth: torch.Tensor     # [N] depth (<=0 unknown)
    octave: torch.Tensor    # [N] i32
    angle: torch.Tensor     # [N]
    response: torch.Tensor  # [N]
    desc: torch.Tensor      # [N,16] i32
    valid: torch.Tensor     # [N] bool


def make_frame_mono(image: torch.Tensor, cam: CameraModel, tab: OrbTables,
                    cfg: ExtractorConfig) -> Frame:
    f = extract(image, tab, cfg)
    n = f.xy.shape[0]
    dev = f.xy.device
    return Frame(xy=undistort_pixels(cam, f.xy), xy_raw=f.xy,
                 ur=torch.full((n,), -1.0, device=dev), depth=torch.zeros(n, device=dev),
                 octave=f.octave, angle=f.angle, response=f.response, desc=f.desc, valid=f.valid)
