"""Per-frame measurement record (port of pipeline/frame.py): mono, RGB-D and
stereo frames.

* mono: extract + undistort;
* rgbd: + the depth map looked up at each raw keypoint, ur = u - bf / d;
* stereo: both images extracted (kernels 1 and 2, twice), the left
  keypoints undistorted, then the row-band match, SAD refinement, depth and
  acceptance in one kernel-9 launch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.camera import CameraModel, undistort_pixels
from ..kernels.stereo import stereo_match
from ..ops import matching, pyramid
from ..ops.extractor import ExtractorConfig, extract
from ..ops.orb import OrbTables

# the stereo match's acceptance (the reference's (TH_HIGH + TH_LOW) // 2)
TH_STEREO = (matching.TH_HIGH + matching.TH_LOW) // 2


@dataclasses.dataclass
class Frame:
    xy: torch.Tensor        # [N,2] undistorted level-0 pixels
    xy_raw: torch.Tensor    # [N,2] raw pixels
    ur: torch.Tensor        # [N] virtual right u (<0 mono / no match)
    depth: torch.Tensor     # [N] depth (<=0 unknown)
    octave: torch.Tensor    # [N] i32
    angle: torch.Tensor     # [N]
    response: torch.Tensor  # [N]
    desc: torch.Tensor      # [N,16] i32
    valid: torch.Tensor     # [N] bool


def _frame(f, xy_und, ur, depth) -> Frame:
    return Frame(xy=xy_und, xy_raw=f.xy, ur=ur, depth=depth, octave=f.octave, angle=f.angle,
                 response=f.response, desc=f.desc, valid=f.valid)


def make_frame_mono(image: torch.Tensor, cam: CameraModel, tab: OrbTables,
                    cfg: ExtractorConfig) -> Frame:
    f = extract(image, tab, cfg)
    n = f.xy.shape[0]
    dev = f.xy.device
    return _frame(f, undistort_pixels(cam, f.xy), torch.full((n,), -1.0, device=dev),
                  torch.zeros(n, device=dev))


def make_frame_rgbd(image: torch.Tensor, depth_map: torch.Tensor, cam: CameraModel,
                    tab: OrbTables, cfg: ExtractorConfig) -> Frame:
    """depth_map [H,W] f32 metric depth (0 = invalid), read at each raw
    keypoint rounded half to even and clipped to the image."""
    f = extract(image, tab, cfg)
    xy_und = undistort_pixels(cam, f.xy)
    h, w = depth_map.shape
    xi = torch.round(f.xy[:, 0]).long().clamp(0, w - 1)
    yi = torch.round(f.xy[:, 1]).long().clamp(0, h - 1)
    d = depth_map[yi, xi]
    has_d = d > 0
    ur = torch.where(has_d, xy_und[:, 0] - torch.full_like(d, cam.bf) / torch.clamp_min(d, 1e-6),
                     -1.0)
    return _frame(f, xy_und, ur, torch.where(has_d, d, 0.0))


def make_frame_stereo(image_l: torch.Tensor, image_r: torch.Tensor, cam: CameraModel,
                      tab: OrbTables, cfg: ExtractorConfig) -> Frame:
    """A rectified pair [H,W] (u8 or f32) -> the left frame with per-feature
    ur and depth where the stereo match is accepted."""
    image_l = image_l.to(torch.float32).contiguous()
    image_r = image_r.to(torch.float32).contiguous()
    fl = extract(image_l, tab, cfg)
    fr = extract(image_r, tab, cfg)
    xy_und = undistort_pixels(cam, fl.xy)
    scales = pyramid.level_scales(cfg.n_levels, cfg.scale, device=image_l.device)
    ur, depth, _, _, _ = stereo_match(fl.xy, fl.octave, fl.valid, fl.desc, fr.xy, fr.octave,
                                      fr.valid, fr.desc, xy_und[:, 0].contiguous(), image_l,
                                      image_r, scales, cam.fx, cam.bf, TH_STEREO)
    return _frame(fl, xy_und, ur, depth)
