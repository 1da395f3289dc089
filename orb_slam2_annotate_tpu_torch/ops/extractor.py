"""End-to-end ORB extraction for one frame (port of ops/extractor.py), two
wrapper calls: pyramid + blur + FAST + NMS + margin for every level
(kernel 1, one launch), then per-cell selection + IC angle + steered BRIEF
for every level, in level-0 coordinates and padded or cut to n_features
(kernel 2, two launches)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels.fast_nms import fast_nms
from ..kernels.orb_describe import describe_tables, orb_describe
from . import orb


class ExtractorConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    th_fast_hi: float = 20.0
    th_fast_lo: float = 7.0
    margin: int = 19


@dataclasses.dataclass
class Features:
    """Per-frame features, N = n_features: xy [N,2] f32 level-0 raw pixels,
    response [N] f32, octave [N] i32, angle [N] f32, desc [N,16] i32,
    valid [N] bool."""

    xy: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def extract(image: torch.Tensor, tab: orb.OrbTables,
            cfg: ExtractorConfig = ExtractorConfig()) -> Features:
    """image: [H,W] grayscale in [0,255] (u8 or f32), on the device to run on."""
    image = image.to(torch.float32).contiguous()
    H, W = image.shape
    dt = describe_tables(H, W, cfg.n_levels, cfg.scale, cfg.n_features, image.device)
    pyr3, pyr3_blur, score, is_hi = fast_nms(image, dt.lt, cfg.th_fast_lo, cfg.th_fast_hi,
                                             cfg.margin)
    return Features(*orb_describe(pyr3, pyr3_blur, score, is_hi, dt, tab))
