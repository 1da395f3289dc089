"""End-to-end ORB extraction for one frame (port of ops/extractor.py):
pyramid + blur + FAST + NMS + margin for every level (kernel 1, one launch)
-> per-cell selection -> IC angle + steered BRIEF (kernel 2, all levels)
-> level-0 coordinates."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels.fast_nms import fast_nms
from ..kernels.orb_describe import orb_describe
from . import orb, pyramid, select


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


def select_level(score: torch.Tensor, is_hi: torch.Tensor, budget: int, level: int):
    """Corners of one level from its [h,w] score / is_hi: (xy [budget,2]
    level coords, resp, octave, valid)."""
    xy, resp, valid = select.select_keypoints(score, is_hi, budget)
    octave = torch.full((budget,), level, dtype=torch.int32, device=score.device)
    return xy, resp, octave, valid


def extract(image: torch.Tensor, tab: orb.OrbTables,
            cfg: ExtractorConfig = ExtractorConfig()) -> Features:
    """image: [H,W] grayscale in [0,255] (u8 or f32), on the device to run on."""
    image = image.to(torch.float32).contiguous()
    dev = image.device
    lt = pyramid.level_tables(image.shape[0], image.shape[1], cfg.n_levels, cfg.scale, dev)
    pyr3, pyr3_blur, score, is_hi = fast_nms(image, lt, cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
    budgets = pyramid.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)
    parts = [select_level(score[l, :h, :w], is_hi[l, :h, :w], b, l)
             for l, ((h, w), b) in enumerate(zip(lt.shapes, budgets))]
    xy_l, resp, octv, valid = (torch.cat([p[i] for p in parts]) for i in range(4))
    ang, desc = orb_describe(pyr3, pyr3_blur, lt.level_hw, xy_l.contiguous(), octv, valid, tab)

    feats = Features(xy_l * lt.scales[octv.long()][:, None], resp, octv, ang, desc, valid)
    n = feats.xy.shape[0]
    if n < cfg.n_features:
        pad = cfg.n_features - n
        feats = Features(
            torch.cat([feats.xy, torch.zeros(pad, 2, device=dev)]),
            torch.cat([feats.response, torch.zeros(pad, device=dev)]),
            torch.cat([feats.octave, torch.zeros(pad, dtype=torch.int32, device=dev)]),
            torch.cat([feats.angle, torch.zeros(pad, device=dev)]),
            torch.cat([feats.desc, torch.zeros(pad, orb.DESC_WORDS, dtype=torch.int32, device=dev)]),
            torch.cat([feats.valid, torch.zeros(pad, dtype=torch.bool, device=dev)]),
        )
    elif n > cfg.n_features:
        feats = Features(*(getattr(feats, f.name)[: cfg.n_features]
                           for f in dataclasses.fields(Features)))
    return feats
