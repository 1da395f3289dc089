"""Carry state between the reference package and the port.

The reference's records arrive as dicts of numpy arrays (``x._asdict()``
with each field passed through ``np.asarray``).  Descriptor words are uint32
there and int32 bit patterns here; every float table becomes float32 (a
float64 array from numpy would otherwise leak into the port).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry.camera import CameraModel
from .ops.orb import OrbTables, rotated_offsets
from .pipeline.frame import Frame
from .pipeline.local_mapping import CullInfo
from .worldmap.map_state import MapState
from .worldmap.vocabulary import KeyFrameDatabase, Vocabulary

_DESC_FIELDS = ("desc", "kf_desc", "mp_desc", "words")


def _to_torch(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _DESC_FIELDS:
        a = a.astype(np.uint32).view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.int64, np.uint32):
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _DESC_FIELDS else a


def camera_from_numpy(d: dict) -> CameraModel:
    return CameraModel(**{f.name: float(np.float32(d[f.name])) for f in dataclasses.fields(CameraModel)})


def frame_from_numpy(d: dict, device="cpu") -> Frame:
    return Frame(**{f.name: _to_torch(f.name, d[f.name], device) for f in dataclasses.fields(Frame)})


def frame_to_numpy(f: Frame) -> dict:
    return {k.name: _to_numpy(k.name, getattr(f, k.name)) for k in dataclasses.fields(Frame)}


def map_state_from_numpy(d: dict, device="cpu") -> MapState:
    return MapState(**{f.name: _to_torch(f.name, d[f.name], device)
                       for f in dataclasses.fields(MapState)})


def map_state_to_numpy(m: MapState) -> dict:
    return {f.name: _to_numpy(f.name, getattr(m, f.name)) for f in dataclasses.fields(MapState)}


def vocabulary_from_numpy(d: dict, device="cpu") -> Vocabulary:
    return Vocabulary(_to_torch("words", d["words"], device), _to_torch("idf", d["idf"], device))


def vocabulary_to_numpy(v: Vocabulary) -> dict:
    return {"words": _to_numpy("words", v.words), "idf": _to_numpy("idf", v.idf)}


def database_from_numpy(d: dict, device="cpu") -> KeyFrameDatabase:
    return KeyFrameDatabase(_to_torch("bows", d["bows"], device))


_LOOP_COUNTERS = ("n_loops_closed", "n_loop_edges_dropped", "n_stats_overflow", "_last_loop_kf",
                  "_seq")


def loop_closer_state_to_numpy(lc) -> dict:
    """A LoopCloser's state (of either package): database rows, consistency
    streaks, loop edges and counters."""
    d = {"bows": np.array(lc.db.bows if not torch.is_tensor(lc.db.bows) else lc.db.bows.cpu()),
         "streaks": {int(k): int(v) for k, v in lc._streaks.items()},
         "loop_edges": [(int(a), int(b)) for a, b in lc.loop_edges]}
    d.update({k: int(getattr(lc, k)) for k in _LOOP_COUNTERS})
    return d


def loop_closer_state_from_numpy(lc, d: dict):
    """Give the port's LoopCloser `lc` the state `d` (loop_closer_state_to_numpy)."""
    lc.db = KeyFrameDatabase(_to_torch("bows", d["bows"], lc.device))
    lc._streaks = dict(d["streaks"])
    lc.loop_edges = list(d["loop_edges"])
    for k in _LOOP_COUNTERS:
        setattr(lc, k, int(d[k]))
    return lc


def cull_info_from_numpy(d: dict, device="cpu") -> CullInfo:
    return CullInfo(**{f.name: _to_torch(f.name, d[f.name], device)
                       for f in dataclasses.fields(CullInfo)})


def cull_info_to_numpy(c: CullInfo) -> dict:
    return {f.name: _to_numpy(f.name, getattr(c, f.name)) for f in dataclasses.fields(CullInfo)}


def orb_tables_from_numpy(pattern: np.ndarray, rot_offsets: np.ndarray | None = None) -> OrbTables:
    """Tables from the reference's ``orb.PATTERN`` (and ``ROT_OFFSETS``,
    which must equal the steering of that pattern)."""
    rot = rotated_offsets(np.asarray(pattern))
    if rot_offsets is not None and not np.array_equal(rot, np.asarray(rot_offsets)):
        raise ValueError("ROT_OFFSETS do not match the steered PATTERN")
    return OrbTables(rot)
