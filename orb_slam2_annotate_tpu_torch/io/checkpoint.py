"""Map checkpoint / resume (port of io/checkpoint.py).

The reference's on-disk format, unchanged: one compressed ``.npz`` holding a
``map_<field>`` array per MapState field and a ``header`` array, the JSON
header's bytes as uint8 (``format_version``, K, P, N and the caller's
``extra``).  Descriptor fields are written as uint32, as the reference
writes them: the port's int32 words are viewed as uint32 on save and back as
int32 on load, bit for bit, so a file written by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..parallel.points import full_map
from ..worldmap.map_state import MapState

FORMAT_VERSION = 1
_DESC_FIELDS = ("kf_desc", "mp_desc")


def save_map(path: str, m: MapState, extra: dict | None = None) -> None:
    """Write the map (and optional JSON-able metadata) to an .npz file.  A
    map split over ranks is gathered whole (every rank calls this) and
    written by rank 0, so the file is the same at any world size."""
    mesh = m.mesh
    m = full_map(m)
    if mesh is not None and mesh.rank != 0:
        return
    arrays = {}
    for f in dataclasses.fields(MapState):
        a = getattr(m, f.name).detach().cpu().numpy()
        arrays[f"map_{f.name}"] = a.view(np.uint32) if f.name in _DESC_FIELDS else a
    header = {"format_version": FORMAT_VERSION, "K": m.K, "P": m.P, "N": m.N,
              "extra": extra or {}}
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cuda") -> tuple[MapState, dict]:
    """Read a map checkpoint onto `device`.  Returns (MapState, extra)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported map format {header['format_version']}")
        fields = {}
        for f in dataclasses.fields(MapState):
            a = z[f"map_{f.name}"]
            if f.name in _DESC_FIELDS:
                a = a.astype(np.uint32, copy=False).view(np.int32)
            # np.array, not np.ascontiguousarray: that makes a 0-d array 1-d
            fields[f.name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return MapState(**fields), header.get("extra", {})
