"""Settings loader for the reference's OpenCV FileStorage YAML files (port of
io/config.py).

The reference reads Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,fps,RGB,bf,width,
height}, ThDepth, DepthMapFactor, ORBextractor.{nFeatures,scaleFactor,
nLevels,...} and, for a stereo rig, the LEFT./RIGHT. K/D/R/P blocks
(Tracking.cc:53-151, Examples/Stereo/EuRoC.yaml).  The JAX package parses
them with PyYAML after stripping the FileStorage-isms; the port parses the
subset those files use itself, with PyYAML's rules for plain scalars, so it
gives the same dict and needs no YAML package:

- the ``%YAML:1.0`` directive and ``---`` lines (skipped);
- ``key: scalar`` lines, and ``#`` comments;
- nested blocks by indentation, such as ``!!opencv-matrix`` nodes with
  ``rows``, ``cols``, ``dt`` and ``data``;
- ``[a, b, ...]`` lists, which may span lines and may follow ``data:``
  with no space.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from ..geometry.camera import CameraModel
from ..pipeline.system import SlamConfig

# PyYAML's implicit resolvers (YAML 1.1) for the plain scalars these files hold
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _scalar(text: str):
    """A plain or quoted scalar, typed as PyYAML types it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s in _TRUE
    if _INT.match(s):
        v = s.replace("_", "")
        sign, digits = (-1, v[1:]) if v[0] == "-" else (1, v.lstrip("+"))
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith("inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        return float("nan") if v.endswith("nan") else float(v)
    return s


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(text: str):
    """A scalar, or a `[...]` list of scalars."""
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated list: {s[:40]}...")
        inner = s[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    return _scalar(s)


def parse_opencv_yaml(text: str) -> dict:
    """The dict PyYAML's safe_load gives for `text` once the reference's
    loader has stripped it (io/config.py of the JAX package)."""
    text = text.replace("!!opencv-matrix", "").replace("data:[", "data: [")
    lines = []
    for raw in text.splitlines():
        if raw.startswith("%YAML") or raw.strip().startswith("---"):
            continue
        ln = _strip_comment(raw).rstrip()
        if ln.strip():
            lines.append(ln)
    root: dict = {}
    stack = [(-1, root)]          # (indent, the mapping at that indent)
    i = 0
    while i < len(lines):
        ln = lines[i]
        indent = len(ln) - len(ln.lstrip(" "))
        key, sep, rest = ln.strip().partition(":")
        if not sep:
            raise ValueError(f"not a `key: value` line: {ln!r}")
        # a list may span lines: join until its brackets balance
        while rest.count("[") > rest.count("]") and i + 1 < len(lines):
            i += 1
            rest += " " + lines[i].strip()
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key = _scalar(key)
        nxt = lines[i + 1] if i + 1 < len(lines) else ""
        if not rest.strip() and len(nxt) - len(nxt.lstrip(" ")) > indent:
            parent[key] = {}
            stack.append((indent, parent[key]))
        else:
            parent[key] = _value(rest)
        i += 1
    return root


def load_opencv_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read())


def opencv_matrix(node: dict) -> np.ndarray:
    """A parsed `!!opencv-matrix` node {rows, cols, dt, data} -> float64 array."""
    return np.asarray(node["data"], np.float64).reshape(int(node["rows"]), int(node["cols"]))


def load_stereo_rectification(path: str, device="cuda"):
    """A StereoRectifier on `device` from a settings file with LEFT./RIGHT.
    K/D/R/P blocks (the reference applies them with
    cv::initUndistortRectifyMap, Examples/Stereo/stereo_euroc.cc:62-90), or
    None when the file has no such block."""
    d = load_opencv_yaml(path)
    if "LEFT.K" not in d:
        return None
    from ..geometry.rectify import StereoRectifier

    h = int(d.get("LEFT.height", d.get("Camera.height", 480)))
    w = int(d.get("LEFT.width", d.get("Camera.width", 752)))
    mats = [opencv_matrix(d[f"{side}.{k}"]) for side in ("LEFT", "RIGHT") for k in "KDRP"]
    return StereoRectifier(*mats, height=h, width=w, device=device)


@dataclasses.dataclass
class Settings:
    cam: CameraModel
    slam: SlamConfig
    fps: float
    rgb_order: int
    depth_map_factor: float


def load_settings(path: str, sensor: str = "mono", width: int = 640,
                  height: int = 480) -> Settings:
    """Camera, SlamConfig and the stream's settings from a settings file;
    `width` / `height` apply when it has no Camera.width / height."""
    d = load_opencv_yaml(path)
    g = lambda k, default=0.0: float(d.get(k, default))
    width = int(g("Camera.width", width))
    height = int(g("Camera.height", height))
    cam = CameraModel.create(
        fx=g("Camera.fx"), fy=g("Camera.fy"), cx=g("Camera.cx"), cy=g("Camera.cy"),
        k1=g("Camera.k1"), k2=g("Camera.k2"), p1=g("Camera.p1"), p2=g("Camera.p2"),
        k3=g("Camera.k3"), bf=g("Camera.bf"), width=width, height=height)
    n_features = int(g("ORBextractor.nFeatures", 1024))
    slam = SlamConfig(
        sensor=sensor, n_features=n_features, n_levels=int(g("ORBextractor.nLevels", 8)),
        scale=g("ORBextractor.scaleFactor", 1.2), th_depth=g("ThDepth", 40.0),
        # the reference's mono-init gate of 100 matches assumes 1000 features
        # (Tracking.cc:625); the JAX package scales it with nFeatures
        init_min_matches=min(100, max(50, n_features // 8)))
    return Settings(cam=cam, slam=slam, fps=g("Camera.fps", 30.0),
                    rgb_order=int(g("Camera.RGB", 1)),
                    depth_map_factor=g("DepthMapFactor", 1.0))
