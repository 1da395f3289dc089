"""What the dataset drivers share: argument parsing, the frame timer's
summary, and the trajectory files."""

from __future__ import annotations

import argparse
import statistics

from ..io import trajectory


def parse_args(argv, doc: str, modes: tuple, paths: tuple, optional: tuple = ()):
    """The example driver's positional arguments (`mode`, `paths`, then the
    `optional` ones) plus ``--device``."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("mode", choices=modes)
    for name in paths:
        p.add_argument(name)
    for name in optional:
        p.add_argument(name, nargs="?")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def save_trajectories(slam, kitti: bool = False) -> None:
    """CameraTrajectory.txt (TUM, or KITTI's 3x4 rows) and
    KeyFrameTrajectory.txt (TUM) in the current directory, as the
    reference's drivers write them."""
    traj = slam.frame_trajectory()
    if kitti:
        trajectory.save_kitti("CameraTrajectory.txt", [T for _, T in traj if T is not None])
    else:
        trajectory.save_tum("CameraTrajectory.txt",
                            [(r.timestamp, T) for r, (_, T) in zip(slam.records, traj)
                             if T is not None])
    ts_of = {r.frame_id: r.timestamp for r in slam.records}
    trajectory.save_tum("KeyFrameTrajectory.txt",
                        [(ts_of[fid], T) for fid, T in slam.keyframe_trajectory() if fid in ts_of])


def summary(slam, times: list) -> dict:
    """Print the median and mean frame time; return the run's numbers."""
    med = statistics.median(times)
    mean = sum(times) / len(times)
    print(f"median tracking time: {med * 1e3:.1f} ms  mean: {mean * 1e3:.1f} ms")
    return {"frames": len(times), "tracked": sum(not r.lost for r in slam.records),
            "keyframes": slam.n_keyframes, "map_points": slam.n_mappoints,
            "frame_ms_median": 1e3 * med, "frames_per_s": len(times) / sum(times),
            "frame_s": list(times)}
