"""Driver for KITTI odometry sequences (port of examples/run_kitti.py; the
mono_kitti.cc / stereo_kitti.cc analog).

    python -m orb_slam2_annotate_tpu_torch.drivers.run_kitti mono|stereo <settings.yaml> <sequence_dir>
      [--device cuda|cpu]

Writes CameraTrajectory.txt in KITTI format (System.cc:424-477) and
KeyFrameTrajectory.txt in TUM format in the current directory, and prints
frame times like the reference's drivers (mono_kitti.cc:56-121).
"""

from __future__ import annotations

import time

from ..io import config, datasets, native_loader
from ..pipeline import System
from ._common import parse_args, save_trajectories, summary


def main(argv=None) -> dict:
    a = parse_args(argv, __doc__, ("mono", "stereo"), ("settings", "sequence"))
    st = config.load_settings(a.settings, sensor=a.mode, width=1241, height=376)
    slam = System(st.cam, st.slam, device=a.device)
    stereo = a.mode == "stereo"
    samples = (datasets.read_kitti_stereo(a.sequence) if stereo
               else datasets.read_kitti_mono(a.sequence))
    left = native_loader.PrefetchLoader([s.left_path if stereo else s.image_path
                                         for s in samples])
    right = native_loader.PrefetchLoader([s.right_path for s in samples]) if stereo else None
    times = []
    try:
        for i, s in enumerate(samples):
            il = left[i]
            ir = right[i] if stereo else None
            t0 = time.perf_counter()
            if stereo:
                slam.track_stereo(il, ir, s.timestamp)
            else:
                slam.track_mono(il, s.timestamp)
            times.append(time.perf_counter() - t0)
            if i % 100 == 0:
                print(f"frame {i}/{len(samples)} kf={slam.n_keyframes} mp={slam.n_mappoints}")
    finally:
        left.close()
        if right is not None:
            right.close()
    slam.flush()
    save_trajectories(slam, kitti=True)
    return summary(slam, times)


if __name__ == "__main__":
    main()
