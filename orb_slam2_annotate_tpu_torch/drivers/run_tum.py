"""Driver for TUM RGB-D sequences (port of examples/run_tum.py; the
mono_tum.cc / rgbd_tum.cc analog).

    python -m orb_slam2_annotate_tpu_torch.drivers.run_tum mono <settings.yaml> <sequence_dir>
    python -m orb_slam2_annotate_tpu_torch.drivers.run_tum rgbd <settings.yaml> <sequence_dir> <assoc.txt>
      [--device cuda|cpu]

Writes CameraTrajectory.txt and KeyFrameTrajectory.txt (TUM format) in the
current directory and prints frame times like the reference's drivers
(Examples/Monocular/mono_tum.cc:56-121).  Images, and the 16-bit depth maps
(scaled by DepthMapFactor), are decoded ahead by the native loader.
"""

from __future__ import annotations

import sys
import time

from ..io import config, datasets, native_loader
from ..pipeline import System
from ._common import parse_args, save_trajectories, summary


def main(argv=None) -> dict:
    a = parse_args(argv, __doc__, ("mono", "rgbd"), ("settings", "sequence"), ("associations",))
    if a.mode == "rgbd" and a.associations is None:
        sys.exit("rgbd needs an association file")
    st = config.load_settings(a.settings, sensor=a.mode)
    slam = System(st.cam, st.slam, device=a.device)
    rgbd = a.mode == "rgbd"
    samples = (datasets.read_tum_rgbd(a.sequence, a.associations) if rgbd
               else datasets.read_tum_mono(a.sequence))
    images = native_loader.PrefetchLoader([s.rgb_path if rgbd else s.image_path for s in samples])
    depths = native_loader.PrefetchLoader([s.depth_path for s in samples]) if rgbd else None
    times = []
    try:
        for i, s in enumerate(samples):
            t0 = time.perf_counter()
            if rgbd:
                slam.track_rgbd(images[i], depths[i] / st.depth_map_factor, s.timestamp)
            else:
                slam.track_mono(images[i], s.timestamp)
            times.append(time.perf_counter() - t0)
            if i % 50 == 0:
                print(f"frame {i}/{len(samples)} kf={slam.n_keyframes} mp={slam.n_mappoints} "
                      f"{times[-1] * 1e3:.0f} ms")
    finally:
        images.close()
        if depths is not None:
            depths.close()
    save_trajectories(slam)
    return summary(slam, times)


if __name__ == "__main__":
    main()
