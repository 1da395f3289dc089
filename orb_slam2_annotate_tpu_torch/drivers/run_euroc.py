"""Driver for EuRoC MAV sequences (port of examples/run_euroc.py; the
mono_euroc.cc / stereo_euroc.cc analog).

    python -m orb_slam2_annotate_tpu_torch.drivers.run_euroc mono|stereo <settings.yaml> <mav0_dir> <timestamps.txt>
      [--device cuda|cpu]

When the settings file carries LEFT./RIGHT. K/D/R/P blocks (the format of
the reference's Examples/Stereo/EuRoC.yaml), each stereo pair is rectified
on the device before tracking (kernel 10; stereo_euroc.cc:62-90 does it
with cv::initUndistortRectifyMap and cv::remap).  Mono mode undistorts the
keypoints inside the frame build instead.  Writes CameraTrajectory.txt and
KeyFrameTrajectory.txt (TUM format) in the current directory.
"""

from __future__ import annotations

import time

from ..io import config, datasets, native_loader
from ..pipeline import System
from ._common import parse_args, save_trajectories, summary


def main(argv=None) -> dict:
    a = parse_args(argv, __doc__, ("mono", "stereo"), ("settings", "sequence", "timestamps"))
    st = config.load_settings(a.settings, sensor=a.mode, width=752, height=480)
    slam = System(st.cam, st.slam, device=a.device)
    stereo = a.mode == "stereo"
    rectifier = config.load_stereo_rectification(a.settings, a.device) if stereo else None
    if rectifier is not None:
        print("rectifying with LEFT./RIGHT. K/D/R/P maps from settings")
    samples = (datasets.read_euroc_stereo(a.sequence, a.timestamps) if stereo
               else datasets.read_euroc_mono(a.sequence, a.timestamps))
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
                if rectifier is not None:
                    il, ir = rectifier(il, ir)
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
    save_trajectories(slam)
    return summary(slam, times)


if __name__ == "__main__":
    main()
