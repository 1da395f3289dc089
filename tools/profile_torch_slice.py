#!/usr/bin/env python3
"""Where the time of the PyTorch port's monocular slice goes, on one GPU.

    python3 tools/profile_torch_slice.py

Runs chip_smoke.py's slice (its ``slice_setup``: VGA / 1024 features /
8 levels, 48 frames) on cuda:0, times every ``track_mono`` call on the
host clock (ending in a device synchronize), then records the frames from
PROFILE_FROM on with ``torch.profiler``.  Prints per-stage span
totals and per-frame means (the System's record_function spans), the
host-issued ``aten::mul`` calls per frame, the aten ops (and ``aten::sort``
calls) under ``frontend/extract``, the device time of each
hand-written kernel, the top device kernels by total time, and the device
busy share of the profiled window, with the card's name and power limit.
"""

from __future__ import annotations

import glob
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_FROM = 24   # frames before this one warm up; the rest are profiled


def hand_kernels() -> set:
    """The __global__ functions of the checkout's csrc/*.cu."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                    f.read()))
    return names


def inside(event, span: str) -> bool:
    """Whether a profiler event ran under the record_function span `span`."""
    p = event.cpu_parent
    while p is not None:
        if p.name == span:
            return True
        p = p.cpu_parent
    return False


def kernel_name(key: str) -> str:
    """A profiler key's function name: no return type, template or arguments."""
    name = key.split("(")[0].split("<")[0]
    return name[5:] if name.startswith("void ") else name


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    sys.path.insert(0, ROOT)
    from chip_smoke import slice_setup
    from orb_slam2_annotate_tpu_torch.pipeline import System

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cam, _, frames, _, cfg = slice_setup()
    slam = System(cam, cfg, device="cuda")

    kinds = {"init": [], "track": [], "keyframe": []}

    def step(k):
        n_kf = slam.n_keyframes
        was_init = slam.state in ("NO_IMAGES", "NOT_INITIALIZED")
        t0 = time.perf_counter()
        slam.track_mono(frames[k], k / 30.0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        kind = "init" if was_init else ("keyframe" if slam.n_keyframes > n_kf else "track")
        kinds[kind].append(ms)

    for k in range(PROFILE_FROM):
        step(k)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(PROFILE_FROM, len(frames)):
            step(k)
        wall = time.perf_counter() - t0
    print(card)
    for kind, v in kinds.items():
        if v:
            print(f"frames {kind}: n={len(v)} median {statistics.median(v):.2f} ms "
                  f"max {max(v):.2f} ms")
    events = prof.key_averages()
    # kernels only: CPU ops and the record_function spans also carry device time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    n_prof = len(frames) - PROFILE_FROM
    print(f"profiled {n_prof} frames: wall {wall * 1e3:.1f} ms, "
          f"device kernel time {device_us / 1e3:.1f} ms, busy share {device_us / 1e3 / (wall * 1e3):.3f}")
    for name in ("frontend/extract", "tracking/step", "mapping/keyframe", "init/mono"):
        hit = [e for e in events if e.key == name]
        if hit:
            print(f"span {name}: count {hit[0].count} host total {hit[0].cpu_time_total / 1e3:.1f} ms, "
                  f"{hit[0].cpu_time_total / 1e3 / n_prof:.1f} ms a profiled frame")
    in_extract = [e for e in prof.events() if e.name.startswith("aten::")
                  and inside(e, "frontend/extract")]
    print(f"frontend/extract: {len(in_extract) / n_prof:.1f} aten ops a profiled frame (nested "
          f"included), aten::sort {sum(e.name == 'aten::sort' for e in in_extract)}")
    mul = [e for e in events if e.key == "aten::mul"]
    if mul:
        print(f"aten::mul: {mul[0].count} calls, {mul[0].count / n_prof:.1f} a profiled frame")
    hand = hand_kernels()
    for e in events:
        if e.device_type == DeviceType.CUDA and kernel_name(e.key) in hand:
            print(f"hand kernel {e.key[:60]}: {e.count} launches, device "
                  f"{e.self_device_time_total / 1e3:.3f} ms, {e.self_device_time_total / e.count:.2f} us each")
    print(events.table(sort_by="self_device_time_total", row_limit=20))


if __name__ == "__main__":
    main()
