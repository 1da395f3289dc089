#!/usr/bin/env python3
"""Where the time of the PyTorch port's slices goes, on one GPU.

    python3 tools/profile_torch_slice.py           # the slice
    python3 tools/profile_torch_slice.py fuse      # the slice with fuse on (chip_smoke.py phase 9)
    python3 tools/profile_torch_slice.py kidnap    # the kidnap run's jump frame
    python3 tools/profile_torch_slice.py loop      # the loop cell's closure
    python3 tools/profile_torch_slice.py rgbd      # the RGB-D cell (chip_smoke.py phase 7)
    python3 tools/profile_torch_slice.py stereo    # the stereo cell (chip_smoke.py phase 8)

Runs chip_smoke.py's slice (its ``slice_setup``: VGA / 1024 features /
8 levels, 48 frames) on cuda:0, times every ``track_mono`` call on the
host clock (ending in a device synchronize), then records the frames from
PROFILE_FROM on with ``torch.profiler``.  With ``kidnap`` it runs
chip_smoke.py's phase-5 sequence instead (``kidnap_setup``), twice with
two Systems: the first run loads every kernel the relocalization uses (CUDA
loads a kernel's code at its first launch, which would otherwise land in
the jump frame), the second is timed and records the jump frame and the
three after it; it prints the relocalization's stages (the ``reloc/*``
spans) with their host time and the device time of the kernels inside
them.  With ``loop`` it runs chip_smoke.py's phase-6 cell (``loop_setup``),
twice the same way: the first run finds the frame whose keyframe closes the
loop, the second records that frame and the LOOP_AFTER frames after it
(where the global BA is folded) and prints the ``loop/*`` spans (detect,
sim3, correct with pose_graph and fuse inside, gba, fold) and the closure
frame's wall and device time.  With ``rgbd`` or ``stereo`` it runs the
slice's frames through ``track_rgbd`` (the rendered depth) or
``track_stereo`` (chip_smoke.py's ``depth_setup``: the right images, each
pair through the identity StereoRectifier of phase 8) and profiles the
frames from PROFILE_FROM on like the slice; ``fuse`` is the slice with
``enable_fuse=True``.  Prints per-stage span totals and per-frame means
(the System's record_function spans), the keyframe chain's stages (the
``mapping/*`` spans: host time, the device time of the kernels launched
inside, and the span's extent on the device), the
host-issued ``aten::mul`` calls per frame, the aten ops (and ``aten::sort``
calls) under ``frontend/extract``, the device time of each
hand-written kernel (in total and a profiled frame), the top device kernels
by total time, and the device
busy share of the profiled window, with the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import glob
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_FROM = 24   # slice: frames before this one warm up; the rest are profiled
RELOC_SPANS = ("tracking/relocalize", "reloc/bow", "reloc/match", "reloc/sample",
               "reloc/hypotheses", "reloc/polish", "reloc/local_map")
LOOP_SPANS = ("loop/detect", "loop/sim3", "loop/correct", "loop/pose_graph", "loop/fuse",
              "loop/gba", "loop/fold")
LOOP_AFTER = 8      # loop: frames recorded after the closure frame
CHAIN_SPANS = ("mapping/insert", "mapping/depth_points", "mapping/cull_recent",
               "mapping/triangulate", "mapping/fuse", "mapping/local_ba", "mapping/kf_cull",
               "mapping/stats")


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
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    sys.path.insert(0, ROOT)
    import numpy as np

    from chip_smoke import KIDNAP_SWEEP, depth_setup, kidnap_setup, loop_setup, slice_setup
    from orb_slam2_annotate_tpu_torch.geometry.rectify import StereoRectifier
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.pipeline import System

    mode = sys.argv[1] if len(sys.argv) == 2 else "slice"
    if len(sys.argv) > 2 or mode not in ("slice", "fuse", "kidnap", "loop", "rgbd", "stereo"):
        sys.exit(f"usage: {sys.argv[0]} [fuse | kidnap | loop | rgbd | stereo]")
    kidnap, loop = mode == "kidnap", mode == "loop"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if loop:
        cam, _, frames, _, cfg = loop_setup()
    else:
        cam, poses, frames, depths, cfg = slice_setup()
    track = lambda slam, k: slam.track_mono(frames[k], k / 30.0)
    if mode == "fuse":
        cfg = dataclasses.replace(cfg, enable_fuse=True)
    if mode == "rgbd":
        cam, _, config = depth_setup(poses)
        cfg = config("rgbd")
        track = lambda slam, k: slam.track_rgbd(frames[k], depths[k], k / 30.0)
    elif mode == "stereo":
        cam, rights, config = depth_setup(poses)
        cfg = config("stereo")
        eye = np.eye(3, dtype=np.float32)
        rect = StereoRectifier(eye, np.zeros(5), eye, eye, eye, np.zeros(5), eye, eye, 480, 640)
        track = lambda slam, k: slam.track_stereo(*rect(frames[k], rights[k]), k / 30.0)
    profile_from, profile_to = PROFILE_FROM, len(frames)
    if kidnap:
        _, _, frames = kidnap_setup(cam)
        profile_from, profile_to = KIDNAP_SWEEP, len(frames)
    # every kernel built before the first frame: a kernel first used inside
    # the profiled window (kernel 6 in the jump frame) would time its build
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.load, _build.SOURCES))
    if kidnap or loop:
        warm = System(cam, cfg, device="cuda")
        closures = []
        for k, img in enumerate(frames):
            n0 = warm.loop_closer.n_loops_closed if loop else 0
            warm.track_mono(img, k / 30.0)
            if loop and warm.loop_closer.n_loops_closed > n0:
                closures.append(k)
        torch.cuda.synchronize()
        del warm
        if loop:
            if not closures:
                sys.exit("the warm-up run closed no loop")
            profile_from = closures[0]
            profile_to = min(len(frames), profile_from + 1 + LOOP_AFTER)
    slam = System(cam, cfg, device="cuda")

    kinds = {"init": [], "track": [], "keyframe": []}
    kinds_ms = {}

    def step(k):
        n_kf = slam.n_keyframes
        was_init = slam.state in ("NO_IMAGES", "NOT_INITIALIZED")
        t0 = time.perf_counter()
        with record_function("closure_frame" if loop and k == profile_from else "frame"):
            track(slam, k)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        kind = "init" if was_init else ("keyframe" if slam.n_keyframes > n_kf else "track")
        kinds[kind].append(ms)
        kinds_ms[k] = ms

    for k in range(profile_from):
        step(k)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(profile_from, profile_to):
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
    n_prof = profile_to - profile_from
    print(f"profiled {n_prof} frames: wall {wall * 1e3:.1f} ms, "
          f"device kernel time {device_us / 1e3:.1f} ms, busy share {device_us / 1e3 / (wall * 1e3):.3f}")
    for name in ("frontend/extract", "tracking/step", "mapping/keyframe", "init/mono",
                 "init/depth"):
        hit = [e for e in events if e.key == name]
        if hit:
            print(f"span {name}: count {hit[0].count} host total {hit[0].cpu_time_total / 1e3:.1f} ms, "
                  f"{hit[0].cpu_time_total / 1e3 / n_prof:.1f} ms a profiled frame")
    for name in CHAIN_SPANS:
        host = [e for e in events if e.key == name and e.device_type == DeviceType.CPU]
        on_dev = [e for e in events if e.key == name and e.device_type == DeviceType.CUDA]
        if host:
            print(f"span {name}: count {host[0].count} host {host[0].cpu_time_total / 1e3:.3f} ms, "
                  f"{host[0].cpu_time_total / 1e3 / host[0].count:.3f} ms a call, kernels inside "
                  f"{host[0].device_time_total / 1e3:.3f} ms, extent on the device "
                  f"{sum(e.device_time_total for e in on_dev) / 1e3:.3f} ms")
    if kidnap or loop:
        what = "jump frame" if kidnap else "closure frame"
        print(f"{what} {profile_from}: {kinds_ms[profile_from]:.2f} ms wall; frames after it "
              f"{[round(kinds_ms[k], 2) for k in range(profile_from + 1, profile_to)]} ms; state "
              f"{slam.state}" + (f"; loops closed {slam.loop_closer.n_loops_closed}, global BAs "
                                 f"folded {slam.loop_closer.n_gba_folded}" if loop else ""))
        for name in (RELOC_SPANS if kidnap else ("closure_frame",) + LOOP_SPANS):
            host = [e for e in events if e.key == name and e.device_type == DeviceType.CPU]
            on_dev = [e for e in events if e.key == name and e.device_type == DeviceType.CUDA]
            if host:
                print(f"span {name}: count {host[0].count} host {host[0].cpu_time_total / 1e3:.3f} ms, "
                      f"kernels inside {host[0].device_time_total / 1e3:.3f} ms, extent on the "
                      f"device {sum(e.device_time_total for e in on_dev) / 1e3:.3f} ms")
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
                  f"{e.self_device_time_total / 1e3:.3f} ms, {e.self_device_time_total / e.count:.2f} us "
                  f"each, {e.self_device_time_total / 1e3 / n_prof:.4f} ms a profiled frame")
    print(events.table(sort_by="self_device_time_total", row_limit=20))


if __name__ == "__main__":
    main()
