#!/usr/bin/env python3
"""The host time of kernels 9's and 10's wrappers, split by part, on the card.

    python3 tools/stereo_host_parts.py

Each part is timed by chip_smoke.host_ns: time.perf_counter_ns around
batches of 200 back-to-back calls, 10,000 calls in all, the card drained
between batches.  Beside the current wrappers' parts (``check_inputs``,
``check_maps``, ``check_images``, the ``empty_like`` outputs, the stream
pointer, the bare ctypes call with its launch, ``remap.launch``, the
rectifier's pass-through, the whole calls) stand the pieces of the earlier
call paths they replaced: a four-test check a tensor (``generic_check``
below), separate alignment reads, ``torch.empty`` outputs, one [2, Ho, Wo]
output viewed twice, and the rectifier's ``as_tensor().to().contiguous()``.
Inputs: kernel 9 on the VGA pair of chip_smoke.py's phase 3
(tools/k9_stages.py vga_inputs, 1024 x 1024 keypoints), kernel 10 on that
pair and phase 3's distortion maps, and one ``grid_sample`` call on them.
Prints one JSON line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def generic_check(t, name, dtype, shape, device):
    """The earlier call paths' check: four separate tests a tensor."""
    if t.dtype != dtype:
        raise TypeError(name)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(name)
    if not t.is_contiguous():
        raise ValueError(name)
    if t.device != device:
        raise ValueError(name)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("stereo_host_parts: CUDA is not available")
    from chip_smoke import host_ns
    from k9_stages import vga_inputs
    from orb_slam2_annotate_tpu_torch.geometry import rectify
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import remap as k10
    from orb_slam2_annotate_tpu_torch.kernels import stereo as k9
    from orb_slam2_annotate_tpu_torch.pipeline.frame import TH_STEREO

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    f32, i32 = torch.float32, torch.int32
    cam, t9 = vga_inputs(dev)
    args9 = (*t9, cam.fx, cam.bf, TH_STEREO)
    names9 = ("xy_l", "oct_l", "valid_l", "desc_l", "xy_r", "oct_r", "valid_r", "desc_r", "x_und",
              "image_l", "image_r", "scales")
    specs9 = [(t, n, t.dtype, tuple(t.shape)) for t, n in zip(t9, names9)]
    N, M, H, W, L, ptrs9 = k9.check_inputs(*t9, TH_STEREO, dev)
    outs9 = k9.stereo_match(*args9)
    ws9 = torch.zeros(2, dtype=i32, device=dev)
    optrs9 = [o.data_ptr() for o in outs9] + [ws9.data_ptr()]
    lib9 = k9._lib()
    parts9 = {
        "earlier: 12 four-test checks": lambda: [generic_check(*sp, dev) for sp in specs9],
        "earlier: 3 alignment reads": lambda: (t9[3].data_ptr() % 16 or t9[7].data_ptr() % 16
                                               or t9[4].data_ptr() % 8),
        "check_inputs: 12 fused checks, 12 pointers, alignment, capacity": lambda: k9.check_inputs(
            *t9, TH_STEREO, dev),
        "earlier: 5 torch.empty": lambda: [torch.empty(N, dtype=dt, device=dev)
                                           for dt in (f32, f32, i32, i32, torch.bool)],
        "5 torch.empty_like": lambda: (torch.empty_like(t9[8]), torch.empty_like(t9[8]),
                                       torch.empty_like(t9[1]), torch.empty_like(t9[1]),
                                       torch.empty_like(t9[2])),
        "stream_ptr": lambda: _build.stream_ptr(dev),
        "ctypes call (27 args) + launch": lambda: lib9(
            *ptrs9, N, M, H, W, L, TH_STEREO, float(cam.fx), float(cam.bf), *optrs9,
            _build.stream_ptr(dev)),
        "stereo_match": lambda: k9.stereo_match(*args9)}

    il, ir = t9[9], t9[10]
    K = np.array([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]], np.float32)
    D = np.array([-0.28, 0.07, 1e-4, -2e-5, 0.0], np.float32)
    eye = np.eye(3, dtype=np.float32)
    rect = rectify.StereoRectifier(K, D, eye, K, K, D, eye, K, 480, 640, device="cuda")
    maps = (rect.map_l, rect.map_r + 0.37)
    args10 = (il, ir, *maps)
    specs10 = [(il, "img_l", f32, (480, 640)), (ir, "img_r", f32, (480, 640)),
               (maps[0], "map_l", f32, (480, 640, 2)), (maps[1], "map_r", f32, (480, 640, 2))]
    checked = k10.check_maps(*maps, dev)
    out10 = k10.remap_pair(*args10)
    lib10 = k10._lib()
    grid = torch.stack(maps) * torch.tensor([2.0 / 639, 2.0 / 479], device=dev) - 1.0
    img = torch.stack([il, ir])[:, None]
    parts10 = {
        "earlier: 4 four-test checks": lambda: [generic_check(*sp, dev) for sp in specs10],
        "earlier: 2 alignment reads": lambda: maps[0].data_ptr() % 8 or maps[1].data_ptr() % 8,
        "earlier: one torch.empty [2, Ho, Wo] and out[0], out[1]": lambda: (
            lambda o: (o[0], o[1]))(torch.empty((2, 480, 640), dtype=f32, device=dev)),
        "earlier: the rectifier's as_tensor().to().contiguous() x 2": lambda: [
            torch.as_tensor(im).to(dev, f32).contiguous() for im in (il, ir)],
        "check_maps: 2 fused checks, 2 pointers, alignment": lambda: k10.check_maps(*maps, dev),
        "check_images: 2 fused checks": lambda: k10.check_images(il, ir, dev),
        "earlier: 2 torch.empty [Ho, Wo]": lambda: [torch.empty((480, 640), dtype=f32, device=dev)
                                                    for _ in range(2)],
        "2 torch.empty_like": lambda: (torch.empty_like(il), torch.empty_like(il)),
        "the rectifier's pass-through x 2": lambda: (rect._as_f32(il), rect._as_f32(ir)),
        "stream_ptr": lambda: _build.stream_ptr(dev),
        "ctypes call (11 args) + launch": lambda: lib10(
            il.data_ptr(), ir.data_ptr(), checked[2], checked[3], out10[0].data_ptr(),
            out10[1].data_ptr(), 480, 640, 480, 640, _build.stream_ptr(dev)),
        "remap_pair": lambda: k10.remap_pair(*args10),
        "launch (the inputs checked)": lambda: k10.launch(il, ir, 480, 640, *checked),
        "StereoRectifier.__call__": lambda: rect(il, ir),
        "grid_sample (one PyTorch call)": lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)}
    out = {"card": card, "calls_a_part": 10_000}
    for name, parts in (("stereo_match", parts9), ("remap_pair", parts10)):
        out[name] = {k: round(host_ns(fn), 1) for k, fn in parts.items()}
    torch.cuda.synchronize()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
