#!/usr/bin/env python3
"""Kernel 9's device time split by stage, on the card.

    python3 tools/k9_stages.py [--source PATH] [--design current|rowscan]

Builds variants of a ``stereo.cu`` (by default the port's own) with nvcc
into ``orb_slam2_annotate_tpu_torch/_build/k9_stages/`` (gitignored), each
cutting one more stage from the end of the kernel: the last CTA's ticket and
median gate, then the SAD refinement, then the candidates' descriptor loads
(their distances from the left descriptor itself), then the gate scan, then
everything (an empty kernel of the same launch).  The committed source holds
no switch: each variant is the text with fixed strings replaced, and each
replacement must match exactly once.  A stage's time is the difference of
two neighbouring variants' CUDA-graph replay times (chip_smoke.graph_us: 50
calls in one graph), the median of 5 replays, on the VGA pair of
chip_smoke.py's phase 3 (frame 0 of the slice, the right camera 0.3 m along
+x, 1024 x 1024 keypoints).  ``--design rowscan`` reads the earlier
row-scan kernel (one warp a left row scanning all M right keypoints), given
by ``--source``.  The current design is also built with 128 and 512 threads
a CTA.  Prints one JSON line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (stage removed by this cut, [(old text, new text), ...]), applied in order,
# each cut on top of the ones before
KERNEL_TOP = "    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
TICKET = "    // (5) the median gate, by the last CTA\n"
SAD_OPEN = {"current": "        if (ok) {\n            const float4 kb",
            "rowscan": "        if (ok) {\n            const float ur0"}
CUTS = {
    "current": [
        ("ticket + median gate", [(TICKET, "    return;\n" + TICKET)]),
        ("SAD refinement", [(SAD_OPEN["current"], "        if (false) {\n            const float4 kb")]),
        ("candidate distances", [("const int4 v0 = pr[0], v1 = pr[1], v2 = pr[2], v3 = pr[3];",
                                  "const int4 v0 = dl[0], v1 = dl[1], v2 = dl[2], v3 = dl[3];")]),
        ("gate scan", [("for (int c = p0; c < p1; c += 32) {", "for (int c = p0; c < p0; c += 32) {")]),
        ("staging + row setup", [(KERNEL_TOP, KERNEL_TOP + "    return;\n")]),
    ],
    "rowscan": [
        ("ticket + median gate", [(TICKET, "    return;\n" + TICKET)]),
        ("SAD refinement", [(SAD_OPEN["rowscan"], "        if (false) {\n            const float ur0")]),
        ("candidate distances", [("const int4 v = pr[q];",
                                  "const int4 v = make_int4(dl[4 * q], dl[4 * q + 1], "
                                  "dl[4 * q + 2], dl[4 * q + 3]);")]),
        ("gate scan", [("for (int j = lane; j < a.M; j += 32) {", "for (int j = lane; j < 0; j += 32) {")]),
        ("staging + row setup", [(KERNEL_TOP, KERNEL_TOP + "    return;\n")]),
    ],
}


def variants(text: str, design: str) -> dict:
    """name -> source text: the full kernel, then each cut on top of the last."""
    out = {"full": text}
    for stage, edits in CUTS[design]:
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"k9_stages: {old!r} is in the source {text.count(old)} times, not once")
            text = text.replace(old, new)
        out[f"without {stage}"] = text
    if design == "current":
        for nt in (128, 512):
            if out["full"].count("#define NT 256\n") != 1:
                sys.exit("k9_stages: no '#define NT 256' line")
            out[f"full, {nt} threads a CTA"] = out["full"].replace("#define NT 256\n", f"#define NT {nt}\n")
    return out


def build(name: str, text: str, out_dir: str, tag: str) -> tuple[str, str]:
    from orb_slam2_annotate_tpu_torch.kernels import _build

    slug = "".join(c if c.isalnum() else "_" for c in f"{tag}_{name}")
    src = os.path.join(out_dir, f"{slug}.cu")
    lib = os.path.join(out_dir, f"lib{slug}.so")
    with open(src, "w") as f:
        f.write(text)
    flags = _build.ARCH_FLAGS + _build.BASE_FLAGS + list(_build.SOURCES["stereo"]) + ["-Xptxas", "-v"]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"k9_stages: nvcc failed for {name}:\n{proc.stderr}")
    usage = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    return lib, " | ".join(usage)


def vga_inputs(dev):
    """(camera, kernel 9's twelve tensor inputs) on the VGA pair of
    chip_smoke.py's phase 3."""
    import numpy as np
    import torch

    from chip_smoke import BASELINE
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel, undistort_pixels
    from orb_slam2_annotate_tpu_torch.io import synthetic
    from orb_slam2_annotate_tpu_torch.ops import extractor, orb, pyramid
    from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                             bf=500.0 * BASELINE)
    scene = synthetic.PlaneScene(seed=1)
    R, t = synthetic.orbit_trajectory(48, step=0.05)[0]
    render = lambda tt: torch.from_numpy(np.clip(scene.render(cam, R, tt, h=480, w=640)[0], 0, 255)
                                         .astype(np.uint8)).to(dev).float()
    il = render(np.asarray(t, np.float32))
    ir = render(np.asarray(t, np.float32) - np.array([BASELINE, 0.0, 0.0], np.float32))
    cfg = mono_slice_config(n_features=1024, n_levels=8).extractor
    tab = orb.OrbTables().to(dev)
    fl, fr = extractor.extract(il, tab, cfg), extractor.extract(ir, tab, cfg)
    x_und = undistort_pixels(cam, fl.xy)[:, 0].contiguous()
    scales = pyramid.level_scales(cfg.n_levels, cfg.scale, device=dev)
    return cam, (fl.xy, fl.octave, fl.valid, fl.desc, fr.xy, fr.octave, fr.valid, fr.desc, x_und,
                 il, ir, scales)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "csrc",
                                                     "stereo.cu"))
    ap.add_argument("--design", choices=sorted(CUTS), default="current")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("k9_stages: CUDA is not available")
    from chip_smoke import graph_us
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import stereo as k9
    from orb_slam2_annotate_tpu_torch.pipeline.frame import TH_STEREO

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = os.path.join(_build.BUILD_DIR, "k9_stages")
    os.makedirs(out_dir, exist_ok=True)
    with open(opts.source) as f:
        texts = variants(f.read(), opts.design)
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(*kv, out_dir, opts.design), texts.items())))

    dev = torch.device("cuda:0")
    cam, args = vga_inputs(dev)
    N, M, H, W, L, ptrs = k9.check_inputs(*args, TH_STEREO, dev)
    ref = k9.stereo_match(*args, cam.fx, cam.bf, TH_STEREO)
    outs = [torch.empty_like(o) for o in ref]
    ws = torch.zeros(2, dtype=torch.int32, device=dev)

    times, usage = {}, {}
    for name, (lib_path, regs) in built.items():
        fn = ctypes.CDLL(lib_path).stereo_match_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 12 + [I] * 6 + [F, F] + [P] * 6 + [P]
        fn.restype = ctypes.c_int

        def call(fn=fn):
            err = fn(*ptrs, N, M, H, W, L, TH_STEREO, float(cam.fx), float(cam.bf),
                     *[o.data_ptr() for o in outs], ws.data_ptr(), _build.stream_ptr(dev))
            _build.check_launch(err, name)

        times[name] = statistics.median(graph_us(call) for _ in range(5))
        usage[name] = regs
        if name == "full" or name.startswith("full,"):
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                sys.exit(f"k9_stages: the {name} variant differs from stereo_match")
    names = list(CUTS[opts.design])
    chain = ["full"] + [f"without {stage}" for stage, _ in CUTS[opts.design]]
    stages = {stage: times[chain[k]] - times[chain[k + 1]] for k, (stage, _) in enumerate(names)}
    stages["launch (empty kernel)"] = times[chain[-1]]
    print(json.dumps({"design": opts.design, "source": os.path.relpath(opts.source, ROOT),
                      "card": card, "graph_us": times, "stage_us": stages,
                      "rows_accepted": int(ref[4].sum()), "ptxas": usage}))


if __name__ == "__main__":
    main()
