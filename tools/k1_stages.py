#!/usr/bin/env python3
"""Kernel 1 (``fast_nms``: a frame's pyramid, blur, FAST, NMS and margin) by
stage on the card, and its bits against another tree's.

    python3 tools/k1_stages.py [--root DIR]
    python3 tools/k1_stages.py --against DIR [--root DIR]

Stages: builds an edited copy of the tree's ``csrc/fast_nms.cu`` (``--root``,
default this checkout) into ``orb_slam2_annotate_tpu_torch/_build/k1_stages/``
in which lane 0 of every warp reads ``clock64`` at fixed points
(``tools/stage_common.py``; the committed source holds no switch: each edit
is a fixed string that must match once).  The design is read from the text:

- ``tiles`` (the first design): a CTA a 32 x 16 tile of one level, (a) the
  tile and its 4-pixel halo resized tap by tap from the level-0 image in
  device memory, (b) FAST over the tile and a 1-pixel halo, (c) the blur's
  vertical pass, (d) the blur's horizontal pass, NMS and the stores;
  padding-only CTAs (e) write zeros;
- ``separable`` (the present one): a CTA a tile of one level or a band of
  padding rows; (a) the row pass from the level-0 image, (b) the column pass
  in shared memory, (c) FAST with the compass pretest, (d) the blur's
  vertical pass, (e) the horizontal pass, NMS and the stores; (f) padding.

For each case (the slice's frame 0 at VGA x 8 levels, the loop cell's frame
at QVGA x 4) it prints one JSON line: each stage's summed CTA cycles and share,
the marked call's span, the uninstrumented kernel's CUDA-graph replay
(``chip_smoke.graph_us``) and that of a variant without the arc test (the
first design: one difference in its place; the present one: the listed
positions' arcs left out), its FAST cost by subtraction.

Against: builds ``DIR``'s and the tree's kernels, imports each tree's wrapper
in turn, runs both on every input of ``chip_smoke.k1_cases`` and prints whether
all four stacks are equal bit for bit (exit 1 if not), then their graph-replay
times in turns (DIR, tree, tree, DIR).  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import stage_common as sc  # noqa: E402

MAX_CTA = 8192
END = sc.NM - 1
EDITS = {
    "tiles": [
        ("__global__ void __launch_bounds__(NT) pyramid_fast_nms(",
         sc.marks_source(MAX_CTA) + "__global__ void __launch_bounds__(NT) pyramid_fast_nms("),
        ("    const size_t plane = (size_t)l * a.H0 * a.W0;\n",
         "    const size_t plane = (size_t)l * a.H0 * a.W0;\n    STAGE_MARK(0, h)\n"),
        ("            }\n        }\n        return;\n",
         f"            }}\n        }}\n        STAGE_MARK({END}, tid)\n        return;\n"),
        ("    }\n    __syncthreads();\n\n    // FAST score of the tile",
         "    }\n    __syncthreads();\n    STAGE_MARK(1, __float_as_int(S[0][0]))\n\n"
         "    // FAST score of the tile"),
        ("    // blur, vertical pass: V[r][c]",
         "    STAGE_MARK(2, __float_as_int(SC[0][0]))\n    // blur, vertical pass: V[r][c]"),
        ("        V[r][c] = acc;\n    }\n    __syncthreads();\n",
         "        V[r][c] = acc;\n    }\n    __syncthreads();\n    STAGE_MARK(3, __float_as_int(V[0][0]))\n"),
        ("        a.score[o] = (inside && s >= m) ? s : 0.0f;\n    }\n}\n",
         f"        a.score[o] = (inside && s >= m) ? s : 0.0f;\n    }}\n    STAGE_MARK({END}, tid)\n}}\n"),
    ],
    "separable": [
        ("__global__ void __launch_bounds__(NT) pyramid_fast_nms(",
         sc.marks_source(MAX_CTA) + "__global__ void __launch_bounds__(NT) pyramid_fast_nms("),
        ("    const size_t plane = (size_t)l * a.H0 * a.W0;\n",
         "    const size_t plane = (size_t)l * a.H0 * a.W0;\n    STAGE_MARK(0, h)\n"),
        ("            zero_u8(a.is_hi + o, n, lane);\n        }\n",
         f"            zero_u8(a.is_hi + o, n, lane);\n        }}\n        STAGE_MARK({END}, tid)\n"),
        ("        __syncthreads();\n        // column pass: out(y, x)",
         "        __syncthreads();\n"
         "        STAGE_MARK(1, __float_as_int(T[0]))\n        // column pass: out(y, x)"),
        ("        cx = ce + 1;\n    }\n", "        cx = ce + 1;\n    }\n    STAGE_MARK(2, __float_as_int(S[0][0]))\n"),
        ("    // blur, vertical pass: V[r][c]",
         "    STAGE_MARK(3, __float_as_int(SC[0]))\n    // blur, vertical pass: V[r][c]"),
        ("        V[i] = acc;\n    }\n    __syncthreads();\n",
         "        V[i] = acc;\n    }\n    __syncthreads();\n    STAGE_MARK(4, __float_as_int(V[0]))\n"),
        ("        a.score[o] = (inside && s0 >= m) ? s0 : 0.0f;\n    }\n}\n",
         f"        a.score[o] = (inside && s0 >= m) ? s0 : 0.0f;\n    }}\n    STAGE_MARK({END}, tid)\n}}\n"),
    ],
}
PHASES = {
    "tiles": {"resize (taps from device memory)": (0, 1), "FAST": (1, 2), "blur vertical": (2, 3),
              "blur horizontal, NMS, stores": (3, END), "padding-only CTAs": (0, END)},
    "separable": {"row pass": (0, 1), "column pass": (1, 2), "FAST": (2, 3), "blur vertical": (3, 4),
                  "blur horizontal, NMS, stores": (4, END), "padding": (0, END)},
}
# the arc test left out (the first design: one difference in its place)
NO_ARC = {
    "tiles": [("const float v = fmaxf(arc_strength(d, 1.0f), arc_strength(d, -1.0f));",
               "const float v = d[0] + d[8];")],
    "separable": [("    for (int e = lane; e < nlist; e += 32) {", "    for (int e = lane; e < 0; e += 32) {")],
}


def design(text: str) -> str:
    return "separable" if "arc_bright" in text else "tiles"


def phases_of(clk, ns, d: str) -> dict:
    """Per-CTA phases; a CTA's padding phase and its tile phases are told
    apart by which marks it recorded."""
    import numpy as np

    rec = (clk > 0).any(axis=2)
    tile = rec[:, 1]
    out = {}
    for name, (i, j) in PHASES[d].items():
        keep = ~tile if name.startswith("padding") else tile
        out[name] = (i, j, keep)
    res, total = {}, 0.0
    latest = clk.max(axis=2)
    for name, (i, j, keep) in out.items():
        live = keep & rec[:, i] & rec[:, j]
        dcyc = (latest[live, j] - latest[live, i]).astype(np.float64)
        res[name] = {"ctas": int(live.sum()), "cycles": float(dcyc.sum()),
                     "median_cycles": float(np.median(dcyc)) if len(dcyc) else None}
        total += float(dcyc.sum())
    for v in res.values():
        v["share"] = v["cycles"] / total if total else None
    start, end = ns[:, 0][ns[:, 0] > 0], ns[:, 1][ns[:, 1] > 0]
    return {"phases": res, "span_us": float(end.max() - start.min()) / 1e3 if len(end) else None}


def stage_cases(cs):
    cases = cs.k1_cases()
    return {k: cases[k] for k in ("slice frame 0", "loop frame 0 (QVGA, 4 levels)")}


def stages(cs, root: str, card: str):
    import torch

    k1 = sc.import_tree(root, "kernels.fast_nms")
    from orb_slam2_annotate_tpu_torch.ops import extractor, pyramid

    cfg = extractor.ExtractorConfig()
    fast_args = (cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
    with open(os.path.join(root, "orb_slam2_annotate_tpu_torch", "csrc", "fast_nms.cu")) as f:
        text = f.read()
    d = design(text)
    lib = sc.build(sc.edited(text, EDITS[d]), "fast_nms", "fast_nms", "k1_stages")
    no_arc = sc.build(sc.edited(text, NO_ARC[d]), "fast_nms_no_arc", "fast_nms", "k1_stages")
    dev = torch.device("cuda:0")
    for name, (img_np, n_lev, scale) in stage_cases(cs).items():
        img = torch.from_numpy(img_np).to(dev)
        lt = pyramid.level_tables(*img.shape, n_lev, scale, dev)
        fn = lambda: k1.fast_nms(img, lt, *fast_args)
        graph = cs.graph_us(fn)
        with sc.use_lib("fast_nms", lib, k1._lib):
            clk, ns = sc.run_marked(lib, MAX_CTA, fn)
        with sc.use_lib("fast_nms", no_arc, k1._lib):
            graph_no_arc = cs.graph_us(fn)
        row = {"case": name, "design": d, "shape": list(img.shape), "levels": n_lev,
               **phases_of(clk, ns, d), "graph_us": graph, "graph_us_no_arc_test": graph_no_arc}
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


def against(cs, root: str, other: str, card: str):
    import torch

    dev = torch.device("cuda:0")
    cases = cs.k1_cases()
    outs = {}
    for side, path in (("against", other), ("tree", root)):
        k1 = sc.import_tree(path, "kernels.fast_nms")
        from orb_slam2_annotate_tpu_torch.ops import extractor, pyramid

        cfg = extractor.ExtractorConfig()
        fast_args = (cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
        outs[side] = {}
        for name, (img_np, n_lev, scale) in cases.items():
            img = torch.from_numpy(img_np).to(dev)
            lt = pyramid.level_tables(*img.shape, n_lev, scale, dev)
            outs[side][name] = [t.clone() for t in k1.fast_nms(img, lt, *fast_args)]
        torch.cuda.synchronize()
    all_equal = True
    for name in cases:
        eq = [torch.equal(a, b) for a, b in zip(outs["against"][name], outs["tree"][name])]
        all_equal &= all(eq)
        print(json.dumps({"case": name, "equal (pyr3, blur, score, is_hi)": eq}), flush=True)
    times = {name: {"against": [], "tree": []} for name in cases}
    for side in ("against", "tree", "tree", "against"):
        k1 = sc.import_tree(other if side == "against" else root, "kernels.fast_nms")
        from orb_slam2_annotate_tpu_torch.ops import extractor, pyramid

        cfg = extractor.ExtractorConfig()
        fast_args = (cfg.th_fast_lo, cfg.th_fast_hi, cfg.margin)
        for name, (img_np, n_lev, scale) in cases.items():
            img = torch.from_numpy(img_np).to(dev)
            lt = pyramid.level_tables(*img.shape, n_lev, scale, dev)
            times[name][side].append(cs.graph_us(lambda: k1.fast_nms(img, lt, *fast_args)))
    print(json.dumps({"graph_us (against, tree; in turns against, tree, tree, against)": times}))
    print(json.dumps({"all_equal": all_equal, "against": os.path.abspath(other),
                      "tree": os.path.abspath(root), "card": card}))
    if not all_equal:
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=sc.ROOT)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_stages: no CUDA device")
    cs = sc.chip_smoke()
    sc.import_tree(args.root, "kernels")
    card = sc.card()
    if args.against:
        against(cs, os.path.abspath(args.root), os.path.abspath(args.against), card)
    else:
        stages(cs, os.path.abspath(args.root), card)


if __name__ == "__main__":
    main()
