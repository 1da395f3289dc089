#!/usr/bin/env python3
"""Kernel 3 (``hamming_match``: the batched, gate-fused matcher) by stage on
the card, and its bits against another tree's.

    python3 tools/k3a_stages.py [--root DIR]
    python3 tools/k3a_stages.py --against DIR [--root DIR]

Stages: builds an edited copy of the tree's ``csrc/hamming.cu`` (``--root``,
default this checkout) into ``orb_slam2_annotate_tpu_torch/_build/k3a_stages/``
in which lane 0 of every warp reads ``clock64`` at fixed points
(``tools/stage_common.py``; each edit a fixed string that must match once,
no switch in the committed source).  The design is read from the text:

- ``popc`` (the first design): a thread a column, 16 XOR + ``__popc`` a gated
  pair; (a) staging the CTA's rows and their gate terms, (b) the column tiles
  (the gate, the distances, the row merge and the column keys, interleaved
  a row at a time), (c) the CTA's merge of its rows and their store,
  (d) the ticket, (e) the last CTA's finish, (f) its reset of the column keys;
- ``tc`` (the present one): a lane a row, a CTA a split of columns; (a)
  staging the rows, the split's columns and their terms, (b) the walk (each
  32-column chunk's gate bits, then the gated pairs' distances by popcounts
  or, where a lane has more than ``POPC_MAX``, by 16 ``mma.sync``
  AND-popcounts; the merge and the shared column keys of the gated pairs),
  (c) the global column keys and the split's records, (d) the row block's
  ticket, (e) the last split's merge of the records, the distance gate and
  ratio test and the candidates' list, (f) the problem's ticket, (g) the last
  row block's check of the candidates, (h) the reset.

The interleaved parts of (b) are split by variants, each timed in a CUDA-graph
replay beside the unchanged kernel: ``no_distance`` (the popcounts, or the
mma, gone), ``no_column_keys`` (no column atomics) and, for ``tc``,
``gate_only`` (every chunk left after its gate bits), ``popcounts_only`` and
``mma_only`` (every chunk's distances one way).  For each of the main
path's shapes (window + octave band at B = 1, a window at B = 2 and B = 11,
validity at B = 8, the epipolar gate at B = 20; ``chip_smoke.k3a_cases``) it
prints one JSON line: each stage's summed CTA cycles, share and median, the
marked call's span and the graph times.

Against: imports ``DIR``'s and the tree's wrappers in turn, runs both on
every case of ``chip_smoke.k3a_cases`` at each of its (max_dist, ratio,
mutual) settings, prints whether idx and dist are equal (exit 1 if not),
then the graph-replay times of the five shapes in turns (DIR, tree, tree,
DIR).  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import stage_common as sc  # noqa: E402

MAX_CTA = 4096
END = sc.NM - 1
EDITS = {
    "popc": [
        ("template <int ROWS>\n__global__ void __launch_bounds__(NT) hamming_match_fused(",
         sc.marks_source(MAX_CTA) +
         "template <int ROWS>\n__global__ void __launch_bounds__(NT) hamming_match_fused("),
        ("    const int* d2 = a.d2 + (size_t)b * a.s_d2;\n",
         "    const int* d2 = a.d2 + (size_t)b * a.s_d2;\n    STAGE_MARK(0, tid)\n"),
        ("        ro[r] = po;\n    }\n    __syncthreads();\n",
         "        ro[r] = po;\n    }\n    __syncthreads();\n    STAGE_MARK(1, any_row)\n"),
        ("    // merge the per-thread row states", "    STAGE_MARK(2, best[0])\n"
         "    // merge the per-thread row states"),
        ("    // the last CTA of problem b finishes all its rows",
         "    STAGE_MARK(3, tid)\n    // the last CTA of problem b finishes all its rows"),
        ("    __syncthreads();\n    if (!is_last) return;\n",
         "    __syncthreads();\n    STAGE_MARK(4, is_last)\n    if (!is_last) return;\n"),
        ("        dist_out[i] = ok ? bb : MAX_DIST;\n    }\n",
         "        dist_out[i] = ok ? bb : MAX_DIST;\n    }\n    STAGE_MARK(5, tid)\n"),
        ("    if (tid == 0) a.ticket[b] = 0u;\n}\n",
         f"    if (tid == 0) a.ticket[b] = 0u;\n    STAGE_MARK({END}, tid)\n}}\n"),
    ],
    "tc": [
        ("__global__ void __launch_bounds__(MNT, 3) hamming_match_fused(",
         sc.marks_source(MAX_CTA) + "__global__ void __launch_bounds__(MNT, 3) hamming_match_fused("),
        ("    const bool window = a.gate == GATE_WINDOW, spatial = window || a.gate == GATE_EPIPOLAR;\n",
         "    const bool window = a.gate == GATE_WINDOW, spatial = window || a.gate == GATE_EPIPOLAR;\n"
         "    STAGE_MARK(0, tid)\n"),
        ("    // (b) the walk", "    STAGE_MARK(1, cpop[0])\n    // (b) the walk"),
        ("    // (c) the column keys", "    STAGE_MARK(2, best + second)\n    // (c) the column keys"),
        ("    // (d) the last split", "    STAGE_MARK(3, tid)\n    // (d) the last split"),
        ("(unsigned)(S - 1);\n    __syncthreads();\n    if (!is_last) return;\n",
         "(unsigned)(S - 1);\n    __syncthreads();\n    STAGE_MARK(4, is_last)\n    if (!is_last) return;\n"),
        ("    // (e) the last row block", "    STAGE_MARK(5, at)\n    // (e) the last row block"),
        ("(unsigned)(RB - 1);\n    }\n    __syncthreads();\n    if (!is_last) return;\n",
         "(unsigned)(RB - 1);\n    }\n    __syncthreads();\n    STAGE_MARK(6, is_last)\n"
         "    if (!is_last) return;\n"),
        ("    // (f) reset the problem's", "    STAGE_MARK(7, tid)\n    // (f) reset the problem's"),
        ("        tk[RB + 1] = 0u;\n    }\n}\n",
         f"        tk[RB + 1] = 0u;\n    }}\n    STAGE_MARK({END}, tid)\n}}\n"),
    ],
}
PHASES = {
    "popc": {"staging": (0, 1), "column tiles": (1, 2), "CTA merge and row store": (2, 3),
             "ticket": (3, 4), "finish (last CTA)": (4, 5), "reset (last CTA)": (5, END)},
    "tc": {"staging": (0, 1), "walk (gate, mma, merge, keys)": (1, 2),
           "keys out and records": (2, 3), "row-block ticket": (3, 4),
           "splits merged, candidates (last split)": (4, 5), "problem ticket": (5, 6),
           "candidates checked (last row block)": (6, 7), "reset": (7, END)},
}
VARIANTS = {
    "popc": {"no_distance": [("d += __popc((unsigned)(q[r][w] ^ c[w]));",
                              "d += (q[r][w] ^ c[w]) & 1;")],
             "no_column_keys": [("if (ckey < KEY_INIT) atomicMin(", "if (ckey < 0ull) atomicMin(")]},
    "tc": {"no_distance": [("mma_and_popc(acc[mb][nb], af[mb], col[0], col[4]);",
                            "acc[mb][nb][0] += (int)(col[0] & 1u);"),
                           ("d += __popc(u.x ^ v.x) + __popc(u.y ^ v.y) + __popc(u.z ^ v.z) + "
                            "__popc(u.w ^ v.w);", "d += (int)((u.x ^ v.x) & 1u);")],
           "no_column_keys": [("            atomicMin(&ckey[cb + c],",
                               "            if (d < 0) atomicMin(&ckey[cb + c],")],
           "gate_only": [("        if (most == 0) continue;",
                          "        second ^= (int)m;\n        continue;")],
           "popcounts_only": [("const bool tc = most > POPC_MAX;", "const bool tc = false;")],
           "mma_only": [("const bool tc = most > POPC_MAX;", "const bool tc = true;")],
           "finish_16_ahead": [("#define RPT 4 ", "#define RPT 16 ")]},
}
TIMED = ("window+octave B=1 4096x1024", "window B=2 1024x1024", "validity B=8 shared desc2",
         "window+octave B=11 1024x1024", "epipolar B=20")


def design(text: str) -> str:
    return "tc" if "window_pass(" in text else "popc"


def inputs(cs):
    """chip_smoke.k3a_cases on the slice's frames 0-20, as extracted by the
    imported tree, the gates as plain tuples (type name, fields)."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import hamming as k3
    from orb_slam2_annotate_tpu_torch.ops import extractor, orb

    dev = torch.device("cuda:0")
    cam, poses, frames, _, slice_cfg = cs.slice_setup(21)
    cfg = slice_cfg.extractor
    tab = orb.OrbTables().to(dev)
    feats = [extractor.extract(torch.from_numpy(f).to(dev), tab, cfg) for f in frames[:21]]
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = cs.k3a_cases(feats, poses, cam, cfg, dev, k3, gen)
    return {name: (*c[:4], None if c[4] is None else (type(c[4]).__name__, tuple(c[4])), c[5])
            for name, c in cases.items()}


def call(k3, case, params):
    """The tree's hamming_match on `case` (its gate made with the tree's class)."""
    da, db, rva, cva, gate, _ = case
    g = None if gate is None else getattr(k3, gate[0])(*gate[1])
    return k3.hamming_match(da, db, rva, cva, *params, g)


def stages(cs, root: str, card: str):
    from orb_slam2_annotate_tpu_torch.ops import matching

    k3 = sc.import_tree(root, "kernels.hamming")
    with open(os.path.join(root, "orb_slam2_annotate_tpu_torch", "csrc", "hamming.cu")) as f:
        text = f.read()
    d = design(text)
    cases = inputs(cs)
    lib = sc.build(sc.edited(text, EDITS[d]), "hamming", "hamming", "k3a_stages")
    variants = {v: sc.build(sc.edited(text, e), f"hamming_{v}", "hamming", "k3a_stages")
                for v, e in VARIANTS[d].items()}
    params = (matching.TH_HIGH, 0.8, False)
    for name in TIMED:
        fn = lambda: call(k3, cases[name], params)
        row = {"case": name, "design": d, "graph_us": cs.graph_us(fn)}
        with sc.use_lib("hamming", lib, k3._fns):
            clk, ns = sc.run_marked(lib, MAX_CTA, fn)
        row.update(sc.summary(clk, ns, PHASES[d]))
        for v, vlib in variants.items():
            with sc.use_lib("hamming", vlib, k3._fns):
                row[f"graph_us_{v}"] = cs.graph_us(fn)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


def against(cs, root: str, other: str, card: str):
    import torch

    from orb_slam2_annotate_tpu_torch.ops import matching

    default = [(mx, ratio, mutual) for mutual in (False, True)
               for mx, ratio in ((matching.TH_HIGH, 0.9), (matching.TH_LOW, 1.0))]
    cases = inputs(cs)
    outs = {}
    for side, path in (("against", other), ("tree", root)):
        k3 = sc.import_tree(path, "kernels.hamming")
        outs[side] = {(name, p): [t.clone() for t in call(k3, c, p)]
                      for name, c in cases.items() for p in (c[5] or default)}
        torch.cuda.synchronize()
    all_equal = True
    for key in outs["tree"]:
        eq = all(torch.equal(a, b) for a, b in zip(outs["against"][key], outs["tree"][key]))
        all_equal &= eq
        print(json.dumps({"case": key[0], "max_dist, ratio, mutual": key[1], "equal": eq,
                          "matched": int((outs["tree"][key][0] >= 0).sum())}), flush=True)
    times = {name: {"against": [], "tree": []} for name in TIMED}
    params = (matching.TH_HIGH, 0.8, False)
    for side in ("against", "tree", "tree", "against"):
        k3 = sc.import_tree(other if side == "against" else root, "kernels.hamming")
        for name in TIMED:
            times[name][side].append(cs.graph_us(lambda: call(k3, cases[name], params)))
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
        sys.exit("k3a_stages: no CUDA device")
    cs = sc.chip_smoke()
    sc.import_tree(args.root, "kernels")
    card = sc.card()
    if args.against:
        against(cs, os.path.abspath(args.root), os.path.abspath(args.against), card)
    else:
        stages(cs, os.path.abspath(args.root), card)


if __name__ == "__main__":
    main()
