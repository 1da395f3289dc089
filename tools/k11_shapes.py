#!/usr/bin/env python3
"""Kernel 11 (the segment sum in one fixed order) alone on the card, at
synthetic versions of the solvers' seven call shapes.

    python3 tools/k11_shapes.py [--root DIR] [--edges]

Each shape is (E edge slots, S segments, D floats a row, kept rows, the
longest segment) of the runs in ``chip_smoke.py``'s phase 3 (the closure's
pose graph; the global BA on phase 15's map, 131,072 slots of which 27,117
are kept), its index and rows from ``chip_smoke.k11_case`` (one segment of
the longest length, the others uniform; rows whose sums depend on the
order of addition).  Each goes through ``chip_smoke.k11_shape``: bit for
bit the CPU twin, the plan equal to the CPU's, two calls equal, then the
kernel's 100-call and CUDA-graph times
beside index_add's and torch.segment_reduce's, the host time a call, the
bytes bound and the chain floor.  ``--edges`` adds chip_smoke's K11_EDGES
(checked, not timed).  ``--root DIR`` imports ``orb_slam2_annotate_tpu_torch``
from DIR, so that two trees are timed on one card in one sitting (parent,
change, change, parent); the chain floor's probe is this checkout's.

Prints one JSON line a shape and a last line with the card's name and
power limit (``nvidia-smi``).  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (E, S, D, kept rows, longest segment)
SHAPES = {
    "pose graph g": (1100, 128, 7, 300, 6),
    "pose graph H (four blocks)": (4400, 128 * 128, 49, 1200, 10),
    "global BA Hcc": (131072, 128, 36, 27117, 461),
    "global BA gc": (131072, 128, 6, 27117, 461),
    "global BA Hpp": (131072, 16384, 9, 27117, 10),
    "global BA gp and the PCG point sum": (131072, 16384, 3, 27117, 10),
    "normal equations B": (131072, 16384 * 128, 18, 27117, 1),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--edges", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("k11_shapes: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke_k11",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, HERE)
    add = cs.fadd_chain_ns()             # this checkout's probe, before the tree under test
    sys.path.remove(HERE)
    sys.path.insert(0, root)
    for mod in [m for m in sys.modules if m.startswith("orb_slam2_annotate_tpu_torch")]:
        del sys.modules[mod]
    from orb_slam2_annotate_tpu_torch.kernels import segment_sum as k11

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "fadd": add}), flush=True)
    for i, (name, (E, S, D, live, longest)) in enumerate(SHAPES.items()):
        idx, vals = cs.k11_case(100 + i, E, S, D, live, longest)
        row = cs.k11_shape(k11, name, idx, S, vals, add["ns_per_add"])
        print(json.dumps({"shape": name, **row}), flush=True)
    if args.edges:
        for i, (name, (E, S, D, live, longest)) in enumerate(cs.K11_EDGES.items()):
            idx, vals = cs.k11_case(i, E, S, D, live, longest)
            print(json.dumps({"edge": name, **cs.k11_shape(k11, name, idx, S, vals, None)}),
                  flush=True)
    print(json.dumps({"card": card, "root": root}))


if __name__ == "__main__":
    main()
