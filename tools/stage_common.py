"""What ``tools/k1_stages.py`` and ``tools/k3a_stages.py`` share: a tree's
kernel wrapper imported by path, an edited copy of a ``csrc/*.cu`` file built
with nvcc under the package's ``_build/`` (gitignored), and per-CTA marks.

The marks: ``STAGE_MARK(i, dep)`` in an edited copy stores, from lane 0 of
each warp, ``clock64`` as mark i of its CTA once `dep` has been computed,
and ``%globaltimer`` at marks 0 and ``NM - 1``; ``summary`` turns them into
each phase's CTA-time (the latest warp's mark minus the latest warp's
previous mark, summed over the CTAs that record both) and its share.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NM, NW = 10, 8           # marks a CTA, warps recorded a CTA


def marks_source(max_cta: int) -> str:
    """The marks' device arrays, their host readers and STAGE_MARK."""
    return f"""#define STAGE_MAX_CTA {max_cta}
__device__ long long stage_clk[STAGE_MAX_CTA][{NM}][{NW}];
__device__ long long stage_ns[STAGE_MAX_CTA][2];
extern "C" int stage_read(long long* clk, long long* ns) {{
    int e = (int)cudaMemcpyFromSymbol(clk, stage_clk, sizeof(stage_clk));
    return e ? e : (int)cudaMemcpyFromSymbol(ns, stage_ns, sizeof(stage_ns));
}}
extern "C" int stage_clear() {{
    static long long zc[STAGE_MAX_CTA][{NM}][{NW}], zn[STAGE_MAX_CTA][2];
    int e = (int)cudaMemcpyToSymbol(stage_clk, zc, sizeof(zc));
    return e ? e : (int)cudaMemcpyToSymbol(stage_ns, zn, sizeof(zn));
}}
__device__ __forceinline__ int stage_cta() {{
    return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}}
#define STAGE_MARK(i, dep)                                                          \\
    if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < {NW} && stage_cta() < STAGE_MAX_CTA) {{ \\
        long long c_;                                                               \\
        asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_) : "r"((int)(dep)));        \\
        stage_clk[stage_cta()][(i)][threadIdx.x >> 5] = c_;                        \\
        if ((i) == 0 || (i) == {NM} - 1) {{                                         \\
            unsigned long long t_;                                                  \\
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) : "r"((int)(dep)));\\
            stage_ns[stage_cta()][(i) == 0 ? 0 : 1] = (long long)t_;                \\
        }}                                                                          \\
    }}
"""


def edited(text: str, edits: list) -> str:
    """`text` with each (old, new) of `edits` replaced; each old must match once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"stage edit {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(text: str, name: str, flags_of: str, tag: str) -> ctypes.CDLL:
    """`text` (a csrc source) built with the flags of source `flags_of` into
    ``_build/<tag>/`` and loaded."""
    from orb_slam2_annotate_tpu_torch.kernels import _build

    out_dir = os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "_build", tag)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS,
                    *_build.SOURCES[flags_of], "-o", lib_path, src], check=True)
    return ctypes.CDLL(lib_path)


def import_tree(root: str, module: str):
    """``orb_slam2_annotate_tpu_torch.<module>`` of the tree at `root`, every
    earlier import of the package dropped (tensors made before stay valid)."""
    for p in [p for p in sys.path if os.path.isdir(os.path.join(p, "orb_slam2_annotate_tpu_torch"))]:
        sys.path.remove(p)
    for mod in [m for m in sys.modules if m.startswith("orb_slam2_annotate_tpu_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, os.path.abspath(root))
    return importlib.import_module(f"orb_slam2_annotate_tpu_torch.{module}")


class use_lib:
    """Within the block, `_build.load(name)` returns `lib` and the wrapper's
    cached loader (`cached`, a functools.cache function) is cleared."""

    def __init__(self, name, lib, cached):
        self.name, self.lib, self.cached = name, lib, cached

    def __enter__(self):
        from orb_slam2_annotate_tpu_torch.kernels import _build

        self.real = _build.load
        _build.load = lambda n: self.lib if n == self.name else self.real(n)
        self.cached.cache_clear()

    def __exit__(self, *exc):
        from orb_slam2_annotate_tpu_torch.kernels import _build

        _build.load = self.real
        self.cached.cache_clear()


def run_marked(lib, max_cta: int, fn):
    """Marks of one call of `fn` (three warm-up calls first): (clk
    [max_cta, NM, NW], ns [max_cta, 2]) as numpy int64, 0 where unrecorded."""
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import _build

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    _build.check_launch(lib.stage_clear(), "stage_clear")
    fn()
    torch.cuda.synchronize()
    clk = np.zeros((max_cta, NM, NW), np.int64)
    ns = np.zeros((max_cta, 2), np.int64)
    _build.check_launch(lib.stage_read(clk.ctypes.data_as(ctypes.c_void_p),
                                       ns.ctypes.data_as(ctypes.c_void_p)), "stage_read")
    return clk, ns


def summary(clk, ns, phases: dict) -> dict:
    """phases {name: (mark i, mark j)} -> {name: {ctas, cycles (summed over
    the CTAs that record both marks), share of all phases' cycles, median
    cycles a CTA}}, and the span from the first CTA's mark 0 to the last
    CTA's last mark (globaltimer, us)."""
    import numpy as np

    latest = clk.max(axis=2)                          # the latest warp's mark
    rec = (clk > 0).any(axis=2)
    out, total = {}, 0
    for name, (i, j) in phases.items():
        live = rec[:, i] & rec[:, j]
        d = (latest[live, j] - latest[live, i]).astype(np.float64)
        out[name] = {"ctas": int(live.sum()), "cycles": float(d.sum()),
                     "median_cycles": float(np.median(d)) if len(d) else None}
        total += float(d.sum())
    for v in out.values():
        v["share"] = v["cycles"] / total if total else None
    start, end = ns[:, 0][ns[:, 0] > 0], ns[:, 1][ns[:, 1] > 0]
    span = float(end.max() - start.min()) / 1e3 if len(start) and len(end) else None
    return {"phases": out, "span_us": span}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def chip_smoke():
    """chip_smoke.py imported as a module (its cases, graph_us, time_ms)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_stages",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
