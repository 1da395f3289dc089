"""Build a ``csrc/*.cu`` file with nvcc, or a host C++ source with g++, into
a shared library and load it.

Each source has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds.  The library lands in ``_build/`` beside the package
(listed in .gitignore), named by a hash of the source and flags, and is
built at first use by the process that needs it.  There is no fallback: a
missing compiler or a failed build raises.  ``load_host`` builds the
repository's ``native/loader.cpp`` (the image loader) the same way, and
never reads or writes ``native/`` beyond its source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# every source in csrc/ with its own flags: --fmad=false where float results
# decide bits or must round like the plain torch twin
SOURCES = {"fast_nms": ("--fmad=false",), "orb_describe": ("--fmad=false",),
           "hamming": ("--fmad=false",), "pose_lm": ("--fmad=false",), "assign_words": (),
           "pnp_score": ("--fmad=false",), "sim3": ("--fmad=false",),
           "stereo": ("--fmad=false",), "remap": ("--fmad=false",),
           "segment_sum": ("--fmad=false",), "grid_ba": ("--fmad=false",),
           "chol_solve": ("--fmad=false",), "lu_solve": ("--fmad=false",)}

# host C++ sources outside the package: name -> (path, g++ flags, link flags);
# the loader's flags are native/build.sh's, so that both packages' builds
# convert colour to gray with the same float contractions
HOST_SOURCES = {"loader": (os.path.join(os.path.dirname(PKG_DIR), "native", "loader.cpp"),
                           ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"),
                           ("-lz", "-lpthread"))}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _build_and_load(key: str, src: str, compiler: str, flags: list, post: list) -> ctypes.CDLL:
    """Build `src` (once per content and flags) into _build/ and load it."""
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags + post).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{key}-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *flags, "-o", tmp, src, *post],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed for {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_SECONDS[key] = time.perf_counter() - t0
    lib = ctypes.CDLL(out)
    _LIBS[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    return _build_and_load(name, os.path.join(CSRC_DIR, f"{name}.cu"), _nvcc(),
                           ARCH_FLAGS + BASE_FLAGS + list(SOURCES[name]), [])


def load_host(name: str) -> ctypes.CDLL:
    """Build (once) with g++ and load the host C++ source `name` of
    HOST_SOURCES."""
    src, flags, libs = HOST_SOURCES[name]
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX); the host library cannot be built")
    return _build_and_load(f"host_{name}", src, cxx, list(flags), list(libs))


def check_launch(err: int, name: str) -> None:
    """Raise if the C launcher reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate what a kernel takes: dtype, shape, contiguity and device.
    One fused test passes a good tensor; the separate tests run only to
    name what failed."""
    if t.dtype is dtype and t.shape == shape and t.is_contiguous() and t.device == device:
        return
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def stream_ptr(device) -> int:
    """The device's current CUDA stream as an int (PyTorch's raw accessor,
    which makes no Stream object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
