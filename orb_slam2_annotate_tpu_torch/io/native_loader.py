"""ctypes binding of the native prefetching image loader (port of
io/native_loader.py).

The C++ source is the repository's ``native/loader.cpp``: a worker pool
decodes PNG / PGM frames ahead of the SLAM loop into a bounded window, so
file IO and inflate stay off the Python thread that drives the card.
``kernels/_build.load_host`` compiles it with g++ into the package's
``_build/`` at first use; a failed build raises.  Colour is converted to
gray with float weights 0.299 / 0.587 / 0.114 and no rounding; 16-bit
images come back as their raw values.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import _build

MAX_PIXELS = 1 << 24          # decode's buffer: up to 16 Mpx

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host("loader")
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_get_info.restype = ctypes.c_int
    lib.loader_get_info.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.loader_copy.restype = ctypes.c_int
    lib.loader_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    lib.loader_error.restype = ctypes.c_char_p
    lib.loader_error.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [ctypes.c_char_p,
                                 np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                                 ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the loader builds and loads here."""
    try:
        _load_lib()
        return True
    except (RuntimeError, OSError):
        return False


def decode(path: str) -> np.ndarray:
    """Decode one PNG / PGM to grayscale float32 [H, W]."""
    lib = _load_lib()
    buf = np.empty(MAX_PIXELS, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_image(path.encode(), buf, buf.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class PrefetchLoader:
    """Decoded grayscale frames in order, decoded ahead by C++ threads.

    loader = PrefetchLoader(paths, n_threads=2, ahead=8)
    img = loader[i]        # blocks only while frame i is still decoding
    loader.close()         # joins the threads (also on garbage collection)

    Frames are read once each, in increasing order, at most `ahead` past the
    next unread one: the C++ side frees a frame once it is copied out, and
    decodes only within its window, so any other read would return freed
    data or wait forever.  Such a read raises.
    """

    def __init__(self, paths: list[str], n_threads: int = 2, ahead: int = 8):
        self._lib = _load_lib()
        self._paths = list(paths)
        self._ahead = ahead
        self._next = 0
        # the C++ side keeps its own copies of the paths
        arr = (ctypes.c_char_p * len(self._paths))(*[p.encode() for p in self._paths])
        self._h = self._lib.loader_create(arr, len(self._paths), n_threads, ahead)
        if not self._h:
            raise RuntimeError("loader_create failed")

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._h is None:
            raise ValueError("PrefetchLoader is closed")
        if not 0 <= idx < len(self._paths):
            raise IndexError(idx)
        if not self._next <= idx < self._next + self._ahead:
            raise ValueError(f"frame {idx} read out of order: the next unread is {self._next}, "
                             f"and at most {self._ahead} ahead of it can be read")
        w, h = ctypes.c_int(), ctypes.c_int()
        if self._lib.loader_get_info(self._h, idx, ctypes.byref(w), ctypes.byref(h)) != 0:
            err = self._lib.loader_error(self._h, idx).decode()
            raise IOError(f"decode failed for {self._paths[idx]}: {err}")
        out = np.empty((h.value, w.value), np.float32)
        if self._lib.loader_copy(self._h, idx, out) != 0:
            raise IOError(f"copy failed for {self._paths[idx]}")
        self._next = idx + 1
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
