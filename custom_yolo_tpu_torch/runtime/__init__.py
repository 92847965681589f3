"""Native JPEG decoder (the port's own copy of
``custom_yolo_tpu/runtime/__init__.py``): ctypes bindings to
``src/decoder.cpp``, a threaded libjpeg decode + resize into one uint8
batch. Host code, not a device kernel.

The library is built with ``g++ -ljpeg`` at first use into ``_build/``
beside this file. Where it cannot be built (no compiler or no
``jpeglib.h``), or where a library built elsewhere does not load,
:func:`native_available` is False and the data loader decodes with PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "decoder.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_BUILD_DIR, "libyolo_runtime.so")
_BUILD_LOCK = threading.Lock()


def build_native(force: bool = False) -> Optional[str]:
    """Compile the library if it is missing or older than its source;
    returns its path, or None when it cannot be built. The library is
    written under a temporary name and renamed, so no process loads a
    half-written file while another builds it."""
    with _BUILD_LOCK:
        if not force and os.path.exists(_LIB) and \
                os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
            return _LIB
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                "-o", tmp, "-ljpeg", "-lpthread"]
        try:
            # -march=native lets the resize loops vectorise to the host's
            # widest SIMD; portable code where it is refused
            for extra in (["-march=native", "-funroll-loops"], []):
                try:
                    subprocess.run(base[:1] + extra + base[1:], check=True,
                                   capture_output=True, text=True)
                except subprocess.CalledProcessError:
                    continue
                except FileNotFoundError:
                    return None
                os.replace(tmp, _LIB)
                return _LIB
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


_lib_handle = None


def _load():
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    path = build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # a library built on another machine (a copied checkout) against a
        # libjpeg that this one does not have
        return None
    lib.yt_pool_create.restype = ctypes.c_void_p
    lib.yt_pool_create.argtypes = [ctypes.c_int]
    lib.yt_pool_destroy.restype = None
    lib.yt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.yt_decode_resize_batch.restype = ctypes.c_int
    lib.yt_decode_resize_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    _lib_handle = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeDecoder:
    """Threaded JPEG decode + resize into one contiguous uint8 batch."""

    def __init__(self, num_threads: int = 8):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable (g++/libjpeg)")
        self._pool = self._lib.yt_pool_create(num_threads)

    def __del__(self):
        if getattr(self, "_pool", None) and self._lib is not None:
            self._lib.yt_pool_destroy(self._pool)
            self._pool = None

    def decode_batch(self, paths: List[str], out_h: int, out_w: int,
                     fast: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """paths → (images (n, out_h, out_w, 3) u8, original sizes (n, 2)
        [w, h] int32, number of failures). ``fast=True`` selects libjpeg's
        fast IDCT and DCT-domain prescaling (not pixel-exact); training
        keeps ``fast=False``, PIL's decode within one level."""
        n = len(paths)
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        sizes = np.zeros((n, 2), np.int32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        failures = self._lib.yt_decode_resize_batch(
            self._pool, arr, n, out_h, out_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            1 if fast else 0)
        return out, sizes, int(failures)
