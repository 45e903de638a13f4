"""ctypes bindings for the native IO runtime (csrc/slamio.cc, the port's
byte-equal copy of the JAX package's native/slamio.cc): a grayscale PNG/PGM
decoder and a background-thread prefetcher.

Counterpart of the JAX package's utils/native_io.py.  The library is built
with one g++ call (zlib, pthreads) into the package's `_build/` directory
the first time a process decodes an image, never at import, and cached by
the hash of its source; the JAX package's committed libslamio.so is never
read.  Without a toolchain load_gray returns None and the caller decodes
with PIL (utils/datasets._load_gray); build_error says why.  Decoding runs
on the host: it is not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from ..kernels import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "slamio.cc"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
GXX_LIBS = ("-lz", "-lpthread")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
build_error: Optional[str] = None   # why the library is unavailable, if it is
library_path: Optional[str] = None  # the loaded library


def _build() -> str:
    """Compile the source (or reuse the cached library); returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        GXX_FLAGS + GXX_LIBS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libslamio_{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *GXX_LIBS],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return str(lib)


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, build_error, library_path
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _build()
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError) as exc:   # no g++, no zlib.h, or no loader
        build_error = str(exc)
        return None
    lib.slamio_load_gray.restype = ctypes.POINTER(ctypes.c_float)
    lib.slamio_load_gray.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.slamio_free.restype = None
    lib.slamio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.slamio_prefetch_start.restype = ctypes.c_void_p
    lib.slamio_prefetch_start.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                          ctypes.c_int, ctypes.c_int]
    lib.slamio_prefetch_next.restype = ctypes.POINTER(ctypes.c_float)
    lib.slamio_prefetch_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    lib.slamio_prefetch_stop.restype = None
    lib.slamio_prefetch_stop.argtypes = [ctypes.c_void_p]
    _LIB, library_path = lib, path
    return lib


def available() -> bool:
    return _build_and_load() is not None


def load_gray(path: str) -> Optional[np.ndarray]:
    """Decode an image to float32 grayscale via the native library.
    Returns None if the library or format is unsupported (caller falls back)."""
    lib = _build_and_load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    ptr = lib.slamio_load_gray(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(h.value, w.value)).copy()
    finally:
        lib.slamio_free(ptr)
    return arr


class Prefetcher:
    """Background-thread image decoding ahead of the tracking loop
    (the native analogue of the reference drivers' synchronous imread)."""

    def __init__(self, paths: list[str], capacity: int = 4):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError(f"native IO library unavailable: {build_error}")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._n = len(paths)
        self._handle = lib.slamio_prefetch_start(arr, len(paths), capacity)  # copies the paths
        self._served = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._served >= self._n:
            raise StopIteration
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = self._lib.slamio_prefetch_next(self._handle, ctypes.byref(w), ctypes.byref(h))
        self._served += 1
        if not ptr:
            raise IOError("decode failed in prefetcher")
        try:
            return np.ctypeslib.as_array(ptr, shape=(h.value, w.value)).copy()
        finally:
            self._lib.slamio_free(ptr)

    def close(self):
        if getattr(self, "_handle", None):  # None after close, absent if __init__ raised
            self._lib.slamio_prefetch_stop(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
