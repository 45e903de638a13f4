"""Build, load and count the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled with `nvcc` for `sm_90a` into a shared
library with a plain C interface the first time a process launches it, and
loaded with `ctypes`.  Libraries are cached by the hash of their source in
the package's `_build/` directory (listed in `.gitignore`), so a fresh
checkout builds everything it runs and nothing else is read or written
outside the checkout.  Nothing here runs at import time: the CPU tests import
every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaKernel:
    """One C entry point of one `.cu` source.

    `launches` counts the wrapper's kernel launches (the wrapper adds one
    after each successful launch); `build_log` keeps nvcc's `-Xptxas -v`
    report of registers and shared memory once the library is built.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def build(self) -> Path:
        """Compile the source (or reuse the cached library); returns its path.
        The cache key covers the source, every shared header beside it and
        the flags."""
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(self.source.parent.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"{self.source.stem}_{digest}.so"
        log = lib.with_suffix(".log")
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
        self.build_log = log.read_text() if log.exists() else ""
        return lib

    def function(self):
        """The loaded C entry point (builds on first use)."""
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


def check_launch(kernel: CudaKernel, rc: int) -> None:
    """Raise on a refused launch (the C side returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: kernel launch failed with CUDA "
                           f"error {rc}")
    kernel.launches += 1
