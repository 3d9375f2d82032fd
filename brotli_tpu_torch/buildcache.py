"""Build cache for the port's compiled libraries.

Libraries are built at first use into brotli_tpu_torch/_build/ under a
name that carries a hash of everything that decides their content, so
a library with the name is never stale.  Processes that need the same
library at once wait on a per-library file lock, and one of them
builds it; the library appears under its final name atomically.

CudaLibrary builds one CUDA source of csrc/ with nvcc for sm_90a into
a shared library with a plain C interface and loads it with ctypes;
every kernel of the port is built and loaded this way.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_once(name: str, compile_to) -> tuple[str, str]:
    """Path of library `name` in the build directory, built first if it
    is missing by `compile_to(path, workdir)`, which writes the library
    to `path` and returns the compiler's log.  Returns (path, log); the
    log is empty when the library was already there."""
    out = os.path.join(BUILD_DIR, name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out, ""
        work = tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR)
        try:
            tmp = os.path.join(work, name)
            log = compile_to(tmp, work)
            os.replace(tmp, out)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out, log


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("brotli_tpu_torch: nvcc not found; the CUDA "
                           "kernels cannot be built")
    return path


class CudaLibrary:
    """csrc/<stem>.cu, or the CUDA source `src`, as a ctypes library,
    built at first use.  `bind(lib)` sets the argtypes and restype of its
    C functions."""

    def __init__(self, stem: str, bind, src: str | None = None):
        self.stem = stem
        self.src = src or os.path.join(_PKG, "csrc", f"{stem}.cu")
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None

    def _compile(self, out: str, work: str) -> str:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, self.src, "-o", out],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"brotli_tpu_torch: nvcc failed on {self.src}\n"
                + r.stdout[-4000:] + r.stderr[-4000:])
        return r.stdout + r.stderr

    def build(self) -> tuple[str, str]:
        """Compile the source unless the library for this source and
        these flags is there.  Returns the library's path and the
        compiler's log (ptxas register and spill report; empty when the
        library was already built)."""
        h = hashlib.sha256()
        with open(self.src, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return build_once(f"lib{self.stem}_{h.hexdigest()[:16]}.so",
                          self._compile)

    def get(self):
        """The loaded library (built first if needed)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build()[0])
                self._bind(lib)
                self._lib = lib
        return self._lib
