"""Build-on-first-use for the package's native sources.

Each shared library is compiled from the sources in the checkout into
`_build/` (listed in `.gitignore`) the first time a caller needs it. The file
name carries a hash of the sources, the compiler command and a caller key,
so an edited source or a changed flag rebuilds instead of loading a stale
library. Nothing here runs at import time: the CPU path never compiles.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_locks: dict = {}  # library path → its build lock (distinct libraries build in parallel)
_locks_guard = threading.Lock()


def build_library(name: str, sources: list, command: list, key: str = "",
                  timeout: float = 600.0) -> str:
    """Compile `sources` with `command` (the compiler and its flags, without
    `-o` or the sources) into `_build/<name>-<hash>.so` unless that library
    already exists; returns its path. The compiler's diagnostics land beside
    it as `<path>.log`. Raises RuntimeError with the compiler's output when
    the build fails."""
    digest = hashlib.sha256()
    for source in sources:
        with open(source, "rb") as f:
            digest.update(f.read())
    digest.update(repr((command, key)).encode())
    path = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    with _locks_guard:
        lock = _locks.setdefault(path, threading.Lock())
    with lock:
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [*command, "-o", tmp, *sources],
            capture_output=True, text=True, timeout=timeout,
        )
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}):\n"
                + proc.stdout + proc.stderr
            )
        # atomic publish: a concurrent process never loads a partial file
        os.replace(tmp, path)
    return path


# sm_90a keeps Hopper's arch-specific instructions available; -fmad=false
# keeps every product separately rounded (the kernels' bit-exactness rests
# on it); -Xptxas -v writes each kernel's registers and spills to the log
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


class CudaKernel:
    """One hand-written kernel source under `csrc/`, built with nvcc into a
    shared library with a plain C entry point `symbol` on first use and
    loaded through ctypes, and the count of its launches (`launches`: the
    wrapper calls `count_launch` once per launch of the kernel, and
    nowhere else)."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.source = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "csrc", f"{name}.cu"
        )
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.path = None  # the built library; its compiler output is path + ".log"
        self._fn = None
        self._lock = threading.Lock()

    def entry(self):
        """The C entry point (building and loading the library on first
        use); raises RuntimeError if the build fails."""
        with self._lock:
            if self._fn is None:
                import ctypes

                self.path = build_library(self.name, [self.source], [nvcc(), *NVCC_FLAGS])
                fn = getattr(ctypes.CDLL(self.path), self.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._fn = fn
            return self._fn

    def count_launch(self) -> None:
        with self._lock:
            self.launches += 1
