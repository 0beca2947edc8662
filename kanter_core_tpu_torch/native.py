"""ctypes binding for the host-runtime spill hash (`native/kanter_native.cpp`).

The library is built on first use with g++ (plain C ABI, no Python headers)
into the package's `_build/` directory, keyed by a hash of the source and of
the host CPU's feature flags (it is built `-march=native`, so a library
copied from another machine must rebuild rather than die of SIGILL). Without
a toolchain the hash falls back to hashlib.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from .build import build_library

_CPP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "kanter_native.cpp",
)

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _host_key() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    return platform.machine() + flags


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = build_library(
                "kanter_native", [_CPP],
                ["g++", "-O3", "-march=native", "-shared", "-fPIC"],
                key=_host_key(), timeout=120,
            )
            lib = ctypes.CDLL(path)
            lib.salted_hash64.restype = ctypes.c_uint64
            lib.salted_hash64.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,
            ]
            _lib = lib
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            # no toolchain / build error → hashlib fallback
            _build_failed = True
    return _lib


def salted_hash64(data: bytes | np.ndarray, salt: int) -> str:
    """Hex digest of the salted content hash used for spill-file names."""
    if not isinstance(data, np.ndarray):
        data = np.frombuffer(data, dtype=np.uint8)
    data = np.ascontiguousarray(data)
    lib = _load()
    if lib is None:
        h = hashlib.blake2b(int(salt).to_bytes(16, "little"), digest_size=8)
        h.update(data.tobytes())
        return h.hexdigest()
    value = lib.salted_hash64(
        data.ctypes.data, data.nbytes, ctypes.c_uint64(salt & (2**64 - 1)).value
    )
    return f"{value:016x}"
