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
import subprocess
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_lock = threading.Lock()


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
    with _lock:
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
