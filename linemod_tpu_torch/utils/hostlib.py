"""Build and load the port's host C++ (`linemod_tpu_torch/csrc/*.cpp`).

Each source is compiled by g++ into its own shared library under
`build/host/` at the root of the checkout, at first use, and loaded with
ctypes. The file name carries a hash of the source and the flags, so an
edited source or a change of flags builds anew. A failed build raises:
the port has no fallback for its host code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def library_path(name: str, flags: tuple) -> str:
    """Where csrc/<name>.cpp built with `flags` lives."""
    with open(os.path.join(CSRC, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def load(name: str, flags: tuple) -> ctypes.CDLL:
    """csrc/<name>.cpp as a loaded library: `g++ <flags> -o <lib>` when the
    library is missing (written to a temporary name, then renamed, so a
    concurrent process never loads half a file). One library a name per
    process."""
    with _lock:
        if name in _libraries:
            return _libraries[name]
        path = library_path(name, flags)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            source = os.path.join(CSRC, f"{name}.cpp")
            out = subprocess.run(["g++", *flags, "-o", tmp, source], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed on {source}:\n{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        _libraries[name] = ctypes.CDLL(path)
        return _libraries[name]
