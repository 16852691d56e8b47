"""Build and load the port's CUDA kernels (`linemod_tpu_torch/csrc/*.cu`).

Each source is compiled by nvcc for `sm_90a` into its own shared library
with a plain C interface, under `build/kernels/` at the root of the
checkout, and bound with ctypes. A library's file name carries a hash of
its source and the flags, so an edited kernel is rebuilt. `build(names)`
starts one nvcc per source whose library is missing, all at once, and waits
for every one of them; `load(name, signatures)` builds one source if needed
and binds its C functions. Every C function launches on the stream it is
given, does not synchronise, and returns cudaGetLastError() (0 = launched).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("similarity", "probes")

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
# per source: the library's path, the build's wall seconds (0 when it was
# already built) and nvcc's output (ptxas registers and spills)
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(names=SOURCES) -> None:
    """Compile every named source whose library is missing: one nvcc process
    per source, all started together. Raises if any of them fails."""
    t0 = time.perf_counter()
    running = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            build_info.setdefault(name, {"path": path, "seconds": 0.0, "log": ""})
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        running[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (path, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
        build_info[name] = {"path": path, "seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once per source version) and load `csrc/<name>.cu`, binding
    each C function in `signatures` ({function: ctypes argtypes}) with an int
    return (a CUDA error code)."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        build([name])
        lib = ctypes.CDLL(build_info[name]["path"])
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libraries[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
