"""Build and load the port's CUDA kernels (`linemod_tpu_torch/csrc/*.cu`).

Each source is compiled by nvcc for `sm_90a` into its own shared library
with a plain C interface, under `build/kernels/` at the root of the
checkout, and bound with ctypes. A library's file name carries a hash of
its source and the flags, so an edited kernel is rebuilt. `build(names)`
starts one nvcc per source whose library is missing, all at once, and waits
for every one of them; `load(name, signatures)` builds what is missing of
`SOURCES` (the first kernel a process loads starts the nvcc of every
source, so they build side by side) and binds the source's C functions;
`launch(...)` calls one of them on the current stream, the path every
kernel wrapper takes. Every C function launches on the stream it is given,
does not synchronise, and returns cudaGetLastError() (0 = launched).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("similarity", "quantize", "probes")

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
    """Build (once per source version, beside the other missing `SOURCES`)
    and load `csrc/<name>.cu`, binding each C function in `signatures`
    ({function: ctypes argtypes}) with an int return (a CUDA error code)."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        build(SOURCES if name in SOURCES else [name])
        lib = ctypes.CDLL(build_info[name]["path"])
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libraries[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# (source, function) -> the bound C function, so that a launch after the
# first takes no lock and no attribute lookup
_bound: dict[tuple[str, str], object] = {}
# the current stream's raw handle, without building a torch.cuda.Stream
_raw_stream = getattr(
    torch._C, "_cuda_getCurrentRawStream",
    lambda index: torch.cuda.current_stream(index).cuda_stream,
)


def launch(source: str, signatures: dict, fn: str, device, *args) -> None:
    """Call C function `fn` of `csrc/<source>.cu` with `args` and the current
    stream of CUDA `device`, and raise if the launch failed. The device is
    made current for the call only when it is not already."""
    func = _bound.get((source, fn))
    if func is None:
        func = getattr(load(source, signatures), fn)
        _bound[(source, fn)] = func
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = func(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = func(*args, _raw_stream(index))
    check_launch(fn, err)
