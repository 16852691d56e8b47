"""The public LINEMOD dataset's raw `.dpt` depth format (the port's own copy
of `linemod_tpu/utils/io.py`, which replaces parts of src/utility.cpp)."""

from __future__ import annotations

import struct

import numpy as np


def load_depth_linemod_dataset(path: str) -> np.ndarray:
    """Load a `.dpt` depth: int32 rows, int32 cols, then row-major uint16 mm
    (src/utility.cpp:99-127)."""
    with open(path, "rb") as f:
        rows, cols = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(rows * cols * 2), dtype="<u2")
    return data.reshape(rows, cols).copy()


def save_depth_linemod_dataset(path: str, depth: np.ndarray) -> None:
    depth = np.ascontiguousarray(depth.astype("<u2"))
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", depth.shape[0], depth.shape[1]))
        f.write(depth.tobytes())
