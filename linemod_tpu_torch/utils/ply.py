"""PLY mesh loader (ASCII and binary, either byte order) and ASCII writer.

The port's own copy of `linemod_tpu/utils/ply.load_ply`, which replaces the
reference's assimp import (src/ModelImporter.cpp:13-83): fills vertices,
per-vertex colors (white fallback when the file has none,
src/ModelImporter.cpp:64-71), uint32 triangle indices, and normals when
present. The bundled fixture is ASCII with per-vertex normals and no colors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_DTYPES = {
    "char": np.int8,
    "uchar": np.uint8,
    "short": np.int16,
    "ushort": np.uint16,
    "int": np.int32,
    "uint": np.uint32,
    "float": np.float32,
    "double": np.float64,
    "int8": np.int8,
    "uint8": np.uint8,
    "int16": np.int16,
    "uint16": np.uint16,
    "int32": np.int32,
    "uint32": np.uint32,
    "float32": np.float32,
    "float64": np.float64,
}


@dataclasses.dataclass
class Mesh:
    """Triangle mesh in model units (mm). Mirrors `Model` (include/defines.h:16-23)."""

    vertices: np.ndarray  # [V, 3] float32
    colors: np.ndarray  # [V, 3] float32 in [0, 1]
    indices: np.ndarray  # [F, 3] uint32
    normals: np.ndarray | None = None  # [V, 3] float32 or None

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.indices.shape[0])

    def subsampled_vertices(self, step: int) -> np.ndarray:
        """Every step-th vertex (Benchmark::subsamplingModel, src/Benchmark.cpp:172-180)."""
        return self.vertices[::step]


def _parse_header(f):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) or ('list', count_dt, item_dt, name)])
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.strip().decode("ascii", "replace").split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1][2].append(("list", _DTYPES[tokens[2]], _DTYPES[tokens[3]], tokens[4]))
            else:
                elements[-1][2].append((tokens[-1], _DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    return fmt, elements


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            data = _read_ascii(f, elements)
        elif fmt == "binary_little_endian":
            data = _read_binary(f, elements, "<")
        elif fmt == "binary_big_endian":
            data = _read_binary(f, elements, ">")
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    vert = data.get("vertex", {})
    verts = np.stack([vert["x"], vert["y"], vert["z"]], axis=1).astype(np.float32)
    if "red" in vert:
        scale = 255.0 if vert["red"].dtype == np.uint8 else 1.0
        colors = (
            np.stack([vert["red"], vert["green"], vert["blue"]], axis=1).astype(np.float32)
            / scale
        )
    else:
        # White fallback, as the reference importer does (src/ModelImporter.cpp:64-71).
        colors = np.ones_like(verts)
    normals = None
    if "nx" in vert:
        normals = np.stack([vert["nx"], vert["ny"], vert["nz"]], axis=1).astype(np.float32)

    if "face" in data and "vertex_indices" in data["face"]:
        faces = data["face"]["vertex_indices"]
    elif "face" in data and "vertex_index" in data["face"]:
        faces = data["face"]["vertex_index"]
    else:
        faces = np.zeros((0, 3), dtype=np.uint32)
    return Mesh(vertices=verts, colors=colors, indices=faces.astype(np.uint32), normals=normals)


def _read_ascii(f, elements):
    out = {}
    text = f.read().decode("ascii", "replace").split("\n")
    cursor = 0
    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        rows = text[cursor : cursor + count]
        cursor += count
        if not has_list:
            arr = np.loadtxt(rows, dtype=np.float64, ndmin=2)
            out[name] = {p[0]: arr[:, i].astype(p[1]) for i, p in enumerate(props)}
        else:
            # Faces: assume triangles (the reference triangulates on import).
            tri = np.loadtxt(rows, dtype=np.float64, ndmin=2)
            out[name] = {props[0][3]: tri[:, 1:4].astype(np.uint32)}
    return out


def _read_binary(f, elements, endian):
    out = {}
    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        if not has_list:
            dt = np.dtype([(p[0], endian + np.dtype(p[1]).str[1:]) for p in props])
            raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
            out[name] = {p[0]: raw[p[0]].copy() for p in props}
        else:
            # Variable-length lists: parse row by row (faces only; counts are small).
            lname = next(p for p in props if p[0] == "list")
            cnt_dt = np.dtype(lname[1]).newbyteorder(endian)
            item_dt = np.dtype(lname[2]).newbyteorder(endian)
            faces = []
            for _ in range(count):
                n = int(np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0])
                idx = np.frombuffer(f.read(item_dt.itemsize * n), dtype=item_dt)
                if n == 3:
                    faces.append(idx)
                else:
                    for k in range(1, n - 1):  # fan-triangulate
                        faces.append(np.array([idx[0], idx[k], idx[k + 1]], dtype=item_dt))
            out[name] = {lname[3]: np.asarray(faces, dtype=np.uint32)}
    return out


def save_ply(path: str, mesh: Mesh) -> None:
    """Write an ASCII PLY (vertices, normals where the mesh has them, faces),
    byte for byte as the JAX package's save_ply writes it."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {mesh.num_vertices}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if mesh.normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write(f"element face {mesh.num_faces}\n")
        f.write("property list uchar uint vertex_indices\nend_header\n")
        for i in range(mesh.num_vertices):
            row = list(mesh.vertices[i])
            if mesh.normals is not None:
                row += list(mesh.normals[i])
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        for tri in mesh.indices:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
