"""Mesh import by extension: PLY, Wavefront OBJ and STL.

The port's own copy of `linemod_tpu/utils/mesh_io.py`, which replaces the
reference's assimp import: PLY through `utils/ply`, OBJ (ASCII, polygon
faces fan-triangulated) and STL (binary and ASCII; vertices joined by exact
coordinate identity, facet normals averaged per vertex). A mesh without
colors is white, as in the reference.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .ply import Mesh, load_ply


def load_obj(path: str) -> Mesh:
    """Wavefront OBJ: v/vn records and polygonal f records, fan-triangulated.
    Textures and materials are ignored; a file without colors is white."""
    verts: list = []
    normals: list = []
    colors: list = []
    faces: list = []
    vert_normal_idx: dict[int, int] = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:  # non-standard but common: v x y z r g b
                    colors.append([float(x) for x in parts[4:7]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                idx = []
                for vert in parts[1:]:
                    fields = vert.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    if len(fields) >= 3 and fields[2]:
                        ni = int(fields[2])
                        vert_normal_idx[vi] = ni - 1 if ni > 0 else len(normals) + ni
                    idx.append(vi)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    if len(colors) == len(verts) and len(colors) > 0:
        c = np.asarray(colors, np.float32)
        if c.max() > 1.0:
            c = c / 255.0
    else:
        c = np.ones_like(v)  # white when the file has no colors
    n = None
    if normals and vert_normal_idx:
        narr = np.asarray(normals, np.float32)
        n = np.zeros_like(v)
        for vi, ni in vert_normal_idx.items():
            n[vi] = narr[ni]
        norms = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(norms > 0, n / np.maximum(norms, 1e-12), 0.0).astype(np.float32)
    return Mesh(
        vertices=v,
        colors=c,
        indices=np.asarray(faces, np.uint32),
        normals=n,
    )


def load_stl(path: str) -> Mesh:
    """STL (binary or ASCII): the triangle soup joined into an indexed mesh
    by exact vertex identity; a vertex's normal is the normalized mean of its
    facets' normals; white (STL has no colors)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header: try ASCII, fall back
        try:
            tris, fnrm = _parse_stl_ascii(path)
        except ValueError:
            tris, fnrm = _parse_stl_binary(path)
    else:
        tris, fnrm = _parse_stl_binary(path)
    flat = tris.reshape(-1, 3)
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.uint32)
    # accumulate facet normals onto shared vertices
    n = np.zeros_like(verts)
    np.add.at(n, faces.ravel(), np.repeat(fnrm, 3, axis=0))
    norms = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norms > 0, n / np.maximum(norms, 1e-12), 0.0).astype(np.float32)
    return Mesh(
        vertices=verts.astype(np.float32),
        colors=np.ones_like(verts, dtype=np.float32),
        indices=faces,
        normals=n,
    )


def _parse_stl_binary(path: str):
    with open(path, "rb") as f:
        f.seek(80)
        (count,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(count * 50), dtype=np.uint8)
    rec = data.reshape(count, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(count, 12)
    fnrm = floats[:, 0:3]
    tris = floats[:, 3:12].reshape(count, 3, 3)
    return tris, fnrm


def _parse_stl_ascii(path: str):
    tris = []
    fnrm = []
    cur: list = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "facet" and parts[1] == "normal":
                fnrm.append([float(x) for x in parts[2:5]])
            elif parts[0] == "vertex":
                cur.append([float(x) for x in parts[1:4]])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    if not tris:
        raise ValueError("no ASCII STL facets found")
    return np.asarray(tris, np.float32), np.asarray(fnrm, np.float32)


def load_mesh(path: str) -> Mesh:
    """Load a PLY, OBJ or STL mesh, chosen by the file's extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path)
    if ext == ".obj":
        return load_obj(path)
    if ext == ".stl":
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {ext} ({path})")
