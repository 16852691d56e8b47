"""Camera viewpoints for template generation (numpy).

The port's own copy of `linemod_tpu/models/viewpoints.py`: an icosahedron
subdivided on a sphere of the given radius, or, for a rotationally
symmetric object, a circle of viewpoints in the y/z plane; then only the
vertices whose componentwise product with the model's `planes_of_symmetry`
is >= 0 are kept. The circle's step is exactly 60 / 2^s degrees.
"""

from __future__ import annotations

import numpy as np

GOLDEN_RATIO = (1.0 + np.sqrt(5.0)) / 2.0


def icosphere(radius: float, subdivisions: int) -> np.ndarray:
    """Subdivided icosahedron vertices on a sphere of `radius` (mm). [N, 3]."""
    a = np.sqrt(radius * radius / (GOLDEN_RATIO * GOLDEN_RATIO + 1.0))
    b = a * GOLDEN_RATIO
    verts = np.array(
        [
            [-a, 0, b], [a, 0, b], [-a, 0, -b], [a, 0, -b],
            [0, b, a], [0, b, -a], [0, -b, a], [0, -b, -a],
            [b, a, 0], [-b, a, 0], [b, -a, 0], [-b, -a, 0],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 4, 1], [0, 9, 4], [9, 5, 4], [4, 5, 8], [4, 8, 1],
            [8, 10, 1], [8, 3, 10], [5, 3, 8], [5, 2, 3], [2, 7, 3],
            [7, 10, 3], [7, 6, 10], [7, 11, 6], [11, 0, 6], [0, 1, 6],
            [6, 1, 10], [9, 0, 11], [9, 11, 2], [9, 2, 5], [7, 2, 11],
        ],
        dtype=np.int64,
    )

    for _ in range(subdivisions):
        # midpoint subdivision, each edge's midpoint made once (keyed by
        # its sorted vertex pair)
        edge_mid = {}
        verts_list = [v for v in verts]

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key in edge_mid:
                return edge_mid[key]
            m = (verts_list[i] + verts_list[j]) / 2.0
            m = m * (radius / np.linalg.norm(m))
            verts_list.append(m)
            edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for tri in faces:
            ia, ib, ic = (int(x) for x in tri)
            ab = midpoint(ia, ib)
            bc = midpoint(ib, ic)
            ac = midpoint(ia, ic)
            new_faces += [[ia, ab, ac], [ib, ab, bc], [ic, bc, ac], [ab, bc, ac]]
        faces = np.asarray(new_faces, dtype=np.int64)
        verts = np.asarray(verts_list, dtype=np.float64)

    return verts


def rot_sym_circle(radius: float, subdivisions: int) -> np.ndarray:
    """Circle of viewpoints in the y/z plane for rotationally symmetric objects."""
    step = 60.0 / (2.0**subdivisions)
    angles = np.deg2rad(np.arange(0.0, 360.0, step))
    return np.stack(
        [np.zeros_like(angles), np.sin(angles) * radius, np.cos(angles) * radius], axis=1
    )


def prune_by_symmetry(verts: np.ndarray, planes_of_symmetry) -> np.ndarray:
    """Keep vertices whose (v * planes) is componentwise >= 0."""
    planes = np.asarray(planes_of_symmetry, dtype=np.float64)
    scaled = verts * planes
    keep = np.all(scaled >= 0.0, axis=1)
    return verts[keep]


def camera_view_points(
    radius: float,
    subdivisions: int,
    rotationally_symmetrical: bool = False,
    planes_of_symmetry=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """The viewpoints of one radius."""
    if rotationally_symmetrical:
        verts = rot_sym_circle(radius, subdivisions)
    else:
        verts = icosphere(radius, subdivisions)
    return prune_by_symmetry(verts, planes_of_symmetry)
