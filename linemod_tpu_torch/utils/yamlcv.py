"""OpenCV-FileStorage-compatible YAML (the port's counterpart of
`linemod_tpu/utils/yamlcv.py`): `write_yamlcv` is the JAX package's
writer, `read_yamlcv` its reader, built over `utils/cvyaml.parse_yaml`
instead of PyYAML."""

from __future__ import annotations

import numpy as np

from .cvyaml import parse_yaml


def _resolve(node):
    """Matrix mappings (rows, cols, dt, data) -> float64 arrays, recursively."""
    if isinstance(node, dict):
        if {"rows", "cols", "dt", "data"} <= set(node):
            return np.array(node["data"], np.float64).reshape(int(node["rows"]), int(node["cols"]))
        return {k: _resolve(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v) for v in node]
    return node


def read_yamlcv(path: str) -> dict:
    """Read an OpenCV FileStorage YAML file into a dict: `!!opencv-matrix`
    nodes become float64 arrays of shape (rows, cols)."""
    with open(path) as f:
        data = parse_yaml(f.read())
    return {} if data is None else _resolve(data)


def _fmt_scalar(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return f'"{v}"'


def write_yamlcv(path: str, data: dict) -> None:
    """Write a dict to OpenCV-FileStorage-compatible YAML.

    numpy 2-D arrays are emitted as `!!opencv-matrix` nodes so the files can be
    read back by OpenCV's FileStorage (and by `read_yamlcv`).
    """
    out = ["%YAML:1.0", "---"]
    for key, val in data.items():
        if isinstance(val, np.ndarray) and val.ndim == 2:
            out.append(f"{key}: !!opencv-matrix")
            out.append(f"   rows: {val.shape[0]}")
            out.append(f"   cols: {val.shape[1]}")
            out.append("   dt: d")
            flat = ", ".join(repr(float(x)) for x in val.ravel())
            out.append(f"   data: [ {flat} ]")
        elif isinstance(val, (list, tuple, np.ndarray)):
            flat = ", ".join(_fmt_scalar(x) for x in np.asarray(val).ravel())
            out.append(f"{key}: [ {flat} ]")
        else:
            out.append(f"{key}: {_fmt_scalar(val)}")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
