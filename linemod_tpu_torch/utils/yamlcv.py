"""OpenCV-FileStorage-compatible YAML writing (the port's own copy of
`linemod_tpu/utils/yamlcv.write_yamlcv`). The reading side is
`utils/cvyaml`, which needs no PyYAML."""

from __future__ import annotations

import numpy as np


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
    read back by OpenCV's FileStorage (and by `utils/cvyaml.read_cvyaml`).
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
