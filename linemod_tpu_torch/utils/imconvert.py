"""The sample conversions `cv2.imread` applies after a codec has decoded a
frame, shared by the port's frame readers (`utils/png`, `utils/tiff`,
`utils/pnm`, `utils/bmp`).

Samples come in as [H, W, C] arrays, uint8 or uint16, C = 1 (gray) or 3
(color, in the order given), alpha already dropped. Two read modes:

- `"color"` (`cv2.IMREAD_COLOR`): BGR uint8 [H, W, 3]; gray is replicated
  and a 16-bit sample keeps its high byte (0x1280 and 0x12ff both give 18).
- `"anydepth"` (`cv2.IMREAD_ANYDEPTH`): gray [H, W] at the file's own depth.
  A color file becomes imread's gray, `(1868 B + 9617 G + 4899 R + 2^13)
  >> 14` at 8 and 16 bits alike (imgcodecs' `icvCvt_BGR2Gray`). That is not
  `cvtColor`'s 16-bit fixed point (`ops/aruco.to_gray`): the two differ on
  43,864 of the 2^24 8-bit triples, and imread's is the one held to cv2 over
  all of them (tests/test_torch_imread.py). A PNG's color-to-gray is
  libpng's and stays in `utils/png`.
"""

from __future__ import annotations

import numpy as np

MODES = ("color", "anydepth")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown read mode {mode!r} (one of {MODES})")


def gray(px: np.ndarray, order: str = "bgr") -> np.ndarray:
    """imread's gray of color samples [H, W, 3] (uint8 or uint16) in channel
    `order` ("bgr" or "rgb"), in their own dtype."""
    p = px.astype(np.int64)
    b, r = (p[..., 0], p[..., 2]) if order == "bgr" else (p[..., 2], p[..., 0])
    return ((1868 * b + 9617 * p[..., 1] + 4899 * r + 8192) >> 14).astype(px.dtype)


def high_byte(px: np.ndarray) -> np.ndarray:
    """uint16 samples cut to their high byte; uint8 unchanged."""
    return (px >> 8).astype(np.uint8) if px.dtype == np.uint16 else px


def convert(px: np.ndarray, mode: str, order: str = "bgr") -> np.ndarray:
    """Samples [H, W, 1 or 3] (uint8 or uint16) as imread gives them in
    `mode`: BGR uint8 for "color", gray at the samples' depth for
    "anydepth"."""
    check_mode(mode)
    if mode == "color":
        px = high_byte(px)
        if px.shape[2] == 1:
            return np.repeat(px, 3, axis=2)
        return np.ascontiguousarray(px if order == "bgr" else px[:, :, ::-1])
    if px.shape[2] == 1:
        return np.ascontiguousarray(px[:, :, 0])
    return gray(px, order)
