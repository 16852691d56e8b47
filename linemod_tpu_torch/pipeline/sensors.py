"""Frame sources (counterpart of `linemod_tpu/pipeline/sensors.py`, which
replaces the reference's Kinect2 wrapper, src/Kinect2.cpp).

Sensors are iterables yielding (color BGR uint8 [H, W, 3], depth mm uint16
[H, W]) pairs. `FileSequenceSource` replays recorded sequences (the
detector's default input, detector.cpp:12-25): frames are read as the
reference reads them with `cv2.imread` (color with IMREAD_COLOR, depth with
IMREAD_ANYDEPTH, or the LINEMOD dataset's `.dpt`). A file is decoded by its
leading bytes, as `cv2.imread` picks its codec: PNG by `utils/png`, JPEG
(baseline, extended and progressive; the public LINEMOD layout's
`color%d.jpg`) by `utils/jpeg`, TIFF by `utils/tiff`, BMP by `utils/bmp`,
PNM and PAM by `utils/pnm`. A format cv2 reads and the port does not
(WebP, JPEG 2000, AVIF, GIF, Radiance HDR, Sun raster, PFM, OpenEXR), and
any other file, raises a ValueError that names the file and the format;
no frame is skipped.
`Kinect2Source` keeps the reference's frame math (`from_raw_frames`); its
live device needs libfreenect2 and USB, which the port does not bind.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import bmp, pnm, tiff
from ..utils.io import load_depth_linemod_dataset
from ..utils.jpeg import SOI, read_jpeg
from ..utils.png import _SIGNATURE as PNG_SIGNATURE
from ..utils.png import read_png

# formats cv2.imread reads that the port refuses, by their leading bytes
# (offset, bytes): WebP and AVIF by their RIFF / ISO-BMFF brand
_REFUSED = (
    ("WebP", ((0, b"RIFF"), (8, b"WEBP"))),
    ("JPEG 2000", ((0, b"\xff\x4f\xff\x51"),)),
    ("JPEG 2000", ((0, b"\x00\x00\x00\x0cjP  \r\n\x87\n"),)),
    ("AVIF", ((4, b"ftypavif"),)),
    ("AVIF", ((4, b"ftypavis"),)),
    ("GIF", ((0, b"GIF87a"),)),
    ("GIF", ((0, b"GIF89a"),)),
    ("Radiance HDR", ((0, b"#?RADIANCE"),)),
    ("Radiance HDR", ((0, b"#?RGBE"),)),
    ("Sun raster", ((0, b"\x59\xa6\x6a\x95"),)),
    ("PFM", ((0, b"PF"),)),
    ("PFM", ((0, b"Pf"),)),
    ("OpenEXR", ((0, b"\x76\x2f\x31\x01"),)),
)


def frame_paths(img_template: str, depth_template: str, i: int) -> tuple:
    """Frame i's (color, depth) paths; a template without `%` is one file."""
    img = img_template % i if "%" in img_template else img_template
    depth = depth_template % i if "%" in depth_template else depth_template
    return img, depth


def read_image(path: str, mode: str) -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR) (mode "color") or IMREAD_ANYDEPTH
    ("anydepth") of a PNG, JPEG, TIFF, BMP or PNM/PAM file, told apart by
    their leading bytes."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:8] == PNG_SIGNATURE:
        return read_png(path, mode)
    if head[:2] == SOI:
        return read_jpeg(path, mode)
    if head[:4] in tiff.SIGNATURES + tiff.BIGTIFF_SIGNATURES:
        return tiff.read_tiff(path, mode)
    if head[:2] == bmp.SIGNATURE:
        return bmp.read_bmp(path, mode)
    if len(head) > 2 and head[0] == ord("P") and head[1] in b"1234567" and head[2] in b" \t\r\n":
        return pnm.read_pnm(path, mode)
    for name, marks in _REFUSED:
        if all(head[at : at + len(mark)] == mark for at, mark in marks):
            raise ValueError(f"{path}: a {name} file (cv2.imread reads it; the port does not decode {name})")
    raise ValueError(f"{path}: not a PNG, JPEG, TIFF, BMP or PNM file")


def load_frame(img_path: str, depth_path: str) -> tuple:
    """(color, depth) of one frame on the host."""
    color = read_image(img_path, "color")
    if depth_path.endswith(".dpt"):
        depth = load_depth_linemod_dataset(depth_path)
    else:
        depth = read_image(depth_path, "anydepth")
    return color, depth


class FrameSource:
    """Iterable of (color, depth) frames."""

    def __iter__(self):
        raise NotImplementedError


class FileSequenceSource(FrameSource):
    """Frames `start`, `start` + 1, ... of a numbered sequence, up to the
    first color file that does not exist."""

    def __init__(self, img_template: str, depth_template: str, start: int = 0):
        self.img_template = img_template
        self.depth_template = depth_template
        self.start = start

    def __iter__(self):
        i = self.start
        while True:
            img_path, depth_path = frame_paths(self.img_template, self.depth_template, i)
            if not os.path.exists(img_path):
                return
            yield load_frame(img_path, depth_path)
            i += 1


class ArraySource(FrameSource):
    """In-memory frames (tests, synthetic data)."""

    def __init__(self, frames):
        self.frames = list(frames)

    def __iter__(self):
        return iter(self.frames)


class Kinect2Source(FrameSource):
    """Kinect v2 via libfreenect2 (capability parity with src/Kinect2.cpp:3-61).

    The frame math (depth-to-color registration, float mm to uint16, the
    1920x1080 to 640x480 centre crop, BGRA to BGR and the horizontal flip,
    src/Kinect2.cpp:41-61) is in ops/registration.py; only the USB device
    is hardware-gated. A raw recording (bgra [1080, 1920, 4] and big-depth
    [1082, 1920] pairs) replays through `from_raw_frames` without hardware."""

    def __init__(self):
        try:
            import freenect2  # noqa: F401  (no binding ships with the port)
        except ImportError as e:
            raise RuntimeError(
                "Kinect2 live capture requires libfreenect2 python bindings and "
                "USB hardware, neither of which is available in this "
                "environment. Use Kinect2Source.from_raw_frames to replay raw "
                "recordings, or FileSequenceSource for processed sequences."
            ) from e

    @staticmethod
    def from_raw_frames(raw_pairs):
        """Replay raw (bgra, bigdepth) recordings through the reference's
        frame transform (registration assumed already applied, as
        libfreenect2's Registration::apply does on the device)."""
        from ..ops.registration import kinect_frame_transform

        return ArraySource(
            [kinect_frame_transform(np.asarray(bgra), big) for bgra, big in raw_pairs]
        )
