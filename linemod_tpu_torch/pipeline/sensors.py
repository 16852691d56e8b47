"""Frame sources (counterpart of `linemod_tpu/pipeline/sensors.py`, which
replaces the reference's Kinect2 wrapper, src/Kinect2.cpp).

Sensors are iterables yielding (color BGR uint8 [H, W, 3], depth mm uint16
[H, W]) pairs. `FileSequenceSource` replays recorded sequences (the
detector's default input, detector.cpp:12-25): color frames are PNG, depth
frames PNG or the LINEMOD dataset's `.dpt`. The port has no image codec
library, so it decodes PNG only (`utils/png`): any other color file, a JPEG
for one, raises a ValueError that names it, and no frame is skipped.
`Kinect2Source` keeps the reference's frame math (`from_raw_frames`); its
live device needs libfreenect2 and USB, which the port does not bind.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.io import load_depth_linemod_dataset
from ..utils.png import read_png


def frame_paths(img_template: str, depth_template: str, i: int) -> tuple:
    """Frame i's (color, depth) paths; a template without `%` is one file."""
    img = img_template % i if "%" in img_template else img_template
    depth = depth_template % i if "%" in depth_template else depth_template
    return img, depth


def load_frame(img_path: str, depth_path: str) -> tuple:
    """(color, depth) of one frame on the host."""
    color = read_png(img_path, "color")
    if depth_path.endswith(".dpt"):
        depth = load_depth_linemod_dataset(depth_path)
    else:
        depth = read_png(depth_path, "anydepth")
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
