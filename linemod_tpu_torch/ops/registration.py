"""Depth-to-color registration and the Kinect v2 frame transform
(counterpart of `linemod_tpu/ops/registration.py`, which re-implements the
frame math of the reference's Kinect2 wrapper, src/Kinect2.cpp:41-61).

1. `register_depth_to_color`: project every depth-camera pixel to 3-D with
   the depth (IR) intrinsics, transform it by the depth-to-color
   extrinsics, and z-buffer it into the color camera's pixel grid (the role
   of libfreenect2's Registration::apply "big depth" output). The z-buffer
   is a scatter of `amin` onto an inf-filled buffer, whose result does not
   depend on the order of the scatter.
2. `kinect_frame_transform`: float mm to uint16, the reference's centre
   crop of the 1920x1082 big-depth / 1920x1080 BGRA frame to 640x480
   (cv::Rect Point(640, 301) .. Point(1280, 781), src/Kinect2.cpp:53-56),
   BGRA to BGR, and the horizontal flip (src/Kinect2.cpp:58-60). Numpy.

The registration's arithmetic follows XLA's CPU program for the reference
op by op, so that no point moves to a neighbouring pixel: the intrinsics
are traced there, so `(x - cx) * z / fx` is a true division by a device
tensor (never a product with a reciprocal); the extrinsic product is three
`rasterizer.dot3` rows plus the translation (float32 products, the later
two fused; never a matmul, so TF32 cannot move it); and the projection
`x / z * f + c` is fused (`gradients._fma`). `torch.round` rounds half to
even, as `jnp.round` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .gradients import _fma
from .rasterizer import _f32, dot3

# Reference crop: cv::Rect(Point(320+320, 61+240), Point(1600-320, 1021-240))
# on the 1920-wide frames (src/Kinect2.cpp:53-56) -> x 640..1280, y 301..781.
CROP_X0, CROP_Y0 = 640, 301
CROP_W, CROP_H = 640, 480
BIGDEPTH_PAD_ROWS = 1  # libfreenect2 bigdepth is 1920 x (1080 + 2)


def register_depth_to_color(
    depth: torch.Tensor,  # [Hd, Wd] float32 mm, depth-camera frame (0 = invalid)
    k_depth,  # [3, 3] depth (IR) camera intrinsics
    k_color,  # [3, 3] color camera intrinsics
    rot,  # [3, 3] depth-to-color rotation
    trans,  # [3] depth-to-color translation (mm)
    *,
    out_width: int = 1920,
    out_height: int = 1080,
) -> torch.Tensor:
    """Reproject a depth image into the color camera ("big depth") on the
    depth tensor's device. The camera arguments may be arrays or tensors.

    Returns [out_height, out_width] float32 mm with 0 where no depth
    projects; the nearest surface wins."""
    dev = depth.device
    z = depth.to(torch.float32)
    k_d, k_c, rot, trans = (_f32(a, dev) for a in (k_depth, k_color, rot, trans))
    hd, wd = z.shape
    yy, xx = torch.meshgrid(
        torch.arange(hd, dtype=torch.float32, device=dev),
        torch.arange(wd, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    x3 = (xx - k_d[0, 2]) * z / k_d[0, 0]
    y3 = (yy - k_d[1, 2]) * z / k_d[1, 1]
    pts = torch.stack([x3, y3, z], dim=-1).reshape(-1, 1, 3)
    cam = dot3(pts, rot[None]) + trans  # [Hd * Wd, 3]
    zc = cam[:, 2]
    u = _fma(cam[:, 0] / zc, k_c[0, 0], k_c[0, 2].expand_as(zc))
    v = _fma(cam[:, 1] / zc, k_c[1, 1], k_c[1, 2].expand_as(zc))
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    ok = (z > 0).reshape(-1) & (zc > 0) & (ui >= 0) & (ui < out_width) & (vi >= 0) & (vi < out_height)
    flat = torch.where(ok, vi * out_width + ui, out_width * out_height)
    big = torch.full((out_width * out_height + 1,), torch.inf, dtype=torch.float32, device=dev)
    big.scatter_reduce_(0, flat, torch.where(ok, zc, torch.inf), "amin")
    big = big[:-1].reshape(out_height, out_width)
    return torch.where(torch.isfinite(big), big, 0.0)


def kinect_frame_transform(bgra: np.ndarray, bigdepth: np.ndarray):
    """Crop/convert/flip a registered Kinect v2 frame pair to the pipeline's
    640x480 (BGR uint8, depth uint16 mm) format (src/Kinect2.cpp:50-60).

    bgra: [1080, 1920, 4] uint8; bigdepth: [1080(+2), 1920] f32 mm (the
    libfreenect2 big-depth layout with one padding row top and bottom).

    Parity quirk: the reference applies the SAME crop rect to the 1082-row
    big depth and the 1080-row color image (src/Kinect2.cpp:53-56), so its
    depth crop sits one row higher on the sensor than the color crop. When a
    padded big depth is passed, that off-by-one is reproduced exactly.
    """
    bigdepth = np.asarray(bigdepth, np.float32)
    if bigdepth.shape[0] == 1080 + 2 * BIGDEPTH_PAD_ROWS:
        bigdepth = bigdepth[:-2 * BIGDEPTH_PAD_ROWS]  # rows 301..781 of the
        # padded frame == rows 300..780 unpadded (reference off-by-one kept)
    # float mm -> uint16 (convertTo CV_16UC1 saturates + rounds)
    d16 = np.clip(np.rint(np.nan_to_num(bigdepth, posinf=0.0)), 0, 65535).astype(
        np.uint16
    )
    depth = d16[CROP_Y0 : CROP_Y0 + CROP_H, CROP_X0 : CROP_X0 + CROP_W]
    color = np.asarray(bgra)[CROP_Y0 : CROP_Y0 + CROP_H, CROP_X0 : CROP_X0 + CROP_W, :3]
    # horizontal flip (cv::flip(..., 1))
    return np.ascontiguousarray(color[:, ::-1]), np.ascontiguousarray(depth[:, ::-1])
