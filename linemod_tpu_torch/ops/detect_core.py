"""The per-frame device program (counterpart of `linemod_tpu/ops/detect_core.py`).

`detect_frame` runs the whole coarse-to-fine match of the bank on the
state's device and returns one small packed array, so the host copies one
[top_k, 5] float32 tensor back per frame. The color and depth checks run on
the host afterwards (ops/postprocess.py), so in color-only mode
the depth image never goes to the device; in dual-modality mode the depth
normals take part in the match, and it does.

Two more ways in, the reference's upload routes, give the same packed
array: `detect_frame_quant` takes the two quantized orientation maps made
on the host (utils/native.quantize_frame), and `detect_frame_delta` the
color frame as `delta_encode_host` encodes it (a PNG-style horizontal
predictor), decoded on the device by a mod-256 prefix sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .matching import MatchState, match_templates, match_templates_quant


def _pack(m: dict) -> torch.Tensor:
    """Match dict -> [top_k, 5] float32 (template_id, x, y, similarity, valid),
    plus one row (cut_exact, 0, 0, 0, 0) when the prefiltered cut ran: host
    code that reads only valid rows ignores it, and the orchestrator reads
    it to retry saturated frames."""
    out = torch.stack(
        [
            m["template_id"].float(),
            m["x"].float(),
            m["y"].float(),
            m["similarity"],
            m["valid"].float(),
        ],
        dim=1,
    )
    if "cut_exact" in m:
        flag = out.new_zeros((1, 5))
        flag[0, 0] = m["cut_exact"].float()
        out = torch.cat([out, flag], dim=0)
    return out


def detect_frame(state: MatchState, color: torch.Tensor, depth: torch.Tensor | None = None) -> torch.Tensor:
    """The per-frame program.

    color: [H, W, 3] uint8 BGR; depth: [H, W] float32 mm, needed by a
    dual-modality state (color gradients and depth normals) and ignored by
    a color-only one; both principal-point recentred, on the state's device.
    Returns the packed [top_k, 5] float32 candidates, sorted by similarity
    ([top_k + 1, 5] on the prefiltered cut)."""
    return _pack(match_templates(state, color.float(), None if depth is None else depth.float()))


def detect_frame_dual(state: MatchState, color: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """detect_frame of a dual-modality state (the reference's entry name)."""
    return detect_frame(state, color, depth)


def detect_frames_batch(state: MatchState, colors: torch.Tensor, depths: torch.Tensor | None = None) -> torch.Tensor:
    """detect_frame of each of B frames: colors [B, H, W, 3] uint8 (depths
    [B, H, W] float32 for a dual state) -> packed [B, top_k, 5] (one row
    more on the prefiltered cut), launched together without a host sync."""
    return torch.stack([
        detect_frame(state, colors[i], None if depths is None else depths[i]) for i in range(colors.shape[0])
    ])


def detect_frame_quant(state: MatchState, quant0: torch.Tensor, quant1: torch.Tensor) -> torch.Tensor:
    """detect_frame of a color-only state from the frame's quantized
    orientation maps: quant0 [H, W] and quant1 [H/2, W/2] uint8 one-hot
    (utils/native.quantize_frame of the recentred frame), on the state's
    device."""
    return _pack(match_templates_quant(state, quant0, quant1))


def delta_encode_host(color_bgr: np.ndarray) -> np.ndarray:
    """Planar [3, H, W] uint8 of a BGR uint8 [H, W, 3] frame: column 0 as
    it is, every other column the mod-256 difference from its left
    neighbour (host numpy)."""
    planar = color_bgr.transpose(2, 0, 1)
    d = planar.astype(np.int16)
    out = np.empty_like(planar)
    out[:, :, 0] = planar[:, :, 0]
    out[:, :, 1:] = (d[:, :, 1:] - d[:, :, :-1]).astype(np.uint8)
    return out


def _delta_decode(delta: torch.Tensor) -> torch.Tensor:
    """delta_encode_host's inverse on the device: [3, H, W] uint8 -> the
    frame [H, W, 3] float32."""
    return (torch.cumsum(delta.to(torch.int32), dim=2) & 255).permute(1, 2, 0).float().contiguous()


def detect_frame_delta(state: MatchState, delta: torch.Tensor, depth: torch.Tensor | None = None) -> torch.Tensor:
    """detect_frame of the frame that `delta` ([3, H, W] uint8, from
    delta_encode_host, on the state's device) encodes; `depth` as for
    detect_frame."""
    return _pack(match_templates(state, _delta_decode(delta), None if depth is None else depth.float()))


def detect_frame_dual_delta(state: MatchState, delta: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """detect_frame_delta of a dual-modality state (the reference's entry name)."""
    return detect_frame_delta(state, delta, depth)


def detect_frames_batch_delta(state: MatchState, deltas: torch.Tensor, depths: torch.Tensor | None = None) -> torch.Tensor:
    """detect_frames_batch over delta-encoded frames: deltas [B, 3, H, W]
    uint8 (depths [B, H, W] float32 for a dual state) -> packed [B, top_k, 5]."""
    return torch.stack([
        detect_frame_delta(state, deltas[i], None if depths is None else depths[i]) for i in range(deltas.shape[0])
    ])
