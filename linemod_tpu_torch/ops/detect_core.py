"""The per-frame device program (counterpart of `linemod_tpu/ops/detect_core.py`).

`detect_frame` runs the whole coarse-to-fine match of the bank on the
state's device and returns one small packed array, so the host copies one
[top_k, 5] float32 tensor back per frame. The color and depth checks run on
the host afterwards (ops/postprocess.py), so in color-only mode
the depth image never goes to the device; in dual-modality mode the depth
normals take part in the match, and it does.
"""

from __future__ import annotations

import torch

from .matching import MatchState, match_templates


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
