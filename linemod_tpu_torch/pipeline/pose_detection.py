"""Online pose detection (counterpart of `linemod_tpu/pipeline/pose_detection.py`).

Per frame: principal-point recentring (host) -> the match program on the
device (ops/detect_core.detect_frame) -> one [top_k, 5] copy to the host ->
grouping, the lazy per-candidate color/depth checks and the closed-form pose
(host numpy, ops/postprocess.py).

Banks above 8,192 templates take the prefiltered exact cut; a frame whose
cut cannot prove itself exact is re-run on the streaming exact cut
(`resolve_prefilter_packed`).

A dual-modality bank (color gradients and depth normals, T=5/8) uploads
the recentred depth with the color, and the program matches both.

`detect_submit` launches the device work without waiting for it and
`detect_collect` waits for it, so a caller can prepare the next frame while
the card works. Not ported yet: ICP refinement, `detect_stream` and batched
frames; left out: the reference's delta-encoded and host-quantized uploads,
which serve a remote TPU link.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CameraParameters, ModelProperties, TemplateSettings
from ..models.template_bank import _pad_bank, _pad_chunk
from ..ops.detect_core import detect_frame
from ..ops.matching import MatchConfig, build_match_state
from ..ops.postprocess import (
    color_check_host,
    depth_p20_host,
    discard_small_groups,
    group_matches,
    hull_mask,
    reconstruct_pose,
)

# banks above this many templates take the prefiltered cut
BIG_BANK_TEMPLATES = 8192


def resolve_prefilter_packed(
    packed: np.ndarray, owner, color_c: np.ndarray, depth_c: np.ndarray | None = None
) -> np.ndarray:
    """Handle the prefiltered cut's proof row (detect_core._pack appends it):
    slice it off, and re-run a frame whose cut is not proved exact on the
    exact streaming cut (`owner.exact_state`), on the same device.

    owner: a PoseDetection; color_c, depth_c: the recentred frame (host
    arrays; the depth is needed, and used, only in dual mode)."""
    top_k = owner.state.cfg.top_k
    if packed.shape[0] != top_k + 1:
        return packed
    if packed[-1, 0] < 0.5:
        packed = detect_frame(owner.exact_state, *owner.upload(color_c, depth_c)).cpu().numpy()
        owner.retries += 1
    return packed[:top_k]


def make_match_config(
    cam: CameraParameters, settings: TemplateSettings, n_templates: int,
    dual_modality: bool = False,
) -> MatchConfig:
    """The production MatchConfig: the T=2/8 pyramid (T=5/8 with
    `dual_modality`, color gradients and depth normals), the detector
    threshold from the settings, top-512 candidates, and the bank padded to
    a multiple of min(256, next power of two of its size). Banks above 8,192
    templates (the reference's settings configure 96,300) take the
    prefiltered cut over the best max(2 * top_k, 1024) templates, with the
    4,096-template streaming cut kept for retries."""
    top_k = 512
    big_bank = n_templates > BIG_BANK_TEMPLATES
    return MatchConfig(
        width=cam.width,
        height=cam.height,
        t_fine=5 if dual_modality else 2,
        top_k=top_k,
        threshold=settings.detector_threshold,
        dual_modality=dual_modality,
        template_chunk=min(256, _pad_chunk(n_templates)),
        scan_chunk=4096 if big_bank else 0,
        prefilter_sel=max(2 * top_k, 1024) if big_bank else 0,
    )


class PoseDetection:
    """One model class's bank and its match state on `device`.

    `cfg` replaces make_match_config's choice (to force a cut on a small
    bank). With the prefiltered cut, `exact_state` is the same state on the
    streaming cut, built here so that no collector ever builds it, and
    `retries` counts the frames re-run on it."""

    def __init__(
        self,
        bank,
        cam: CameraParameters,
        settings: TemplateSettings,
        props: ModelProperties,
        device,
        cfg: MatchConfig | None = None,
    ):
        self.bank = bank
        self.cam = cam
        self.settings = settings
        self.props = props
        self.device = torch.device(device)
        if cfg is None:
            cfg = make_match_config(cam, settings, bank.num_templates, bank.dual_modality)
        self.state = build_match_state(_pad_bank(bank, cfg.template_chunk), cfg, self.device)
        self.exact_state = None
        if cfg.prefilter_sel:
            exact_cfg = dataclasses.replace(cfg, prefilter_sel=0, scan_chunk=cfg.scan_chunk or 4096)
            self.exact_state = dataclasses.replace(self.state, cfg=exact_cfg)
        self.retries = 0
        self._hull_masks: dict[int, np.ndarray] = {}  # per template, built lazily

    def recenter(self, img: np.ndarray) -> np.ndarray:
        """Shift the principal point to the image centre: integer shift, zero fill."""
        dx = int(round(-self.cam.cx + self.cam.width / 2))
        dy = int(round(-self.cam.cy + self.cam.height / 2))
        if dx == 0 and dy == 0:
            return img
        out = np.zeros_like(img)
        h, w = img.shape[:2]
        sy0, dy0 = max(0, -dy), max(0, dy)
        sx0, dx0 = max(0, -dx), max(0, dx)
        hh = h - abs(dy)
        ww = w - abs(dx)
        out[dy0 : dy0 + hh, dx0 : dx0 + ww] = img[sy0 : sy0 + hh, sx0 : sx0 + ww]
        return out

    def upload(self, color_c: np.ndarray, depth_c) -> tuple:
        """(color, depth) of one recentred frame on the device, the
        program's inputs: color as uint8; with a dual bank the depth as
        float32, converted on the host (torch's uint16 support is thin),
        else None (the depth stays on the host)."""
        frame = torch.from_numpy(np.ascontiguousarray(color_c, dtype=np.uint8)).to(self.device)
        if not self.state.cfg.dual_modality:
            return frame, None
        return frame, torch.from_numpy(np.ascontiguousarray(depth_c, dtype=np.float32)).to(self.device)

    def detect(self, color: np.ndarray, depth: np.ndarray, num_objects: int = 1) -> list:
        """Detect up to num_objects poses in one RGB-D frame (synchronous).

        color: [H, W, 3] uint8 BGR; depth: [H, W] uint16/float mm. Returns a
        list of ObjectPose (CV camera frame, mm)."""
        return self.detect_collect(self.detect_submit(color, depth), num_objects)

    def detect_submit(self, color: np.ndarray, depth: np.ndarray):
        """Upload the recentred frame and launch the match program without
        waiting for it; returns the handle for detect_collect. In color-only
        mode the depth image stays on the host, where the checks read it; a
        dual bank uploads it too."""
        color_c = self.recenter(np.ascontiguousarray(color))
        depth_c = self.recenter(np.ascontiguousarray(depth))
        return detect_frame(self.state, *self.upload(color_c, depth_c)), color_c, depth_c

    def detect_collect(self, handle, num_objects: int = 1) -> list:
        """Wait for one submitted frame, copy its packed candidates to the
        host, and run grouping, the checks and the pose math there. A frame
        whose prefiltered cut is not proved exact is re-run first."""
        packed, color_c, depth_c = handle
        packed = resolve_prefilter_packed(packed.cpu().numpy(), self, color_c, depth_c)
        valid = packed[:, 4] > 0.5
        tid = packed[valid, 0].astype(np.int64)
        xs = packed[valid, 1]
        ys = packed[valid, 2]
        grouped = group_candidate_poses(
            tid, xs, ys, self.bank, self.props, self.settings, self.cam,
            color_c, depth_c, self._hull_masks,
        )
        return [g[0] for g in grouped[:num_objects]]


def group_candidate_poses(
    tid: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    bank,
    props,
    settings,
    cam,
    color_c: np.ndarray,
    depth_c: np.ndarray,
    hull_masks: dict,
) -> list:
    """Group the valid matches, run the lazy per-candidate color and depth
    checks in post-grouping order, and reconstruct candidate poses.
    Returns one list of poses per kept group (empty groups dropped)."""
    if len(tid) == 0:
        return []
    groups = discard_small_groups(
        group_matches(xs, ys, settings.group_radius), settings.discard_group_ratio
    )
    if not groups:
        return []

    lower = np.asarray(props.lower_color_range, np.float32)
    upper = np.asarray(props.upper_color_range, np.float32)
    grouped_pose_sets = []
    for g in groups:
        group_poses = []
        for j in g:
            t = int(tid[j])
            xy = (xs[j], ys[j])
            wh = bank.bbox[t, 2:4]
            mask = hull_masks.get(t)
            if mask is None:
                mask = hull_mask(bank.hull[t], wh)
                hull_masks[t] = mask
            color_pct = color_check_host(color_c, mask, xy, lower, upper)
            ok_color = color_pct > settings.percent_to_pass_check
            if settings.use_depth_improvement:
                scene_p20 = depth_p20_host(depth_c, xy, wh)
                depth_diff = scene_p20 - float(bank.median_depth[t]) - settings.depth_offset
                ok_depth = abs(depth_diff) < settings.distance_step
                direct_depth = float(bank.z[t]) + depth_diff
            else:
                ok_depth = True
                direct_depth = float(bank.z[t])
            if ok_color and ok_depth:
                group_poses.append(
                    reconstruct_pose(
                        float(xs[j]), float(ys[j]), bank.bbox[t], bank.quat[t],
                        direct_depth, cam,
                    )
                )
            if len(group_poses) >= settings.number_wanted_poses:
                break
        if group_poses:
            grouped_pose_sets.append(group_poses)
    return grouped_pose_sets
