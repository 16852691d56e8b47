"""Multi-class detection (counterpart of `linemod_tpu/pipeline/multi_model.py`).

The reference loads every model's bank at startup and checks the banks'
class ids against the model files (src/PoseDetection.cpp:142-160). Here
every class's bank is concatenated into one (`concat_banks`), so one match
program per frame computes the response planes once and scans all classes;
the candidates are then split by class (by the banks' template offsets) and
grouped, checked, and with ICP refined and verified, class by class.
`make_match_config` scales top_k with the class count, so one class cannot
crowd the others out of the cut. The attribute `delta_transport` uploads
the color frame delta-encoded (PoseDetection's route); as in the
reference, the multi-class detector has no host-quantize route.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import CameraParameters, ModelProperties, TemplateSettings
from ..models.template_bank import TemplateBank, _pad_bank, concat_banks
from ..ops.matching import build_match_state
from .pose_detection import (
    DetectionDebug,
    PoseDetection,
    _exact_state,
    _first_verified,
    _pipelined,
    group_candidate_poses,
    make_match_config,
    resolve_prefilter_packed,
)


def check_bank_model_consistency(class_ids, model_files) -> None:
    """The banks must match the model files one to one
    (src/PoseDetection.cpp:155-159: the count, then each sorted id against
    each sorted file stem). Raises ValueError."""
    stems = sorted(os.path.splitext(os.path.basename(f))[0] for f in model_files)
    ids = sorted(class_ids)
    if len(ids) != len(stems):
        raise ValueError(f"number of banks ({len(ids)}) does not match number of model files ({len(stems)})")
    for i, s in zip(ids, stems):
        if i != s:
            raise ValueError(f"bank class id {i!r} does not match model file {s!r}")


class MultiModelPoseDetection:
    """One detector over several classes on `device`: one match program a
    frame, post-processing class by class.

    banks, props: dicts keyed by class id; model_files (optional): the model
    files to check the banks against; icps (optional): an IcpRefiner a
    class, used when `settings.use_icp`. `exact_state` and `retries` are
    PoseDetection's (the prefiltered cut's retry state, built here)."""

    # recentring, the upload routes and the match program are PoseDetection's
    recenter = PoseDetection.recenter
    _to_device = PoseDetection._to_device
    _upload_depth = PoseDetection._upload_depth
    upload = PoseDetection.upload
    launch = PoseDetection.launch
    detect_submit = PoseDetection.detect_submit
    host_quant = False

    def __init__(
        self,
        banks: dict[str, TemplateBank],
        cam: CameraParameters,
        settings: TemplateSettings,
        props: dict[str, ModelProperties],
        device,
        model_files=None,
        icps: dict | None = None,
    ):
        if model_files is not None:
            check_bank_model_consistency(list(banks), model_files)
        if set(banks) != set(props):
            raise ValueError("banks and props must cover the same class ids")
        self.class_ids = list(banks)
        self.banks = banks
        self.props = props
        self.cam = cam
        self.settings = settings
        self.device = torch.device(device)
        self.icps = icps or {}
        combined, self.offsets = concat_banks([banks[c] for c in self.class_ids])
        cfg = make_match_config(
            cam, settings, combined.num_templates, combined.dual_modality, n_classes=len(self.class_ids)
        )
        self.state = build_match_state(_pad_bank(combined, cfg.template_chunk), cfg, self.device)
        self.exact_state = _exact_state(self.state)
        self.retries = 0
        self._hull_masks = {c: {} for c in self.class_ids}
        self.delta_transport = False

    def detect_all(
        self, color: np.ndarray, depth: np.ndarray, num_objects: int = 1,
        debug: dict[str, DetectionDebug] | None = None,
    ) -> dict[str, list]:
        """Detect every class in one frame: {class_id: [ObjectPose, ...]},
        empty lists included."""
        return self._collect(self.detect_submit(color, depth), self.class_ids, num_objects, debug)

    def detect(
        self, class_id: str, color: np.ndarray, depth: np.ndarray, num_objects: int = 1,
        debug: DetectionDebug | None = None,
    ) -> list:
        """Detect one class (the reference's per-frame call with a model
        name): the scan covers every class, the post-processing this one."""
        out = self._collect(
            self.detect_submit(color, depth), [class_id], num_objects,
            None if debug is None else {class_id: debug},
        )
        return out[class_id]

    def detect_all_stream(self, frames, num_objects: int = 1, pipeline_depth: int | None = None):
        """Generator: detect_all over an iterable of (color, depth) with up
        to `pipeline_depth` frames submitted ahead, collected in the
        caller's thread; with ICP, every class's ICP of a frame is collected
        after the next frame's matches (PoseDetection.detect_stream). Yields
        {class_id: [ObjectPose, ...]} in submission order."""
        two_stage = bool(self.icps) and self.settings.use_icp
        if pipeline_depth is None:
            pipeline_depth = 12 if two_stage else 4
        yield from _pipelined(
            frames, lambda cd: self.detect_submit(*cd),
            lambda handle: self._collect_phase1(handle, self.class_ids),
            lambda per_class: self._collect_phase2(per_class, num_objects), pipeline_depth, two_stage,
        )

    def _collect(self, handle, class_ids, num_objects, debug):
        return self._collect_phase2(self._collect_phase1(handle, class_ids, debug), num_objects)

    def _collect_phase1(self, handle, class_ids, debug=None) -> dict:
        """Stage 1: the frame's candidates split by class, each class's
        grouped and checked, and each ICP class's refine and verify
        submitted. Returns {class_id: (groups, ICP handle or None)}."""
        packed, color_c, depth_c = handle
        packed = resolve_prefilter_packed(packed.cpu().numpy(), self, color_c, depth_c)
        valid = packed[:, 4] > 0.5
        tid = packed[valid, 0].astype(np.int64)
        xs = packed[valid, 1]
        ys = packed[valid, 2]
        cls_idx = np.searchsorted(self.offsets, tid, side="right") - 1
        per_class = {}
        for c in class_ids:
            i = self.class_ids.index(c)
            sel = cls_idx == i
            dbg = debug.get(c) if debug else None
            if dbg is not None:
                dbg.num_raw_matches = int(sel.sum())
            grouped = group_candidate_poses(
                tid[sel] - self.offsets[i], xs[sel], ys[sel], self.banks[c], self.props[c], self.settings,
                self.cam, color_c, depth_c, self._hull_masks[c], debug=dbg,
            )
            icp = self.icps.get(c)
            icp_handle = None
            if icp is not None and self.settings.use_icp and grouped:
                icp_handle = icp.refine_submit(depth_c, grouped)
            per_class[c] = (grouped, icp_handle)
        return per_class

    def _collect_phase2(self, per_class: dict, num_objects: int) -> dict:
        """Stage 2: each class's ICP results and final poses."""
        results = {}
        for c, (grouped, icp_handle) in per_class.items():
            if icp_handle is None:
                results[c] = [g[0] for g in grouped[:num_objects]]
            else:
                results[c] = _first_verified(self.icps[c].refine_collect(icp_handle), num_objects)
        return results
