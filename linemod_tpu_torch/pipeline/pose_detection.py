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
the card works. `detect_stream` keeps up to `pipeline_depth` frames
submitted ahead and collects them in the caller's thread, in order;
`detect_submit_batch` / `detect_collect_batch` run several frames as one
submission. With `settings.use_icp` and an `IcpRefiner` (ops/icp.py), each
group's candidate poses are refined against the scene cloud and verified by
rendering (src/PoseDetection.cpp:72-84); the stream then collects in two
stages, so a frame's ICP is collected after the next frame's matches.

Two upload routes are opt-ins, as in the reference, where only a TPU
backend turns them on: `host_quant` quantizes the frame on the host
(utils/native.quantize_frame) and uploads the two u8 orientation maps
(384 KB at 640x480) in place of the color frame (921 KB); `delta_transport`
uploads the color frame delta-encoded (ops/detect_core.delta_encode_host).
Every route gives the same packed array.

Spans (utils/profiling) mark a frame's host work: `frame.submit` with
`submit.recenter`, `submit.upload` and the match program's `match.*`;
`frame.collect`, carrying the id its submission started, with
`collect.copy` (the wait for the device and the copy), `collect.retry`,
`collect.group`, `collect.checks` (a candidate) and `collect.icp`.

Left out: the reference's collector threads, which serve a remote TPU link
whose fetch takes ~50 ms. On the card `detect_submit` already returns at
once, and collector threads would share the unlocked hull-mask cache and
retry count, so the stream takes no `workers`.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..config import CameraParameters, ModelProperties, TemplateSettings
from ..models.template_bank import _pad_bank, _pad_chunk
from ..ops.detect_core import (
    delta_encode_host,
    detect_frame,
    detect_frame_delta,
    detect_frame_quant,
    detect_frames_batch,
    detect_frames_batch_delta,
)
from ..ops.matching import MatchConfig, build_match_state
from ..ops.postprocess import (
    color_check_host,
    depth_p20_host,
    discard_small_groups,
    group_matches,
    hull_mask,
    reconstruct_pose,
)
from ..utils.native import quantize_frame
from ..utils.profiling import frame_span, last_frame, span

# banks above this many templates take the prefiltered cut
BIG_BANK_TEMPLATES = 8192


def resolve_prefilter_packed(
    packed: np.ndarray, owner, color_c: np.ndarray, depth_c: np.ndarray | None = None
) -> np.ndarray:
    """Handle the prefiltered cut's proof row (detect_core._pack appends it):
    slice it off, and re-run a frame whose cut is not proved exact on the
    exact streaming cut (`owner.exact_state`), on the same device.

    owner: a PoseDetection or MultiModelPoseDetection; color_c, depth_c:
    the recentred frame (host arrays; the depth is needed, and used, only in
    dual mode)."""
    top_k = owner.state.cfg.top_k
    if packed.shape[0] != top_k + 1:
        return packed
    if packed[-1, 0] < 0.5:
        with span("collect.retry"):
            retried = detect_frame(owner.exact_state, *owner.upload(color_c, depth_c))
            with span("collect.copy"):
                packed = retried.cpu().numpy()
        owner.retries += 1
    return packed[:top_k]


@dataclasses.dataclass
class DetectionDebug:
    """What one frame's collection saw: valid matches, groups before and
    after the small-group cut, and each candidate check as (template id,
    color %, scene p20 depth (-1 without the depth check), color ok, depth
    ok, (x, y))."""

    num_raw_matches: int = 0
    num_groups: int = 0
    groups_kept: int = 0
    checks: list = dataclasses.field(default_factory=list)


def make_match_config(
    cam: CameraParameters, settings: TemplateSettings, n_templates: int,
    dual_modality: bool = False, n_classes: int = 1,
) -> MatchConfig:
    """The production MatchConfig: the T=2/8 pyramid (T=5/8 with
    `dual_modality`, color gradients and depth normals), the detector
    threshold from the settings, top 512 x n_classes candidates (so the
    classes of a concatenated bank cannot crowd each other out of the cut,
    as the reference's per-class match lists cannot,
    src/HighLevelLinemod.cpp:145-164), and the bank padded to a multiple of
    min(256, next power of two of its size). Banks above 8,192 templates
    (the reference's settings configure 96,300) take the prefiltered cut
    over the best max(2 * top_k, 1024) templates, with the 4,096-template
    streaming cut kept for retries."""
    top_k = 512 * n_classes
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
    `retries` counts the frames re-run on it. `icp` (an IcpRefiner on the
    same device) refines and verifies the poses when `settings.use_icp`;
    `mesh` is kept for callers, as the reference keeps it.

    The upload routes (`detect_submit`): `host_quant` quantizes the frame on
    the host and uploads the two orientation maps; a dual bank never does,
    since its normals need the depth on the device. The attribute
    `delta_transport` (False; a caller sets it) uploads the color frame
    delta-encoded, with either bank; `host_quant` takes precedence over it.
    The reference turns both on by itself only on a TPU backend, so here
    `host_quant=None` means False."""

    def __init__(
        self,
        bank,
        cam: CameraParameters,
        settings: TemplateSettings,
        props: ModelProperties,
        device,
        cfg: MatchConfig | None = None,
        mesh=None,
        icp=None,
        host_quant: bool | None = None,
    ):
        self.bank = bank
        self.cam = cam
        self.settings = settings
        self.props = props
        self.device = torch.device(device)
        self.mesh = mesh
        self.icp = icp
        if cfg is None:
            cfg = make_match_config(cam, settings, bank.num_templates, bank.dual_modality)
        self.state = build_match_state(_pad_bank(bank, cfg.template_chunk), cfg, self.device)
        self.exact_state = _exact_state(self.state)
        self.retries = 0
        self._hull_masks: dict[int, np.ndarray] = {}  # per template, built lazily
        self.host_quant = bool(host_quant) and not bank.dual_modality
        self.delta_transport = False

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

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

    def upload(self, color_c: np.ndarray, depth_c) -> tuple:
        """(color, depth) of one recentred frame on the device, the
        program's inputs: color as uint8; with a dual bank the depth as
        float32, converted on the host (torch's uint16 support is thin),
        else None (the depth stays on the host)."""
        return self._to_device(color_c, np.uint8), self._upload_depth(depth_c)

    def _upload_depth(self, depth_c):
        return self._to_device(depth_c, np.float32) if self.state.cfg.dual_modality else None

    def launch(self, color_c: np.ndarray, depth_c) -> torch.Tensor:
        """Upload one recentred frame by this detector's route and launch its
        match program: the host-quantized maps (`host_quant`), the
        delta-encoded color (`delta_transport`) or the color frame; with a
        dual bank the depth goes too. Returns the packed tensor, not yet
        computed."""
        with span("submit.upload"):
            if self.host_quant:
                program = detect_frame_quant
                inputs = tuple(self._to_device(q, np.uint8) for q in quantize_frame(color_c))
            elif self.delta_transport:
                program = detect_frame_delta
                delta = self._to_device(delta_encode_host(np.asarray(color_c, np.uint8)), np.uint8)
                inputs = (delta, self._upload_depth(depth_c))
            else:
                program, inputs = detect_frame, self.upload(color_c, depth_c)
        return program(self.state, *inputs)

    def detect(
        self, color: np.ndarray, depth: np.ndarray, num_objects: int = 1,
        debug: DetectionDebug | None = None,
    ) -> list:
        """Detect up to num_objects poses in one RGB-D frame (synchronous).

        color: [H, W, 3] uint8 BGR; depth: [H, W] uint16/float mm. Returns a
        list of ObjectPose (CV camera frame, mm)."""
        handle = self.detect_submit(color, depth)
        return self.detect_collect(handle, num_objects, debug, frame=last_frame())

    def detect_submit(self, color: np.ndarray, depth: np.ndarray):
        """Upload the recentred frame and launch the match program without
        waiting for it (`launch`); returns the handle for detect_collect. In
        color-only mode the depth image stays on the host, where the checks
        read it; a dual bank uploads it too. Its `frame.submit` span starts
        a frame; `utils/profiling.last_frame()` gives its id, to carry to
        detect_collect beside the handle."""
        with frame_span("frame.submit"):
            with span("submit.recenter"):
                color_c = self.recenter(np.ascontiguousarray(color))
                depth_c = self.recenter(np.ascontiguousarray(depth))
            return self.launch(color_c, depth_c), color_c, depth_c

    def detect_submit_batch(self, frames) -> tuple:
        """Launch the match program for several (color, depth) frames at
        once, the color delta-encoded with `delta_transport` (as the
        reference, the batch has no host-quantize route); returns the handle
        for detect_collect_batch."""
        recentred = [
            (self.recenter(np.ascontiguousarray(c)), self.recenter(np.ascontiguousarray(d))) for c, d in frames
        ]
        depths = None
        if self.state.cfg.dual_modality:
            depths = self._to_device(np.stack([d for _, d in recentred]), np.float32)
        if self.delta_transport:
            deltas = np.stack([delta_encode_host(np.asarray(c, np.uint8)) for c, _ in recentred])
            return detect_frames_batch_delta(self.state, self._to_device(deltas, np.uint8), depths), recentred
        colors = self._to_device(np.stack([c for c, _ in recentred]), np.uint8)
        return detect_frames_batch(self.state, colors, depths), recentred

    def detect_collect_batch(self, handle, num_objects: int = 1) -> list:
        """Collect a submitted batch (one copy to the host): one pose list a
        frame, in submission order."""
        packed, recentred = handle
        packed = packed.cpu()
        return [self.detect_collect((packed[i], c, d), num_objects) for i, (c, d) in enumerate(recentred)]

    def detect_stream(self, frames, num_objects: int = 1, pipeline_depth: int | None = None, batch: int = 1):
        """Generator: detect over an iterable of (color, depth) with up to
        `pipeline_depth` frames (batches, with `batch` > 1) submitted ahead
        of the one collected. Results come out in submission order and equal
        `detect`'s. With ICP on, a frame's ICP is collected after the next
        frame's matches are (two stages). Collection runs in the caller's
        thread (see the module docstring). With `host_quant` the frames go
        one at a time, as the reference sends them."""
        two_stage = self.icp is not None and self.settings.use_icp
        if pipeline_depth is None:
            pipeline_depth = 12 if two_stage else 4
        if batch > 1 and not self.host_quant:
            for results in _pipelined(
                _batches(frames, batch), self.detect_submit_batch, lambda handle: handle,
                lambda handle: self.detect_collect_batch(handle, num_objects), pipeline_depth, False,
            ):
                yield from results
            return
        # each handle travels with its frame id (framed), so that a frame's
        # collection spans carry the id of its submission
        yield from _pipelined(
            frames, framed(lambda cd: self.detect_submit(*cd)),
            lambda fh: (self._collect_phase1(fh[1], frame=fh[0]), fh[0]),
            lambda p1: self._collect_phase2(p1[0], num_objects, frame=p1[1]), pipeline_depth, two_stage,
        )

    def detect_collect(
        self, handle, num_objects: int = 1, debug: DetectionDebug | None = None, frame: int | None = None,
    ) -> list:
        """Wait for one submitted frame, copy its packed candidates to the
        host, and run grouping, the checks and the pose math there (with
        ICP on, refine and verify each group). A frame whose prefiltered cut
        is not proved exact is re-run first. `frame`: the id its submission's
        span started (utils/profiling.last_frame()), for the spans."""
        return self._collect_phase2(self._collect_phase1(handle, debug, frame), num_objects, frame)

    def _collect_phase1(self, handle, debug: DetectionDebug | None = None, frame: int | None = None):
        """Stage 1: the frame's candidates, grouped and checked; with ICP on,
        its refine and verify submitted (ops/icp.IcpRefiner.refine_submit).
        Returns (groups, ICP handle or None)."""
        packed, color_c, depth_c = handle
        with frame_span("frame.collect", frame):
            with span("collect.copy"):
                packed = packed.cpu()
            packed = resolve_prefilter_packed(packed.numpy(), self, color_c, depth_c)
            valid = packed[:, 4] > 0.5
            if debug is not None:
                debug.num_raw_matches = int(valid.sum())
            grouped = group_candidate_poses(
                packed[valid, 0].astype(np.int64), packed[valid, 1], packed[valid, 2], self.bank,
                self.props, self.settings, self.cam, color_c, depth_c, self._hull_masks, debug=debug,
            )
            icp_handle = None
            if self.icp is not None and self.settings.use_icp and grouped:
                with span("collect.icp"):
                    icp_handle = self.icp.refine_submit(depth_c, grouped)
        return grouped, icp_handle

    def _collect_phase2(self, phase1, num_objects: int = 1, frame: int | None = None) -> list:
        """Stage 2: the ICP results, if ICP ran, and the final poses."""
        grouped, icp_handle = phase1
        if icp_handle is None:
            return [g[0] for g in grouped[:num_objects]]
        with frame_span("frame.collect", frame), span("collect.icp"):
            return _first_verified(self.icp.refine_collect(icp_handle), num_objects)


def _exact_state(state):
    """The state on the exact streaming cut when `state` takes the
    prefiltered cut (its retry engine), else None."""
    cfg = state.cfg
    if not cfg.prefilter_sel:
        return None
    return dataclasses.replace(
        state, cfg=dataclasses.replace(cfg, prefilter_sel=0, scan_chunk=cfg.scan_chunk or 4096)
    )


def framed(submit):
    """`submit` returning (frame id, handle): the id the submission's
    `frame.submit` span started (None while recording is off)."""

    def submit_framed(item):
        handle = submit(item)
        return last_frame(), handle

    return submit_framed


def _first_verified(results: list, num_objects: int) -> list:
    """The first num_objects groups' verified poses (None: rejected)."""
    return [p for p in results if p is not None][:num_objects]


def _batches(frames, size: int):
    """Lists of up to `size` consecutive items of `frames`."""
    batch = []
    for item in frames:
        batch.append(item)
        if len(batch) == size:
            yield batch
            batch = []
    if batch:
        yield batch


def _pipelined(frames, submit, phase1, phase2, depth: int, two_stage: bool):
    """Submit each frame (or batch), and once more than `depth` are in
    flight collect the oldest: phase2(phase1(handle)), or, in two stages,
    the oldest's phase 1 and then the previous one's phase 2. Yields in
    order."""
    submitted = collections.deque()
    staged = []  # two stages: the phase-1 result waiting for its phase 2

    def collect_oldest():
        handle = submitted.popleft()
        if not two_stage:
            yield phase2(phase1(handle))
            return
        staged.append(phase1(handle))
        if len(staged) > 1:
            yield phase2(staged.pop(0))

    for frame in frames:
        submitted.append(submit(frame))
        if len(submitted) > depth:
            yield from collect_oldest()
    while submitted:
        yield from collect_oldest()
    while staged:
        yield phase2(staged.pop(0))


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
    debug: DetectionDebug | None = None,
) -> list:
    """Group the valid matches, run the lazy per-candidate color and depth
    checks in post-grouping order, and reconstruct candidate poses.
    Returns one list of poses per kept group (empty groups dropped)."""
    if len(tid) == 0:
        return []
    with span("collect.group"):
        groups = group_matches(xs, ys, settings.group_radius)
        if debug is not None:
            debug.num_groups = len(groups)
        groups = discard_small_groups(groups, settings.discard_group_ratio)
    if debug is not None:
        debug.groups_kept = len(groups)
    if not groups:
        return []

    lower = np.asarray(props.lower_color_range, np.float32)
    upper = np.asarray(props.upper_color_range, np.float32)
    grouped_pose_sets = []
    for g in groups:
        group_poses = []
        for j in g:
            with span("collect.checks"):
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
                    scene_p20 = -1.0
                    ok_depth = True
                    direct_depth = float(bank.z[t])
                if debug is not None:
                    debug.checks.append(
                        (t, float(color_pct), float(scene_p20), ok_color, ok_depth, (float(xy[0]), float(xy[1])))
                    )
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


def postprocess_matches(
    tid: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    bank,
    props,
    settings,
    cam,
    color_c: np.ndarray,
    depth_c: np.ndarray,
    num_objects: int,
    hull_masks: dict,
    icp=None,
    debug: DetectionDebug | None = None,
) -> list:
    """Group, check and reconstruct one class's valid matches (tid local to
    `bank`), then select the poses (select_group_poses)."""
    grouped = group_candidate_poses(
        tid, xs, ys, bank, props, settings, cam, color_c, depth_c, hull_masks, debug=debug,
    )
    return select_group_poses(grouped, settings, depth_c, num_objects, icp=icp)


def select_group_poses(grouped_pose_sets: list, settings, depth_c, num_objects: int, icp=None) -> list:
    """A pose a group: with ICP on, each group's best verified pose
    (src/PoseDetection.cpp:72-84; rejected groups give none), else its first
    pose; at most num_objects."""
    if icp is not None and settings.use_icp and grouped_pose_sets:
        return _first_verified(icp.refine_best_many(depth_c, grouped_pose_sets), num_objects)
    return [g[0] for g in grouped_pose_sets[:num_objects]]
