"""Dense template bank: generation, persistence, padding and concatenation
(counterpart of `linemod_tpu/models/template_bank.py`).

A bank is one npz of dense per-template arrays plus a json sidecar with the
class id and the modality flag; both packages read each other's. The bank
stays host numpy: `ops/matching` derives the device tensors from it.

Generation renders every template view (radius outermost, then viewpoint,
then in-plane angle) on the device a radius at a time: it quantizes and
cuts the radius's candidates a chunk of views at a time, selects the
radius's features in one scan, takes each view's p20 depth a chunk at a
time, and assembles the records on the host. A view is the object rendered
from the template's own pose (the camera rolled by the in-plane angle),
which keeps pose and pixels consistent by construction.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time

import numpy as np
import torch

from ..config import CameraParameters, ModelProperties, TemplateSettings
from ..ops.extract import concat_candidates, cut_candidates, quantize_views, scan_select
from ..ops.rasterizer import mesh_to_arrays, render
from ..utils.geometry import quat_to_mat, template_view_pose
from .viewpoints import camera_view_points

MAX_FEATURES = 64  # 63 features padded to 64
HULL_VERTS = 32
BG_DEPTH = 65535.0
CROP = 320  # the template render window (object centred)
# views rendered, quantized, cut and reduced to p20 depths at once: the
# quantizer's float32 temporaries of the 1,620 views of a radius at
# subdivision 2 outgrow an 80 GB card
VIEW_CHUNK = 256
# views gathered, whole radii at a time, before one scan selects their
# features: a scan's ~2,048 dependent steps cost about the same whatever
# its row count, so radii of a few hundred views share one
SCAN_VIEWS = 1024
TIMED_PHASES = ("render", "quantize", "cut", "scan", "assemble")
# the bank's arrays, in the order of the npz
FIELDS = ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull")
DUAL_FIELDS = ("nfeat0", "nvalid0", "nfeat1", "nvalid1")


@dataclasses.dataclass
class TemplateBank:
    class_id: str
    feat0: np.ndarray  # [N, 64, 3] int16 (x, y, ori), bbox-relative, level 0
    valid0: np.ndarray  # [N, 64] bool
    feat1: np.ndarray  # [N, 64, 3] int16, level 1 (half resolution)
    valid1: np.ndarray
    bbox: np.ndarray  # [N, 4] int32 (x, y, w, h) at level 0
    quat: np.ndarray  # [N, 4] f32 template rotation, CV frame
    z: np.ndarray  # [N] f32 template camera distance (mm)
    median_depth: np.ndarray  # [N] f32 ~p20 depth over the bbox
    hull: np.ndarray  # [N, HULL_VERTS, 2] f32 convex hull of level-0 features
    dual_modality: bool = False
    nfeat0: np.ndarray | None = None  # dual-modality normal features
    nvalid0: np.ndarray | None = None
    nfeat1: np.ndarray | None = None
    nvalid1: np.ndarray | None = None

    @property
    def num_templates(self) -> int:
        return int(self.bbox.shape[0])

    def save(self, path: str) -> None:
        """Write `<path>` (.npz) and its `<path>.json` sidecar."""
        fields = FIELDS + (DUAL_FIELDS if self.dual_modality else ())
        np.savez_compressed(path, **{f: getattr(self, f) for f in fields})
        with open(path + ".json", "w") as f:
            json.dump({"class_id": self.class_id, "dual_modality": self.dual_modality}, f)

    @staticmethod
    def load(path: str) -> "TemplateBank":
        """Load `<path>` (.npz) and its `<path>.json` sidecar."""
        with open(path + ".json") as f:
            meta = json.load(f)
        with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        return TemplateBank(
            class_id=meta["class_id"], dual_modality=meta["dual_modality"], **arrays
        )


def make_synthetic_bank(
    n_templates: int,
    seed: int = 0,
    bbox_wh: int = 48,
    image_wh=(640, 480),
    dual_modality: bool = False,
) -> TemplateBank:
    """Random bank (no rendering), the same arrays as
    `linemod_tpu.models.template_bank.make_synthetic_bank` for one seed."""
    rng = np.random.default_rng(seed)
    w, h = image_wh

    def feats(scale):
        f = np.zeros((n_templates, MAX_FEATURES, 3), np.int16)
        f[:, :, 0] = rng.integers(0, bbox_wh // scale, (n_templates, MAX_FEATURES))
        f[:, :, 1] = rng.integers(0, bbox_wh // scale, (n_templates, MAX_FEATURES))
        f[:, :, 2] = rng.integers(0, 8, (n_templates, MAX_FEATURES))
        return f

    valid = np.zeros((n_templates, MAX_FEATURES), bool)
    valid[:, :63] = True
    bbox = np.tile(
        np.array([[(w - bbox_wh) // 2, (h - bbox_wh) // 2, bbox_wh, bbox_wh]], np.int32),
        (n_templates, 1),
    )
    quat = np.tile(np.array([[0.0, 1.0, 0.0, 0.0]], np.float32), (n_templates, 1))
    hull = np.zeros((n_templates, HULL_VERTS, 2), np.float32)
    hull[:, 1] = (bbox_wh, 0)
    hull[:, 2:] = (bbox_wh, bbox_wh)
    dual = {}
    if dual_modality:
        dual = dict(nfeat0=feats(1), nvalid0=valid.copy(), nfeat1=feats(2), nvalid1=valid.copy())
    return TemplateBank(
        class_id="synthetic",
        feat0=feats(1),
        valid0=valid.copy(),
        feat1=feats(2),
        valid1=valid.copy(),
        bbox=bbox,
        quat=quat,
        z=np.full((n_templates,), 600.0, np.float32),
        median_depth=np.full((n_templates,), 580.0, np.float32),
        hull=hull,
        dual_modality=dual_modality,
        **dual,
    )


def concat_banks(banks: list[TemplateBank]) -> tuple[TemplateBank, np.ndarray]:
    """Concatenate several banks into one scannable bank.

    Returns (combined bank, offsets), where offsets[i] is the first global
    template id of banks[i]; a global id maps to its bank by
    np.searchsorted(offsets, id, side="right") - 1."""
    if not banks:
        raise ValueError("no banks")
    dual = banks[0].dual_modality
    if any(b.dual_modality != dual for b in banks):
        raise ValueError("all banks must share the modality configuration")

    def cat(field):
        parts = [getattr(b, field) for b in banks]
        if any(p is None for p in parts):
            return None
        return np.concatenate(parts, axis=0)

    fields = FIELDS + (DUAL_FIELDS if dual else ())
    combined = TemplateBank(
        class_id="+".join(b.class_id for b in banks),
        dual_modality=dual,
        **{f: cat(f) for f in fields},
    )
    offsets = np.cumsum([0] + [b.num_templates for b in banks])[:-1]
    return combined, offsets


def _pad_chunk(n: int) -> int:
    """Template chunk: the next power of two at or above n."""
    return max(1, 1 << (int(np.ceil(np.log2(max(n, 1))))))


def _pad_bank(bank: TemplateBank, chunk: int) -> TemplateBank:
    """Pad the bank to a multiple of `chunk` with inert templates: no valid
    features (they score against the zero plane) and a 1-px bbox."""
    n = bank.num_templates
    target = int(np.ceil(n / chunk)) * chunk
    if target == n:
        return bank
    pad = target - n
    b = copy.copy(bank)

    def padded(a, fill=0):
        if a is None:
            return None
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    b.feat0 = padded(bank.feat0)
    b.valid0 = padded(bank.valid0, False)
    b.feat1 = padded(bank.feat1)
    b.valid1 = padded(bank.valid1, False)
    b.bbox = padded(bank.bbox, 1)
    b.quat = padded(bank.quat)
    b.z = padded(bank.z, 1.0)
    b.median_depth = padded(bank.median_depth)
    b.hull = padded(bank.hull)
    b.nfeat0 = padded(bank.nfeat0)
    b.nvalid0 = padded(bank.nvalid0, False)
    b.nfeat1 = padded(bank.nfeat1)
    b.nvalid1 = padded(bank.nvalid1, False)
    return b


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; points [M, 2] -> hull vertices CCW."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(a, b):
        return a[0] * b[1] - a[1] * b[0]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out[:-1]

    return np.asarray(half(pts) + half(pts[::-1]), dtype=np.float32)


def _pad_hull(hull: np.ndarray) -> np.ndarray:
    """[HULL_VERTS, 2], padded by repeating the last vertex."""
    h = np.zeros((HULL_VERTS, 2), np.float32)
    n = min(len(hull), HULL_VERTS)
    h[:n] = hull[:n]
    if n > 0:
        h[n:] = hull[n - 1]
    return h


def _feature_box(sel: dict, dual: bool):
    """Per view, the level-0 box (x_min, x_max, y_min, y_max) of the valid
    features of grad0, grad1 (scaled by 2) and, dual, norm0; +-1e9 where a
    view has none."""
    keys = [("grad0", 1), ("grad1", 2)] + ([("norm0", 1)] if dual else [])
    big = 10**9
    lo_x, hi_x, lo_y, hi_y = [], [], [], []
    for key, scale in keys:
        x, y, _, v = sel[key]
        lo_x.append(torch.where(v, x * scale, big).amin(1))
        hi_x.append(torch.where(v, x * scale, -big).amax(1))
        lo_y.append(torch.where(v, y * scale, big).amin(1))
        hi_y.append(torch.where(v, y * scale, -big).amax(1))
    return (torch.stack(lo_x).amin(0), torch.stack(hi_x).amax(0),
            torch.stack(lo_y).amin(0), torch.stack(hi_y).amax(0))


def _p20(depth: torch.Tensor, box) -> torch.Tensor:
    """Per view [B, H, W], the exact k-th smallest depth over the feature
    box (background as BG_DEPTH), k = the box's area // 5."""
    x0, x1, y0, y1 = (t[:, None, None] for t in box)
    b, h, w = depth.shape
    yy = torch.arange(h, device=depth.device)[None, :, None]
    xx = torch.arange(w, device=depth.device)[None, None, :]
    in_bb = (xx >= x0) & (xx <= x1) & (yy >= y0) & (yy <= y1)
    vals = torch.where(in_bb, torch.where(depth > 0, depth, BG_DEPTH), torch.inf)
    k = ((box[1] - box[0] + 1) * (box[3] - box[2] + 1)) // 5
    k = k.clamp(0, h * w - 1)  # a view without features is dropped anyway
    return vals.reshape(b, -1).sort(dim=1).values.gather(1, k[:, None].long())[:, 0]


def _assemble_template(f, p20s, i, ox, oy, dual):
    """One bank record from view i's per-level features, or None for a
    degenerate view (fewer than 8 valid color features at either level).

    Coordinates: crop -> the template image's frame (+ox, +oy); features are
    re-based on the level-0 box's corner, shifted right by the level, and
    clipped at zero."""
    gx0, gy0, go0, gv0 = (a[i] for a in f["grad0"])
    gx1, gy1, go1, gv1 = (a[i] for a in f["grad1"])
    if gv0.sum() < 8 or gv1.sum() < 8:
        return None
    xs0 = [gx0[gv0]]
    ys0 = [gy0[gv0]]
    if dual:
        nx0, ny0, no0, nv0 = (a[i] for a in f["norm0"])
        nx1, ny1, no1, nv1 = (a[i] for a in f["norm1"])
        xs0.append(nx0[nv0])
        ys0.append(ny0[nv0])
    # level-1 features scaled up for the box over all levels
    xs_all = np.concatenate(xs0 + [gx1[gv1] * 2])
    ys_all = np.concatenate(ys0 + [gy1[gv1] * 2])
    x_min, x_max = int(xs_all.min()), int(xs_all.max())
    y_min, y_max = int(ys_all.min()), int(ys_all.max())

    def rebase(x, y, o, lvl):
        arr = np.zeros((MAX_FEATURES, 3), np.int16)
        arr[: len(x), 0] = x - (x_min >> lvl)
        arr[: len(x), 1] = y - (y_min >> lvl)
        arr[: len(x), 2] = o
        val = np.zeros(MAX_FEATURES, bool)
        val[: len(x)] = True
        arr[:, :2] = np.maximum(arr[:, :2], 0)  # negatives of the >> lvl rounding
        return arr, val

    rec = {}
    rec["feat0"], rec["valid0"] = rebase(gx0[gv0], gy0[gv0], go0[gv0], 0)
    rec["feat1"], rec["valid1"] = rebase(gx1[gv1], gy1[gv1], go1[gv1], 1)
    if dual:
        rec["nfeat0"], rec["nvalid0"] = rebase(nx0[nv0], ny0[nv0], no0[nv0], 0)
        rec["nfeat1"], rec["nvalid1"] = rebase(nx1[nv1], ny1[nv1], no1[nv1], 1)
    rec["bbox"] = np.array(
        [x_min + int(ox), y_min + int(oy), x_max - x_min + 1, y_max - y_min + 1], np.int32
    )
    rec["median_depth"] = np.float32(p20s[i])
    pts = np.stack([gx0[gv0] - x_min, gy0[gv0] - y_min], axis=1).astype(np.float32)
    rec["hull"] = _pad_hull(_convex_hull(pts))
    return rec


def build_template_bank(
    mesh,
    class_id: str,
    cam: CameraParameters,
    settings: TemplateSettings,
    props: ModelProperties,
    device,
    progress=None,
    timings: dict | None = None,
) -> TemplateBank:
    """Offline template generation on `device`: radii x viewpoints x
    in-plane angles, each view rendered from its pose in a CROP x CROP
    window centred in the camera image.

    One radius at a time: its views are rendered, quantized and cut
    VIEW_CHUNK at a time into the radius's depth stack (in host memory)
    and candidate lists. Once the radii waiting hold SCAN_VIEWS views (or
    the last radius is cut), their rows take one scan, and each radius's
    feature boxes and p20 depths are taken a chunk at a time before its
    records are assembled on the host. Every step is per view, so the rows
    are those of one batch; the device holds one chunk's renders and maps
    and the candidates of one radius, or of radii of SCAN_VIEWS views, at
    most.

    `progress(radius, templates)` is called after each radius's records, with the
    count of templates kept so far (JAX's callback). `timings`, where
    given, gains the seconds spent in each of TIMED_PHASES: "render",
    "quantize", "cut" (to 512 candidates a map), "scan" (the selection) and
    "assemble" (the box statistics and the host records); the phases are
    timed on the host clock after a device sync each."""
    dev = torch.device(device)
    marr = mesh_to_arrays(mesh, dev)
    dual = not settings.only_color_modality
    ox = (cam.width - CROP) / 2.0
    oy = (cam.height - CROP) / 2.0
    # the reference's in-plane pose angle is the negated warp angle
    angles = [-a for a in settings.in_plane_angles]
    clock = {k: 0.0 for k in TIMED_PHASES}

    def lap(key, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        clock[key] += t - t0
        return t

    records = {k: [] for k in FIELDS + DUAL_FIELDS}
    waiting = []  # (radius, poses, depth, candidates) of the radii not yet scanned
    for r_i, radius in enumerate(settings.radii):
        vps = camera_view_points(
            float(radius), settings.subdivisions, props.rotationally_symmetrical, props.planes_of_symmetry
        )
        q = np.array([template_view_pose(vp, a) for vp in vps for a in angles], np.float64)
        n = len(q)
        # the radius's depth waits for its scan in host memory (pinned: one
        # copy a chunk each way), so the device's peak is a chunk's whatever
        # the radius's view count
        depth = torch.empty((n, CROP, CROP), dtype=torch.float32, pin_memory=dev.type == "cuda")
        cands = []
        for v0 in range(0, n, VIEW_CHUNK):
            t0 = time.perf_counter()
            qc = q[v0 : v0 + VIEW_CHUNK]
            chunk_depth = torch.empty((len(qc), CROP, CROP), dtype=torch.float32, device=dev)
            color = torch.empty((len(qc), CROP, CROP, 3), dtype=torch.float32, device=dev)
            for j, qi in enumerate(qc):
                chunk_depth[j], color[j] = render(
                    marr, quat_to_mat(qi).astype(np.float32), np.array([0.0, 0.0, radius], np.float32),
                    cam.fx, cam.fy, cam.width / 2.0, cam.height / 2.0, width=CROP, height=CROP,
                    with_color=True, origin=(ox, oy), focal_reciprocal=True,
                )
            color *= 255.0
            depth[v0 : v0 + len(qc)] = chunk_depth
            t0 = lap("render", t0)
            maps = quantize_views(color, chunk_depth, dual)
            del color, chunk_depth
            t0 = lap("quantize", t0)
            cands.append({k: cut_candidates(*m) for k, m in maps.items()})
            del maps
            lap("cut", t0)
        waiting.append((radius, q, depth, cands))
        if sum(len(w[1]) for w in waiting) < SCAN_VIEWS and r_i + 1 < len(settings.radii):
            continue
        t0 = time.perf_counter()
        keys = list(cands[0])
        # rows are radius-major, then key, then view
        sel = scan_select(concat_candidates([c[k] for *_, cs in waiting for k in keys for c in cs]))
        t0 = lap("scan", t0)
        row = 0
        for radius, q, depth, cs in waiting:
            n = len(q)
            rsel = {k: tuple(a[row + j * n : row + (j + 1) * n] for a in sel) for j, k in enumerate(keys)}
            row += len(keys) * n
            box = _feature_box(rsel, dual)
            p20 = torch.cat([
                _p20(depth[v0 : v0 + VIEW_CHUNK].to(dev), tuple(t[v0 : v0 + VIEW_CHUNK] for t in box))
                for v0 in range(0, n, VIEW_CHUNK)
            ]).cpu().numpy()
            f = {k: tuple(a.cpu().numpy() for a in v) for k, v in rsel.items()}
            del rsel, box
            for i in range(n):
                rec = _assemble_template(f, p20, i, ox, oy, dual)
                if rec is None:
                    continue
                for k, v in rec.items():
                    records[k].append(v)
                records["quat"].append(q[i].astype(np.float32))
                records["z"].append(np.float32(radius))
            t0 = lap("assemble", t0)
            if progress is not None:
                progress(float(radius), len(records["z"]))
        del sel, cands, cs, depth
        waiting = []
    if timings is not None:
        for k, v in clock.items():
            timings[k] = timings.get(k, 0.0) + v

    def stack(k):
        return np.stack(records[k]) if records[k] else None

    return TemplateBank(
        class_id=class_id,
        feat0=stack("feat0"),
        valid0=stack("valid0"),
        feat1=stack("feat1"),
        valid1=stack("valid1"),
        bbox=stack("bbox"),
        quat=stack("quat"),
        z=np.asarray(records["z"], np.float32),
        median_depth=np.asarray(records["median_depth"], np.float32),
        hull=stack("hull"),
        dual_modality=dual,
        nfeat0=stack("nfeat0"),
        nvalid0=stack("nvalid0"),
        nfeat1=stack("nfeat1"),
        nvalid1=stack("nvalid1"),
    )
