"""Dense template bank: loading, padding and concatenation.

Counterpart of the persistence half of `linemod_tpu/models/template_bank.py`
(one npz of dense per-template arrays plus a json sidecar with the class id
and modality flag) and of its `concat_banks`. The bank stays host numpy:
`ops/matching` derives the device tensors from it. Template generation is
not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import json

import numpy as np

MAX_FEATURES = 64
HULL_VERTS = 32


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
) -> TemplateBank:
    """Random color-only bank (no rendering), the same arrays as
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

    fields = ["feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull"]
    if dual:
        fields += ["nfeat0", "nvalid0", "nfeat1", "nvalid1"]
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
