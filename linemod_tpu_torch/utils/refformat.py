"""The reference's on-disk bank pair: `linemod_templates.yml.gz` +
`linemod_tempPosFile.bin` (the port's own copy of
`linemod_tpu/utils/refformat.py`).

The reference persists its trained state as two files
(HighLevelLineMOD::writeLinemod / readLinemod,
src/HighLevelLinemod.cpp:256-320):

1. `linemod_templates.yml.gz`: cv::FileStorage YAML of the cv::linemod
   detector (pyramid levels, modality params, T per level) followed by one
   `classes` entry per model with every template's per-level feature lists
   (opencv_contrib modules/rgbd/src/linemod.cpp: Detector::write /
   writeClass / Template::write; template pyramids are indexed
   level * num_modalities + modality).
2. `linemod_tempPosFile.bin`: raw `Template` structs
   (include/HighLevelLinemod.h:130-148): glm::vec3 translation (3xf32),
   glm::quat (x, y, z, w storage), cv::Rect (4xi32), uint16 medianDepth, 2
   pad bytes -> 48 bytes each, prefixed by a u32 model count and a u64
   per-model template count.

The export writes the JAX package's text and bytes exactly, and the import
reads the YAML with `utils/cvyaml.parse_yaml` (no PyYAML), so banks convert
both ways between the two packages. The quaternion is stored x, y, z, w, as
the JAX package stores it: GLM's storage order before 0.9.9.9, which a
reference built against a later GLM (w first unless
GLM_FORCE_QUAT_DATA_XYZW) would not share.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..models.template_bank import HULL_VERTS, MAX_FEATURES, TemplateBank, _convex_hull, _pad_hull
from .cvyaml import parse_yaml

TEMPLATE_STRUCT = struct.Struct("<3f4f4iH2x")  # 48 bytes, see module docstring


def _fmt_features(feats, valid):
    rows = []
    for (x, y, label), ok in zip(feats, valid):
        if ok:
            rows.append(f"[ {int(x)}, {int(y)}, {int(label)} ]")
    return rows


def _template_yaml(width, height, level, feats, valid, indent):
    pad = " " * indent
    lines = [
        f"{pad}- {{ width: {int(width)}, height: {int(height)}, "
        f"pyramid_level: {int(level)},",
        f"{pad}    features: [",
    ]
    rows = _fmt_features(feats, valid)
    for i, r in enumerate(rows):
        lines.append(f"{pad}      {r}{',' if i + 1 < len(rows) else ''}")
    lines.append(f"{pad}    ] }}")
    return lines


def export_reference_banks(banks: list, out_dir: str, t_levels=None) -> tuple:
    """Write `banks` (one per model, matching the reference's one-pair-for-
    all-models layout) as linemod_templates.yml.gz + linemod_tempPosFile.bin.
    Returns the two paths.

    All banks must share the modality mode (one cv::linemod detector holds
    every class). t_levels: spreading T per pyramid level; defaults to the
    reference's ({5, 8} dual-modality, {2, 8} color-only —
    src/HighLevelLinemod.cpp:32,40)."""
    if not banks:
        raise ValueError("no banks to export")
    os.makedirs(out_dir, exist_ok=True)
    dual = banks[0].dual_modality
    if any(b.dual_modality != dual for b in banks):
        raise ValueError("all banks must share the modality mode")
    if t_levels is None:
        t_levels = (5, 8) if dual else (2, 8)

    lines = ["%YAML:1.0", "---", "pyramid_levels: 2", "modalities:"]
    # modality extraction params are cv::linemod construction defaults; they
    # affect template EXTRACTION (already done) and image quantization, not
    # the stored features, so defaults are recorded for readback fidelity
    lines.append(
        "   - { type: ColorGradient, weak_threshold: 10., num_features: 63, "
        "strong_threshold: 55. }"
    )
    if dual:
        lines.append(
            "   - { type: DepthNormal, distance_threshold: 2000, "
            "difference_threshold: 50, num_features: 63, "
            "extract_threshold: 2 }"
        )
    lines.append(f"T: [ {t_levels[0]}, {t_levels[1]} ]")
    lines.append("classes:")
    num_mod = 2 if dual else 1
    for bank in banks:
        lines.append(f"   - class_id: \"{bank.class_id}\"")
        lines.append("     modalities: [ ColorGradient"
                     + (", DepthNormal" if dual else "") + " ]")
        lines.append("     pyramid_levels: 2")
        lines.append("     template_pyramids:")
        for i in range(bank.num_templates):
            lines.append(f"        - template_id: {i}")
            lines.append("          templates:")
            # index = level * num_modalities + modality (cv::linemod layout)
            entries = {
                (0, 0): (bank.feat0[i], bank.valid0[i]),
                (1, 0): (bank.feat1[i], bank.valid1[i]),
            }
            if dual:
                entries[(0, 1)] = (bank.nfeat0[i], bank.nvalid0[i])
                entries[(1, 1)] = (bank.nfeat1[i], bank.nvalid1[i])
            w0, h0 = int(bank.bbox[i, 2]), int(bank.bbox[i, 3])
            for level in (0, 1):
                scale = 1 << level
                for mod in range(num_mod):
                    feats, valid = entries[(level, mod)]
                    lines += _template_yaml(
                        -(-w0 // scale), -(-h0 // scale), level, feats,
                        valid, 10,
                    )
    yml_path = os.path.join(out_dir, "linemod_templates.yml.gz")
    with gzip.open(yml_path, "wt") as f:
        f.write("\n".join(lines) + "\n")

    bin_path = os.path.join(out_dir, "linemod_tempPosFile.bin")
    with open(bin_path, "wb") as f:
        f.write(struct.pack("<I", len(banks)))
        for bank in banks:
            f.write(struct.pack("<Q", bank.num_templates))
            for i in range(bank.num_templates):
                w, x, y, z = bank.quat[i]  # ours is (w, x, y, z)
                f.write(
                    TEMPLATE_STRUCT.pack(
                        0.0, 0.0, float(bank.z[i]),  # translation (0, 0, d)
                        float(x), float(y), float(z), float(w),  # glm xyzw
                        int(bank.bbox[i, 0]), int(bank.bbox[i, 1]),
                        int(bank.bbox[i, 2]), int(bank.bbox[i, 3]),
                        int(round(float(bank.median_depth[i]))),
                    )
                )
    return yml_path, bin_path


def export_reference_bank(bank, out_dir: str, t_levels=None) -> tuple:
    """Single-class convenience wrapper over export_reference_banks."""
    return export_reference_banks([bank], out_dir, t_levels)


def import_reference_banks(in_dir: str) -> dict:
    """Read a reference-format pair into {class_id: TemplateBank}.

    The reference writes EVERY model's templates into the one yml.gz (one
    `classes` entry each) and the bin file's model-count-prefixed struct
    runs in the same class order (writeLinemod,
    src/HighLevelLinemod.cpp:262-284)."""
    with gzip.open(
        os.path.join(in_dir, "linemod_templates.yml.gz"), "rt"
    ) as f:
        doc = parse_yaml(f.read())
    classes = doc["classes"]

    # bin file: per-model template runs, in class order
    bin_path = os.path.join(in_dir, "linemod_tempPosFile.bin")
    per_model = []
    with open(bin_path, "rb") as f:
        (n_models,) = struct.unpack("<I", f.read(4))
        for _ in range(n_models):
            (cnt,) = struct.unpack("<Q", f.read(8))
            rows = [
                TEMPLATE_STRUCT.unpack(f.read(TEMPLATE_STRUCT.size))
                for _ in range(cnt)
            ]
            per_model.append(rows)
    if len(per_model) != len(classes):
        raise ValueError(
            f"model count mismatch: yml has {len(classes)} classes, "
            f"bin has {len(per_model)}"
        )
    return {
        str(cls["class_id"]): _class_to_bank(cls, rows)
        for cls, rows in zip(classes, per_model)
    }


def import_reference_bank(in_dir: str):
    """Read a single-class reference-format pair into a TemplateBank."""
    banks = import_reference_banks(in_dir)
    if len(banks) != 1:
        raise ValueError(
            f"reference pair holds {len(banks)} classes "
            f"({sorted(banks)}); use import_reference_banks"
        )
    return next(iter(banks.values()))


def _class_to_bank(cls: dict, bin_rows: list):
    mods = cls["modalities"]
    dual = "DepthNormal" in mods
    num_mod = len(mods)
    tps = cls["template_pyramids"]
    n = len(tps)

    def alloc():
        return (
            np.zeros((n, MAX_FEATURES, 3), np.int16),
            np.zeros((n, MAX_FEATURES), bool),
        )

    feat0, valid0 = alloc()
    feat1, valid1 = alloc()
    nfeat0, nvalid0 = alloc()
    nfeat1, nvalid1 = alloc()
    bbox = np.zeros((n, 4), np.int32)
    hull = np.zeros((n, HULL_VERTS, 2), np.float32)

    targets = {
        (0, 0): (feat0, valid0),
        (1, 0): (feat1, valid1),
        (0, 1): (nfeat0, nvalid0),
        (1, 1): (nfeat1, nvalid1),
    }
    for i, tp in enumerate(tps):
        templates = tp["templates"]
        for j, t in enumerate(templates):
            level = int(t["pyramid_level"])
            # cv::linemod layout: j == level * num_mod + mod
            mod = j - level * num_mod
            fa, va = targets[(level, mod)]
            feats = t.get("features") or []
            m = min(len(feats), MAX_FEATURES)
            for k in range(m):
                fa[i, k] = feats[k]
                va[i, k] = True

    if len(bin_rows) != n:
        raise ValueError(
            f"template count mismatch: yml has {n}, bin has {len(bin_rows)}"
        )
    quat = np.zeros((n, 4), np.float32)
    zdist = np.zeros((n,), np.float32)
    median = np.zeros((n,), np.float32)
    for idx, vals in enumerate(bin_rows):
        tx, ty, tz, qx, qy, qz, qw, bx, by, bw, bh, med = vals
        zdist[idx] = tz
        quat[idx] = (qw, qx, qy, qz)  # glm xyzw -> ours wxyz
        bbox[idx] = (bx, by, bw, bh)
        median[idx] = med

    for i in range(n):
        pts = feat0[i, valid0[i], :2].astype(np.float32)
        hull[i] = _pad_hull(_convex_hull(pts)) if len(pts) else 0.0

    kw = {}
    if dual:
        kw = dict(nfeat0=nfeat0, nvalid0=nvalid0, nfeat1=nfeat1,
                  nvalid1=nvalid1)
    return TemplateBank(
        class_id=str(cls["class_id"]),
        feat0=feat0, valid0=valid0, feat1=feat1, valid1=valid1,
        bbox=bbox, quat=quat, z=zdist, median_depth=median, hull=hull,
        dual_modality=dual, **kw,
    )
