"""The benchmark's inputs, made from `--seed`: the bank (the committed
templates plus seeded fillers, where the configuration asks for them) and
the pool of camera frames a traffic mix cycles through. Both sides, the
port and the plain reference, get the same arrays.

Seeds: one `np.random.SeedSequence(seed)` spawns one stream each for the
fillers, the frames and the reference's sample, so a seed gives the same
inputs whatever else changes.

The fillers (`make_fillers`): each copies the bbox, pose (quat), depth (z,
median_depth) and hull of a committed template picked by the seed, and
draws 63 valid features inside that bbox at each level (level 0 in
[0, w) x [0, h), level 1 in [0, w // 2) x [0, h // 2)) with orientations
0-7; the 64th slot is invalid, as in the committed bank. So each filler's
fit box, which the prefiltered cut's masked max scores, has the real
bank's spread. A dual-modality configuration's fillers then draw their
normal features (`nfeat*`/`nvalid*`) by the same rule; a color
configuration's stream of draws ends before them, so its arrays are the
same as before the dual modality was known.

The modality is the configuration's: `settings.only_color_modality` false
is the dual one (color gradients and depth normals), whose committed bank
file holds `nfeat0`, `nvalid0`, `nfeat1`, `nvalid1` beside the color
features.

The frames (`make_pool`): a canvas of the mix's size, cut into a grid of
tiles; each tile holds the fixture scene (640x480 color and depth)
shifted by a seeded integer offset (|dx| <= max_dx, |dy| <= max_dy, zero
fill), cropped about its centre to the tile; then seeded sensor noise:
+-color_noise levels on each color value (clipped to 0..255) and
+-depth_noise_mm on each nonzero depth.

What a window sends (`window_frames`): the mix's `pool` frames drawn from
one fixed stream (`FRAMES_SEED`), cycled, the same for every seed; and
`check_frames` frames drawn from the seed, sent once each. How much host
work a frame makes (candidates, groups, checks) depends on its shifts and
noise: a pool drawn anew for each seed changed a run's work by up to a
quarter from seed to seed, while the seed's own frames, a few among
thousands, move it by well under one percent.
"""

from __future__ import annotations

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
BANK_FIELDS = ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull")
DUAL_FIELDS = ("nfeat0", "nvalid0", "nfeat1", "nvalid1")
FRAMES_SEED = 0  # the stream of the frames the window cycles, the same for every seed


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def repo_path(rel: str) -> str:
    """A path given relative to the root of the checkout."""
    if os.path.isabs(rel) or ".." in rel.split("/"):
        raise ValueError(f"{rel!r} must be a path inside the checkout")
    return os.path.join(REPO, rel)


def streams(seed: int) -> dict:
    """Independent generators of one seed: fillers, frames, sample."""
    kids = np.random.SeedSequence(int(seed) % 2**64).spawn(3)
    return {k: np.random.default_rng(s) for k, s in zip(("fillers", "frames", "sample"), kids)}


def dual(config: dict) -> bool:
    """Whether the configuration is dual-modality (color gradients and depth
    normals)."""
    return not config["settings"]["only_color_modality"]


def bank_fields(is_dual: bool) -> tuple:
    return BANK_FIELDS + (DUAL_FIELDS if is_dual else ())


def load_committed(path: str, is_dual: bool = False) -> dict:
    with np.load(repo_path(path)) as z:
        return {k: z[k] for k in bank_fields(is_dual)}


def make_fillers(committed: dict, n: int, rng: np.random.Generator, is_dual: bool = False) -> dict:
    """n filler templates (see the module docstring); with normal features
    where the bank is dual-modality (`is_dual`)."""
    src = rng.integers(0, committed["bbox"].shape[0], n)
    out = {k: committed[k][src] for k in ("bbox", "quat", "z", "median_depth", "hull")}
    w = out["bbox"][:, 2].astype(np.int64)
    h = out["bbox"][:, 3].astype(np.int64)
    slots = committed["feat0"].shape[1]
    prefixes = ("", "n") if is_dual else ("",)
    for prefix in prefixes:
        for level, (fw, fh) in ((0, (w, h)), (1, (w // 2, h // 2))):
            f = np.zeros((n, slots, 3), np.int16)
            f[:, :63, 0] = np.floor(rng.random((n, 63)) * fw[:, None])
            f[:, :63, 1] = np.floor(rng.random((n, 63)) * fh[:, None])
            f[:, :63, 2] = rng.integers(0, 8, (n, 63))
            v = np.zeros((n, slots), bool)
            v[:, :63] = True
            out[f"{prefix}feat{level}"], out[f"{prefix}valid{level}"] = f, v
    return out


def make_bank(config: dict, rng: np.random.Generator) -> dict:
    """The configuration's bank as arrays: the committed templates, then
    `templates - committed` fillers; with the normal features where the
    configuration is dual."""
    spec = config["bank"]
    is_dual = dual(config)
    committed = load_committed(spec["committed"], is_dual)
    extra = int(spec["templates"]) - committed["bbox"].shape[0]
    if extra < 0:
        raise ValueError("the bank has fewer templates than the committed file")
    if not extra:
        return committed
    fill = make_fillers(committed, extra, rng, is_dual)
    return {k: np.concatenate([committed[k], fill[k]]) for k in committed}


def camera(config: dict, mix: dict) -> dict:
    """The configuration's focal lengths with the mix's frame geometry
    (principal point at the frame's centre)."""
    w, h = int(mix["width"]), int(mix["height"])
    return {"fx": float(config["camera"]["fx"]), "fy": float(config["camera"]["fy"]),
            "cx": w / 2.0, "cy": h / 2.0, "width": w, "height": h}


def _shifted(a: np.ndarray, dx: int, dy: int) -> np.ndarray:
    out = np.zeros_like(a)
    h, w = a.shape[:2]
    out[max(0, dy) : h + min(0, dy), max(0, dx) : w + min(0, dx)] = \
        a[max(0, -dy) : h + min(0, -dy), max(0, -dx) : w + min(0, -dx)]
    return out


def make_pool(mix: dict, rng: np.random.Generator) -> list:
    """The mix's pool of (color [H, W, 3] uint8 BGR, depth [H, W] uint16)."""
    with np.load(os.path.join(ROOT, "data", "fixture.npz")) as z:
        scene_c, scene_d = z["color"], z["depth"]
    sh, sw = scene_d.shape
    w, h = int(mix["width"]), int(mix["height"])
    rows, cols = mix["tiles"]
    th, tw = h // rows, w // cols
    if th > sh or tw > sw:
        raise ValueError("a tile is larger than the fixture scene")
    oy, ox = (sh - th) // 2, (sw - tw) // 2
    pool = []
    for _ in range(int(mix["pool"])):
        color = np.zeros((h, w, 3), np.uint8)
        depth = np.zeros((h, w), np.uint16)
        for r in range(rows):
            for c in range(cols):
                dx = int(rng.integers(-mix["max_dx"], mix["max_dx"] + 1))
                dy = int(rng.integers(-mix["max_dy"], mix["max_dy"] + 1))
                tile = (slice(r * th, (r + 1) * th), slice(c * tw, (c + 1) * tw))
                color[tile] = _shifted(scene_c, dx, dy)[oy : oy + th, ox : ox + tw]
                depth[tile] = _shifted(scene_d, dx, dy)[oy : oy + th, ox : ox + tw]
        cn, dn = int(mix["color_noise"]), int(mix["depth_noise_mm"])
        color = np.clip(color.astype(np.int16) + rng.integers(-cn, cn + 1, color.shape, dtype=np.int16),
                        0, 255).astype(np.uint8)
        noise = rng.integers(-dn, dn + 1, depth.shape, dtype=np.int32)
        depth = np.where(depth > 0, depth.astype(np.int32) + noise, 0).clip(0, 65535).astype(np.uint16)
        pool.append((color, depth))
    return pool


def window_frames(mix: dict, rng: np.random.Generator) -> tuple:
    """(pool, cycled, once): the frames a window sends. `cycled`: the pool
    indices of the mix's `pool` frames drawn from the fixed stream
    FRAMES_SEED, the same for every seed, which the window cycles through,
    so that every seed brings the same work; `once`: those of
    `check_frames` frames drawn from `rng`, the seed's own, which the window
    sends once each, so that every seed brings new frames to the check."""
    cycled = make_pool(mix, np.random.default_rng(FRAMES_SEED))
    once = make_pool(dict(mix, pool=int(mix["check_frames"])), rng)
    n = len(cycled)
    return cycled + once, list(range(n)), list(range(n, n + len(once)))


def sample(pool_size: int, k: int, rng: np.random.Generator) -> list:
    """The pool frames whose answers the reference checks."""
    return sorted(int(i) for i in rng.choice(pool_size, size=min(k, pool_size), replace=False))
