"""The seeded inputs: each traffic mix's frames and the filler bank."""

import os

import numpy as np
import pytest

from portbench import harness, inputs

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(inputs.ROOT, "traffic")) if f.endswith(".json"))
SEEDS = (0, 2**31 + 12345, 9_007_199_254_740_993)


def _mix(name):
    return dict(inputs.load_json(os.path.join(inputs.ROOT, "traffic", f"{name}.json")), pool=2)


@pytest.mark.parametrize("mix", MIXES)
def test_frames_deterministic_for_a_seed(mix):
    m = _mix(mix)
    a = inputs.make_pool(m, inputs.streams(SEEDS[1])["frames"])
    b = inputs.make_pool(m, inputs.streams(SEEDS[1])["frames"])
    for (ca, da), (cb, db) in zip(a, b):
        assert np.array_equal(ca, cb) and np.array_equal(da, db)
    c, d = a[0]
    assert c.shape == (m["height"], m["width"], 3) and c.dtype == np.uint8
    assert d.shape == (m["height"], m["width"]) and d.dtype == np.uint16


@pytest.mark.parametrize("mix", MIXES)
def test_frames_differ_between_seeds(mix):
    m = _mix(mix)
    a = inputs.make_pool(m, inputs.streams(SEEDS[0])["frames"])
    b = inputs.make_pool(m, inputs.streams(SEEDS[2])["frames"])
    assert not np.array_equal(a[0][0], b[0][0])


def test_frames_are_the_scene_shifted_with_bounded_noise():
    m = dict(_mix("stream"), pool=1)
    color, depth = inputs.make_pool(m, inputs.streams(7)["frames"])[0]
    with np.load(os.path.join(inputs.ROOT, "data", "fixture.npz")) as z:
        scene_c, scene_d = z["color"], z["depth"]
    best = None
    for dy in range(-m["max_dy"], m["max_dy"] + 1):
        for dx in range(-m["max_dx"], m["max_dx"] + 1):
            ref = inputs._shifted(scene_d, dx, dy).astype(np.int32)
            err = np.abs(ref - depth.astype(np.int32)).max()
            if best is None or err < best[0]:
                best = (err, dx, dy)
    err, dx, dy = best
    assert err <= m["depth_noise_mm"]
    ref_c = inputs._shifted(scene_c, dx, dy).astype(np.int16)
    assert np.abs(ref_c - color.astype(np.int16)).max() <= m["color_noise"]


def test_four_tiles_at_1280():
    m = dict(_mix("bin1280"), pool=1)
    color, depth = inputs.make_pool(m, inputs.streams(3)["frames"])[0]
    assert color.shape == (960, 1280, 3)
    for ty in (0, 480):
        for tx in (0, 640):
            assert (depth[ty : ty + 480, tx : tx + 640] > 0).mean() > 0.5


def test_fillers_copy_committed_boxes_and_stay_inside():
    committed = inputs.load_committed("portbench/data/lagergehaeuse.npz")
    fill = inputs.make_fillers(committed, 500, np.random.default_rng(4))
    rows = {tuple(b) + tuple(q) for b, q in zip(committed["bbox"], committed["quat"])}
    for i in range(500):
        assert tuple(fill["bbox"][i]) + tuple(fill["quat"][i]) in rows
    src = [np.flatnonzero((committed["bbox"] == fill["bbox"][i]).all(1) & (committed["quat"] == fill["quat"][i]).all(1))
           for i in range(20)]
    for i, s in enumerate(src):
        assert any(committed["z"][j] == fill["z"][i] and np.array_equal(committed["hull"][j], fill["hull"][i])
                   for j in s)
    w, h = fill["bbox"][:, 2, None], fill["bbox"][:, 3, None]
    f0, f1 = fill["feat0"][:, :63].astype(int), fill["feat1"][:, :63].astype(int)
    assert (f0[..., 0] < w).all() and (f0[..., 1] < h).all() and (f0 >= 0).all()
    assert (f1[..., 0] < w // 2).all() and (f1[..., 1] < h // 2).all() and (f1 >= 0).all()
    assert set(np.unique(f0[..., 2])) == set(range(8))
    assert fill["valid0"][:, :63].all() and not fill["valid0"][:, 63].any()


def test_bank_deterministic_and_sized():
    cfg = inputs.load_json(os.path.join(inputs.ROOT, "configs", "shipped-96k.json"))
    cfg = dict(cfg, bank=dict(cfg["bank"], templates=3000))
    a = inputs.make_bank(cfg, inputs.streams(SEEDS[1])["fillers"])
    b = inputs.make_bank(cfg, inputs.streams(SEEDS[1])["fillers"])
    c = inputs.make_bank(cfg, inputs.streams(SEEDS[2])["fillers"])
    assert a["bbox"].shape[0] == 3000
    assert all(np.array_equal(a[k], b[k]) for k in inputs.BANK_FIELDS)
    assert not np.array_equal(a["feat0"], c["feat0"])


def test_sample_draws_distinct_frames():
    s = inputs.sample(32, 8, inputs.streams(11)["sample"])
    assert len(set(s)) == 8 and all(0 <= k < 32 for k in s)


def test_dual_bank_carries_the_normal_features():
    """A dual configuration's bank: the committed normal features, then
    fillers' drawn by the color features' rule."""
    cfg = inputs.load_json(os.path.join(inputs.ROOT, "configs", "pruned-2k.json"))
    cfg = dict(cfg, settings=dict(cfg["settings"], only_color_modality=False),
               bank={"committed": "portbench/data/lagergehaeuse_dual.npz", "templates": 2200})
    assert inputs.dual(cfg)
    bank = inputs.make_bank(cfg, inputs.streams(5)["fillers"])
    assert set(bank) == set(inputs.BANK_FIELDS + inputs.DUAL_FIELDS) and bank["nfeat0"].shape == (2200, 64, 3)
    with np.load(inputs.repo_path(cfg["bank"]["committed"])) as z:
        assert all(np.array_equal(bank[k][:1950], z[k]) for k in inputs.DUAL_FIELDS)
    w, h = bank["bbox"][1950:, 2, None], bank["bbox"][1950:, 3, None]
    n0, n1 = bank["nfeat0"][1950:, :63].astype(int), bank["nfeat1"][1950:, :63].astype(int)
    assert (n0[..., 0] < w).all() and (n0[..., 1] < h).all() and (n0 >= 0).all()
    assert (n1[..., 0] < w // 2).all() and (n1[..., 1] < h // 2).all() and (n1 >= 0).all()
    assert set(np.unique(n0[..., 2])) == set(range(8))
    assert bank["nvalid0"][1950:, :63].all() and not bank["nvalid1"][1950:, 63].any()
    assert not np.array_equal(bank["nfeat0"][1950:], bank["feat0"][1950:])


def _key(frame):
    return frame[0].tobytes() + frame[1].tobytes()


@pytest.mark.parametrize("mix", MIXES)
def test_window_cycles_the_same_frames_and_sends_the_seeds_own(mix):
    """Every seed cycles the same frames (so brings the same work) and adds
    `check_frames` of its own, which differ from seed to seed."""
    m = dict(_mix(mix), pool=4, check_frames=3)
    pa, ca, oa = inputs.window_frames(m, inputs.streams(SEEDS[0])["frames"])
    pb, cb, ob = inputs.window_frames(m, inputs.streams(SEEDS[2])["frames"])
    assert ca == cb == [0, 1, 2, 3] and oa == ob == [4, 5, 6] and len(pa) == len(pb) == 7
    assert [_key(pa[k]) for k in ca] == [_key(pb[k]) for k in cb]
    assert len({_key(f) for f in pa}) == 7
    assert not {_key(pa[k]) for k in oa} & {_key(pb[k]) for k in ob}


class _Stream:
    """A detector whose stream answers each frame at once with the frame."""

    def detect_stream(self, frames, num_objects, pipeline_depth):
        yield from frames


def test_window_sends_each_of_the_seeds_frames_once():
    pool = list(range(10))
    sent, answers, _, _, _ = harness.drive(_Stream(), pool, [0, 1, 2], {"loop": "stream", "pipeline_depth": 4},
                                           0.05, once=[7, 8, 9])
    assert len(sent) > 20 and answers == sent
    assert sent[:7] == [0, 7, 1, 8, 2, 9, 0] and set(sent[7:]) == {0, 1, 2}
