"""The color configurations' inputs and reference answers are pinned: for one
seed, the bank, the pool of every mix and the plain reference's answers
hash to what they hashed to before the harness learned the dual modality,
and the scan kernels' bounds over them are the same numbers.
A change to the generators or to the reference that moves a color cell's
yardstick fails here."""

import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from portbench import harness, inputs

SEED = 2**31 + 99
BANKS = {
    "pruned-2k": "622ddf033e0b9a8e9cfd24ca14a10dc492aaae2148eab25ddb41409ffcf39c44",
    "shipped-96k": "6ee0e12555c4fb37d6c4f629a7a0de9f5979b2558391df3d55422411819c03ae",
}
POOLS = {
    "bin1280": "2977f210e6e4906f41218f424bc7a338f699b2ae0a921fb5fa1edf4041e5b3a5",
    "cycle": "59876d1d9979132974723434ef347016765d790a3c5ce49f9a5fdcb865ad95fc",
    "stream": "59876d1d9979132974723434ef347016765d790a3c5ce49f9a5fdcb865ad95fc",
}
# (configuration, templates): the reference over a 320x240 pool of 3 (134,
# 136 and 38 valid rows, a pose each; the shipped bank's fillers reach no
# candidate there, so both give the same answers)
ANSWERS = {
    ("pruned-2k", 1950): "3df09324b6eab39496f275cb517c3c822034cc8877764c1c91358b3c0cfca36d",
    ("shipped-96k", 2600): "3df09324b6eab39496f275cb517c3c822034cc8877764c1c91358b3c0cfca36d",
}
# the scan kernels' bounds (s) over those three frames
BOUNDS = {
    ("pruned-2k", 1950): {
        "fine_scores": [2.1486029850746268e-07, 2.0434477611940298e-07, 2.1492835820895523e-07],
        "coarse_scores": [2.143980895522388e-06] * 3,
    },
    ("shipped-96k", 2600): {
        "fine_scores": [2.1486029850746268e-07, 2.0434477611940298e-07, 2.1492835820895523e-07],
        "coarse_scores": [1.542419104477612e-06] * 3,
        "coarse_max": [1.596522985074627e-06] * 3,
    },
}


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _config(name, templates=None):
    cfg = inputs.load_json(os.path.join(inputs.ROOT, "configs", f"{name}.json"))
    if templates is not None:
        cfg = dict(cfg, bank=dict(cfg["bank"], templates=templates))
    return cfg


def _mix(name, **kw):
    return dict(inputs.load_json(os.path.join(inputs.ROOT, "traffic", f"{name}.json")), **kw)


def _bank_digest(cfg):
    bank = inputs.make_bank(cfg, inputs.streams(SEED)["fillers"])
    return _digest(bank[k] for k in sorted(bank))


@pytest.mark.parametrize("config", sorted(BANKS))
def test_color_bank_unchanged(config):
    assert _bank_digest(_config(config)) == BANKS[config]


@pytest.mark.parametrize("mix", sorted(POOLS))
def test_pool_unchanged(mix):
    pool = inputs.make_pool(_mix(mix), inputs.streams(SEED)["frames"])
    assert _digest(a for frame in pool for a in frame) == POOLS[mix]


@functools.lru_cache(maxsize=None)
def _reference(config, templates):
    """(configuration, mix, bank, the reference's answers, its bank) of the
    pinned seed over a 320x240 pool of 3."""
    cfg = _config(config, templates)
    mix = _mix("stream", width=320, height=240, pool=3)
    rngs = inputs.streams(SEED)
    bank = inputs.make_bank(cfg, rngs["fillers"])
    pool = inputs.make_pool(mix, rngs["frames"])
    ref, ref_bank = harness.reference_frames(cfg, mix, bank, pool, [0, 1, 2], torch.device("cpu"))
    return cfg, mix, bank, ref, ref_bank


def _answers_digest(config, templates):
    ref = _reference(config, templates)[3]
    parts = []
    for k in sorted(ref):
        packed, poses, _ = ref[k]
        parts.append(packed)
        for t, q, b in poses:
            parts += [np.asarray(t), np.asarray(q), np.asarray(b, np.int64)]
    return _digest(parts)


@pytest.mark.parametrize("config,templates", sorted(ANSWERS))
def test_color_reference_answers_unchanged(config, templates):
    assert _answers_digest(config, templates) == ANSWERS[(config, templates)]


@pytest.mark.parametrize("config,templates", sorted(BOUNDS))
def test_color_kernel_bounds_unchanged(config, templates):
    cfg, mix, bank, ref, ref_bank = _reference(config, templates)
    assert harness.kernel_bounds(cfg, mix, bank, ref_bank, ref, [0, 1, 2]) == BOUNDS[(config, templates)]
