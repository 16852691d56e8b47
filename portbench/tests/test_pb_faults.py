"""A whole run on the CPU at a small size (the harness's look for a chip
skipped), of a color deployment and of a dual-modality one (color gradients
and depth normals, T = 5/8: pruned-2k's settings with `only_color_modality`
false, over the committed dual bank): sound, it comes out correct; with the
timed path broken underneath, in each way a detection cell can be broken, it
does not.

- an answer altered where it is produced: one packed candidate's
  similarity moved in the match program's output;
- a step that returns its state unchanged: the match program hands back
  the previous frame's candidates;
- half of the frames left out: the stream answers every other frame;
- a pose altered where it is produced: the translation off by 1 mm.
(One card: there is no exchange between chips to leave out.)
"""

import time

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.reference import match

CELL = "pruned-2k.stream"
DUAL_BANK = "portbench/data/lagergehaeuse_dual.npz"
MODALITIES = ["color", "dual"]


def small_cell(modality="color"):
    """(configuration, mix) of CELL cut to a 320x240 pool of 3; "dual": its
    deployment over the committed dual bank, the normals on."""
    manifest = inputs.load_json(inputs.repo_path("BENCHMARK.json"))
    spec = next(c for c in manifest["workloads"] if c["name"] == CELL)
    config, mix = harness.load_cell(manifest, spec)
    if modality == "dual":
        config = dict(config, settings=dict(config["settings"], only_color_modality=False),
                      bank=dict(config["bank"], committed=DUAL_BANK))
    return config, dict(mix, width=320, height=240, pool=3, check_frames=3)


def run_small(modality="color", seconds=6.0, seed=20260101):
    config, mix = small_cell(modality)
    return harness.run_cell(config, mix, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                            log=lambda s: None)


def _run(modality="color"):
    return run_small(modality)["numbers"]


def _correct(numbers):
    return all(numbers[k] <= lim for k, lim in harness.LIMITS.items())


@pytest.mark.parametrize("modality", MODALITIES)
def test_sound_run_is_correct(modality):
    numbers = _run(modality)
    assert numbers["compared"] >= 2 and _correct(numbers), numbers


def _fault(monkeypatch, kind):
    from linemod_tpu_torch.pipeline import pose_detection as pd

    if kind == "answer_altered":
        original = pd.detect_frame

        def altered(state, color, depth=None):
            out = original(state, color, depth).clone()
            out[0, 3] += 0.5
            return out

        monkeypatch.setattr(pd, "detect_frame", altered)
    elif kind == "state_unchanged":
        original = pd.detect_frame
        last = []

        def stale(state, color, depth=None):
            out = original(state, color, depth)
            last.append(out)
            return last[0]

        monkeypatch.setattr(pd, "detect_frame", stale)
    elif kind == "half_left_out":
        original = pd.PoseDetection.detect_stream

        def halved(self, frames, *args, **kwargs):
            for i, poses in enumerate(original(self, frames, *args, **kwargs)):
                if i % 2 == 0:
                    yield poses

        monkeypatch.setattr(pd.PoseDetection, "detect_stream", halved)
    elif kind == "pose_altered":
        original = pd.reconstruct_pose

        def moved(*args, **kwargs):
            p = original(*args, **kwargs)
            p.translation = p.translation + 1.0
            return p

        monkeypatch.setattr(pd, "reconstruct_pose", moved)


@pytest.mark.parametrize("modality", MODALITIES)
@pytest.mark.parametrize("kind", ["answer_altered", "state_unchanged", "half_left_out", "pose_altered"])
def test_broken_path_is_not_correct(monkeypatch, kind, modality):
    _fault(monkeypatch, kind)
    numbers = _run(modality)
    assert not _correct(numbers), numbers


def test_dual_run_reads_both_modalities():
    """The dual run's reference bank holds both modalities' features, and its
    answers lie on the T = 5 grid."""
    out = run_small("dual")
    assert inputs.dual(small_cell("dual")[0])
    ref_bank = match.make_bank(out["inputs"][0], "cpu", True)
    assert ref_bank.dual and ref_bank.t_fine == 5 and ref_bank.feat0.shape[1] == 128
    packed = np.concatenate([out["ref"][k][0] for k in out["ref"]])
    live = packed[packed[:, 4] > 0.5]
    assert len(live) and not (live[:, 1] % 5).any() and not (live[:, 2] % 5).any()
