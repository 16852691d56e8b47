"""A whole run on the CPU at a small size (the harness's look for a chip
skipped): sound, it comes out correct; with the timed path broken
underneath, in each way a detection cell can be broken, it does not.

- an answer altered where it is produced: one packed candidate's
  similarity moved in the match program's output;
- a step that returns its state unchanged: the match program hands back
  the previous frame's candidates;
- half of the frames left out: the stream answers every other frame;
- a pose altered where it is produced: the translation off by 1 mm.
(One card: there is no exchange between chips to leave out.)
"""

import time

import pytest
import torch

from portbench import harness, inputs

CELL = "pruned-2k.stream"


def _run(seconds=1.5, seed=20260101):
    manifest = inputs.load_json(inputs.repo_path("BENCHMARK.json"))
    spec = next(c for c in manifest["workloads"] if c["name"] == CELL)
    config, mix = harness.load_cell(manifest, spec)
    mix = dict(mix, width=320, height=240, pool=3, check_frames=3)
    out = harness.run_cell(config, mix, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                           log=lambda s: None)
    return out["numbers"]


def _correct(numbers):
    return all(numbers[k] <= lim for k, lim in harness.LIMITS.items())


def test_sound_run_is_correct():
    numbers = _run()
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


@pytest.mark.parametrize("kind", ["answer_altered", "state_unchanged", "half_left_out", "pose_altered"])
def test_broken_path_is_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    numbers = _run()
    assert not _correct(numbers), numbers
