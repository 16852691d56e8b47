"""The port's spans (`linemod_tpu_torch/utils/profiling.py`) on the fixture
frame with the committed 1,950-template bank, on the CPU.

One `detect` records the span tree of a frame (`frame.submit` with its
`submit.*` and `match.*` children, `frame.collect` with its `collect.*`
children, one frame id); with recording off nothing is kept and the
results do not change; the stream carries each submission's id to its
collection; a retried frame's copy lies inside `collect.retry`; the list is
bounded; a torch.profiler session turns recording on, and the spans share
its clock.
"""

import collections
import os

import numpy as np
import pytest
import torch

from linemod_tpu_torch.utils import profiling
from linemod_tpu_torch.utils.profiling import RECORDER, frame_span, recording, span

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")

SUBMIT_CHILDREN = ["submit.recenter", "submit.upload", "match.quantize", "match.planes", "match.quantize",
                   "match.planes", "match.cut", "match.refine", "match.pack"]


@pytest.fixture(scope="module")
def fixture():
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    det = PoseDetection(
        TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")), cam, settings,
        load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")), device="cpu",
    )
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
    return det, color, depth


@pytest.fixture(scope="module")
def recorded_detect(fixture):
    """(spans of one recorded detect, its poses, its packed array)."""
    det, color, depth = fixture
    RECORDER.take()
    with recording():
        handle = det.detect_submit(color, depth)
        packed = handle[0].numpy().copy()
        poses = det.detect_collect(handle, 1, frame=profiling.last_frame())
    return RECORDER.take(), poses, packed


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.seq]


def test_detect_records_the_span_tree(recorded_detect):
    spans, poses, _ = recorded_detect
    assert poses
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [r.name for r in roots] == ["frame.submit", "frame.collect"]
    submit, collect = roots
    assert {s.frame for s in spans} == {submit.frame}
    assert _children(spans, submit) == SUBMIT_CHILDREN
    kids = _children(spans, collect)
    assert kids[:2] == ["collect.copy", "collect.group"] and len(kids) > 2
    assert set(kids[2:]) == {"collect.checks"}
    assert len(spans) == 2 + len(SUBMIT_CHILDREN) + len(kids)
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_seq[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert submit.end_ns <= collect.start_ns


def test_recording_off_keeps_nothing_and_changes_no_result(fixture, recorded_detect):
    det, color, depth = fixture
    _, poses_on, packed_on = recorded_detect
    RECORDER.take()
    assert not RECORDER.on() and profiling.last_frame() is None
    handle = det.detect_submit(color, depth)
    packed_off = handle[0].numpy().copy()
    poses_off = det.detect_collect(handle, 1)
    assert len(RECORDER.spans) == 0
    assert np.array_equal(packed_on, packed_off)
    assert len(poses_on) == len(poses_off)
    for a, b in zip(poses_on, poses_off):
        assert np.array_equal(a.translation, b.translation) and np.array_equal(a.quaternion, b.quaternion)
        assert tuple(a.bounding_box) == tuple(b.bounding_box)


def test_stream_collects_carry_their_submissions_ids(fixture):
    """With 4 frames in flight, the k-th frame.collect carries the k-th
    frame.submit's id, and the first collection starts after the fifth
    submission."""
    det, color, depth = fixture
    RECORDER.take()
    with recording():
        out = list(det.detect_stream([(color, depth)] * 5, num_objects=1, pipeline_depth=4))
    spans = RECORDER.take()
    assert len(out) == 5 and all(out)
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    submits = [s for s in roots if s.name == "frame.submit"]
    collects = [s for s in roots if s.name == "frame.collect"]
    assert len(submits) == len(collects) == 5
    assert len({s.frame for s in submits}) == 5
    assert [c.frame for c in collects] == [s.frame for s in submits]
    assert collects[0].start_ns >= submits[4].end_ns
    for s in spans:
        assert s.frame in {r.frame for r in submits}


def test_retry_copy_lies_inside_collect_retry(fixture):
    """A packed array whose proof row says the cut is not exact is re-run
    (here on the dense state): the rerun's copy is a collect.copy inside
    collect.retry, under the frame.collect, beside its match spans."""
    from linemod_tpu_torch.pipeline.pose_detection import resolve_prefilter_packed

    det, color, depth = fixture

    class Owner:
        state = exact_state = det.state
        upload = staticmethod(det.upload)
        retries = 0

    top_k = det.state.cfg.top_k
    packed = np.zeros((top_k + 1, 5), np.float32)
    color_c, depth_c = det.recenter(color), det.recenter(depth)
    RECORDER.take()
    with recording():
        with frame_span("frame.collect", 7):
            with span("collect.copy"):
                pass
            out = resolve_prefilter_packed(packed, Owner, color_c, depth_c)
    spans = RECORDER.take()
    assert Owner.retries == 1 and out.shape == (top_k, 5)
    root = next(s for s in spans if s.name == "frame.collect")
    retry = next(s for s in spans if s.name == "collect.retry")
    assert root.frame == 7 and {s.frame for s in spans} == {7}
    assert _children(spans, root) == ["collect.copy", "collect.retry"]
    assert _children(spans, retry)[-1] == "collect.copy"
    assert "match.cut" in _children(spans, retry)
    from portbench.spans import outermost_copies

    assert [s.parent for s in outermost_copies(spans)] == [root.seq]


def test_span_list_is_bounded(monkeypatch):
    assert RECORDER.spans.maxlen == profiling.SPAN_CAPACITY
    monkeypatch.setattr(RECORDER, "spans", collections.deque(maxlen=16))
    with recording():
        for i in range(40):
            with span(f"s{i}"):
                pass
    kept = list(RECORDER.spans)
    assert [s.name for s in kept] == [f"s{i}" for i in range(24, 40)]
    assert all(s.parent is None and s.frame is None for s in kept)


def test_profiler_session_turns_recording_on():
    """Spans record inside a torch.profiler session and not after it, and
    lie on the profiler's clock (its records are stamped in time.time_ns's
    epoch ns)."""
    from torch.profiler import ProfilerActivity, profile

    RECORDER.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert RECORDER.on()
        with frame_span("frame.submit") as frame:
            with span("match.cut"):
                with torch.profiler.record_function("marker"):
                    torch.ones(8).sum()
    assert not RECORDER.on()
    with span("match.cut"):
        pass
    spans = RECORDER.take()
    assert [s.name for s in spans] == ["match.cut", "frame.submit"]
    assert frame is not None and {s.frame for s in spans} == {frame}
    marker = next(e for e in prof.events() if e.name == "marker")
    start_ns = prof.profiler.kineto_results.trace_start_ns() + marker.time_range.start * 1e3
    cut = spans[0]
    assert cut.start_ns - 5e6 <= start_ns <= cut.end_ns + 5e6


def test_stage_timer_folds_spans():
    timer = profiling.StageTimer(sync=False)
    with recording():
        for _ in range(3):
            with frame_span("frame.submit"):
                with span("match.cut"):
                    pass
    timer.add_spans(RECORDER.take())
    assert timer.counts == {"frame.submit": 3, "match.cut": 3}
    assert timer.totals["frame.submit"] >= timer.totals["match.cut"] >= 0.0
    assert [line.split()[0] for line in timer.summary().splitlines()] == ["frame.submit", "match.cut"]
