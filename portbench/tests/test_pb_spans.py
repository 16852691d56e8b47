"""portbench/spans.py on synthetic device operations and spans: the clocks'
offset and rate recovered from the copy anchors, planted idle gaps put down
to the submission or the collection, and None where the anchors disagree."""

import types
from typing import NamedTuple

import pytest

from portbench import harness, spans

BASE_NS = 1_792_000_000_000_000_000  # an epoch time in ns, as time.time_ns() gives
OFFSET_US = 123_456.75
FRAME_US = 1000.0
COPY = "Memcpy DtoH (Device -> Pageable)"


class Span(NamedTuple):
    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    frame: int | None


def synthetic(frames=4, copy_lag_us=(2.0,), first_frame=1, rate=1.0):
    """Frame k's device work at k * FRAME_US: a 100 us kernel, then its 10 us
    copy; the host submits it from 50 us before to 20 us after its start and
    collects it from there until 300 us after its start, the copy span
    ending copy_lag_us after the copy (cycled). The host's clock reads
    BASE_NS + (rate * trace time + OFFSET_US)."""

    def ns(trace_us: float) -> int:
        return BASE_NS + round((rate * trace_us + OFFSET_US) * 1e3)

    ops, recorded, seq = [], [], 0
    for k in range(frames):
        t = k * FRAME_US
        ops += [("kernel", t, 100.0), (COPY, t + 100.0, 10.0)]
        frame = first_frame + k
        lag = copy_lag_us[k % len(copy_lag_us)]
        sub, col, cp = seq + 1, seq + 2, seq + 3
        recorded += [
            Span(sub, "frame.submit", ns(t - 50), ns(t + 20), None, frame),
            Span(sub + 10_000, "match.quantize", ns(t - 40), ns(t - 30), sub, frame),
            Span(col, "frame.collect", ns(t + 20), ns(t + 300), None, frame),
            Span(cp, "collect.copy", ns(t + 30), ns(t + 110) + round(lag * 1e3), col, frame),
        ]
        seq += 3
    return ops, recorded


def _run(ops, frames, steady):
    return types.SimpleNamespace(trace=harness.Trace(frames=frames, ops=ops, steady=steady))


@pytest.mark.parametrize("rate", [1.0, 1 - 1.259e-3, 1 + 15.126e-3])  # the drifts seen on the H100
def test_known_offset_and_rate_are_recovered(rate):
    ops, recorded = synthetic(frames=8, copy_lag_us=(2.0,), rate=rate)
    al = spans.align(ops, recorded)
    # base: the first copy span's end (copy end 110 us, lag 2 us)
    assert al["base_ns"] == recorded[3].end_ns and al["rate"] == pytest.approx(rate, abs=1e-6)
    assert max(abs(r) for r in al["residuals_us"]) < 1e-3
    # a span's time on the trace's clock: its planted time, less the lag
    assert spans.to_trace(al, recorded[0].start_ns) == pytest.approx(-50.0 - 2.0 / rate, abs=1e-3)
    assert spans.to_trace(al, recorded[-4].start_ns) == pytest.approx(7 * FRAME_US - 50.0 - 2.0 / rate, abs=1e-3)


def test_jittered_lags_leave_their_residuals():
    ops, recorded = synthetic(frames=8, copy_lag_us=(1.0, 2.0, 3.0, 2.0))
    al = spans.align(ops, recorded)
    assert al["rate"] == pytest.approx(1.0, abs=1e-3)
    assert sorted(round(r) for r in al["residuals_us"]) == [-1, -1, 0, 0, 0, 0, 1, 1]


@pytest.mark.parametrize("rate", [1.0, 1 + 15.126e-3])
def test_planted_idle_gap_is_put_down_to_submit_and_collect(monkeypatch, rate):
    ops, recorded = synthetic(copy_lag_us=(0.0,), rate=rate)
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    run = _run(ops, 4, ops[2:6])  # frames 1 and 2: one gap, from 110 us after frame 1 to frame 2
    # the gap is 890 us; frame 2's submission covers its last 50 us, frame
    # 1's collection its first 190 us; two steady frames
    assert spans.idle_ms(run, "frame.submit") == pytest.approx(0.050 / 2, abs=1e-6)
    assert spans.idle_ms(run, "frame.collect") == pytest.approx(0.190 / 2, abs=1e-6)
    assert spans.per_frame_ms(run, "collect.copy", outermost=True) == pytest.approx(0.080 * rate, abs=1e-6)
    assert spans.per_frame_ms(run, "match.quantize") == pytest.approx(0.010 * rate, abs=1e-6)


def test_count_mismatch_and_large_residual_give_none(monkeypatch):
    ops, recorded = synthetic()
    assert spans.align(ops[:-1], recorded) is None
    assert spans.align(ops, recorded[:-1]) is None
    assert spans.align(ops[:2], recorded[:4]) is None  # one anchor fixes no line
    # copy spans ending 2 ms late, then 2 ms early: a line through them is
    # farther than 0.5 ms from some anchor whichever quarter is left out
    lags = [0.0, 0.0, 2000.0, -2000.0] * 2
    assert spans.align(synthetic(frames=8)[0], synthetic(frames=8, copy_lag_us=lags)[1]) is None


@pytest.mark.parametrize("late", [[4], [1, 6]])
def test_late_anchors_are_left_out_up_to_a_quarter(late):
    """Copy spans that end 2 ms late (the host descheduled after the copy)
    are left out of the line, up to a quarter of the anchors; the others
    fix it exactly."""
    ops = synthetic(frames=8)[0]
    lags = [2.0] * 8
    for k in late:
        lags[k] = 2000.0
    al = spans.align(ops, synthetic(frames=8, copy_lag_us=lags)[1])
    assert al["dropped"] == len(late) and al["rate"] == pytest.approx(1.0, abs=1e-9)
    assert max(abs(r) for r in al["residuals_us"]) < 1e-3
    lags[3] = lags[7] = 2000.0  # three or four late: more than a quarter of eight
    assert spans.align(ops, synthetic(frames=8, copy_lag_us=lags)[1]) is None


def test_traced_takes_the_last_frames_and_needs_enough(monkeypatch):
    _, older = synthetic(first_frame=1)
    ops, newer = synthetic(first_frame=5)
    both = older + newer
    assert {s.frame for s in spans.traced(_run(ops, 4, ops), both)} == {5, 6, 7, 8}
    assert spans.traced(_run(ops, 9, ops), both) is None
    assert spans.traced(types.SimpleNamespace(trace=None), both) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)  # a program without the recorder
    assert spans.per_frame_ms(_run(ops, 4, ops), "match.quantize") is None


def test_idle_gaps_and_overlap():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0), ("d", 50.0, 1.0)]
    gaps = spans.idle_gaps(ops)
    assert gaps == [(15.0, 30.0), (35.0, 50.0)]
    assert spans.overlap_us(gaps, [(0.0, 20.0), (25.0, 40.0), (45.0, 60.0)]) == pytest.approx(5 + 5 + 5 + 5)
