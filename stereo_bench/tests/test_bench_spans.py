"""The span metrics' readers (`metrics/*.py` over `span_trace.reduce_spans`)
on hand-made records and event lists: each reads its known value, or None
where the spans are missing; host launch calls are put down to the right
span; an idle gap is split at an `eval_step` boundary."""

import pytest

from stereo_bench.cell import metric_reader
from stereo_bench.span_trace import SPAN_METRICS, reduce_spans


def _span(id, name, parent, root, at, stream_ms, **attrs):
    return {"name": name, "attrs": attrs, "id": id, "parent": parent, "root": root, "host_ns": [0, 0],
            "stream_ms": stream_ms, "launches": {}, "trace_us": list(at), "record_us": list(at), "anchor_us": None}


def _tick(first, t0, ms):
    """An eval step from trace time t0 (us) to t0 + 70: matching, cost,
    context, two gru iterations and the decode, 8 us each from t0 + 5, 10 us
    apart, stream ms from `ms`."""
    names = ["matching", "cost", "context", "gru", "gru", "decode"]
    out = [_span(first, "eval_step", None, first, (t0, t0 + 70), sum(ms))]
    for k, (name, m) in enumerate(zip(names, ms)):
        attrs = {"i": k - 3} if name == "gru" else {}
        out.append(_span(first + 1 + k, name, first, first, (t0 + 5 + 10 * k, t0 + 13 + 10 * k), m, **attrs))
    return out


RECORDS = _tick(0, 0.0, [3.0, 5.0, 2.0, 4.0, 6.0, 1.0]) + _tick(7, 100.0, [5.0, 7.0, 4.0, 6.0, 8.0, 3.0])
# launch calls: 2 in each tick's first gru, 1 in its second, 1 in its matching,
# 1 between its stages (in the step alone) and 1 between the ticks (in no span)
LAUNCHES = [t + d for t in (0.0, 100.0) for d in (6.0, 14.0, 36.0, 37.0, 46.0)] + [80.0]
HOST = ([(t, t + 0.2, "cudaLaunchKernel") for t in LAUNCHES[:-1]] + [(80.0, 80.5, "cudaMemcpyAsync")]
        + [(t, t + 0.1, "cudaEventRecord") for t in (1.0, 2.0)] + [(90.0, 95.0, "cudaStreamSynchronize")])
# device activity [0, 20], [50, 60] and [130, 140]: the gap 20-50 lies in the
# first step, the gap 60-130 leaves it at 70 and enters the second step at 100
DEVICE = [(0.0, 20.0, "k"), (50.0, 55.0, "k"), (52.0, 60.0, "k"), (130.0, 140.0, "Memcpy DtoH")]


def _run(spans):
    return {"record": {"spans": spans} if spans is not None else {}}


@pytest.fixture(scope="module")
def reduced():
    return reduce_spans(RECORDS, sorted(HOST), sorted(DEVICE))


def test_launch_calls_fall_to_the_innermost_span_they_start_in(reduced):
    calls = {(r["id"], r["name"]): r["launch_calls"] for r in reduced["spans"]}
    assert calls[(0, "eval_step")] == calls[(7, "eval_step")] == 5
    assert calls[(1, "matching")] == 1 and calls[(2, "cost")] == 0
    assert [calls[(4, "gru")], calls[(5, "gru")]] == [2, 1]
    assert reduced["launch_calls"] == {"in_spans": 10, "outside": 1}
    assert reduced["device_ops"] == 4 and reduced["anchor_gap_us"] is None


def test_anchored_boundaries_decide_where_a_call_falls():
    records = [dict(r) for r in RECORDS[:7]]
    # gru 0's stamps lie at 35 and 43 on the trace's clock, its own calls at 34 and 43
    records[4] = dict(records[4], anchor_us=[34.0, 43.0])
    reduced = reduce_spans(records, sorted(HOST), sorted(DEVICE))
    assert [r["launch_calls"] for r in reduced["spans"] if r["name"] == "gru"] == [2, 1]
    assert reduced["anchor_gap_us"] == 1.0
    records[4]["anchor_us"] = [36.5, 43.0]  # the first call now starts before the span
    reduced = reduce_spans(records, sorted(HOST), sorted(DEVICE))
    assert [r["launch_calls"] for r in reduced["spans"] if r["name"] == "gru"] == [1, 1]


def test_an_idle_gap_is_split_at_an_eval_step_boundary(reduced):
    assert reduced["idle_ms"] == pytest.approx({"eval_step": (30 + 10 + 30) / 1e3, "outside": 30 / 1e3})
    assert reduced["idle_gaps"] == [["decode", pytest.approx(0.07)], ["cost", pytest.approx(0.03)]]


def test_each_span_metric_reads_its_known_value(reduced):
    want = {"matching_ms.eval": 4.0, "cost_ms.eval": 6.0, "context_ms.eval": 3.0, "gru_span_ms.eval": 12.0,
            "decode_span_ms.eval": 2.0, "gru_launches_per_iter.eval": 1.5, "step_idle_ms.eval": 0.035}
    assert sorted(want) == sorted(m["name"] for m in SPAN_METRICS)
    for name, value in want.items():
        assert metric_reader(name)(_run(reduced)) == pytest.approx(value), name


@pytest.mark.parametrize("name", sorted(m["name"] for m in SPAN_METRICS))
def test_each_span_metric_reads_none_without_spans(name, reduced):
    read = metric_reader(name)
    assert read(_run(None)) is None
    assert read(_run(dict(reduced, spans=[]))) is None
