"""The program spans put on a CUDA trace's clock (stcbench/spans.py), on a
hand-made Chrome trace: the anchor offset is recovered, launch calls are
counted per span (a call in nested spans once, in the outer span), the
three idle numbers add up to the trace's idle time, and every reader
returns None without the program's spans; then a tiny traced cell on the
CPU through spans.traced_cell."""

import json
import time

import pytest
import torch

from stcbench import harness, spans
from stcbench.tests import tiny

OFF = 5000.0                      # trace us = perf_counter_ns / 1e3 + OFF
JITTER = [0.0, 2.0, -1.0]         # the syncs' own delay after each anchor
PROFILED = (1, 4)                 # units 1-3 of five
T = 1000                          # a unit's length, us


def program_spans():
    """Five 1-frame chunks, full and cached in turn; times in ns.  In unit
    u (base u * T us): chunk 0-800, vision 50-400 with the pruner 300-380
    inside, append 450-750."""
    out = []
    for u in range(5):
        b = u * T
        c = len(out)
        path = "vision.full" if u % 2 == 0 else "vision.cached"
        for name, s, e, parent in (("chunk", 0, 800, -1), (path, 50, 400, c),
                                   ("pruner", 300, 380, c + 1),
                                   ("append", 450, 750, c)):
            out.append((name, (b + s) * 1000, (b + e) * 1000, parent, u))
    return out


def trace_events():
    """Per profiled unit: launches in vision (one in the nested pruner), in
    append (a stream_attention kernel's among them), one in the chunk
    outside both and an event record (no launch); kernels leave idle gaps
    in each part; the chunk's synchronize."""
    ev = []
    corr = 0

    def host(name, ts, dur=2.0, c=None):
        ev.append(dict(ph="X", cat="cuda_runtime", name=name, ts=ts + OFF,
                       dur=dur, args={} if c is None else
                       dict(correlation=c)))

    def kernel(name, ts, dur, c):
        ev.append(dict(ph="X", cat="kernel", name=name, ts=ts + OFF,
                       dur=dur, args=dict(correlation=c)))

    for i, u in enumerate(range(*PROFILED)):
        b = u * T
        for ts in (60, 320):                      # vision (one in pruner)
            corr += 1
            host("cudaLaunchKernel", b + ts, c=corr)
            kernel("gemm(A)", b + ts + 10, 100, corr)
        corr += 1
        host("cudaMemsetAsync", b + 460, c=corr)
        kernel("memset", b + 470, 10, corr)
        ev[-1]["cat"] = "gpu_memset"
        corr += 1
        host("cuLaunchKernel", b + 500, c=corr)
        kernel("void stc::stream_attention_tc<128, false>(A)", b + 520, 150,
               corr)
        host("cudaEventRecord", b + 700)
        corr += 1
        host("cudaLaunchKernel", b + 780, c=corr)  # chunk, outside both
        kernel("elementwise(B)", b + 785, 5, corr)
        host(spans.SYNC_CALL, b + 795 + JITTER[i], dur=5.0)
    return ev


@pytest.fixture
def rec(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=trace_events())))
    prof = harness.read_trace(path)
    prof.update(spans.read_events(path))
    anchors = [(u * T + 795) * 1000 for u in range(*PROFILED)]
    return dict(kind="ingest", units=5, profiled=PROFILED,
                lat=[0.001] * 5, spans={}, profile=prof,
                program_spans=program_spans(), span_anchors=anchors)


def test_anchor_offset_is_recovered(rec):
    off, spread = spans.align(rec)
    assert off == pytest.approx(OFF)
    assert spread == pytest.approx(max(JITTER) - min(JITTER))
    # a synchronize of the profiler's own, before or after the chunks'
    rt = rec["profile"]["runtime"]
    for ts in (rt[0][1] - 50.0, rt[-1][1] + 85.0):
        rec["profile"]["runtime"] = sorted(
            rt + [(spans.SYNC_CALL, ts, 4.0, None)], key=lambda e: e[1])
        assert spans.align(rec) == (pytest.approx(OFF), pytest.approx(
            spread))
    rec["profile"]["runtime"] = [e for e in rt if e[0] != spans.SYNC_CALL]
    assert spans.align(rec) is None              # nothing to pair with
    assert spans.READERS["launches_per_frame.vision"](rec) is None


def test_launches_per_span(rec):
    r = spans.READERS
    # two launch calls in vision, the pruner's counted once
    assert r["launches_per_frame.vision"](rec) == 2
    # a memset and a cuLaunchKernel in append; an event record is no launch
    assert r["launches_per_frame.append"](rec) == 2
    got = spans.readings(rec)
    assert got["stream_attention_in_append"] == [3, 3]
    # per frame that ran the span: unit 2 ran the full path, 1 and 3 the
    # cacher's; the chunk span holds all five launches
    assert got["launches_by_span"] == {
        "chunk": 5, "vision.full": 2, "vision.cached": 2, "pruner": 1,
        "append": 2}
    assert got["anchors"] == got["syncs"] == 3


def test_idle_split_adds_up_to_the_trace_idle(rec):
    """Each part against a count on a 1 us grid (every edge lies on one),
    and the three together against harness.read_trace's idle time."""
    prof = rec["profile"]
    ev = prof["device"] + prof["runtime"]
    a = min(ts for _, ts, _, _ in ev)
    b = max(ts + d for _, ts, d, _ in ev)
    busy = [(ts, ts + d) for _, ts, d, _ in prof["device"]]
    vis, app = [], []
    for name, t0, t1, _, u in rec["program_spans"]:
        if PROFILED[0] <= u < PROFILED[1]:
            iv = (t0 / 1e3 + OFF, t1 / 1e3 + OFF)
            if name.startswith("vision."):
                vis.append(iv)
            elif name == "append":
                app.append(iv)
    want = dict(vision=0, append=0, rest=0)
    for t in range(int(a), int(b)):
        m = t + 0.5
        if any(s <= m < e for s, e in busy):
            continue
        part = "vision" if any(s <= m < e for s, e in vis) else \
            "append" if any(s <= m < e for s, e in app) else "rest"
        want[part] += 1
    frames = PROFILED[1] - PROFILED[0]
    got = {p: spans.READERS[f"idle_ms_per_frame.{p}"](rec)
           for p in want}
    for p in want:
        assert got[p] * 1e3 * frames == pytest.approx(want[p]), p
    idle_us = (prof["window_s"] - prof["busy_s"]) * 1e6
    assert sum(got.values()) * 1e3 * frames == pytest.approx(idle_us)
    close = spans.readings(rec)["idle_closure_ms"]
    assert close["split"] == pytest.approx(close["harness"])


def test_host_clock_readers_read_the_unprofiled_chunks(rec):
    r = spans.READERS
    # units 0 and 4 are unprofiled, both on the full path
    assert r["vision_full_ms_per_frame"](rec) == pytest.approx(0.35)
    assert r["vision_cached_ms_per_frame"](rec) is None
    assert r["pruner_ms_per_frame"](rec) == pytest.approx(0.08)
    rec["profiled"] = (3, 4)
    assert r["vision_cached_ms_per_frame"](rec) == pytest.approx(0.35)


def test_longest_gap_is_put_in_its_span(rec):
    """The 280 us from one profiled chunk's last kernel to the next's first
    lie between chunks; the 160 us between the vision kernels lie in the
    vision span (the pruner holds half of them, not most)."""
    gaps = spans.readings(rec)["longest_gaps"]
    assert gaps[:3] == [["between chunks", pytest.approx(0.28)]] * 2 + [
        ["vision.cached (unit 1)", pytest.approx(0.16)]]


@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_reader_is_none_without_program_spans(rec, name):
    del rec["program_spans"]
    assert spans.READERS[name](rec) is None
    rec["program_spans"] = []
    assert spans.READERS[name](rec) is None


def test_traced_cell_keeps_the_spans():
    """A tiny traced cell on the CPU: the port's spans come back, one chunk
    span a unit, and the host-clock readers read them; with no CUDA trace
    there is no clock, so the trace readers give nothing; the harness's
    own metrics are all there."""
    spec = tiny.spec()
    torch.manual_seed(0)
    r = spans.traced_cell(spec, 2 ** 31 + 4242, 3.0, "cpu",
                          time.perf_counter())
    assert r["correct"] is True
    got = r["spans"]["metrics"]
    assert {"vision_full_ms_per_frame", "vision_cached_ms_per_frame",
            "pruner_ms_per_frame"} == set(got)
    assert all(v > 0 for v in got.values())
    assert {"vision_ms_per_frame", "append_ms_per_frame"} <= set(
        r["metrics"])
    host = r["spans"]["readings"]["host_ms"]
    assert host["chunk"] > host["append"] > 0
    off = spans.traced_cell(spec, 2 ** 31 + 4242, 1.0, "cpu",
                            time.perf_counter(), port_tracing=False)
    assert off["spans"]["metrics"] == {}
