"""The port's own spans (``stc_tpu_torch.utils.metrics``: ``chunk``,
``vision.full`` / ``vision.cached``, ``pruner``, ``append``) in a traced
run of a cell, put on the CUDA trace's clock, and the per-layer numbers
they give.

    python3 stcbench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--port-tracing 0|1]

runs the cell as ``run.py --trace 1`` does, with the port's span
recorder on for the window (``--port-tracing 0`` leaves it off: the
tracing's cost is the difference), and prints the harness's result line
with a ``spans`` object added.  The harness is used as it is: this
module subclasses its ``Run`` and ``Profile`` and wraps its ``sync`` in
this process only, to keep what the readers below need in the run record
(``rec``):

- ``program_spans``: the port's spans of the window, ``(name, start_ns,
  end_ns, parent, chunk)`` on ``time.perf_counter_ns``;
- ``span_anchors``: in each profiled chunk, ``perf_counter_ns`` read just
  before the synchronize that ends the chunk;
- ``profile["runtime"]`` / ``profile["device"]``: the trace's CUDA API
  calls and its kernels, copies and memsets, each ``(name, ts, dur,
  correlation)`` in the trace's microseconds.

Each anchor is paired, in order, with its chunk's ``cudaDeviceSynchronize``
in the trace; the median of the differences moves the spans onto the
trace's clock, and their range is ``span_clock_spread_us``.  The readers
(``READERS``, one a per-layer metric, each returning None where the
record lacks what it reads) are written to be the bodies of
``metrics/<name>.py`` files once the harness keeps these fields itself.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time

# the CUDA API calls that put work on the card
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaGraphLaunch"})
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALL = "cudaDeviceSynchronize"
VISION = ("vision.full", "vision.cached")


# ------------------------------------------------------------ the trace --
def read_events(path) -> dict:
    """The Chrome trace's CUDA API calls and device activity, each
    sorted by start: (name, ts, dur, correlation), times in us; and the
    trace's scalar top-level fields (its time base among them)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    host, dev = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        row = (ev.get("name", ""), float(ev["ts"]), float(ev["dur"]),
               (ev.get("args") or {}).get("correlation"))
        if cat in DEVICE_CATS:
            dev.append(row)
        elif cat in HOST_CATS:
            host.append(row)
    host.sort(key=lambda e: e[1])
    dev.sort(key=lambda e: e[1])
    meta = {k: v for k, v in trace.items()
            if isinstance(v, (int, float, str))}
    return dict(runtime=host, device=dev, trace_meta=meta)


def merge(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(prof) -> list:
    """The idle intervals of the window, where no kernel, copy or memset
    runs; the window runs from the first event to the last, runtime calls
    included, as harness.read_trace's does."""
    host, dev = prof["runtime"], prof["device"]
    a = min([dev[0][1]] + [h[1] for h in host[:1]])
    b = max(max(ts + dur for _, ts, dur, _ in dev),
            max((ts + dur for _, ts, dur, _ in host), default=0.0))
    busy = merge((ts, ts + dur) for _, ts, dur, _ in dev)
    edges = [a] + [x for s, e in busy for x in (s, e)] + [b]
    return [[s, e] for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def covered(spans, ts: float) -> bool:
    """Whether ts lies in one of the merged intervals `spans`."""
    i = bisect.bisect_right(spans, [ts, float("inf")]) - 1
    return i >= 0 and ts <= spans[i][1]


# -------------------------------------------------------------- the clock --
def align(rec):
    """(offset_us, spread_us): trace time = perf_counter_ns / 1e3 + offset,
    from each profiled chunk's anchor and its cudaDeviceSynchronize; None
    without a trace or with fewer synchronizes than anchors.  The trace
    may hold synchronizes of its own (the profiler's at its stop): each
    anchor takes the synchronize nearest to it under a trial offset, one
    trial for each way of pairing the first anchor, and the pairing whose
    offsets spread least is kept."""
    prof, anchors = rec.get("profile"), rec.get("span_anchors")
    if not prof or not anchors or "runtime" not in prof:
        return None
    syncs = [ts for name, ts, _, _ in prof["runtime"] if name == SYNC_CALL]
    if len(syncs) < len(anchors):
        return None
    best = None
    for first in syncs[:len(syncs) - len(anchors) + 1]:
        trial = first - anchors[0] / 1e3
        offs = []
        for a in anchors:
            t = a / 1e3 + trial
            i = bisect.bisect_left(syncs, t)
            near = min(syncs[max(i - 1, 0):i + 1], key=lambda s: abs(s - t))
            offs.append(near - a / 1e3)
        got = (statistics.median(offs), max(offs) - min(offs))
        if best is None or got[1] < best[1]:
            best = got
    return best


def units(rec) -> list:
    """Each program span's window unit: the i-th outermost ``chunk`` span
    opens unit i, and a span inside one belongs to its unit (-1 outside
    any)."""
    out = []
    n = -1
    for name, _, _, parent, _ in rec["program_spans"]:
        if parent >= 0:
            out.append(out[parent])
        elif name == "chunk":
            n += 1
            out.append(n)
        else:
            out.append(-1)
    return out


def _have(rec) -> bool:
    return rec.get("kind") == "ingest" and bool(rec.get("program_spans"))


def _profiled(rec) -> range:
    a, b = rec.get("profiled") or (0, 0)
    return range(a, min(b, rec["units"]))


def on_trace(rec, names, where) -> list:
    """The merged trace-time intervals of the spans named `names` in the
    units `where`; None when the spans cannot be put on the trace's
    clock."""
    clock = align(rec)
    if clock is None:
        return None
    off = clock[0]
    where = set(where)
    return merge((t0 / 1e3 + off, t1 / 1e3 + off)
                 for (name, t0, t1, _, _), u in zip(rec["program_spans"],
                                                    units(rec))
                 if name in names and u in where)


# ------------------------------------------------------------ the readers --
def span_ms_per_frame(rec, names):
    """The host-clock time of the spans named `names` per frame that ran
    them, over the window's unprofiled 1-frame chunks, in ms."""
    if not _have(rec):
        return None
    skip = set(_profiled(rec))
    total, frames = 0.0, set()
    for (name, t0, t1, _, _), u in zip(rec["program_spans"], units(rec)):
        if name in names and u >= 0 and u not in skip:
            total += (t1 - t0) / 1e6
            frames.add(u)
    return total / len(frames) if frames else None


def launches_per_frame(rec, names, per_run: bool = False):
    """The CUDA API calls that put work on the card (LAUNCH_CALLS)
    starting inside the spans named `names`, per profiled frame (per_run:
    per profiled frame that ran such a span): a call in nested spans
    counts once."""
    if not _have(rec):
        return None
    where = _profiled(rec)
    spans = on_trace(rec, names, where)
    if not spans or not where:
        return None
    if per_run:
        where = {u for (name, *_), u in zip(rec["program_spans"],
                                             units(rec))
                 if name in names and u in where}
    n = sum(name in LAUNCH_CALLS and covered(spans, ts)
            for name, ts, _, _ in rec["profile"]["runtime"])
    return n / len(where)


def idle_ms_per_frame(rec, part: str):
    """Device idle time per profiled frame, in ms, inside the vision spans
    (``vision``), inside the append spans (``append``), or elsewhere in the
    profiled window (``rest``: in chunks outside both, and between
    chunks)."""
    if not _have(rec) or not (rec.get("profile") or {}).get("device"):
        return None
    where = _profiled(rec)
    names = dict(vision=VISION, append=("append",),
                 rest=VISION + ("append",))[part]
    spans = on_trace(rec, names, where)
    if spans is None or not where:
        return None
    gaps = idle(rec["profile"])
    inside = overlap(gaps, spans)
    if part == "rest":
        inside = sum(e - s for s, e in gaps) - inside
    return inside / 1e3 / len(where)


READERS = {
    "vision_full_ms_per_frame": lambda r: span_ms_per_frame(
        r, ("vision.full",)),
    "vision_cached_ms_per_frame": lambda r: span_ms_per_frame(
        r, ("vision.cached",)),
    "pruner_ms_per_frame": lambda r: span_ms_per_frame(r, ("pruner",)),
    "launches_per_frame.vision": lambda r: launches_per_frame(r, VISION),
    "launches_per_frame.append": lambda r: launches_per_frame(
        r, ("append",)),
    "idle_ms_per_frame.vision": lambda r: idle_ms_per_frame(r, "vision"),
    "idle_ms_per_frame.append": lambda r: idle_ms_per_frame(r, "append"),
    "idle_ms_per_frame.rest": lambda r: idle_ms_per_frame(r, "rest"),
}


# ------------------------------------------------- what a run is read for --
def readings(rec) -> dict:
    """The checks of the spans against the trace, and what they show:
    the clock's spread, the share of the profiled stream_attention launches
    inside append spans, each span's launches per frame that ran it, the
    idle split against the harness's idle time, the longest idle gaps and
    the span that holds each, and the host-clock time of each unprofiled
    chunk and its parts."""
    out = {}
    prof = rec.get("profile") or {}
    clock = align(rec)
    out["anchors"] = len(rec.get("span_anchors") or [])
    out["syncs"] = sum(name == SYNC_CALL
                       for name, _, _, _ in prof.get("runtime", []))
    if clock is not None:
        out["span_clock_offset_us"], out["span_clock_spread_us"] = clock
    where = _profiled(rec)
    if clock is not None and prof.get("device"):
        appends = on_trace(rec, ("append",), where)
        sa = {c for name, _, _, c in prof["device"]
              if "stream_attention" in name and c is not None}
        calls = [ts for _, ts, _, c in prof["runtime"] if c in sa]
        out["stream_attention_in_append"] = [
            sum(covered(appends, ts) for ts in calls), len(calls)]
        out["launches_by_span"] = {
            n: launches_per_frame(rec, (n,), per_run=True)
            for n in sorted({s[0] for s in rec["program_spans"]})}
        gaps = idle(prof)
        parts = [READERS[f"idle_ms_per_frame.{p}"](rec)
                 for p in ("vision", "append", "rest")]
        if None not in parts:
            out["idle_closure_ms"] = dict(
                split=sum(parts) * len(where),
                harness=(prof["window_s"] - prof["busy_s"]) * 1e3,
                window=prof["window_s"] * 1e3)
        out["longest_gaps"] = [[holder(rec, clock[0], s, e), (e - s) / 1e3]
                               for s, e in sorted(
                                   gaps, key=lambda g: g[0] - g[1])[:10]]
    out["host_ms"] = host_parts(rec)
    return out


def holder(rec, off: float, s: float, e: float) -> str:
    """The innermost program span that covers most of the interval
    [s, e] (trace us), with its unit; 'between chunks' where none does."""
    best, depth, unit = "between chunks", -1, None
    for (name, t0, t1, parent, _), u in zip(rec["program_spans"],
                                            units(rec)):
        a, b = t0 / 1e3 + off, t1 / 1e3 + off
        if min(b, e) - max(a, s) > (e - s) / 2:
            d = 0
            while parent >= 0:
                d, parent = d + 1, rec["program_spans"][parent][3]
            if d > depth:
                best, depth, unit = name, d, u
    return best if unit is None else f"{best} (unit {unit})"


def host_parts(rec) -> dict:
    """Host-clock ms a frame over the unprofiled units: each span name's
    time per unit that ran it, the chunk's latency as the harness timed it
    before and after the profiled units, and the harness's own CUDA-event
    spans."""
    if not _have(rec):
        return {}
    a, b = rec.get("profiled") or (0, 0)
    lat = rec["lat"]
    names = sorted({s[0] for s in rec["program_spans"]})
    out = {n: span_ms_per_frame(rec, (n,)) for n in names}
    before, after = lat[:a], lat[b:]
    if before:
        out["lat_before_profiled"] = statistics.mean(before) * 1e3
    if after:
        out["lat_after_profiled"] = statistics.mean(after) * 1e3
    for name, xs in rec.get("spans", {}).items():
        if len(xs) == rec["units"]:
            idx = [i for i in range(rec["units"]) if not a <= i < b]
            out["harness." + name] = sum(xs[i] for i in idx) / len(idx) * 1e3
    return out


# ----------------------------------------------------------------- the run --
def traced_cell(spec, seed: int, seconds: float, device, t_start: float,
                port_tracing: bool = True, keep=None) -> dict:
    """harness.run_cell with trace on, keeping the fields above in the run
    record; the result line gains ``spans``: the readers' values and
    ``readings``.  keep: a path to write those fields of the record to
    (gzipped JSON), with the clocks read side by side."""
    import torch
    from stc_tpu_torch.utils import metrics
    from stcbench import harness

    anchors = []
    state = dict(on=False, run=None)

    def sync(dev):
        if state["on"]:
            anchors.append(time.perf_counter_ns())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    class SpanProfile(harness.Profile):
        def __enter__(self):
            out = super().__enter__()
            state["on"] = True
            return out

        def __exit__(self, *exc):
            state["on"] = False
            self.prof.stop()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                self.data = harness.read_trace(path)
                self.data.update(read_events(path))
            finally:
                os.unlink(path)
            return False

    class SpanRun(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            state["run"] = self

        def window(self):
            metrics.take_spans()
            metrics.tracing(port_tracing)
            try:
                super().window()
            finally:
                metrics.tracing(False)
            self.rec["program_spans"] = metrics.take_spans()
            self.rec["span_anchors"] = list(anchors)

    saved = harness.sync, harness.Profile, harness.Run
    harness.sync, harness.Profile, harness.Run = sync, SpanProfile, SpanRun
    try:
        result = harness.run_cell(spec, seed, seconds, True, device, t_start)
    finally:
        harness.sync, harness.Profile, harness.Run = saved
    rec = state["run"].rec
    values = {}
    for name, read in READERS.items():
        v = read(rec)
        if v is not None:
            values[name] = v
    result["spans"] = dict(metrics=values, readings=readings(rec),
                           port_tracing=port_tracing)
    if keep:
        import gzip
        fields = ("kind", "units", "profiled", "lat", "spans",
                  "program_spans", "span_anchors", "profile")
        clocks = dict(perf_counter_ns=time.perf_counter_ns(),
                      monotonic_ns=time.monotonic_ns(),
                      time_ns=time.time_ns())
        with gzip.open(keep, "wt") as f:
            json.dump(dict({k: rec.get(k) for k in fields}, clocks=clocks),
                      f)
    return result


def main(argv, t_start: float) -> int:
    import argparse

    import torch
    from stcbench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--port-tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--keep", help="write the run record's spans, anchors "
                    "and trace events here (gzipped JSON)")
    args = ap.parse_args(argv)
    spec = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("stcbench: spans needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    # as run.py: one core for the process
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    result = traced_cell(spec, args.seed, args.seconds, "cuda", t_start,
                         bool(args.port_tracing), keep=args.keep)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    T_START = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main(sys.argv[1:], T_START))
