"""What the per-layer readers share: the window's units outside the
profiled sub-window, and an op's share of its roofline."""

from __future__ import annotations


def outside(rec) -> list:
    """Indices of the window's units the profiler did not cover."""
    a, b = rec.get("profiled") or (0, 0)
    return [i for i in range(rec["units"]) if not a <= i < b]


def inside(rec) -> list:
    a, b = rec.get("profiled") or (0, 0)
    return list(range(a, min(b, rec["units"])))


def per_frame_ms(rec, span: str):
    """A span's seconds per frame, over the unprofiled chunks, in ms."""
    xs = rec["spans"].get(span) or []
    if rec["kind"] != "ingest" or len(xs) != rec["units"]:
        return None
    idx = outside(rec)
    return sum(xs[i] for i in idx) / len(idx) * 1e3 if idx else None


def roofline(rec, op: str):
    """Sum of the profiled calls' least times of op `op` over the device
    time of its kernels (the LM's ``Op``), in %.  The port's launch
    counter has to match the calls the harness expects; the profiler may
    drop a few of the trace's records, so the device time is scaled to all
    the calls when it holds at least 98% of them, and None is returned
    otherwise."""
    from stcbench.harness import op_time
    prof = rec.get("profile")
    launches = (rec.get("launches") or {}).get(op)
    kern = (rec.get("op_kernels") or {}).get(op)
    if not prof or not prof["kernels"] or launches is None or kern is None:
        return None
    calls = [c for i in inside(rec) for c in rec["items"][i]["ops"].get(
        op, [])]
    seconds, n = op_time(prof["kernels"], kern.words, kern.main)
    if not calls or seconds <= 0 or launches != len(calls) or \
            abs(n - len(calls)) > 0.02 * len(calls):
        return None
    return sum(c.least_s() for c in calls) / (seconds * len(calls) / n) \
        * 100.0


def idle_share(rec, kind: str):
    prof = rec.get("profile")
    if rec["kind"] != kind or not prof or prof["window_s"] <= 0 or \
            not prof["kernels"]:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0


def mfu(rec, kind: str):
    """The least time of the unprofiled units over the time they took."""
    if rec["kind"] != kind:
        return None
    idx = outside(rec)
    took = sum(rec["lat"][i] for i in idx)
    if not idx or took <= 0:
        return None
    return sum(rec["items"][i]["least_s"] for i in idx) / took * 100.0
