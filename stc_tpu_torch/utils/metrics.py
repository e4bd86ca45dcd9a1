"""Performance instrumentation for streaming sessions.

Per-frame latency percentiles, throughput and KV memory (``Timer``,
``StreamingStats``), the FLOPs of one call (``estimate_flops``), spans of
the ingest path on the host clock (``tracing``, ``span``, ``take_spans``)
and how each streaming append and vision tower call ran (``count_graph``,
``graph_counts``).

``Timer`` reads the host clock; on a CUDA device the caller passes a
``sync`` (``device_sync`` gives ``torch.cuda.synchronize`` for one), since
PyTorch returns before the card has finished.

``estimate_flops`` counts with ``torch.utils.flop_counter.FlopCounterMode``
over one call.  The hand-written kernels launch through ``ctypes``, where
the counter cannot see them, so each kernel's wrapper adds the products
of its plain version (a formula of the call's shapes, next to the wrapper)
to every count open while it launches (``add_kernel_flops``).  On a CPU
tensor the counter sees the plain version itself and the wrapper adds
nothing, so both devices count the same.

The span recorder is off until ``tracing(True)``; off, ``span`` returns
one shared object that does nothing, after one check of a module flag.
On, a span reads ``time.perf_counter_ns`` when it opens and when it
closes and keeps ``(name, start_ns, end_ns, parent, chunk)`` in a list in
memory: ``parent`` is the index of the span open around it (-1 for none),
``chunk`` the session's ``chunk_idx`` when the outermost span of a chunk
opened, shared by every span inside it.  No span makes a CUDA call (no
event, no synchronize), so it leaves the launches it is used to attribute
as they were; a reader lines the spans up with a device trace on its own
clock.  ``take_spans`` hands the spans over and starts a new list.  The
recorder serves one thread.

The graph counts say how each call of a CUDA graph's path ran
(runtime/graphs.py), by kind: 'append', a pixel session's streaming
appends, and 'vision', the tower calls (``full`` and ``cached`` paths).
A call was replayed from a graph captured earlier, captured (and then
replayed once), or eager, by the reason that sent it eager.
``graph_hit_share`` is the share of a kind's calls that were replays.

An MoE language model (models/deepseek_v3.py) keeps its routing counters
on the device, added to inside every video append (a CUDA graph's replays
included): ``moe_counts(lm)`` reads them to the host with one sync, and
``reset_moe_counts(lm)`` zeroes them on the device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

# the kernel products of the estimate_flops calls in progress, innermost
# last (one entry each)
_open_counts: List[List[int]] = []

# the span recorder: whether it is on, the spans recorded
# ([name, start_ns, end_ns, parent, chunk], end_ns 0 while open) and the
# indices of those open, innermost last
_tracing = False
_spans: List[list] = []
_open_spans: List[int] = []

# how the streaming appends and the vision tower calls ran: replays and
# captures of their CUDA graphs, and eager calls by reason
_graph_runs = {kind: {"replays": 0, "captures": 0, "eager": {}}
               for kind in ("append", "vision")}


def device_sync(device) -> Optional[Callable[[], None]]:
    """`torch.cuda.synchronize` of `device` when it is a CUDA device, else
    None (a Timer's sync)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    dev = torch.device(device)
    return lambda: torch.cuda.synchronize(dev)


class Timer:
    """`with Timer() as t: ...; t.seconds` -- wall-clock; `sync`, a
    function that waits for the device (``device_sync``), runs before the
    clock starts and before it stops."""

    def __init__(self, sync=None):
        self._sync = sync
        self.seconds = 0.0

    def __enter__(self):
        if self._sync:
            self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            self._sync()
        self.seconds = time.perf_counter() - self._t0
        return False


class StreamingStats:
    def __init__(self):
        self.frame_times: List[float] = []
        self.encode_tokens = 0
        self.questions = 0
        self.qa_times: List[float] = []

    def record_frame(self, seconds: float, tokens: int = 0):
        self.frame_times.append(seconds)
        self.encode_tokens += tokens

    def record_qa(self, seconds: float):
        self.questions += 1
        self.qa_times.append(seconds)

    @staticmethod
    def _pct(xs: List[float], p: float) -> Optional[float]:
        if not xs:
            return None
        xs = sorted(xs)
        i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
        return xs[i]

    def summary(self, kv_memory_bytes: int = 0) -> Dict:
        ft = self.frame_times
        total = sum(ft)
        return {
            "frames": len(ft),
            "fps": len(ft) / total if total else None,
            "frame_p50_ms": (self._pct(ft, 50) or 0) * 1e3 if ft else None,
            "frame_p95_ms": (self._pct(ft, 95) or 0) * 1e3 if ft else None,
            "encode_tokens": self.encode_tokens,
            "questions": self.questions,
            "qa_p50_ms": (self._pct(self.qa_times, 50) or 0) * 1e3
            if self.qa_times else None,
            "kv_memory_gb": kv_memory_bytes / 1024 ** 3,
        }


def add_kernel_flops(n: int) -> None:
    """A hand kernel's wrapper adds its products to every open count (none
    open: nothing happens)."""
    for c in _open_counts:
        c[0] += int(n)


def counting_flops() -> bool:
    """Whether an estimate_flops count is open."""
    return bool(_open_counts)


def estimate_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call of `fn(*args, **kwargs)`: the products
    FlopCounterMode sees, plus those of the hand kernels launched inside
    (add_kernel_flops).  The call runs, with whatever effects it has."""
    from torch.utils.flop_counter import FlopCounterMode

    count = [0]
    _open_counts.append(count)
    try:
        with FlopCounterMode(display=False) as mode:
            fn(*args, **kwargs)
    finally:
        _open_counts.pop()
    return int(mode.get_total_flops()) + count[0]


# what span returns while tracing is off: one shared, reusable no-op
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "chunk", "index")

    def __init__(self, name: str, chunk: Optional[int]):
        self.name, self.chunk = name, chunk

    def __enter__(self):
        parent = _open_spans[-1] if _open_spans else -1
        chunk = self.chunk
        if chunk is None:
            chunk = _spans[parent][4] if parent >= 0 else -1
        self.index = len(_spans)
        _open_spans.append(self.index)
        _spans.append([self.name, time.perf_counter_ns(), 0, parent,
                       int(chunk)])
        return self

    def __exit__(self, *exc):
        _spans[self.index][2] = time.perf_counter_ns()
        _open_spans.pop()
        return False


def tracing(on: bool) -> None:
    """Turn the span recorder on or off; spans already recorded stay until
    take_spans."""
    global _tracing
    _tracing = bool(on)


def span(name: str, chunk: Optional[int] = None):
    """A context manager that records one span while tracing is on.  chunk:
    the session's chunk_idx; None takes the enclosing span's (-1 outside
    any span)."""
    if not _tracing:
        return _NO_SPAN
    return _Span(name, chunk)


def take_spans() -> List[Tuple[str, int, int, int, int]]:
    """The spans recorded since the last call, in the order they opened, as
    (name, start_ns, end_ns, parent, chunk); the recorder starts a new
    list.  Raises while a span is open (its parent indices would point
    into the list handed over)."""
    if _open_spans:
        raise RuntimeError(f"{len(_open_spans)} span(s) still open")
    out = [tuple(s) for s in _spans]
    _spans.clear()
    return out


def count_graph(kind: str, how: str) -> None:
    """One call of kind `kind` ('append' or 'vision'): 'replay',
    'capture', or the reason it ran eager (runtime/graphs.py)."""
    runs = _graph_runs[kind]
    if how in ("replay", "capture"):
        runs[how + "s"] += 1
    else:
        runs["eager"][how] = runs["eager"].get(how, 0) + 1


def graph_counts(kind: str) -> dict:
    """{'replays': n, 'captures': n, 'eager': {reason: n}} of kind `kind`
    since the last reset_graph_counts(kind)."""
    runs = _graph_runs[kind]
    return dict(runs, eager=dict(runs["eager"]))


def reset_graph_counts(kind: str) -> None:
    _graph_runs[kind].update(replays=0, captures=0, eager={})


def graph_hit_share(kind: str) -> Optional[float]:
    """Replays over all calls of kind `kind` counted (None before
    any)."""
    runs = _graph_runs[kind]
    n = runs["replays"] + runs["captures"] + sum(runs["eager"].values())
    return runs["replays"] / n if n else None


def moe_counts(lm) -> Dict[str, object]:
    """An MoE LM's routing since its last reset, on the host: ``tokens``
    (layers, experts) int64, the tokens routed to each expert; ``hits``
    (layers,) int64, the experts each layer hit (routed a token to),
    summed over the appends; ``appends``, the video appends counted.
    Layers before the first MoE layer read 0."""
    L, n = lm.expert_tokens.shape
    flat = torch.cat([lm.expert_tokens.reshape(-1), lm.expert_hits,
                      lm.moe_appends.reshape(1)]).cpu()
    return dict(tokens=flat[:L * n].reshape(L, n), hits=flat[L * n:-1],
                appends=int(flat[-1]))


def reset_moe_counts(lm) -> None:
    for t in (lm.expert_tokens, lm.expert_hits, lm.moe_appends):
        t.zero_()
