"""The CUDA graphs of the ingest path: a pixel session's streaming append
and a vision tower's full and cached paths, each replayed as one graph.

A 1-frame chunk is some 1100 to 2500 small ops in the tower and some 70
a layer in the LM append, which the host issues far slower than the card
runs them.  None of them reads a value back to the host (the cacher's
widths come from the configuration, selections stay on the device, the
append's positions and kernel scalars come from the store's counters and
its cover length from engine.n_window_pages), so one graph a path,
captured once, does every later call of the same shape, across the
window filling and host-tier eviction.

The graphs belong to the owner of the state they read (``Graphs``: a
session's, or a FrameEncoder's).  The session appends through
``Graphs.append`` (path 'append'); the towers' ``encode_full`` /
``encode_cached`` hand their eager body to ``run`` (paths 'full',
'cached'), which takes the owner from the innermost ``calls(owner, ...)``
(a context, since hooks and pipelines own the towers' signatures).  A
call runs eager for the first reason of ``eager_reason``; else eager as
the warm-up, on the card's side stream, when its key (``graph_key``: the
input's shape, dtype and device, the path's settings, the addresses of
the state it reads) is not the one the path holds, dropping the path's
graph; captured on the next call with that key and replayed once (a
capture runs no kernel); replayed after that, the input copied (and
cast) into the static input.

State and weights are read where they lie.  A replay rewrites the static
outputs, so a call hands out copies, but those in ``keep`` (the append's
hidden states, the full path's references, which the owner replaces
before that path's next replay).  The owner drops its graphs before it
makes fresh state (``release``).  A replay passes no hand kernel's
wrapper, so it adds the launches recorded at capture to their counters,
which the capture put back.  ``pool_bytes`` is the device memory each
path's last capture reserved; utils/metrics counts the calls by how they
ran (``count_graph``, kind 'append' or 'vision').
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from stc_tpu_torch.ops import latent_attention as la
from stc_tpu_torch.ops import stream_attention as sa
from stc_tpu_torch.parallel import pipeline
from stc_tpu_torch.utils import metrics


def eager_reason(x, owner, lm=None, active=None,
                 mixed: bool = False) -> Optional[str]:
    """Why a call on x (features or pixels) runs eager, or None where a
    graph may take it: a ragged `active` mask, a `mixed` tick that runs
    both tower paths, a tp, sp or pp layout of `lm` (collectives in the
    layers), a FLOP count open (utils/metrics.estimate_flops), a device
    other than CUDA, or no `owner` ('bare')."""
    if active is not None:
        return "active"
    if mixed:
        return "mixed"
    if lm is not None and (lm.tp is not None or lm.sp is not None
                           or lm.pp is not None):
        return "parallel"
    if metrics.counting_flops():
        return "flops"
    if x.device.type != "cuda":
        return "device"
    if owner is None:
        return "bare"
    return None


def graph_key(x: torch.Tensor, settings: tuple = (),
              reads: Sequence[torch.Tensor] = ()) -> tuple:
    """What a captured path depends on beyond the weights."""
    return (tuple(x.shape), x.dtype, x.device, tuple(settings),
            tuple(t.data_ptr() for t in reads))


# the side stream of each card's warm-ups and captures: one, since cuBLAS
# keeps a workspace for every stream it runs on
_streams: dict = {}


def on_side_stream(dev, fn):
    """fn() on the card's side stream, ordered after and before the current
    stream's work: a warm-up there readies the stream (cuBLAS's workspace
    for it) before a capture, which cannot run on the default stream."""
    side = _streams.get(dev)
    if side is None:
        side = _streams[dev] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def _launches() -> tuple:
    return dict(sa.launches), sa.masked_launches, la.launches


class _Held:
    """One path's key, graph, static tensors and the launches its capture
    recorded."""
    __slots__ = ("key", "graph", "static_in", "static_out", "launches")

    def __init__(self, key):
        self.key, self.graph = key, None
        self.static_in = self.static_out = self.launches = None


class Graphs:
    """One owner's graphs: at most one a path, each for one key."""

    def __init__(self):
        self.release()

    def release(self) -> None:
        """Drop every graph held, its static tensors and its memory
        pool."""
        self._held = {}
        self.pool_bytes = {}  # device memory each path's last capture took

    def append(self, lm, rekv, kvs, x: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pipeline.pp_encode_step(lm, rekv, kvs, x in the LM's dtype,
        active): kvs updated in place; returns the hidden states (B, T, E),
        the graph's static output when replayed."""
        def fn(y):
            return (pipeline.pp_encode_step(lm, rekv, kvs, y.to(lm.dtype),
                                            active),)

        return self.call("append", fn, x, eager_reason(x, self, lm, active),
                         (rekv,), kvs, keep=(0,), dtype=lm.dtype)[0]

    def call(self, path: str, fn, x: torch.Tensor, reason: Optional[str],
             settings: tuple = (), reads: Sequence[torch.Tensor] = (),
             keep: Sequence[int] = (), dtype=None) -> tuple:
        """fn(x), a tuple of tensors, as path `path` runs it: eager for
        `reason`, else through the path's graph; `settings` and the
        addresses of `reads` join x's shape, dtype and device in the key.
        The static input takes `dtype` (x's by default).  On a replay the
        outputs are copies, but those at the indices in `keep`."""
        how = reason
        if how is None:
            held = self._held.get(path)
            key = graph_key(x, settings, reads)
            if held is None or held.key != key:
                self._held[path] = _Held(key)
                how = "warmup"
            else:
                how = "capture" if held.graph is None else "replay"
        metrics.count_graph("append" if path == "append" else "vision", how)
        if how == "warmup":
            return on_side_stream(x.device, lambda: fn(x))
        if how not in ("capture", "replay"):
            return fn(x)
        held = self._held[path]
        if how == "capture":
            self._capture(path, held, fn, x, dtype or x.dtype)
        held.static_in.copy_(x)
        held.graph.replay()
        by_kind, masked, latent = held.launches
        sa.add_launches(by_kind, masked)
        la.add_launches(latent)
        return tuple(t if i in keep else t.clone()
                     for i, t in enumerate(held.static_out))

    def _capture(self, path, held, fn, x, dtype) -> None:
        dev = x.device
        held.static_in = torch.zeros(x.shape, dtype=dtype, device=dev)
        before = _launches()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                return fn(held.static_in)
            finally:
                graph.capture_end()

        try:
            held.static_out = on_side_stream(dev, capture)
        finally:  # the wrapper calls of the capture launched nothing
            after = _launches()
            held.launches = (
                {k: n - before[0][k] for k, n in after[0].items()},
                after[1] - before[1], after[2] - before[2])
            sa.launches.update(before[0])
            sa.masked_launches, la.launches = before[1:]
        held.graph = graph
        self.pool_bytes[path] = torch.cuda.memory_reserved(dev) - reserved


# (owner, what the session knows of the tick) of the tower calls in
# progress, innermost last
_calls: list = []


@contextlib.contextmanager
def calls(owner: Optional[Graphs], lm=None, active=None,
          mixed: bool = False):
    """Tower calls inside take their graphs from `owner`; lm, active and
    mixed as eager_reason."""
    _calls.append((owner, dict(lm=lm, active=active, mixed=mixed)))
    try:
        yield
    finally:
        _calls.pop()


_BARE = Graphs()  # the calls of a tower with no owner: eager, never held


def run(path: str, fn, x: torch.Tensor, settings: tuple = (),
        reads: Sequence[torch.Tensor] = (), keep: Sequence[int] = ()):
    """fn(x), a tuple of tensors: the tower path `path` ('full' or
    'cached') on pixels x, fn its eager body, through the graphs of the
    innermost ``calls`` (Graphs.call)."""
    owner, seen = _calls[-1] if _calls else (None, {})
    return (owner or _BARE).call(path, fn, x,
                                 eager_reason(x, owner, **seen), settings,
                                 reads, keep)
