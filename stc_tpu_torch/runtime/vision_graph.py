"""A vision tower's full and cached paths, each replayed as one CUDA graph.

A 1-frame chunk through SigLIP's, MoonViT's or CLIP's tower is some 1100
to 2500 small ops (norms, projections, the cacher's similarity, top-k,
gathers and scatters), and the host issues them far slower than the card
runs them.  Neither path reads a value back to the host: the cacher's
widths (SigLIP's update count, CLIP's skip counts) come from the
configuration and every selection stays on the device.  So one graph a
path, captured once, does every later chunk of the same shape.

The graphs belong to whoever owns the tower's cacher state (a session's
or a FrameEncoder's ``VisionGraph``), which opens ``calls(owner, held)``
around its tower calls; the towers' ``encode_full`` / ``encode_cached``
hand their eager body to ``run``, which decides how to run it from what
it can see:

- eager (``eager_reason``) for a reason the owner holds and the tower
  cannot see (``held_reason``: a ragged ``active`` mask, a mixed tick that
  runs both paths, a tp, sp or pp layout), inside an open FLOP count
  (utils/metrics.estimate_flops), on a device other than CUDA, or with no
  owner ('bare');
- eager as the warm-up, on the card's side stream
  (append_graph.on_side_stream), when its key (``graph_key``: the pixels'
  shape and dtype, the path's settings, the addresses of the state
  tensors it reads, the device) is not the key the path holds; the
  path's graph and its memory pool are dropped first;
- captured on the next call with that key, then replayed once to do the
  call's work (a capture runs no kernel);
- replayed on every later call: the pixels are copied into the static
  input, then one graph launch.

The state a cached path reads (the cacher's references) is read where it
lies, never copied: its addresses are in the key.  A replay rewrites the
graph's static outputs, so the call hands out copies of them (features,
selections: a few MB and kB), except those named in ``keep``: the full
path's references, which become the owner's and are rewritten in place
by the path's next replay, when the owner replaces them anyway.  Their
owner drops the graphs before it makes fresh state (``release``), so two
sets of references are never held at once beyond what eager holds.  The
weights are read where they lie: they keep their storage for the
session's life.  utils/metrics counts the calls by how they ran
(``count_vision``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from stc_tpu_torch.runtime.append_graph import on_side_stream
from stc_tpu_torch.utils import metrics

# (owner, held reason) of the tower calls in progress, innermost last: a
# context and not an argument, since the towers' signatures are their
# callers' (the pipelines, and hooks that wrap the methods)
_calls: list = []


@contextlib.contextmanager
def calls(owner: Optional["VisionGraph"], held: Optional[str] = None):
    """Tower calls inside take their graphs from `owner`, and run eager
    for `held` when it is not None."""
    _calls.append((owner, held))
    try:
        yield
    finally:
        _calls.pop()


def held_reason(lm, active=None, mixed: bool = False) -> Optional[str]:
    """What a session knows of a tick that its tower cannot see: a ragged
    `active` mask, a mixed tick (both paths), a tp, sp or pp layout of
    `lm` (collectives in the layers); None where a graph may take it."""
    if active is not None:
        return "active"
    if mixed:
        return "mixed"
    if lm.tp is not None or lm.sp is not None or lm.pp is not None:
        return "parallel"
    return None


def eager_reason(x: torch.Tensor, owner, held: Optional[str]
                 ) -> Optional[str]:
    """Why a tower call on pixels x runs eager, or None where a graph may
    take it."""
    if held is not None:
        return held
    if metrics.counting_flops():
        return "flops"
    if x.device.type != "cuda":
        return "device"
    if owner is None:
        return "bare"
    return None


def graph_key(x: torch.Tensor, settings: tuple,
              reads: Sequence[torch.Tensor]) -> tuple:
    """What a captured path depends on beyond the weights."""
    return (tuple(x.shape), x.dtype, x.device, tuple(settings),
            tuple(t.data_ptr() for t in reads))


class _Held:
    """One path's graph, its key and its static tensors."""
    __slots__ = ("key", "graph", "static_in", "static_out")

    def __init__(self, key):
        self.key, self.graph = key, None
        self.static_in = self.static_out = None


class VisionGraph:
    """One owner's tower graphs: at most one a path, each for one key."""

    def __init__(self):
        self.release()

    def release(self) -> None:
        """Drop every graph held, its static tensors and its memory
        pool."""
        self._held = {}
        self.pool_bytes = {}  # device memory each path's last capture took

    def _how(self, path: str, key: tuple) -> str:
        held = self._held.get(path)
        if held is None or held.key != key:
            self._held[path] = _Held(key)
            return "warmup"
        return "capture" if held.graph is None else "replay"

    def _capture(self, path: str, fn, x: torch.Tensor) -> None:
        held, dev = self._held[path], x.device
        held.static_in = torch.zeros(x.shape, dtype=x.dtype, device=dev)
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                return fn(held.static_in)
            finally:
                graph.capture_end()

        held.static_out = on_side_stream(dev, capture)
        held.graph = graph
        self.pool_bytes[path] = torch.cuda.memory_reserved(dev) - reserved


def run(path: str, fn, x: torch.Tensor, settings: tuple = (),
        reads: Sequence[torch.Tensor] = (), keep: Sequence[int] = ()):
    """fn(x), a tuple of tensors: the tower path `path` ('full' or
    'cached') on pixels x, fn its eager body; `settings` and the
    addresses of `reads`, the state fn reads, join x's shape, dtype and
    device in the key.  On a replay the outputs are copies, but those at
    the indices in `keep`, which are the graph's own."""
    owner, held = _calls[-1] if _calls else (None, None)
    how = eager_reason(x, owner, held)
    if how is None:
        how = owner._how(path, graph_key(x, settings, reads))
    metrics.count_vision(how)
    if how == "warmup":
        return on_side_stream(x.device, lambda: fn(x))
    if how not in ("capture", "replay"):
        return fn(x)
    if how == "capture":
        owner._capture(path, fn, x)
    g = owner._held[path]
    g.static_in.copy_(x)
    g.graph.replay()
    return tuple(t if i in keep else t.clone()
                 for i, t in enumerate(g.static_out))
