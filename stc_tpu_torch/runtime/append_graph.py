"""A pixel session's streaming append, replayed as one CUDA graph.

The LM append of a 1-frame chunk is some 70 small ops a layer: norms,
QKV, the page and rep-key writes, the RoPE tables, stream_attention's
pre-pass, tile and combine, the MLP.  Issued one by one they cost far
more host time than device time.  None of them reads a value back to the
host: positions, the cover's start tile and the kernel's scalars are
computed on the device from the store's counters, and the cover length
is fixed by the configuration (engine.n_window_pages).  So one graph,
captured once, does every later append of the same shape into the same
store: before the window is full and after it, and across host-tier
eviction, which shifts the pages in place and advances page_offset.

``AppendGraph.append`` does what ``pipeline.pp_encode_step`` does, and
decides how from what it can see:

- eager, as ``pp_encode_step`` runs it, when the call is ineligible
  (``eager_reason``): a ragged ``active`` mask, a tp, sp or pp layout, a
  FLOP count open (utils/metrics.estimate_flops), or a device other than
  CUDA (an init prompt never comes here: the session appends it through
  ``Qwen2.encode_step`` itself);
- eager as the warm-up (kernel builds, cuBLAS handles) when its key
  (``graph_key``: the store's tensors' addresses, the input's shape and
  dtype, the ReKVConfig, the device) is not the key held; the graph held
  and its memory pool are dropped first;
- captured on the next call with that key, then replayed once to do the
  call's work (a capture runs no kernel);
- replayed on every later call: the features are copied, and cast, into
  the static input, then one graph launch.

A replay does not pass the stream_attention (or latent_attention)
wrapper, so each replay adds the launches recorded at capture to its
counters, and the counters are put back as they were before the capture,
whose wrapper calls launched nothing.  ``pool_bytes`` is the device
memory the last capture reserved (the graph's pool).  The LM's weights
are read where they lie: they keep their storage for the session's life
(the session quantizes them at build).  utils/metrics counts the appends
by how they ran (``count_append``).
"""

from __future__ import annotations

from typing import Optional

import torch

from stc_tpu_torch.ops import latent_attention as la
from stc_tpu_torch.ops import stream_attention as sa
from stc_tpu_torch.parallel import pipeline
from stc_tpu_torch.utils import metrics


def eager_reason(lm, x: torch.Tensor,
                 active: Optional[torch.Tensor]) -> Optional[str]:
    """Why a streaming append of x (B, T, E) runs eager, or None where a
    graph may take it."""
    if active is not None:
        return "active"
    if lm.tp is not None or lm.sp is not None or lm.pp is not None:
        return "parallel"
    if metrics.counting_flops():
        return "flops"
    if x.device.type != "cuda":
        return "device"
    return None


def graph_key(kvs, x: torch.Tensor, rekv) -> tuple:
    """What a captured append depends on beyond the weights."""
    return (tuple(t.data_ptr() for t in kvs), tuple(x.shape), x.dtype,
            rekv, x.device)


# the side stream of each card's warm-ups and captures: one, since cuBLAS
# keeps a workspace for every stream it runs on
_streams: dict = {}


def on_side_stream(dev, fn):
    """fn() on the card's side stream, ordered after and before the current
    stream's work: a warm-up there readies the stream (cuBLAS's workspace
    for it) before a capture, which cannot run on the default stream.  The
    vision tower's graphs (runtime/vision_graph.py) share it."""
    side = _streams.get(dev)
    if side is None:
        side = _streams[dev] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


class AppendGraph:
    """One session's append graph: at most one held, for one key."""

    def __init__(self):
        self.release()

    def release(self) -> None:
        """Drop the graph held, its static tensors and its memory pool."""
        self._key = None
        self._graph = self._static_in = self._static_out = None
        self._launches = ({}, 0, 0)
        self.pool_bytes = 0  # device memory the last capture reserved

    def append(self, lm, rekv, kvs, x: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pipeline.pp_encode_step(lm, rekv, kvs, x in the LM's dtype,
        active): kvs updated in place; returns the hidden states (B, T, E),
        the graph's static output when replayed."""
        how = eager_reason(lm, x, active)
        if how is None:
            key = graph_key(kvs, x, rekv)
            if key != self._key:
                self.release()
                self._key = key
                how = "warmup"
            elif self._graph is None:
                self._capture(lm, rekv, kvs, x)
                how = "capture"
            else:
                how = "replay"
        metrics.count_append(how)
        if how == "warmup":
            return on_side_stream(
                x.device, lambda: pipeline.pp_encode_step(
                    lm, rekv, kvs, x.to(lm.dtype)))
        if how not in ("capture", "replay"):
            return pipeline.pp_encode_step(lm, rekv, kvs, x.to(lm.dtype),
                                           active)
        self._static_in.copy_(x)
        self._graph.replay()
        sa.add_launches(*self._launches[:2])
        la.add_launches(self._launches[2])
        return self._static_out

    def _capture(self, lm, rekv, kvs, x):
        dev = x.device
        self._static_in = torch.empty(x.shape, dtype=lm.dtype, device=dev)
        by_kind, masked = dict(sa.launches), sa.masked_launches
        latent = la.launches
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                return pipeline.pp_encode_step(lm, rekv, kvs, self._static_in)
            finally:
                graph.capture_end()

        try:
            self._static_out = on_side_stream(dev, capture)
        finally:  # the wrapper calls of the capture launched nothing
            recorded = ({k: n - by_kind[k] for k, n in sa.launches.items()},
                        sa.masked_launches - masked, la.launches - latent)
            sa.launches.update(by_kind)
            sa.masked_launches = masked
            la.launches = latent
        self._graph, self._launches = graph, recorded
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
