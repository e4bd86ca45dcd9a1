"""Streaming host pipeline (the JAX package's, ported): stage frames ahead
of the device.

``FramePrefetcher`` runs the host half of the preprocess (pass-through for
RGB, YUV 4:2:0 packing for yuv420 ingest) on a background thread, chunk
t + 1 while the device encodes chunk t, and yields the chunks in order,
raising the worker's error where it occurred.  ``stream_encode`` drives a
pixel session with it.  On the card each prefetched chunk goes through a
ring of pinned host buffers: a chunk is copied into a free buffer, sent to
the device on a copy stream, and the compute stream waits on that copy's
event before the chunk's vision runs (the card's form of JAX's
asynchronous dispatch: the host goes on to the next chunk while the copy
and the compute run).  A buffer is refilled only after its copy event has
completed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from stc_tpu_torch import native


def _can_overlap() -> bool:
    """A prefetch thread only helps when a core is free to run it; on a
    single-core host it contends with the dispatching thread for the GIL
    and the CPU, so such hosts stage synchronously."""
    return (os.cpu_count() or 1) >= 2


class FramePrefetcher:
    """Wraps a frame-chunk iterator with a background preprocessing thread.

    chunks: iterable of (n, H, W, 3) uint8 arrays.
    preprocess: host-side fn chunk -> model input.
    depth: max prefetched chunks (double buffering by default).
    overlap: True/False pins the threaded path; None (default) routes on
        the host's core count (single-core hosts iterate synchronously,
        with the same outputs and no thread).  STC_PREFETCH_OVERLAP=0/1
        overrides None.
    """

    _SENTINEL = object()

    def __init__(self, chunks: Iterable[np.ndarray],
                 preprocess: Callable, depth: int = 2,
                 overlap: Optional[bool] = None):
        env = os.getenv("STC_PREFETCH_OVERLAP")
        if overlap is None:
            overlap = _can_overlap() if env is None else env not in ("0", "")
        self._overlap = bool(overlap)
        if not self._overlap:
            self._chunks, self._pre = chunks, preprocess
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for c in chunks:
                    self._q.put(preprocess(c))
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        if not self._overlap:
            for c in self._chunks:
                yield self._pre(c)
            return
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item


def native_preprocess(frames: np.ndarray, out_hw: int, mean, std):
    """The host frame library's preprocessor: (n, h, w, 3) uint8 -> (n, 3,
    out_hw, out_hw) float32 normalised (raises where g++ is missing)."""
    return native.preprocess_frames(frames, out_hw, mean, std)


class PinnedStager:
    """Host-to-device copies of staged chunks through a ring of pinned
    buffers on a side copy stream.  to_device(chunk) fills a buffer whose
    last copy has completed, copies it to the device on the copy stream and
    makes the current stream wait on the copy's event; it returns the
    device tensor.  bytes counts what crossed to the device."""

    def __init__(self, device, n_buffers: int = 3):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._ring = [None] * n_buffers   # (pinned buffer, copy event)
        self._i = 0
        self.bytes = 0

    def to_device(self, chunk) -> torch.Tensor:
        src = torch.as_tensor(chunk)
        slot = self._ring[self._i]
        if slot is not None:
            slot[1].synchronize()         # its last copy has left the buffer
        if slot is None or slot[0].shape != src.shape or \
                slot[0].dtype != src.dtype:
            slot = (torch.empty(src.shape, dtype=src.dtype,
                                pin_memory=True), torch.cuda.Event())
            self._ring[self._i] = slot
        buf, ev = slot
        buf.copy_(src)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = buf.to(self.device, non_blocking=True)
            ev.record(self.stream)
        compute.wait_event(ev)
        out.record_stream(compute)        # made on the copy stream
        self._i = (self._i + 1) % len(self._ring)
        self.bytes += buf.numel() * buf.element_size()
        return out


def stream_encode(session, frames: np.ndarray,
                  chunk_frames: Optional[int] = None, depth: int = 2,
                  overlap: Optional[bool] = None):
    """Encode a whole clip (n, H, W, 3) through a pixel session, chunk by
    chunk (the session's encode_chunk_frames unless chunk_frames is given;
    each staged chunk is one vision chunk), the host half of each chunk's
    preprocess run ahead on FramePrefetcher's thread; on the card through
    PinnedStager.  Returns the bytes that crossed to the device."""
    chunk_frames = chunk_frames or session.scfg.encode_chunk_frames
    chunks = (frames[i:i + chunk_frames]
              for i in range(0, len(frames), chunk_frames))
    staged = FramePrefetcher(chunks, session.vision.preprocess, depth=depth,
                             overlap=overlap)
    if session.device.type != "cuda":
        n = 0
        for chunk in staged:
            session.encode_video(torch.as_tensor(chunk))
            n += chunk.nbytes
        return n
    stager = PinnedStager(session.device, n_buffers=depth + 1)
    for chunk in staged:
        session.encode_video(stager.to_device(chunk))
    return stager.bytes
