"""Host-memory KV tier (port of ``stc_tpu/kvcache/host_tier.py``): streams
longer than the device page store.

When the store fills, the session moves its oldest E pages (every layer and
stream at once) to host memory and shifts the store left by E pages;
page_offset advances by E.  The rep keys of the whole history stay on the
device, so retrieval still scores every block ever seen, and a question
whose top-k hits evicted pages has them staged back (the session's
speculative-prefetch QA).

On the card an eviction is: the E oldest pages copied device to device
into a staging buffer on the current stream (with ``host_kv_quant`` on a
float store, quantized there instead), the store shifted in place, and the
staged pages copied to one pinned host allocation on a side copy stream,
ordered by CUDA events.  So the appends that follow overlap the copy, and
``HostBlockStore.fetch_raw`` waits for a chunk's copy before reading it.
On a CPU session the same steps run on the CPU, with plain host tensors.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from stc_tpu_torch.kvcache.engine import _quantize_page, _quantize_page_int4
from stc_tpu_torch.kvcache.state import StreamKV
from stc_tpu_torch.ops.stream_attention import dequant_rows


class HostBlockStore:
    """Evicted pages of every layer and stream.

    Chunks are (L, B, Hkv, E, S, Dp) tensors in eviction order; absolute
    page p lives in chunk p // E at offset p % E (every eviction moves the
    same E pages).  Quantized chunks (a kv_quant store, or host_kv_quant
    int8 / int4 on a float store) are int8 or packed-int4 uint8 with f32
    scales (L, B, Hkv, E, D).  Chunks of a CUDA session are pinned, one
    allocation per eviction."""

    def __init__(self):
        self.k_chunks: List[torch.Tensor] = []
        self.v_chunks: List[torch.Tensor] = []
        self.k_scales: List[torch.Tensor] = []
        self.v_scales: List[torch.Tensor] = []
        self.pages_per_chunk: int = 0
        self.total_pages: int = 0
        self.fetch_count: int = 0  # pages served (observability, tests)
        # per chunk: (copy start, copy done) CUDA events, or None on the CPU
        self.copy_events: List[Optional[tuple]] = []
        self._copy_stream = None

    @property
    def quantized(self) -> bool:
        return bool(self.k_scales)

    def append(self, k, v, k_scale=None, v_scale=None):
        """Store one eviction's pages, given as device tensors.  From a
        CUDA tensor the copy runs on the copy stream once the current
        stream has produced them, into one pinned allocation; the caller
        must not overwrite them before ``wait_copies``."""
        E = k.shape[3]
        if self.pages_per_chunk == 0:
            self.pages_per_chunk = E
        if E != self.pages_per_chunk:
            raise ValueError(f"chunk of {E} pages in a store of "
                             f"{self.pages_per_chunk}-page chunks")
        if (k_scale is None) != (v_scale is None) or (
                self.total_pages and self.quantized != (k_scale is not None)):
            raise ValueError("a store holds quantized chunks or float ones")
        src = [k, v] + ([k_scale, v_scale] if k_scale is not None else [])
        dst, events = self._copy_to_host(src)
        self.k_chunks.append(dst[0])
        self.v_chunks.append(dst[1])
        if k_scale is not None:
            self.k_scales.append(dst[2])
            self.v_scales.append(dst[3])
        self.copy_events.append(events)
        self.total_pages += E

    def _copy_to_host(self, src: List[torch.Tensor]):
        """Host copies of the device tensors `src`: one pinned allocation
        filled on the copy stream (CUDA), or plain clones (CPU).  Returns
        (host tensors, (start, done) CUDA events or None)."""
        if src[0].device.type == "cpu":
            return [t.clone() for t in src], None
        sizes = [-(-t.numel() * t.element_size() // 16) * 16 for t in src]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
        dst, off = [], 0
        for t, n in zip(src, sizes):
            nb = t.numel() * t.element_size()
            dst.append(buf[off:off + nb].view(t.dtype).view(t.shape))
            off += n
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=src[0].device)
        cs = self._copy_stream
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        cs.wait_stream(torch.cuda.current_stream(src[0].device))
        with torch.cuda.stream(cs):
            start.record(cs)
            for d, t in zip(dst, src):
                d.copy_(t, non_blocking=True)
                t.record_stream(cs)  # its memory stays the copy's until done
            done.record(cs)
        return dst, (start, done)

    def wait_copies(self):
        """Make the current stream wait for the last chunk's copy (before
        it overwrites the buffers the copy reads)."""
        if self.copy_events and self.copy_events[-1] is not None:
            torch.cuda.current_stream().wait_event(self.copy_events[-1][1])

    def _ready(self, c: int):
        if self.copy_events[c] is not None:
            self.copy_events[c][1].synchronize()

    def fetch_raw(self, layer: int, batch: int, abs_pages):
        """Pages as stored: (k, v (n, Hkv, S, Dp), k_scale, v_scale
        (n, Hkv, D) or None when the store is not quantized)."""
        E = self.pages_per_chunk
        abs_pages = [int(p) for p in abs_pages]
        self.fetch_count += len(abs_pages)
        where = [divmod(p, E) for p in abs_pages]
        for c in sorted({c for c, _ in where}):
            self._ready(c)

        def pick(chunks):
            return torch.stack([chunks[c][layer, batch, :, o]
                                for c, o in where])

        if not self.quantized:
            return pick(self.k_chunks), pick(self.v_chunks), None, None
        return (pick(self.k_chunks), pick(self.v_chunks),
                pick(self.k_scales), pick(self.v_scales))

    def fetch(self, layer: int, batch: int, abs_pages):
        """abs_pages (< total_pages) -> (n, Hkv, S, D) k and v in f32,
        dequantized (and int4 unpacked) on the host if stored quantized."""
        k, v, ks, vs = self.fetch_raw(layer, batch, abs_pages)
        if ks is None:
            return k.to(torch.float32), v.to(torch.float32)
        return (dequant_rows(k, ks[:, :, None, :]),
                dequant_rows(v, vs[:, :, None, :]))

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in
                   self.k_chunks + self.v_chunks + self.k_scales
                   + self.v_scales)

    def transfer_ms(self) -> List[float]:
        """Device ms of each chunk's copy to the host (CUDA sessions)."""
        out = []
        for ev in self.copy_events:
            if ev is not None:
                ev[1].synchronize()
                out.append(ev[0].elapsed_time(ev[1]))
        return out


def _shift(x: torch.Tensor, n: int, fill, axis: int = 3) -> None:
    """Shift x left by n pages along `axis` in place, the vacated tail set
    to fill.  One overlapping copy is refused by torch (and would need a
    store-sized temporary); chunks of at most n pages moved front to back
    never overlap their destination."""
    P = x.shape[axis]

    def pages(a, b):
        return (slice(None),) * axis + (slice(a, b),)

    for i in range(0, P - n, n):
        c = min(n, P - n - i)
        x[pages(i, i + c)] = x[pages(i + n, i + n + c)]
    x[pages(P - n, P)] = fill


def evict_pages(kvs: StreamKV, n_evict: int,
                staged: Optional[List[torch.Tensor]]):
    """Split off the oldest n_evict pages of the layer-stacked state.

    The pages (and, with kv_quant, their scales) are first copied into
    `staged` when given (tensors shaped like kvs.block_k[:, :, :, :n_evict]
    and so on); then the store shifts left in place: pages, scales and
    page_keep (vacated keep rows reset to ones, vacated pages and scales
    to zeros), and page_offset advances by n_evict.  Returns staged."""
    src = [kvs.block_k, kvs.block_v]
    if kvs.block_k_scale.shape[3]:
        src += [kvs.block_k_scale, kvs.block_v_scale]
    for d, s in zip(staged or (), src):
        d.copy_(s[:, :, :, :n_evict])
    for s in src:
        _shift(s, n_evict, 0)
    _shift(kvs.page_keep, n_evict, True, axis=2)          # (L, B, Nb, S)
    kvs.page_offset.add_(n_evict)
    return staged


def quantize_pages(k: torch.Tensor, v: torch.Tensor):
    """Symmetric int8 of evicted pages on their device, so the copy to the
    host is already compressed: per-(..., page, dim) absmax scales over the
    S rows.  k/v: (L, B, Hkv, E, S, D) -> (kq int8, ks f32 (L, B, Hkv, E,
    D), vq, vs)."""
    (kq, ks), (vq, vs) = _quantize_page(k), _quantize_page(v)
    return kq, ks, vq, vs


def quantize_pages_int4(k: torch.Tensor, v: torch.Tensor):
    """Symmetric int4 of evicted pages on their device, packed split-plane
    (the int4 page store's layout): (kq uint8 (..., S, D/2), ks, vq, vs)."""
    (kq, ks), (vq, vs) = _quantize_page_int4(k), _quantize_page_int4(v)
    return kq, ks, vq, vs
