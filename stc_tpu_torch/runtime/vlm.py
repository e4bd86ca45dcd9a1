"""Vision-language streaming session (port of ``stc_tpu/runtime/vlm.py``,
main-path subset).

A VisionPipeline supplies the tower's two chunk paths (full and cacher);
VLMSession runs pixels -> vision -> pruned features -> LM append for B
streams, one chunk of encode_chunk_frames frames at a time.  Each stream
slot keeps its own cacher schedule (its chunk count % cache_interval, on
the host): a tick where the ticking slots disagree runs both vision paths
and takes each slot's from its own.  Streams may tick at different rates
(``active``) and slots may be recycled (``reset_streams``); an inactive or
recycled slot's cacher references and pruner memory stay its own.  A
serving tick (``serve``) runs one chunk's vision and ragged append, then
per-stream questions over the state after it.  A slot's vision state can
leave with its stream and come back in another slot or session
(``extract_stream`` / ``restore_stream``, utils/checkpoint.py).  Raw uint8
RGB frames go to the device as they are; normalisation happens there.
With ``SessionConfig.ingest_format='yuv420'`` the host packs each chunk
into planar 4:2:0 planes (half the bytes; already-packed planes pass
through) and the device rebuilds RGB before normalising.  ``stage_chunk``
stages one chunk on the device ahead of time; ``encode_video`` takes such
a staged tensor as one chunk (runtime/pipeline.py's ``stream_encode``).
``estimate_chunk_flops`` counts one chunk's FLOPs at the current state
and leaves the state as it was.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stc_tpu_torch import native
from stc_tpu_torch.kvcache import engine
from stc_tpu_torch.runtime.session import StreamingSession
from stc_tpu_torch.utils import metrics


class Preprocessor:
    """Frame preprocessor in two halves.  ``host`` stages frames: uint8 RGB
    passes through untouched, or with ingest='yuv420' packs into planar
    BT.601 4:2:0 planes (N, h*w*3//2), half the bytes (already-packed
    planes pass through; ``src_hw`` gives their geometry).  ``device``
    finishes on the device: (N, H, W, 3) uint8 (or 0-255 float), or packed
    planes, -> (N, 3, S, S) normalised, resized with plain half-pixel
    bilinear when the frames are not S x S.  The port has no jit keyed on
    the geometry: a new src_hw takes effect at the next call."""

    def __init__(self, image_size: int, mean, std, dtype,
                 ingest: str = "rgb"):
        self.image_size = image_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.dtype = dtype
        self.ingest = ingest
        self._src_hw = None  # (h, w) of packed planes, set by host()

    def host(self, frames) -> np.ndarray:
        frames = np.asarray(frames)
        if frames.dtype == np.uint8 and self.ingest == "yuv420":
            if frames.ndim == 2:  # already-packed planes
                if self._src_hw is None:
                    raise ValueError(
                        "packed yuv420 planes need src_hw: stage one RGB "
                        "chunk first or set src_hw = (h, w)")
                return np.ascontiguousarray(frames)
            self._src_hw = (frames.shape[1], frames.shape[2])
            return native.rgb_to_yuv420(frames)
        if frames.dtype == np.uint8:
            return np.ascontiguousarray(frames)
        return frames

    @property
    def src_hw(self):
        return self._src_hw

    @src_hw.setter
    def src_hw(self, hw):
        self._src_hw = (int(hw[0]), int(hw[1]))

    def _yuv_to_rgb(self, x: torch.Tensor) -> torch.Tensor:
        """(N, h*w*3//2) packed uint8 planes -> (N, h, w, 3) float32 RGB in
        [0, 255] on x's device: nearest 2x2 chroma upsample and the BT.601
        full-range matrix, in float32 as the JAX package computes it."""
        h, w = self._src_hw
        if x.shape[1] != h * w * 3 // 2:
            raise ValueError(
                f"packed yuv420 length {x.shape[1]} does not match src_hw "
                f"({h}, {w}) -> {h * w * 3 // 2}")
        N, ch, cw = x.shape[0], h // 2, w // 2
        y = x[:, :h * w].reshape(N, h, w).to(torch.float32)

        def up(c):
            return c.reshape(N, ch, cw).repeat_interleave(2, 1) \
                .repeat_interleave(2, 2).to(torch.float32) - 128.0

        uf = up(x[:, h * w:h * w + ch * cw])
        vf = up(x[:, h * w + ch * cw:])
        r = y + 1.402 * vf
        g = y - 0.344136 * uf - 0.714136 * vf
        b = y + 1.772 * uf
        return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)

    def device(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:  # packed yuv420 planes
            x = self._yuv_to_rgb(x)
        x = x.to(torch.float32) / 255.0
        S = self.image_size
        if x.shape[1] != S or x.shape[2] != S:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(S, S),
                              mode="bilinear", align_corners=False,
                              antialias=False).permute(0, 2, 3, 1)
        mean = torch.as_tensor(self.mean, device=x.device)
        std = torch.as_tensor(self.std, device=x.device)
        x = (x - mean) / std
        return x.permute(0, 3, 1, 2).contiguous().to(self.dtype)


class VisionPipeline:
    """Backbone-specific vision stack: frames -> (B, F*block_size, E)."""

    def init_state(self):
        """-> (vision_state, pruner_state)."""
        raise NotImplementedError

    def preprocess(self, frames) -> np.ndarray:
        """Host half: stage frames for transfer."""
        raise NotImplementedError

    def device_preprocess(self, pixels: torch.Tensor) -> torch.Tensor:
        return pixels

    def full(self, pixels, vstate, pstate):
        """-> (flat_features, vstate, pstate)"""
        raise NotImplementedError

    def cached(self, pixels, vstate, pstate):
        """-> (flat_features, vstate, pstate)"""
        raise NotImplementedError

    def select_streams(self, vstate, pstate, old_vstate, old_pstate, mask):
        """Per stream, the new state where mask (B,) bool is set, else the
        old (ragged ticks, mixed ticks, recycled slots)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no per-stream vision state")

    def stream_axes(self):
        """(vstate axis, pstate axis) of the stream dim of every leaf."""
        raise NotImplementedError(
            f"{type(self).__name__} has no per-stream vision state axis")

    def extract_stream(self, vstate, pstate, slot: int):
        """One slot's vision and pruner state, as host tensors of the same
        NamedTuple types (a stream's checkpoint)."""
        va, pa = self.stream_axes()
        return (type(vstate)(*(x.select(va, slot).cpu() for x in vstate)),
                type(pstate)(*(x.select(pa, slot).cpu() for x in pstate)))

    def restore_stream(self, vstate, pstate, slot: int, v_blob, p_blob):
        """The live state with extract_stream's blobs written into
        `slot`; returns (vstate, pstate)."""
        va, pa = self.stream_axes()

        def put(axis, state, blob):
            out = []
            for cur, new in zip(state, blob):
                cur = cur.clone()
                cur.select(axis, slot).copy_(torch.as_tensor(new))
                out.append(cur)
            return type(state)(*out)

        return put(va, vstate, v_blob), put(pa, pstate, p_blob)


class PixelPipeline(VisionPipeline):
    """A pipeline whose frames go through a Preprocessor ``_pre``: the
    frames of B streams (B, n, ...) stream-major on one axis, and the
    geometry of packed yuv420 planes (``src_hw``)."""

    _pre: Preprocessor

    @property
    def src_hw(self):
        """(h, w) of the packed yuv420 planes the preprocessor unpacks."""
        return self._pre.src_hw

    @src_hw.setter
    def src_hw(self, hw):
        self._pre.src_hw = hw

    def preprocess(self, frames):
        frames = np.asarray(frames)
        if frames.ndim in (3, 5):  # multi-stream (B, F, ...): stream-major
            frames = frames.reshape((-1,) + frames.shape[2:])
        return self._pre.host(frames)

    def device_preprocess(self, pixels):
        return self._pre.device(pixels)


class VLMSession(StreamingSession):
    """Pixel session of `batch` streams."""

    def __init__(self, lm, scfg, vision: VisionPipeline,
                 state_dtype=torch.bfloat16, batch: int = 1):
        self.vision = vision
        super().__init__(lm, scfg, batch=batch, state_dtype=state_dtype)

    def clear_cache(self):
        super().clear_cache()
        self.chunk_idx = 0
        # each slot's chunk count: its cacher parity is its own
        self._slot_chunk = np.zeros(self.batch, dtype=np.int64)
        self._vstate, self._pstate = self.vision.init_state()

    def reset_streams(self, slots):
        """Slot recycling: also the recycled slots' cacher references,
        pruner memory and chunk counts return to a fresh session's (their
        next chunk takes the full path); the other slots keep theirs."""
        super().reset_streams(slots)
        mask = np.zeros(self.batch, dtype=bool)
        mask[list(slots)] = True
        fresh_v, fresh_p = self.vision.init_state()
        self._vstate, self._pstate = self.vision.select_streams(
            fresh_v, fresh_p, self._vstate, self._pstate,
            torch.as_tensor(mask, device=self.device))
        self._slot_chunk[mask] = 0

    @torch.no_grad()
    def encode_video(self, frames, active=None):
        """frames: (n, H, W, 3) uint8 of one stream, or (B, n, H, W, 3) of
        the session's B streams (with yuv420 ingest also packed planes,
        (n, P) or (B, n, P)), streamed encode_chunk_frames at a time.  A
        torch tensor is one chunk already staged (stage_chunk), its B * n
        frames stream-major.  active: optional (B,) bool ragged mask:
        inactive streams' frames are ignored and their KV, cacher and
        pruner state stay bit-identical."""
        if torch.is_tensor(frames):
            self._encode_chunk_pixels(frames, frames.shape[0] // self.batch,
                                      active)
            return
        frames = np.asarray(frames)
        multi = frames.ndim == (3 if frames.ndim < 4 else 5)
        if multi:
            if frames.shape[0] != self.batch:
                raise ValueError(f"frames of {frames.shape[0]} streams for "
                                 f"a {self.batch}-stream session")
        elif self.batch > 1:
            raise ValueError("a multi-stream session takes (B, n, H, W, 3) "
                             "frames")
        axis = int(multi)
        n = self.scfg.encode_chunk_frames
        for s in range(0, frames.shape[axis], n):
            chunk = frames[:, s:s + n] if axis else frames[s:s + n]
            self._encode_chunk_pixels(self.vision.preprocess(chunk),
                                      chunk.shape[axis], active)

    def stage_chunk(self, frames) -> torch.Tensor:
        """One chunk of frames staged on the device (the host half of the
        preprocess, then the copy), for encode_video."""
        return torch.as_tensor(self.vision.preprocess(frames)).to(
            self.device, non_blocking=True)

    @torch.no_grad()
    def serve(self, frames, active, questions, prompts, stop_token_ids,
              max_new_tokens: int = 128, asked=None):
        """A serving tick on pixels: frames (B, n, H, W, 3) uint8 (inactive
        rows ignored) through encode_video, each slot on its own cacher
        schedule, then the per-stream questions over the state after it.
        Other arguments, last_serve_fused and the return as
        StreamingSession.serve."""
        frames = np.asarray(frames)
        if frames.ndim != 5 or frames.shape[0] != self.batch:
            raise ValueError(f"serve takes (B={self.batch}, n, H, W, 3) "
                             f"frames, got {frames.shape}")
        n_frames = frames.shape[1]
        self.last_serve_fused = self._serve_eligible(
            n_frames * self.rekv.block_size, n_frames)
        self.encode_video(frames, active=active)
        return self._qa_tick(questions, prompts, stop_token_ids,
                             max_new_tokens, asked)

    def _encode_chunk_pixels(self, pixels, n_frames: int, active=None):
        act_dev, act_np = self._normalize_active(active)
        self._maybe_evict(n_frames)
        c = self.scfg.cacher
        cached = c.enabled & (self._slot_chunk % c.cache_interval != 0)
        ticking = cached if act_np is None else cached[act_np]
        vis, vstate, pstate = self.vision, self._vstate, self._pstate
        px = vis.device_preprocess(
            torch.as_tensor(pixels).to(self.device, non_blocking=True))
        if ticking.any() and not ticking.all():
            # the ticking slots disagree: both paths, each slot its own
            flat_f, v_f, p_f = vis.full(px, vstate, pstate)
            flat_c, v_c, p_c = vis.cached(px, vstate, pstate)
            need_full = torch.as_tensor(~cached, device=self.device)
            flat = torch.where(need_full[:, None, None], flat_f, flat_c)
            new_v, new_p = vis.select_streams(v_f, p_f, v_c, p_c, need_full)
        else:
            path = vis.cached if ticking.size and ticking.all() else vis.full
            flat, new_v, new_p = path(px, vstate, pstate)
        if act_dev is not None:
            new_v, new_p = vis.select_streams(new_v, new_p, vstate, pstate,
                                              act_dev)
        self._vstate, self._pstate = new_v, new_p
        self._append_flat(flat, act_dev)
        self._track_blocks(n_frames, act_np)
        self._slot_chunk += 1 if act_np is None else act_np.astype(np.int64)
        self.chunk_idx += 1

    def _append_flat(self, flat, active=None):
        """Pruned features (B, n * block_size, E) into the LM, one append
        a exc_block_size tokens."""
        flat = flat.to(self.lm.dtype)
        S, exc = self.rekv.block_size, self.rekv.exc_block_size
        if flat.shape[1] % S:
            raise ValueError((flat.shape, S))
        for i in range(0, flat.shape[1], exc):
            self.lm.encode_step(self.rekv, self.kvs, flat[:, i:i + exc],
                                is_init=False, active=active)

    @torch.no_grad()
    def estimate_chunk_flops(self, cached: bool = False) -> int:
        """FLOPs of one encode chunk (encode_chunk_frames frames of every
        stream through the tower, projector, pooling, pruner and LM append)
        at the current stream state; cached=True takes the cacher's
        selective-recompute path.  Counted by utils/metrics.estimate_flops
        (torch's counter plus the hand kernels' products) over a chunk of
        zero frames.  The state is left as it was: the chunk's vision and
        pruner states are dropped, and the page and rep-key slots its
        appends write, and the counters, are saved before and written back
        after (engine.save_append_slots).  Nothing is evicted."""
        n = self.scfg.encode_chunk_frames
        hw = self.vision.cfg.vision.image_size
        pixels = torch.zeros((n * self.batch, hw, hw, 3), dtype=torch.uint8,
                             device=self.device)
        path = self.vision.cached if cached else self.vision.full

        def chunk():
            px = self.vision.device_preprocess(pixels)
            flat, _, _ = path(px, self._vstate, self._pstate)
            self._append_flat(flat)

        restore = engine.save_append_slots(self.kvs, self.rekv, n)
        try:
            return metrics.estimate_flops(chunk)
        finally:
            restore()
