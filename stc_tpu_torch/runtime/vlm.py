"""Vision-language streaming session (port of ``stc_tpu/runtime/vlm.py``,
main-path subset).

A VisionPipeline supplies the tower's two chunk paths (full and cacher);
VLMSession runs pixels -> vision -> pruned features -> LM append, one chunk
of encode_chunk_frames frames at a time, with the cacher schedule
chunk_idx % cache_interval kept on the host.  Raw uint8 RGB frames go to
the device as they are; normalisation happens there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stc_tpu_torch.runtime.session import StreamingSession


class Preprocessor:
    """RGB frame preprocessor: ``host`` stages frames (uint8 passes through
    untouched), ``device`` finishes on the device: (N, H, W, 3) uint8 (or
    0-255 float) -> (N, 3, S, S) normalised, resized with plain half-pixel
    bilinear when the frames are not S x S."""

    def __init__(self, image_size: int, mean, std, dtype):
        self.image_size = image_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.dtype = dtype

    def host(self, frames) -> np.ndarray:
        frames = np.asarray(frames)
        if frames.dtype == np.uint8:
            return np.ascontiguousarray(frames)
        return frames

    def device(self, x: torch.Tensor) -> torch.Tensor:
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


class VLMSession(StreamingSession):
    """Single-stream pixel session (multi-stream batches: ROADMAP.md
    queue 1, 'Ragged multi-stream')."""

    def __init__(self, lm, scfg, vision: VisionPipeline,
                 state_dtype=torch.bfloat16):
        self.vision = vision
        super().__init__(lm, scfg, batch=1, state_dtype=state_dtype)

    def clear_cache(self):
        super().clear_cache()
        self.chunk_idx = 0
        self._vstate, self._pstate = self.vision.init_state()

    @torch.no_grad()
    def encode_video(self, frames):
        """frames: (n, H, W, 3) uint8, streamed encode_chunk_frames at a
        time."""
        frames = np.asarray(frames)
        n = self.scfg.encode_chunk_frames
        for s in range(0, frames.shape[0], n):
            chunk = frames[s:s + n]
            self._encode_chunk_pixels(self.vision.preprocess(chunk),
                                      chunk.shape[0])

    def _encode_chunk_pixels(self, pixels, n_frames: int):
        self._maybe_evict(n_frames)
        c = self.scfg.cacher
        cached = c.enabled and self.chunk_idx % c.cache_interval != 0
        px = self.vision.device_preprocess(
            torch.as_tensor(pixels).to(self.device, non_blocking=True))
        path = self.vision.cached if cached else self.vision.full
        flat, self._vstate, self._pstate = path(px, self._vstate,
                                                self._pstate)
        flat = flat.to(self.lm.dtype)
        S, exc = self.rekv.block_size, self.rekv.exc_block_size
        if flat.shape[1] % S:
            raise ValueError((flat.shape, S))
        for i in range(0, flat.shape[1], exc):
            self.lm.encode_step(self.rekv, self.kvs, flat[:, i:i + exc],
                                is_init=False)
        self._total_blocks += n_frames
        self.chunk_idx += 1
