"""Host frame library: ctypes bindings of ``csrc/frameproc.cpp`` (a copy of
the JAX package's native frame library), built with g++ at first use
(``kernels/_build.load_host``).

- ``preprocess_frames``: (n, h, w, 3) uint8 -> (n, 3, S, S) float32,
  half-pixel bilinear resize, normalised, channels first, on host threads;
- ``rgb_to_yuv420``: (n, h, w, 3) uint8 RGB -> (n, h*w*3//2) uint8 packed
  planar BT.601 full-range 4:2:0 (2x2 chroma average), half the bytes of
  RGB; ``_rgb_to_yuv420_np`` is its bit-identical numpy twin.

Without g++ the library cannot be built and these functions raise: there
is no quiet fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from stc_tpu_torch.kernels import _build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def get_lib() -> ctypes.CDLL:
    """The frame library, built and bound on first use."""
    lib = _build.load_host("frameproc")
    if lib.stc_preprocess_frames.argtypes is None:
        lib.stc_preprocess_frames.restype = ctypes.c_int
        lib.stc_preprocess_frames.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P,
            ctypes.c_int, _F32P, _F32P, ctypes.c_int]
        lib.stc_rgb_to_yuv420.restype = ctypes.c_int
        lib.stc_rgb_to_yuv420.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
            ctypes.c_int]
    return lib


def _threads(n_threads: Optional[int]) -> int:
    return n_threads if n_threads is not None else min(8,
                                                       os.cpu_count() or 1)


def preprocess_frames(frames: np.ndarray, out_hw: int, mean, std,
                      n_threads: Optional[int] = None) -> np.ndarray:
    """(n, h, w, 3) uint8 -> (n, 3, out_hw, out_hw) float32: half-pixel
    bilinear resize, (x / 255 - mean) / std, channels first."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"RGB frames expected, got {frames.shape}")
    out = np.empty((n, 3, out_hw, out_hw), dtype=np.float32)
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    rc = get_lib().stc_preprocess_frames(
        frames.ctypes.data_as(_U8P), n, h, w, out.ctypes.data_as(_F32P),
        out_hw, mean.ctypes.data_as(_F32P), std.ctypes.data_as(_F32P),
        _threads(n_threads))
    if rc != 0:
        raise ValueError(f"stc_preprocess_frames refused {frames.shape}")
    return out


def _rgb_to_yuv420_np(frames: np.ndarray) -> np.ndarray:
    """numpy twin of stc_rgb_to_yuv420, bit-identical: the same x256
    fixed-point coefficients and rounding."""
    n, h, w, _ = frames.shape
    f = frames.astype(np.int32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    u = (-43 * r - 85 * g + 128 * b + 32768 + 128) >> 8
    v = (128 * r - 107 * g - 21 * b + 32768 + 128) >> 8

    def sub(c):  # 2x2 chroma average: the four values' sum, +2 rounding
        c = c.reshape(n, h // 2, 2, w // 2, 2)
        return (c.sum(axis=(2, 4)) + 2) >> 2

    return np.concatenate(
        [y.reshape(n, -1), sub(u).reshape(n, -1), sub(v).reshape(n, -1)],
        axis=1).astype(np.uint8)


def rgb_to_yuv420(frames: np.ndarray,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """(n, h, w, 3) uint8 RGB -> (n, h*w*3//2) uint8 packed planar YUV
    4:2:0 (BT.601 full range, 2x2 chroma average): half the
    host-to-device bytes of RGB.  h and w must be even."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, c = frames.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"RGB frames of even height and width expected, "
                         f"got {frames.shape}")
    out = np.empty((n, h * w * 3 // 2), dtype=np.uint8)
    rc = get_lib().stc_rgb_to_yuv420(
        frames.ctypes.data_as(_U8P), n, h, w, out.ctypes.data_as(_U8P),
        _threads(n_threads))
    if rc != 0:
        raise ValueError(f"stc_rgb_to_yuv420 refused {frames.shape}")
    return out
