"""Performance instrumentation for streaming sessions.

Per-frame latency percentiles, throughput and KV memory (``Timer``,
``StreamingStats``), and the FLOPs of one call (``estimate_flops``).

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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

# the kernel products of the estimate_flops calls in progress, innermost
# last (one entry each)
_open_counts: List[List[int]] = []


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
