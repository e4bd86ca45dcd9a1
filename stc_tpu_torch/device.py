"""Device selection for the port's entry points.

Every public constructor takes ``device="cuda"`` by default.  Without a card
it raises; the CPU runs only when the caller asks for it (the tests do).
"meta" builds a module's shapes without memory, to shard it before it is
allocated (``parallel.sharding.shard_module``, then ``Module.to_empty``).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stc_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
