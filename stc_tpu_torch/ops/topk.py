"""Top-k with ``jax.lax.top_k``'s tie order, for every top-k of the port.

``lax.top_k`` returns the k largest values in descending order and, among
equal values, the lower index first; it orders floats totally, so +0.0
ranks above -0.0 and a NaN above +inf.  ``torch.topk`` breaks ties in no
stated order (on the CPU it often returns a higher index first), so a
planted tie in logits, block scores, cacher similarities or pruner scores
would pick other integers than ``stc_tpu`` does.  Here every float is
mapped to an integer key of the same total order, and the key is sorted
stably or reduced with ``argmax``, which returns the first maximum.
"""

from __future__ import annotations

import torch

_SIGN_FREE = {torch.int32: 0x7FFFFFFF, torch.int64: 0x7FFFFFFFFFFFFFFF}


def order_key(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor ordered as x is in the float total order (-NaN <
    -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN); integer inputs are
    their own key.  float16 and bfloat16 widen to float32 exactly."""
    if not x.is_floating_point():
        return x
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    bits = x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
    # negative floats: flip every bit but the sign, so larger magnitudes
    # order lower; non-negative floats already order as their bits
    return bits ^ ((bits >> (bits.element_size() * 8 - 1))
                   & _SIGN_FREE[bits.dtype])


def topk_lowest(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest entries along dim, in descending
    order, the lower index first among equal entries: lax.top_k's."""
    idx = torch.sort(order_key(x), dim=dim, descending=True,
                     stable=True).indices.narrow(dim, 0, k)
    return torch.gather(x, dim, idx), idx


def argmax_lowest(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The index of the largest entry along dim in the total order, the
    lowest index among equal ones (topk_lowest's first index)."""
    return order_key(x).argmax(dim=dim)


def top2_lowest(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) int64 indices of topk_lowest(x, 2) over the last dim,
    without sorting the row: argmax, then argmax with the first index set
    to the smallest key."""
    key = order_key(x)
    first = key.argmax(dim=-1, keepdim=True)
    low = torch.iinfo(key.dtype).min
    second = key.scatter(-1, first, low).argmax(dim=-1, keepdim=True)
    return torch.cat([first, second], dim=-1)
