"""Pipeline-parallel streaming LM (port of ``stc_tpu/parallel/pipeline.py``).

Each pp stage holds num_layers / pp consecutive layers of the LM with their
KV pages and decode cache; the embedding, final norm and head replicate (as
in the JAX package).  One pass of the LM is a stage relay (``pipe``): stage
0 runs its layers on the embeddings and sends the (B, T, E) hidden state to
stage 1, and so on; where the pass ends in logits (the prompt prefill and
every decoded token) the last stage broadcasts its output over pp, so the
final norm, the head and the token pick run the same on every stage and the
greedy loop, its stop flag included, stays in lockstep.

A session's streaming append under pp is ``pp_encode_step``: its T tokens
go through the stages as exc_block_size-token microbatches, each a relay.
The ranks are processes, so stage s works on microbatch m while stage
s + 1 works on microbatch m - 1 (GPipe), and the result is that of the
sequential appends.  Bubble ticks are simply not run: a tp group lies
inside one stage, so no stage waits on a collective of a stage that
idles.  (The JAX package's ``_mask_bubbles`` runs every layer on every
tick to keep GSPMD's collectives in step, and its ``_zero_safe_kv``
exists for shard_map's checks; neither applies.)  The init prompt and
the question's passes are single relays of ``Qwen2.encode_step`` and
``Qwen2.answer_question``.

Refused under pp, as in the JAX package: speculative decode and host-tier
eviction (runtime/session.py), and, here, the layerwise QA of the
host-side block scorers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from stc_tpu_torch.parallel.mesh import Axis


def stage_layers(num_layers: int, pp: Axis) -> range:
    """The global indices of the layers stage pp.rank holds."""
    if num_layers % pp.size:
        raise ValueError(f"{num_layers} layers do not split over "
                         f"pp={pp.size}")
    n = num_layers // pp.size
    return range(pp.rank * n, (pp.rank + 1) * n)


def keep_stage_layers(lm, pp: Axis) -> None:
    """Drop the layers of other stages from a Qwen2 (pp_layer_specs: the
    layer axis splits over pp)."""
    keep = stage_layers(len(lm.layers), pp)
    lm.layers = nn.ModuleList(lm.layers[i] for i in keep)
    lm.layer_offset = keep.start


def pipe(pp: Optional[Axis], local_fn: Callable, h: torch.Tensor, *,
         replicate: bool) -> torch.Tensor:
    """One stage relay: stage 0 applies local_fn to h, every later stage to
    what the stage before it sends; with `replicate` every stage returns
    the last stage's output (one broadcast), else only the last stage's
    return value is the pass's output."""
    if pp is None:
        return local_fn(h)
    s, n = pp.rank, pp.size
    if s > 0:
        h = pp.recv(h, s - 1, site="pp.hop")
    h = local_fn(h)
    if s < n - 1:
        pp.send(h, s + 1, site="pp.hop")
    if replicate:
        h = pp.broadcast(h, n - 1, site="pp.out")
    return h


@torch.no_grad()
def pp_encode_step(lm, rekv, kvs, embeds: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One streaming append of embeds (B, T, E), T whole pages, as
    ceil(T / exc_block_size) microbatches of exc_block_size tokens (the
    last one the remainder), each relayed over the stages; kvs (this
    stage's layers) is updated in place: the state of the sequential
    exc_block_size-token appends.  Returns this stage's output hidden
    states (B, T, E): on the last stage the pass's output."""
    T, exc = embeds.shape[1], rekv.exc_block_size
    if T % rekv.block_size:
        raise ValueError(f"an append of {T} tokens is not whole pages of "
                         f"{rekv.block_size}")
    return torch.cat([lm.encode_step(rekv, kvs, embeds[:, i:i + exc],
                                     is_init=False, active=active)[0]
                      for i in range(0, T, exc)], dim=1)
