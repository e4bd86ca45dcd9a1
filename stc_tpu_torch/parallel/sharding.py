"""Tensor-parallel layouts of the port's modules (port of
``stc_tpu/parallel/sharding.py``).

A spec says which axis of a tensor splits over tp, and of which fused parts
it is made: ``Split(-1, (Hq, Hkv, Hkv))`` is the output axis of the fused
wqkv, whose q, k and v parts each split evenly by heads, so that a rank
holds [q heads | k heads | v heads] of its own and splits them at its own
offsets.  (An even split of the concatenation, which is what the JAX specs
write and GSPMD reshards around, would give rank 0 all the q heads.)
``None`` replicates.  Megatron layout: q/k/v, gate/up, fc1 and the
projector's first matrix are column-parallel, wo, w_down, fc2 and its
second row-parallel, with one all_reduce after each row-parallel product
(models/qwen2.py, models/siglip.py, models/llava_onevision.py).

int8 layouts: the `_q` weights split like their float matrices, the
per-channel `_s` scales follow the output axis (so the row-parallel
`wo_s` / `w_down_s` replicate), the `_gs` group scales (in/G, out) follow
the matrix's input or output axis, and G must divide each shard of a
row-parallel input.  Quantize the whole module first, then shard: a
row-parallel weight's per-channel scale is a maximum over all its rows.

``shard_module`` keeps this rank's slice of every tensor of a module in
place and sets the module's axes; ``init_random`` fills a module (sharded
or not) with seeded random weights drawn tensor by tensor at full size, so
that every layout holds slices of the same weights.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import torch
from torch import nn

from stc_tpu_torch.parallel.mesh import Axis, Mesh


@dataclasses.dataclass(frozen=True)
class Split:
    axis: int
    parts: Tuple[int, ...] = (1,)


COL = Split(-1)
ROW = Split(0)


def qwen2_param_specs(cfg) -> dict:
    """Leaf name -> Split or None for every tensor a Qwen2 may hold (plain,
    fused, int8 per channel and int8_gN)."""
    qkv = Split(-1, (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    gu = Split(-1, (1, 1))
    specs = {"ln1": None, "ln2": None, "wqkv": qkv, "bqkv": qkv, "wo": ROW,
             "w_gateup": gu, "w_down": ROW,
             "embed": None, "embed_q": None, "embed_s": None,
             "norm_f": None, "lm_head": COL, "lm_head_q": COL,
             "lm_head_s": COL, "lm_head_gs": COL}
    for name, s in (("wqkv", qkv), ("w_gateup", gu)):
        specs.update({name + "_q": s, name + "_s": s, name + "_gs": s})
    for name in ("wo", "w_down"):
        specs.update({name + "_q": ROW, name + "_s": None, name + "_gs": ROW})
    return specs


def siglip_param_specs() -> dict:
    """Attention projections over heads on the output axis, the MLP over
    its hidden; norms, patch and position embeddings replicate."""
    return {"patch_w": None, "patch_b": None, "pos_embed": None,
            "ln1_w": None, "ln1_b": None, "wq": COL, "bq": COL, "wk": COL,
            "bk": COL, "wv": COL, "bv": COL, "wo": ROW, "bo": None,
            "ln2_w": None, "ln2_b": None, "fc1": COL, "fc1_b": COL,
            "fc2": ROW, "fc2_b": None, "post_ln_w": None,
            "post_ln_b": None}


def projector_param_specs() -> dict:
    """Column- then row-parallel: one all_reduce."""
    return {"w1": COL, "b1": COL, "w2": ROW, "b2": None}


def stream_kv_specs() -> dict:
    """How the stream state (StreamKV leaves, each with a leading layer
    axis) lies over the mesh: its batch axis over dp (each rank builds
    batch / dp streams), its kv-head axis over tp (each rank builds its
    Hkv / tp heads); page_keep and the counters replicate over tp.  The
    state is built at its local shape, never sliced."""
    return {"init_k": ("dp", "tp"), "init_v": ("dp", "tp"),
            "block_k": ("dp", "tp"), "block_v": ("dp", "tp"),
            "block_k_scale": ("dp", "tp"), "block_v_scale": ("dp", "tp"),
            "block_rep": ("dp", None, "tp"), "page_keep": ("dp",),
            "num_blocks": ("dp",), "page_offset": ("dp",),
            "length": ("dp",)}


def decode_kv_specs() -> dict:
    return {"k": ("dp", "tp"), "v": ("dp", "tp"), "cursor": ("dp",)}


def shard_vision_sp(pixels: torch.Tensor, n_streams: int,
                    sp: Axis) -> torch.Tensor:
    """This sp rank's frames of a chunk's stream-major (B * F, ...) pixels:
    frames r * F/sp .. (r+1) * F/sp of each stream.  A chunk whose F does
    not divide by sp stays whole on every sp rank.  The cacher references
    stay per stream; the last sp rank computes them and broadcasts them
    (models/llava_onevision.LlavaOVVision)."""
    F_ = pixels.shape[0] // n_streams
    if sp.size == 1 or F_ % sp.size:
        return pixels
    f = F_ // sp.size
    x = pixels.reshape((n_streams, F_) + tuple(pixels.shape[1:]))
    x = x[:, sp.rank * f:(sp.rank + 1) * f]
    return x.reshape((n_streams * f,) + tuple(pixels.shape[1:]))


# --------------------------------------------------------------------------
def shard_tensor(x: torch.Tensor, spec: Optional[Split], rank: int,
                 size: int) -> torch.Tensor:
    """This rank's slice of the full tensor x (x itself when replicated)."""
    if spec is None or size == 1:
        return x
    axis = spec.axis % x.dim()
    n = x.shape[axis]
    unit = n // sum(spec.parts)
    if unit * sum(spec.parts) != n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} is not made of "
                         f"parts {spec.parts}")
    out, at = [], 0
    for p in spec.parts:
        w = p * unit
        if w % size:
            raise ValueError(f"a part of {w} on axis {axis} of "
                             f"{tuple(x.shape)} does not split {size} ways")
        s = w // size
        out.append(x.narrow(axis, at + rank * s, s))
        at += w
    return out[0] if len(out) == 1 else torch.cat(out, dim=axis)


def full_shape(shape, spec: Optional[Split], size: int) -> tuple:
    shape = list(shape)
    if spec is not None:
        shape[spec.axis % len(shape)] *= size
    return tuple(shape)


def _specs_for(module) -> dict:
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg
    if isinstance(module, qw.Qwen2):
        return qwen2_param_specs(module.full_cfg)
    if isinstance(module, sg.Siglip):
        return siglip_param_specs()
    if isinstance(module, lo.Projector):
        return projector_param_specs()
    raise TypeError(f"no tp layout for {type(module).__name__}")


def _tensors(module: nn.Module):
    """(owner module, leaf name, tensor, is_parameter) of every tensor."""
    for mname, mod in module.named_modules():
        for leaf, p in list(mod._parameters.items()):
            if p is not None:
                yield mname, mod, leaf, p, True
        for leaf, b in list(mod._buffers.items()):
            if b is not None:
                yield mname, mod, leaf, b, False


def _put(mod, leaf, value, is_param):
    if is_param:
        mod._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    else:
        mod._buffers[leaf] = value


def _parts(module) -> list:
    """The tp-shardable parts of a model: (module, its specs)."""
    from stc_tpu_torch.models import llava_onevision as lo
    if isinstance(module, lo.LlavaOV):
        return [module.vision, module.projector, module.text]
    return [module]


@torch.no_grad()
def shard_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's slice of every tensor of `module` (a Qwen2, a
    Siglip, a Projector or a LlavaOV), in place, and set the axes its
    collectives use.  A Qwen2 on a mesh with a pp axis also keeps only its
    stage's layers (parallel/pipeline.py); on an sp axis its appends split
    their tokens.  A module is sharded once."""
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.parallel import pipeline
    tp = mesh.axis("tp")
    for part in _parts(module):
        if getattr(part, "mesh", None) is not None:
            raise ValueError(f"{type(part).__name__} is already sharded")
        if isinstance(part, qw.Qwen2):
            _check_qwen2(part.cfg, tp.size)
            if mesh.size_of("pp") > 1:
                pipeline.keep_stage_layers(part, mesh.axis("pp"))
        specs = _specs_for(part)
        if tp.size > 1:
            for _, mod, leaf, t, is_param in _tensors(part):
                _put(mod, leaf, shard_tensor(t, specs[leaf], tp.rank,
                                             tp.size).clone(), is_param)
        part.set_mesh(mesh)
    return module


def _check_qwen2(cfg, tp: int):
    for name in ("num_heads", "num_kv_heads", "intermediate_size",
                 "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"Qwen2 {name}={getattr(cfg, name)} does not "
                             f"split over tp={tp}")


INIT_ONES = ("ln1", "ln2", "norm_f", "ln1_w", "ln2_w", "post_ln_w")


@torch.no_grad()
def init_random(module: nn.Module, seed: int,
                scale: float = 0.02) -> nn.Module:
    """Seeded random weights, identical in every layout: each tensor is
    drawn at its full (unsharded) shape from its own generator, seeded by
    `seed` and the tensor's name (with the model's global layer index), on
    the module's device, and the module keeps its slice.  Matrices are
    N(0, 1) * scale, norms one, biases zero.  Tensor by tensor, so the
    peak above the module is one full tensor's draw."""
    from stc_tpu_torch.models import qwen2 as qw
    for part, prefix in _named_parts(module):
        tp = getattr(part, "tp", None)
        r, n = (0, 1) if tp is None else (tp.rank, tp.size)
        specs = _specs_for(part)
        off = part.layer_offset if isinstance(part, qw.Qwen2) else 0
        for mname, mod, leaf, t, _ in _tensors(part):
            name = prefix + _global_name(mname, off) + leaf
            if leaf in INIT_ONES:
                t.fill_(1.0)
                continue
            if t.dim() < 2 or not t.is_floating_point():
                t.zero_()
                continue
            spec = specs[leaf]
            g = torch.Generator(device=t.device).manual_seed(
                seed * 1_000_003 + zlib.crc32(name.encode()))
            full = torch.randn(full_shape(t.shape, spec, n), generator=g,
                               device=t.device, dtype=torch.float32)
            t.copy_(shard_tensor(full, spec, r, n) * scale)
            del full
    return module


def _named_parts(module):
    from stc_tpu_torch.models import llava_onevision as lo
    if isinstance(module, lo.LlavaOV):
        return [(module.vision, "vision."), (module.projector, "projector."),
                (module.text, "text.")]
    return [(module, "")]


def _global_name(mname: str, layer_offset: int) -> str:
    """'layers.3' of a stage whose first layer is the model's 14th ->
    'layers.17.'."""
    if not mname:
        return ""
    parts = mname.split(".")
    if parts[0] == "layers" and len(parts) > 1:
        parts[1] = str(int(parts[1]) + layer_offset)
    return ".".join(parts) + "."
