"""Seeded random weights, made on the device in the dtype they are served in.

Every tensor has a checkpoint-style name (the HF layout: matrices are
(out, in)) and is drawn from its own generator, seeded from the run's
seed and the name, so any one tensor can be made again alone: set-up hands
them to the program's own checkpoint converter one at a time
(``LazyState``), and the reference makes each again when it needs it,
layer by layer.  Kinds: ``w`` matrices and embeddings N(0, 1) * 0.02,
``b`` biases N(0, 1) * 0.02, ``n`` norm weights 1 + N(0, 1) * 0.02.  The
draws run in float32 in blocks of at most 2**26 values and are rounded
once to the served dtype.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, Tuple

import torch

SCALE = 0.02
BLOCK = 1 << 26
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Spec = Tuple[Tuple[int, ...], str, str]  # shape, dtype name, kind


def tensor_seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@torch.no_grad()
def make(seed: int, name: str, spec: Spec, device) -> torch.Tensor:
    """The tensor `name` of this seed, on `device`, in its served dtype."""
    shape, dtype, kind = spec
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    out = torch.empty(shape, dtype=DTYPES[dtype], device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), BLOCK):
        n = min(BLOCK, flat.numel() - i)
        x = torch.randn((n,), generator=g, device=device,
                        dtype=torch.float32) * SCALE
        if kind == "n":
            x += 1.0
        flat[i:i + n] = x
    return out


class LazyState(Mapping):
    """A read-only checkpoint state dict whose tensors are made when they
    are read (the program's converters read each once)."""

    def __init__(self, specs: Dict[str, Spec], seed: int, device):
        self.specs, self.seed, self.device = specs, seed, device

    def __getitem__(self, name):
        if name not in self.specs:
            raise KeyError(name)
        return make(self.seed, name, self.specs[name], self.device)

    def __contains__(self, name):
        return name in self.specs

    def __iter__(self):
        return iter(self.specs)

    def __len__(self):
        return len(self.specs)


def _encoder_layers(specs, prefix, n_layers, C, F_, dt):
    for i in range(n_layers):
        p = f"{prefix}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            specs[p + ln + ".weight"] = ((C,), dt, "n")
            specs[p + ln + ".bias"] = ((C,), dt, "b")
        for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs[p + f"self_attn.{m}.weight"] = ((C, C), dt, "w")
            specs[p + f"self_attn.{m}.bias"] = ((C,), dt, "b")
        specs[p + "mlp.fc1.weight"] = ((F_, C), dt, "w")
        specs[p + "mlp.fc1.bias"] = ((F_,), dt, "b")
        specs[p + "mlp.fc2.weight"] = ((C, F_), dt, "w")
        specs[p + "mlp.fc2.bias"] = ((C,), dt, "b")


def qwen2_specs(t: dict, prefix: str, head: str) -> Dict[str, Spec]:
    """The Qwen2 LM's tensors under `prefix` (the head at `head`)."""
    dt = t["dtype"]
    E, F_, V = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
    Hq, Hkv = t["num_attention_heads"], t["num_key_value_heads"]
    D = E // Hq
    specs = {prefix + "embed_tokens.weight": ((V, E), dt, "w"),
             prefix + "norm.weight": ((E,), dt, "n"),
             head: ((V, E), dt, "w")}
    for i in range(t["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        specs[p + "input_layernorm.weight"] = ((E,), dt, "n")
        specs[p + "post_attention_layernorm.weight"] = ((E,), dt, "n")
        for m, n_out in (("q", Hq * D), ("k", Hkv * D), ("v", Hkv * D)):
            specs[p + f"self_attn.{m}_proj.weight"] = ((n_out, E), dt, "w")
            specs[p + f"self_attn.{m}_proj.bias"] = ((n_out,), dt, "b")
        specs[p + "self_attn.o_proj.weight"] = ((E, Hq * D), dt, "w")
        specs[p + "mlp.gate_proj.weight"] = ((F_, E), dt, "w")
        specs[p + "mlp.up_proj.weight"] = ((F_, E), dt, "w")
        specs[p + "mlp.down_proj.weight"] = ((E, F_), dt, "w")
    return specs


def vision_specs(v: dict, prefix: str, kind: str) -> Dict[str, Spec]:
    """A SigLIP ('siglip': patch bias, no class token) or CLIP ('clip':
    class token, pre-layernorm, no patch bias) tower under `prefix`."""
    dt = v["dtype"]
    C, P = v["hidden_size"], v["patch_size"]
    n_tok = (v["image_size"] // P) ** 2 + (kind == "clip")
    specs = {prefix + "embeddings.patch_embedding.weight":
             ((C, 3, P, P), dt, "w"),
             prefix + "embeddings.position_embedding.weight":
             ((n_tok, C), dt, "w"),
             prefix + "post_layernorm.weight": ((C,), dt, "n"),
             prefix + "post_layernorm.bias": ((C,), dt, "b")}
    if kind == "siglip":
        specs[prefix + "embeddings.patch_embedding.bias"] = ((C,), dt, "b")
    else:
        specs[prefix + "embeddings.class_embedding"] = ((C,), dt, "w")
        specs[prefix + "pre_layrnorm.weight"] = ((C,), dt, "n")
        specs[prefix + "pre_layrnorm.bias"] = ((C,), dt, "b")
    _encoder_layers(specs, prefix, v["num_hidden_layers"], C,
                    v["intermediate_size"], dt)
    return specs


def projector_specs(c_in: int, c_out: int, dt: str, names) -> Dict[str,
                                                                   Spec]:
    """A Linear-GELU-Linear projector; names: (first, second) prefixes."""
    a, b = names
    return {a + "weight": ((c_out, c_in), dt, "w"), a + "bias":
            ((c_out,), dt, "b"), b + "weight": ((c_out, c_out), dt, "w"),
            b + "bias": ((c_out,), dt, "b")}
