"""HF checkpoint -> the port's modules (port of ``stc_tpu/models/convert.py``):
Qwen2 / Llama LMs, the SigLIP and CLIP towers, the linear_{1,2} and mlp2x
projectors, and the config helpers of the four backbones.

The converters fill the port's ``nn.Module``s in place, in their (in, out)
layout with q/k/v and gate/up fused, one tensor at a time: each checkpoint
tensor goes from its stored dtype straight to the module's dtype and device
(``copy_`` rounds to nearest even, as ``jnp.asarray(x, dtype)`` does), so a
7B checkpoint never sits in host memory as float32.  The shard reader is the
port's own (``read_safetensors``): it maps the file and views each tensor in
place, and needs no ``safetensors`` package.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import re
import struct
import types
from typing import Dict

import torch

from stc_tpu_torch.models.clip import CLIP, CLIPConfig
from stc_tpu_torch.models.llava_onevision import Projector
from stc_tpu_torch.models.qwen2 import Qwen2, Qwen2Config
from stc_tpu_torch.models.siglip import Siglip

# safetensors dtype names -> torch dtypes: the kinds a checkpoint holds
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                      "F32": torch.float32, "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor}.  The format: an 8-byte
    little-endian header length, a JSON header {name: {dtype, shape,
    data_offsets}} (and an optional "__metadata__"), then the raw bytes.
    The tensors view a copy-on-write map of the file: nothing is read until
    a tensor is used, and nothing is written back."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}; the reader takes "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        start, end = info["data_offsets"]
        shape = info["shape"]
        count = end - start
        item = torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if (base + start) % item:   # a view must start at its item size
            t = torch.frombuffer(bytearray(buf[base + start:base + end]),
                                 dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count // item,
                                 offset=base + start)
        out[name] = t.reshape(shape)
    return out


def load_hf_state(model_path: str) -> Dict[str, torch.Tensor]:
    """Every *.safetensors (preferred) or *.bin shard of a checkpoint
    directory, as one flat {name: CPU tensor}."""
    state = {}
    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if files:
        for f in files:
            state.update(read_safetensors(f))
    else:
        for f in sorted(glob.glob(os.path.join(model_path, "*.bin"))):
            state.update(torch.load(f, map_location="cpu",
                                    weights_only=True))
    if not state:
        raise FileNotFoundError(
            f"no *.safetensors or *.bin checkpoint shards in {model_path}")
    return state


def read_hf_config(model_path: str):
    """config.json -> attribute-accessible namespace (recursively)."""
    def ns(d):
        if isinstance(d, dict):
            return types.SimpleNamespace(**{k: ns(v) for k, v in d.items()})
        return d

    with open(os.path.join(model_path, "config.json")) as f:
        return ns(json.load(f))


def qwen2_config_from_hf(hf_config) -> Qwen2Config:
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    return Qwen2Config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        intermediate_size=hf_config.intermediate_size,
        rope_base=hf_config.rope_theta,
        rms_eps=hf_config.rms_norm_eps,
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
    )


def llama_config_from_hf(hf_config) -> Qwen2Config:
    """A Llama / Vicuna text config -> the decoder config (no qkv bias;
    rope_theta 1e4 and as many KV heads as heads where the config omits
    them)."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    return Qwen2Config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        head_dim=head_dim,
        intermediate_size=hf_config.intermediate_size,
        rope_base=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=hf_config.rms_norm_eps,
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        qkv_bias=False,
    )


def clip_config_from_hf(hf_vision_config) -> CLIPConfig:
    return CLIPConfig(
        hidden_size=hf_vision_config.hidden_size,
        num_layers=hf_vision_config.num_hidden_layers,
        num_heads=hf_vision_config.num_attention_heads,
        intermediate_size=hf_vision_config.intermediate_size,
        image_size=hf_vision_config.image_size,
        patch_size=hf_vision_config.patch_size,
    )


def clip_config_from_state(state, prefix: str, num_heads: int) -> CLIPConfig:
    """CLIP tower dims from the checkpoint's tensor shapes under `prefix`;
    the head count is not recoverable from them and is given (16 for
    CLIP-L)."""
    C, _, P, _ = state[prefix + "embeddings.patch_embedding.weight"].shape
    n_tok = state[prefix + "embeddings.position_embedding.weight"].shape[0]
    grid = int(round((n_tok - 1) ** 0.5))
    inter = state[prefix + "encoder.layers.0.mlp.fc1.weight"].shape[0]
    pat = re.compile(re.escape(prefix) + r"encoder\.layers\.(\d+)\.")
    n_layers = 1 + max(int(m.group(1)) for k in state
                       if (m := pat.match(k)))
    return CLIPConfig(hidden_size=C, num_layers=n_layers,
                      num_heads=num_heads, intermediate_size=inter,
                      image_size=grid * P, patch_size=P)


def find_prefix(state, probe: str, candidates) -> str:
    """First prefix under which `probe` exists (HF key layouts drift across
    transformers versions, e.g. 'language_model.model.' vs
    'model.language_model.')."""
    for c in candidates:
        if c + probe in state:
            return c
    raise KeyError(
        f"none of the prefixes {list(candidates)} holds '{probe}'; sample "
        f"keys: {sorted(state)[:5]}")


def _put(dst: torch.Tensor, src: torch.Tensor, transpose: bool = False):
    """dst <- src (transposed from HF's (out, in)), converted on the way."""
    dst.copy_(src.t() if transpose else src)


@torch.no_grad()
def convert_qwen2(state, lm: Qwen2, prefix: str = "model.") -> Qwen2:
    """Fill `lm` from a HF Qwen2ForCausalLM state dict whose decoder keys
    sit under `prefix` ('model.' for a bare Qwen2ForCausalLM,
    'language_model.model.' or 'model.language_model.' inside
    LLaVA-OneVision).  Absent q/k/v biases become zeros; the head is
    embed^T when the config ties them or the checkpoint has no head."""
    c = lm.cfg
    Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    split = {"q": (0, Hq * D), "k": (Hq * D, (Hq + Hkv) * D),
             "v": ((Hq + Hkv) * D, (Hq + 2 * Hkv) * D)}
    F_ = c.intermediate_size
    for i, lp in enumerate(lm.layers):
        pre = f"{prefix}layers.{i}."
        _put(lp.ln1, state[pre + "input_layernorm.weight"])
        _put(lp.ln2, state[pre + "post_attention_layernorm.weight"])
        for n, (a, b) in split.items():
            _put(lp.wqkv[:, a:b], state[pre + f"self_attn.{n}_proj.weight"],
                 True)
            bias = state.get(pre + f"self_attn.{n}_proj.bias")
            if bias is None:
                lp.bqkv[a:b].zero_()
            else:
                _put(lp.bqkv[a:b], bias)
        _put(lp.wo, state[pre + "self_attn.o_proj.weight"], True)
        _put(lp.w_gateup[:, :F_], state[pre + "mlp.gate_proj.weight"], True)
        _put(lp.w_gateup[:, F_:], state[pre + "mlp.up_proj.weight"], True)
        _put(lp.w_down, state[pre + "mlp.down_proj.weight"], True)
    embed = state[prefix + "embed_tokens.weight"]
    _put(lm.embed, embed)
    _put(lm.norm_f, state[prefix + "norm.weight"])
    # lm_head sits one level above the decoder ('lm_head.weight' for
    # 'model.*', 'language_model.lm_head.weight' for 'language_model.model.*',
    # top-level again for the newer 'model.language_model.*' layout)
    heads = ["lm_head.weight"]
    if prefix.endswith("model."):
        heads.insert(0, prefix[:-len("model.")] + "lm_head.weight")
    head = next((k for k in heads if k in state), None)
    _put(lm.lm_head, embed if c.tie_embeddings or head is None
         else state[head], True)
    return lm


# encoder-layer parameters of the SigLIP and CLIP towers: HF name under
# encoder.layers.<i>., and whether it is an (out, in) matrix to transpose
ENCODER_LAYER_KEYS = {
    "ln1_w": ("layer_norm1.weight", False),
    "ln1_b": ("layer_norm1.bias", False),
    "wq": ("self_attn.q_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "wk": ("self_attn.k_proj.weight", True),
    "bk": ("self_attn.k_proj.bias", False),
    "wv": ("self_attn.v_proj.weight", True),
    "bv": ("self_attn.v_proj.bias", False),
    "wo": ("self_attn.out_proj.weight", True),
    "bo": ("self_attn.out_proj.bias", False),
    "ln2_w": ("layer_norm2.weight", False),
    "ln2_b": ("layer_norm2.bias", False),
    "fc1": ("mlp.fc1.weight", True),
    "fc1_b": ("mlp.fc1.bias", False),
    "fc2": ("mlp.fc2.weight", True),
    "fc2_b": ("mlp.fc2.bias", False)}


def _put_encoder_layers(state, tower, prefix: str) -> None:
    for i, lp in enumerate(tower.layers):
        for name, (key, tr) in ENCODER_LAYER_KEYS.items():
            _put(getattr(lp, name),
                 state[f"{prefix}encoder.layers.{i}.{key}"], tr)


@torch.no_grad()
def convert_siglip(state, tower: Siglip,
                   prefix: str = "vision_tower.vision_model.") -> Siglip:
    """Fill `tower` from a HF SiglipVisionModel state dict: the patch conv
    (C, 3, P, P) becomes the (3·P·P, C) matrix of patch_embed; the post-LN
    is filled but not applied (the features are the last encoder layer's,
    as LLaVA-OV's vision_feature_layer=-1 takes them)."""
    patch = state[prefix + "embeddings.patch_embedding.weight"]
    _put(tower.patch_w, patch.reshape(patch.shape[0], -1), True)
    _put(tower.patch_b, state[prefix + "embeddings.patch_embedding.bias"])
    _put(tower.pos_embed,
         state[prefix + "embeddings.position_embedding.weight"])
    _put_encoder_layers(state, tower, prefix)
    _put(tower.post_ln_w, state[prefix + "post_layernorm.weight"])
    _put(tower.post_ln_b, state[prefix + "post_layernorm.bias"])
    return tower


@torch.no_grad()
def convert_clip(state, tower: CLIP, prefix: str = "vision_model.") -> CLIP:
    """Fill `tower` from a HF CLIPVisionModel state dict under `prefix`
    (LongVA and Flash-VStream: model.vision_tower.vision_tower.
    vision_model.*, Video-LLaVA: video_tower.vision_model.*): the patch
    conv (C, 3, P, P), which has no bias, becomes the (3·P·P, C) matrix;
    the pre-layernorm is read under HF's 'pre_layrnorm' spelling or
    'pre_layernorm'; the post-LN is filled but not applied."""
    patch = state[prefix + "embeddings.patch_embedding.weight"]
    _put(tower.patch_w, patch.reshape(patch.shape[0], -1), True)
    _put(tower.class_embed,
         state[prefix + "embeddings.class_embedding"].reshape(-1))
    _put(tower.pos_embed,
         state[prefix + "embeddings.position_embedding.weight"])
    pre = ("pre_layrnorm" if prefix + "pre_layrnorm.weight" in state
           else "pre_layernorm")
    _put(tower.pre_ln_w, state[f"{prefix}{pre}.weight"])
    _put(tower.pre_ln_b, state[f"{prefix}{pre}.bias"])
    _put_encoder_layers(state, tower, prefix)
    _put(tower.post_ln_w, state[prefix + "post_layernorm.weight"])
    _put(tower.post_ln_b, state[prefix + "post_layernorm.bias"])
    return tower


@torch.no_grad()
def convert_projector(state, proj: Projector,
                      prefix: str = "multi_modal_projector.") -> Projector:
    _put(proj.w1, state[prefix + "linear_1.weight"], True)
    _put(proj.b1, state[prefix + "linear_1.bias"])
    _put(proj.w2, state[prefix + "linear_2.weight"], True)
    _put(proj.b2, state[prefix + "linear_2.bias"])
    return proj


@torch.no_grad()
def convert_mlp2x(state, proj: Projector,
                  prefix: str = "model.mm_projector.") -> Projector:
    """The mlp2x_gelu projector (LongVA's and Flash-VStream's mm_projector,
    a Sequential(Linear, GELU, Linear): keys 0.* and 2.*)."""
    _put(proj.w1, state[prefix + "0.weight"], True)
    _put(proj.b1, state[prefix + "0.bias"])
    _put(proj.w2, state[prefix + "2.weight"], True)
    _put(proj.b2, state[prefix + "2.bias"])
    return proj
