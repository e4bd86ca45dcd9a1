"""Load the JAX package's parameter trees into the port's modules.

The JAX package keeps its weights as nested dicts of arrays with the layers
stacked on axis 0 and matrices in (in, out) layout.  Given such a tree as
numpy arrays (for example ``jax.tree.map(np.asarray, params)``), these
functions fill the port's modules with the same numbers, so that both
packages compute the same function.  Only numpy is needed here.  Given a
mesh (parallel/mesh.py), the module keeps this rank's slice of every
tensor (parallel/sharding.shard_module): a JAX tree becomes one rank's
sharded module.
"""

from __future__ import annotations

import numpy as np
import torch

from stc_tpu_torch.models import clip as cl
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import longva as lv
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models import siglip as sg
from stc_tpu_torch.parallel import sharding


def _t(x) -> torch.Tensor:
    # float32 first: numpy has no bfloat16 of its own (ml_dtypes' converts)
    return torch.from_numpy(np.array(x, np.float32))


@torch.no_grad()
def qwen2_from_jax(tree, cfg: qw.Qwen2Config, dtype=torch.float32,
                   device="cuda", mesh=None) -> qw.Qwen2:
    """Unfused JAX Qwen2 params (wq/wk/wv, w_gate/w_up) -> Qwen2 with the
    fused wqkv / w_gateup (the same weights, concatenated); a tree of
    qwen2.quantize_params_int8 -> a Qwen2 on the same int8 weights and
    scales; with a mesh, this rank's part of it."""
    return _sharded(_fill_qwen2(qw.Qwen2(cfg, dtype, device), tree), mesh)


def _sharded(module, mesh):
    return module if mesh is None else sharding.shard_module(module, mesh)


def _fill_qwen2(lm: qw.Qwen2, tree) -> qw.Qwen2:
    if "embed_q" in tree:
        return _fill_qwen2_int8(lm, tree)
    lm.embed.copy_(_t(tree["embed"]))
    lm.norm_f.copy_(_t(tree["norm_f"]))
    lm.lm_head.copy_(_t(tree["lm_head"]))
    L = tree["layers"]
    for i, lp in enumerate(lm.layers):
        lp.ln1.copy_(_t(L["ln1"][i]))
        lp.ln2.copy_(_t(L["ln2"][i]))
        lp.wqkv.copy_(torch.cat([_t(L[n][i]) for n in ("wq", "wk", "wv")],
                                dim=-1))
        lp.bqkv.copy_(torch.cat([_t(L[n][i]) for n in ("bq", "bk", "bv")],
                                dim=-1))
        lp.wo.copy_(_t(L["wo"][i]))
        lp.w_gateup.copy_(torch.cat([_t(L["w_gate"][i]), _t(L["w_up"][i])],
                                    dim=-1))
        lp.w_down.copy_(_t(L["w_down"][i]))
    return lm


def _fill_qwen2_int8(lm: qw.Qwen2, tree) -> qw.Qwen2:
    """A tree of stc_tpu's quantize_params_int8 (fused, `*_q` int8 with
    `*_s` or `*_gs` scales, `embed_q` / `embed_s`): quantize the module
    first, which lays out the same buffers, then copy the tree's values
    in (int8 values are exact in float32)."""
    L = tree["layers"]
    gs = L.get("wqkv_gs")
    lm.quantize_int8(0 if gs is None else
                     lm.cfg.hidden_size // np.shape(gs)[-2])
    for name in ("embed_q", "embed_s", "norm_f", "lm_head_q", "lm_head_s",
                 "lm_head_gs"):
        if name in tree:
            getattr(lm, name).copy_(_t(tree[name]))
    for i, lp in enumerate(lm.layers):
        for name, arr in L.items():
            getattr(lp, name).copy_(_t(arr[i]))
    return lm


@torch.no_grad()
def siglip_from_jax(tree, cfg: sg.SiglipConfig, dtype=torch.float32,
                    device="cuda", mesh=None) -> sg.Siglip:
    return _sharded(_fill_siglip(sg.Siglip(cfg, dtype, device), tree), mesh)


def _fill_siglip(tower: sg.Siglip, tree) -> sg.Siglip:
    for name in ("patch_w", "patch_b", "pos_embed", "post_ln_w",
                 "post_ln_b"):
        getattr(tower, name).copy_(_t(tree[name]))
    for i, lp in enumerate(tower.layers):
        for name, arr in tree["layers"].items():
            getattr(lp, name).copy_(_t(arr[i]))
    return tower


@torch.no_grad()
def params_from_jax(tree, cfg: lo.LlavaOVConfig, dtype=torch.float32,
                    vision_dtype=torch.float32, device="cuda",
                    mesh=None) -> lo.LlavaOV:
    """A JAX LLaVA-OV tree {"vision", "projector", "text"} -> LlavaOV (with
    a mesh, this rank's part of it)."""
    model = lo.LlavaOV(cfg, dtype, vision_dtype, device)
    _fill_siglip(model.vision, tree["vision"])
    for name in ("w1", "b1", "w2", "b2"):
        getattr(model.projector, name).copy_(_t(tree["projector"][name]))
    _fill_qwen2(model.text, tree["text"])
    return _sharded(model, mesh)


@torch.no_grad()
def clip_from_jax(tree, cfg: cl.CLIPConfig, dtype=torch.float32,
                  device="cuda") -> cl.CLIP:
    return _fill_clip(cl.CLIP(cfg, dtype, device), tree)


def _fill_clip(tower: cl.CLIP, tree) -> cl.CLIP:
    for name in ("class_embed", "patch_w", "pos_embed", "pre_ln_w",
                 "pre_ln_b", "post_ln_w", "post_ln_b"):
        getattr(tower, name).copy_(_t(tree[name]))
    for i, lp in enumerate(tower.layers):
        for name, arr in tree["layers"].items():
            getattr(lp, name).copy_(_t(arr[i]))
    return tower


@torch.no_grad()
def backbone_from_jax(tree, cfg, dtype=torch.float32,
                      vision_dtype=torch.float32,
                      device="cuda") -> lv.ClipVLM:
    """A JAX LongVA, Video-LLaVA or Flash-VStream tree {"vision",
    "projector", "text"} -> the port's ClipVLM of cfg."""
    model = lv.ClipVLM(cfg, dtype, vision_dtype, device)
    _fill_clip(model.vision, tree["vision"])
    for name in ("w1", "b1", "w2", "b2"):
        getattr(model.projector, name).copy_(_t(tree["projector"][name]))
    _fill_qwen2(model.text, tree["text"])
    return model
