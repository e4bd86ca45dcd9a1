"""LLaVA-OneVision + ReKV (port of ``stc_tpu/models/llava_onevision.py``,
main-path subset): SigLIP tower (with the STC-Cacher) -> projector ->
bilinear 2x pooling -> STC-Pruner -> streaming Qwen2 LM, behind the
streaming-session API.

The vision side (tower, projector, pooling, pruner) computes in
``vision_dtype`` (float32 by default, as the JAX session's); the pruned
features enter the LM in the LM's dtype.  The session config's cacher
variants (``sim_source``, ``k_proxy_rank``) and ``ingest_format`` reach
the tower and the preprocessor.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from stc_tpu_torch.compress.pruner import init_pruner_state, stc_prune
from stc_tpu_torch.config import SessionConfig
from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models import register_model
from stc_tpu_torch.models import siglip as sg
from stc_tpu_torch.runtime.vlm import PixelPipeline, Preprocessor, VLMSession

# SigLIP image preprocessing constants (HF SiglipImageProcessor defaults)
IMAGE_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
IMAGE_STD = np.array([0.5, 0.5, 0.5], np.float32)


@dataclasses.dataclass(frozen=True)
class LlavaOVConfig:
    vision: sg.SiglipConfig = dataclasses.field(
        default_factory=sg.SiglipConfig)
    text: qw.Qwen2Config = dataclasses.field(default_factory=qw.Qwen2Config)

    @property
    def pooled_grid(self) -> int:
        return math.ceil(self.vision.grid / 2)

    @property
    def tokens_per_frame(self) -> int:
        """Visual tokens per frame entering the pruner."""
        return self.pooled_grid ** 2

    @classmethod
    def tiny(cls):
        return cls(vision=sg.SiglipConfig.tiny(), text=qw.Qwen2Config.tiny())


def apply_pooling(feats: torch.Tensor, grid: int) -> torch.Tensor:
    """(F, grid*grid, E) -> (F, ceil(grid/2)^2, E): bilinear, half-pixel
    centres (align_corners=False), no antialias."""
    F_, T, E = feats.shape
    out = math.ceil(grid / 2)
    x = feats.reshape(F_, grid, grid, E).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out, out), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).reshape(F_, out * out, E)


class Projector(nn.Module):
    def __init__(self, c_in: int, c_out: int, dtype, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w1, self.b1 = p(c_in, c_out), p(c_out)
        self.w2, self.b2 = p(c_out, c_out), p(c_out)

    def forward(self, feats):
        h = F.gelu(feats @ self.w1 + self.b1, approximate="none")
        return h @ self.w2 + self.b2


class LlavaOV(nn.Module):
    """The whole model: vision tower + projector (vision_dtype) and the LM
    (dtype).  Weights start zeroed; fill them with init_random_params or
    weights.params_from_jax."""

    def __init__(self, cfg: LlavaOVConfig, dtype=torch.bfloat16,
                 vision_dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision = sg.Siglip(cfg.vision, vision_dtype, device)
        self.projector = Projector(cfg.vision.hidden_size,
                                   cfg.text.hidden_size, vision_dtype, device)
        self.text = qw.Qwen2(cfg.text, dtype, device)

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02) -> "LlavaOV":
        self.vision.init_random_params(generator, scale)
        for w in (self.projector.w1, self.projector.w2):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device) * scale)
        self.projector.b1.zero_()
        self.projector.b2.zero_()
        self.text.init_random_params(generator, scale)
        return self


class LlavaOVVision(PixelPipeline):
    """SigLIP(+STC-Cacher) -> projector -> 2x bilinear pooling ->
    STC-Pruner, for B parallel streams: frames are stream-major on the
    tower's batch axis; the cacher references (L, B, T, C) and the pruner's
    running memory (B, ...) are per stream."""

    def __init__(self, model: LlavaOV, scfg: SessionConfig, batch: int = 1):
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.batch = batch
        self.dtype = model.projector.w1.dtype
        self.device = model.projector.w1.device
        self._pre = Preprocessor(self.cfg.vision.image_size, IMAGE_MEAN,
                                 IMAGE_STD, self.dtype,
                                 ingest=scfg.ingest_format)

    def init_state(self):
        n_sel = int(self.cfg.text.hidden_size
                    * self.scfg.pruner.channel_keep_ratio)
        return (sg.init_cacher_state(self.cfg.vision, self.batch, self.dtype,
                                     device=self.device),
                init_pruner_state(self.batch, n_sel, torch.float32,
                                  device=self.device))

    def select_streams(self, vstate, pstate, old_vstate, old_pstate, mask):
        """Per stream, the new state where mask (B,) is set, else the old:
        cacher references on axis 1, pruner memory on axis 0."""
        def sel(axis):
            def f(n, o):
                shape = [1] * n.dim()
                shape[axis] = mask.shape[0]
                return torch.where(mask.reshape(shape), n, o)
            return f

        return (type(vstate)(*map(sel(1), vstate, old_vstate)),
                type(pstate)(*map(sel(0), pstate, old_pstate)))

    def stream_axes(self):
        return (1, 0)  # cacher refs (L, B, T, C); pruner memory (B, ...)

    def _post(self, feats, pstate):
        B = self.batch
        feats = apply_pooling(self.model.projector(feats),
                              self.cfg.vision.grid)
        BF, T, E = feats.shape
        feats = feats.reshape(B, BF // B, T, E)
        if not self.scfg.pruner.enabled:
            return feats.reshape(B, -1, E), pstate
        pruned, _, pstate = stc_prune(
            feats, pstate,
            keep_per_frame=self.scfg.pruner.token_per_frame,
            channel_keep_ratio=self.scfg.pruner.channel_keep_ratio)
        return pruned.reshape(B, -1, E), pstate

    def full(self, pixels, vstate, pstate):
        feats, vstate = self.model.vision.encode_full(pixels, self.batch)
        flat, pstate = self._post(feats, pstate)
        return flat, vstate, pstate

    def cached(self, pixels, vstate, pstate):
        c = self.scfg.cacher
        feats, _ = self.model.vision.encode_cached(
            pixels, vstate, c.update_token_ratio, self.batch,
            sim_source=c.sim_source, k_proxy_rank=c.k_proxy_rank)
        flat, pstate = self._post(feats, pstate)
        return flat, vstate, pstate


class LlavaOVSession(VLMSession):
    def __init__(self, model: LlavaOV, scfg: SessionConfig,
                 state_dtype=torch.bfloat16, batch: int = 1):
        self.model = model
        super().__init__(model.text, scfg,
                         LlavaOVVision(model, scfg, batch=batch),
                         state_dtype=state_dtype, batch=batch)


def build_session(model: LlavaOV, scfg: SessionConfig,
                  state_dtype=torch.bfloat16, device="cuda",
                  batch: int = 1) -> LlavaOVSession:
    """A pixel session of `batch` streams over `model`, moved to
    `device`."""
    model = model.to(resolve_device(device))
    return LlavaOVSession(model, scfg, state_dtype=state_dtype, batch=batch)


@register_model("llava_ov_7b")
def load_llava_ov_7b(model_path: str, scfg: SessionConfig = None,
                     dtype=torch.bfloat16, vision_dtype=torch.float32,
                     device="cuda"):
    """A session over an HF LLaVA-OneVision checkpoint directory
    (config.json + *.safetensors or *.bin shards), converted tensor by
    tensor onto `device`: the LM in `dtype`, the tower and projector in
    `vision_dtype`, the session state in `dtype`.  Returns (session, cfg)."""
    from stc_tpu_torch.models.convert import (convert_projector,
                                              convert_qwen2, convert_siglip,
                                              find_prefix, load_hf_state,
                                              qwen2_config_from_hf,
                                              read_hf_config)
    device = resolve_device(device)
    hf = read_hf_config(model_path)
    v = hf.vision_config
    vcfg = sg.SiglipConfig(
        hidden_size=v.hidden_size, num_layers=v.num_hidden_layers,
        num_heads=v.num_attention_heads,
        intermediate_size=v.intermediate_size, image_size=v.image_size,
        patch_size=v.patch_size)
    cfg = LlavaOVConfig(vision=vcfg,
                        text=qwen2_config_from_hf(hf.text_config))
    state = load_hf_state(model_path)
    # HF key layouts drift across transformers versions ('model.'-nested in
    # newer releases); probe for the actual prefixes
    vpfx = find_prefix(state, "embeddings.patch_embedding.weight", (
        "vision_tower.vision_model.", "model.vision_tower.vision_model."))
    ppfx = find_prefix(state, "linear_1.weight", (
        "multi_modal_projector.", "model.multi_modal_projector."))
    lpfx = find_prefix(state, "layers.0.self_attn.q_proj.weight", (
        "language_model.model.", "model.language_model.model.",
        "model.language_model."))
    model = LlavaOV(cfg, dtype, vision_dtype, device)
    convert_siglip(state, model.vision, prefix=vpfx)
    convert_projector(state, model.projector, prefix=ppfx)
    convert_qwen2(state, model.text, prefix=lpfx)
    del state
    return build_session(model, scfg or SessionConfig(), state_dtype=dtype,
                         device=device), cfg
