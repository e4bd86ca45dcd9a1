"""LongVA-7B + ReKV (port of ``stc_tpu/models/longva.py``): CLIP-L/14-336
tower (with the token-level MLP-skip cacher, models/clip.py) -> mlp2x_gelu
projector -> 2x2 average pooling (576 -> 144 tokens a frame) -> streaming
Qwen2 LM, behind the streaming-session API.  Defaults: n_local 8000, topk
32, 144-token blocks, cacher interval 2 with a SKIP ratio of 0.8 (80% of
a cached chunk's tokens skip the MLP), no pruning.

The tower and projector compute in ``vision_dtype`` (float32 by default);
the pooled features enter the LM in its dtype.  Video-LLaVA and
Flash-VStream reuse this module's model and pipeline with their own
post-processing (models/video_llava.py, models/flash_vstream.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.models import clip as cl
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models import register_model
from stc_tpu_torch.models.llava_onevision import Projector
from stc_tpu_torch.runtime.vlm import PixelPipeline, Preprocessor, VLMSession

# OpenAI CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class LongVAConfig:
    vision: cl.CLIPConfig = dataclasses.field(default_factory=cl.CLIPConfig)
    text: qw.Qwen2Config = dataclasses.field(default_factory=qw.Qwen2Config)
    pool_stride: int = 2

    @property
    def tokens_per_frame(self) -> int:
        return (self.vision.grid // self.pool_stride) ** 2  # 144

    @classmethod
    def tiny(cls):
        return cls(vision=cl.CLIPConfig.tiny(), text=qw.Qwen2Config.tiny())


def default_session_config(cfg: LongVAConfig) -> SessionConfig:
    tpf = cfg.tokens_per_frame
    return SessionConfig(
        rekv=ReKVConfig(n_init=14, n_local=8000, block_size=tpf,
                        exc_block_size=tpf, topk=32, chunk_size=1,
                        max_blocks=512),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.8,
                            cache_interval=2),
        # LongVA keeps all 144 pooled tokens (no STC pruning)
        pruner=PrunerConfig(strategy="none", token_per_frame=tpf,
                            model_spec="clip"),
    )


def avg_pool_2d(feats: torch.Tensor, grid: int, stride: int) -> torch.Tensor:
    """(F, grid*grid, C) -> (F, (grid/s)^2, C) by average pooling."""
    F_, T, C = feats.shape
    g2 = grid // stride
    x = feats.reshape(F_, g2, stride, g2, stride, C)
    return x.mean(dim=(2, 4)).reshape(F_, g2 * g2, C)


class ClipVLM(nn.Module):
    """The model of all three CLIP backbones (LongVA, Video-LLaVA,
    Flash-VStream; their configs have .vision, a CLIPConfig, and .text):
    the CLIP tower and the projector in vision_dtype, the LM in dtype.
    The projector is LLaVA-OV's ``Projector``: Linear, exact GELU, Linear,
    the mlp2x_gelu projector (the JAX package's project_mlp2x) and
    Video-LLaVA's linear_1 / linear_2 alike.  Weights start zeroed; fill
    them with init_random_params, weights.backbone_from_jax or a loader."""

    def __init__(self, cfg, dtype=torch.bfloat16,
                 vision_dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision = cl.CLIP(cfg.vision, vision_dtype, device)
        self.projector = Projector(cfg.vision.hidden_size,
                                   cfg.text.hidden_size, vision_dtype, device)
        self.text = qw.Qwen2(cfg.text, dtype, device)

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02):
        self.vision.init_random_params(generator, scale)
        for w in (self.projector.w1, self.projector.w2):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device) * scale)
        self.projector.b1.zero_()
        self.projector.b2.zero_()
        self.text.init_random_params(generator, scale)
        return self


class LongVAVision(cl.ClipStreamsMixin, PixelPipeline):
    """CLIP (+ MLP-skip cacher) -> projector -> 2x2 average pooling, for
    B parallel streams (frames stream-major on the tower's batch axis).
    The cached path passes the cacher's update_token_ratio to the tower
    as its skip ratio."""

    def __init__(self, model: ClipVLM, scfg: SessionConfig, batch: int = 1):
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.batch = batch
        self.dtype = model.projector.w1.dtype
        self.device = model.projector.w1.device
        self._pre = Preprocessor(self.cfg.vision.image_size, CLIP_MEAN,
                                 CLIP_STD, self.dtype,
                                 ingest=scfg.ingest_format)

    def init_state(self):
        return cl.init_clip_cacher(self.cfg.vision, self.dtype, self.batch,
                                   device=self.device), ()

    def _post(self, feats):
        feats = self.model.projector(feats[:, 1:])  # CLS dropped
        feats = avg_pool_2d(feats, self.cfg.vision.grid,
                            self.cfg.pool_stride)
        return feats.reshape(self.batch, -1, feats.shape[-1])

    def full(self, pixels, vstate, pstate):
        feats, vstate = self.model.vision.encode_full(
            pixels, vstate, feature_layer=-2, n_streams=self.batch)
        return self._post(feats), vstate, pstate

    def cached(self, pixels, vstate, pstate):
        feats, vstate = self.model.vision.encode_cached(
            pixels, vstate, self.scfg.cacher.update_token_ratio,
            feature_layer=-2, n_streams=self.batch)
        return self._post(feats), vstate, pstate


class LongVASession(VLMSession):
    """The pixel session of a CLIP backbone: its pipeline (vision_cls) and
    its default session config (default_config) when scfg is None."""
    vision_cls = LongVAVision
    default_config = staticmethod(default_session_config)

    def __init__(self, model: ClipVLM, scfg: SessionConfig = None,
                 state_dtype=torch.bfloat16, batch: int = 1):
        scfg = scfg or self.default_config(model.cfg)
        self.model = model
        super().__init__(model.text, scfg,
                         self.vision_cls(model, scfg, batch=batch),
                         state_dtype=state_dtype, batch=batch)


def build_session(model: ClipVLM, scfg: SessionConfig = None,
                  state_dtype=torch.bfloat16, device="cuda",
                  batch: int = 1) -> ClipVLMSession:
    """A pixel session of `batch` streams over `model`, moved to `device`
    (scfg: default_session_config when None)."""
    model = model.to(resolve_device(device))
    return LongVASession(model, scfg, state_dtype=state_dtype, batch=batch)


# where llava-layout checkpoints (LongVA, Flash-VStream) keep the tower
CLIP_PREFIXES = ("model.vision_tower.vision_tower.vision_model.",
                 "vision_tower.vision_tower.vision_model.",
                 "model.vision_tower.vision_model.")


def vision_heads(hf) -> int:
    """The tower's head count from config.json (not recoverable from the
    tensor shapes): vision_config.num_attention_heads, else CLIP-L's 16."""
    return (hf.vision_config.num_attention_heads
            if hasattr(hf, "vision_config") else 16)


@register_model("longva_7b")
def load_longva_7b(model_path: str, scfg: SessionConfig = None,
                   dtype=torch.bfloat16, vision_dtype=torch.float32,
                   device="cuda", batch: int = 1):
    """A session over a LongVA (llava_qwen) checkpoint directory: Qwen2
    under model.*, CLIP-L under model.vision_tower.vision_tower.
    vision_model.*, the mlp2x projector under model.mm_projector.{0,2}.*;
    the LM in `dtype`, tower and projector in `vision_dtype`.  Returns
    (session, cfg)."""
    from stc_tpu_torch.models.convert import (clip_config_from_state,
                                              convert_clip, convert_mlp2x,
                                              convert_qwen2, find_prefix,
                                              load_hf_state,
                                              qwen2_config_from_hf,
                                              read_hf_config)
    device = resolve_device(device)
    hf = read_hf_config(model_path)
    tcfg = qwen2_config_from_hf(hf)  # llava_qwen's config holds the LM's
    state = load_hf_state(model_path)
    vpfx = find_prefix(state, "embeddings.class_embedding", CLIP_PREFIXES)
    vcfg = clip_config_from_state(state, vpfx, num_heads=vision_heads(hf))
    ppfx = find_prefix(state, "0.weight",
                       ("model.mm_projector.", "mm_projector."))
    cfg = LongVAConfig(vision=vcfg, text=tcfg)
    model = ClipVLM(cfg, dtype, vision_dtype, device)
    convert_clip(state, model.vision, prefix=vpfx)
    convert_mlp2x(state, model.projector, prefix=ppfx)
    convert_qwen2(state, model.text, prefix="model.")
    del state
    return build_session(model, scfg, state_dtype=dtype, device=device,
                         batch=batch), cfg

