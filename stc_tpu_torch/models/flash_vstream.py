"""Flash-VStream + ReKV (port of ``stc_tpu/models/flash_vstream.py``):
CLIP-L/14-336 tower -> mlp2x projector -> spatial compression to 64
tokens a frame (8x8 average pooling of the 24x24 grid) -> streaming Vicuna
(Llama) LM.  No cacher and no pruner; n_local 4000, topk 16, 64-token
blocks.
"""

from __future__ import annotations

import dataclasses

import torch

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.models import clip as cl
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models import register_model
from stc_tpu_torch.models.longva import (CLIP_PREFIXES, ClipVLM, LongVASession,
                                         LongVAVision, vision_heads)
from stc_tpu_torch.models.video_llava import llama7b_config


@dataclasses.dataclass(frozen=True)
class FlashVStreamConfig:
    vision: cl.CLIPConfig = dataclasses.field(default_factory=cl.CLIPConfig)
    text: qw.Qwen2Config = dataclasses.field(default_factory=llama7b_config)
    spatial_tokens: int = 64  # 8x8 after compression

    @property
    def tokens_per_frame(self) -> int:
        return self.spatial_tokens

    @classmethod
    def tiny(cls):
        return cls(vision=cl.CLIPConfig.tiny(),
                   text=dataclasses.replace(qw.Qwen2Config.tiny(),
                                            qkv_bias=False),
                   spatial_tokens=4)


def default_session_config(cfg: FlashVStreamConfig) -> SessionConfig:
    tpf = cfg.tokens_per_frame
    return SessionConfig(
        rekv=ReKVConfig(n_init=14, n_local=4000, block_size=tpf,
                        exc_block_size=tpf, topk=16, chunk_size=1,
                        max_blocks=256),
        cacher=CacherConfig(strategy="none"),
        pruner=PrunerConfig(strategy="none", token_per_frame=tpf),
    )


def compress_spatial_features(feats: torch.Tensor, grid: int,
                              out_tokens: int) -> torch.Tensor:
    """(F, grid*grid, C) -> (F, out_tokens, C) by spatial average pooling
    to a side x side grid (out_tokens = side^2)."""
    F_, T, C = feats.shape
    side = int(out_tokens ** 0.5)
    if side * side != out_tokens:
        raise ValueError(f"out_tokens={out_tokens} is not a square")
    s = grid // side
    x = feats.reshape(F_, side, s, side, s, C)
    return x.mean(dim=(2, 4)).reshape(F_, out_tokens, C)



class FlashVStreamVision(LongVAVision):
    """CLIP tower -> projector -> spatial compression, CLS dropped; no
    cacher: both chunk paths run the full tower."""

    def _post(self, feats):
        feats = self.model.projector(feats[:, 1:])
        feats = compress_spatial_features(feats, self.cfg.vision.grid,
                                          self.cfg.spatial_tokens)
        return feats.reshape(self.batch, -1, feats.shape[-1])

    def cached(self, pixels, vstate, pstate):
        return self.full(pixels, vstate, pstate)


class FlashVStreamSession(LongVASession):
    vision_cls = FlashVStreamVision
    default_config = staticmethod(default_session_config)


def build_session(model: ClipVLM, scfg: SessionConfig = None,
                  state_dtype=torch.bfloat16, device="cuda",
                  batch: int = 1) -> FlashVStreamSession:
    """A pixel session of `batch` streams over `model`, moved to `device`
    (scfg: default_session_config when None)."""
    model = model.to(resolve_device(device))
    return FlashVStreamSession(model, scfg, state_dtype=state_dtype,
                               batch=batch)


@register_model("flash_vstream_7b")
def load_flash_vstream(model_path: str, scfg: SessionConfig = None,
                       dtype=torch.bfloat16, vision_dtype=torch.float32,
                       device="cuda", batch: int = 1):
    """A session over a Flash-VStream (llava_vstream) checkpoint directory:
    LongVA's llava key layout with a Llama LM (no qkv biases); the
    checkpoint's flash-memory modules are not read.  Returns (session,
    cfg)."""
    from stc_tpu_torch.models.convert import (clip_config_from_state,
                                              convert_clip, convert_mlp2x,
                                              convert_qwen2, find_prefix,
                                              llama_config_from_hf,
                                              load_hf_state, read_hf_config)
    device = resolve_device(device)
    hf = read_hf_config(model_path)
    tcfg = llama_config_from_hf(hf)
    state = load_hf_state(model_path)
    vpfx = find_prefix(state, "embeddings.class_embedding", CLIP_PREFIXES)
    vcfg = clip_config_from_state(state, vpfx, num_heads=vision_heads(hf))
    ppfx = find_prefix(state, "0.weight",
                       ("model.mm_projector.", "mm_projector."))
    # the 8x8 compression, clamped for towers of fewer patches
    cfg = FlashVStreamConfig(vision=vcfg, text=tcfg,
                             spatial_tokens=min(64, vcfg.grid ** 2))
    model = ClipVLM(cfg, dtype, vision_dtype, device)
    convert_clip(state, model.vision, prefix=vpfx)
    convert_mlp2x(state, model.projector, prefix=ppfx)
    convert_qwen2(state, model.text, prefix="model.")
    del state
    return build_session(model, scfg, state_dtype=dtype, device=device,
                         batch=batch), cfg
