"""Video-LLaVA-7B + ReKV (port of ``stc_tpu/models/video_llava.py``): a
CLIP-L/14 tower at 224 px (256 patches and the CLS token: 257 tokens a
frame, CLS KEPT) -> projector -> streaming Vicuna (Llama) LM.  No cacher
and no pruner; topk 8, 257-token blocks, 8-frame encode chunks, each
frame one append of one page (VLMSession's exc_block_size loop).
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
from stc_tpu_torch.models.longva import (ClipVLM, LongVASession, LongVAVision,
                                         vision_heads)


def llama7b_config(vocab_size: int = 32000) -> qw.Qwen2Config:
    """Vicuna-7B's dims; Llama has no qkv biases (zeros in this layout)."""
    return qw.Qwen2Config(
        vocab_size=vocab_size, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=32, head_dim=128,
        intermediate_size=11008, rope_base=10000.0, qkv_bias=False)


@dataclasses.dataclass(frozen=True)
class VideoLlavaConfig:
    vision: cl.CLIPConfig = dataclasses.field(
        default_factory=lambda: cl.CLIPConfig(image_size=224))
    text: qw.Qwen2Config = dataclasses.field(default_factory=llama7b_config)

    @property
    def tokens_per_frame(self) -> int:
        return self.vision.num_tokens  # 257 (CLS kept)

    @classmethod
    def tiny(cls):
        return cls(vision=cl.CLIPConfig.tiny(),
                   text=dataclasses.replace(qw.Qwen2Config.tiny(),
                                            qkv_bias=False))


def default_session_config(cfg: VideoLlavaConfig,
                           n_local: int = 8000) -> SessionConfig:
    tpf = cfg.tokens_per_frame
    return SessionConfig(
        rekv=ReKVConfig(n_init=14, n_local=n_local, block_size=tpf,
                        exc_block_size=tpf, topk=8, chunk_size=1,
                        max_blocks=128),
        cacher=CacherConfig(strategy="none"),
        pruner=PrunerConfig(strategy="none", token_per_frame=tpf),
        encode_chunk_frames=8,
    )



class VideoLlavaVision(LongVAVision):
    """CLIP tower -> projector, CLS kept; no cacher: both chunk paths run
    the full tower (its references and counters still advance)."""

    def _post(self, feats):
        h = self.model.projector(feats)
        return h.reshape(self.batch, -1, h.shape[-1])

    def cached(self, pixels, vstate, pstate):
        return self.full(pixels, vstate, pstate)


class VideoLlavaSession(LongVASession):
    vision_cls = VideoLlavaVision
    default_config = staticmethod(default_session_config)


def build_session(model: ClipVLM, scfg: SessionConfig = None,
                  state_dtype=torch.bfloat16, device="cuda",
                  batch: int = 1) -> VideoLlavaSession:
    """A pixel session of `batch` streams over `model`, moved to `device`
    (scfg: default_session_config when None)."""
    model = model.to(resolve_device(device))
    return VideoLlavaSession(model, scfg, state_dtype=state_dtype,
                             batch=batch)


@register_model("video_llava_7b")
def load_video_llava_7b(model_path: str, scfg: SessionConfig = None,
                        dtype=torch.bfloat16, vision_dtype=torch.float32,
                        device="cuda", batch: int = 1):
    """A session over a Video-LLaVA-hf checkpoint directory
    (VideoLlavaForConditionalGeneration: the Llama LM under
    language_model.model.*, the CLIP-style tower under
    video_tower.vision_model.*, the projector under
    multi_modal_projector.linear_{1,2}.*; newer 'model.'-nested layouts
    too).  Returns (session, cfg)."""
    from stc_tpu_torch.models.convert import (clip_config_from_state,
                                              convert_clip,
                                              convert_projector,
                                              convert_qwen2, find_prefix,
                                              llama_config_from_hf,
                                              load_hf_state, read_hf_config)
    device = resolve_device(device)
    hf = read_hf_config(model_path)
    tcfg = llama_config_from_hf(hf.text_config)
    state = load_hf_state(model_path)
    lpfx = find_prefix(state, "layers.0.self_attn.q_proj.weight", (
        "language_model.model.", "model.language_model.model.",
        "model.language_model."))
    vpfx = find_prefix(state, "embeddings.class_embedding", (
        "video_tower.vision_model.", "model.video_tower.vision_model.",
        "video_tower.video_tower.vision_model."))
    ppfx = find_prefix(state, "linear_1.weight", (
        "multi_modal_projector.", "model.multi_modal_projector."))
    vcfg = clip_config_from_state(state, vpfx, num_heads=vision_heads(hf))
    cfg = VideoLlavaConfig(vision=vcfg, text=tcfg)
    model = ClipVLM(cfg, dtype, vision_dtype, device)
    convert_clip(state, model.vision, prefix=vpfx)
    convert_projector(state, model.projector, prefix=ppfx)
    convert_qwen2(state, model.text, prefix=lpfx)
    del state
    return build_session(model, scfg, state_dtype=dtype, device=device,
                         batch=batch), cfg
