"""LLaVA-OneVision + ReKV (port of ``stc_tpu/models/llava_onevision.py``):
SigLIP tower (with the STC-Cacher) -> projector -> bilinear 2x pooling ->
STC-Pruner -> streaming Qwen2 LM, behind the streaming-session API.  The
vision pipeline also stands alone as a FrameEncoder, the frame encoder of
a bare StreamingSession.

The vision side (tower, projector, pooling, pruner) computes in
``vision_dtype`` (float32 by default, as the JAX session's); the pruned
features enter the LM in the LM's dtype.  The session config's cacher
variants (``sim_source``, ``k_proxy_rank``) and ``ingest_format`` reach
the tower and the preprocessor.

On a mesh (``build_session(mesh=)``): the tower, the projector (column-
then row-parallel, one all_reduce) and the LM shard over tp; each dp rank
runs batch / dp streams; over sp each rank runs its share of a chunk's
frames through the tower, projector and pooling (frame-local), the pooled
features are gathered over sp before the pruner (its channel variance and
chunk mean span every frame of the chunk), and the cacher's references,
which come from the chunk's last frame, are broadcast from the last sp
rank.
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
from stc_tpu_torch.parallel import sharding
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
        self.mesh = self.tp = None

    def set_mesh(self, mesh) -> None:
        tp = mesh.axis("tp")
        self.mesh, self.tp = mesh, (tp if tp.size > 1 else None)

    def forward(self, feats):
        h = F.gelu(feats @ self.w1 + self.b1, approximate="none")
        h = h @ self.w2
        if self.tp is not None:
            h = self.tp.all_reduce(h, site="projector.out")
        return h + self.b2


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

    @property
    def _mesh(self):
        return self.model.text.mesh

    def init_state(self):
        n_sel = int(self.cfg.text.hidden_size
                    * self.scfg.pruner.channel_keep_ratio)
        tp = 1 if self._mesh is None else self._mesh.size_of("tp")
        return (sg.init_cacher_state(self.cfg.vision, self.batch, self.dtype,
                                     device=self.device, tp=tp),
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

    def _post(self, feats, pstate, sp=None):
        """Tower features -> (flat (B, F * keep, E), the pruner's kept
        indices (B, F, keep), or None without the pruner, pstate).  sp:
        the axis the chunk's frames are split over, whose pooled features
        are gathered before the pruner."""
        B = self.batch
        feats = apply_pooling(self.model.projector(feats),
                              self.cfg.vision.grid)
        BF, T, E = feats.shape
        feats = feats.reshape(B, BF // B, T, E)
        if sp is not None:
            feats = sp.all_gather(feats, dim=1, site="sp.pooled")
        if not self.scfg.pruner.enabled:
            return feats.reshape(B, -1, E), None, pstate
        pruned, idx, pstate = stc_prune(
            feats, pstate,
            keep_per_frame=self.scfg.pruner.token_per_frame,
            channel_keep_ratio=self.scfg.pruner.channel_keep_ratio)
        return pruned.reshape(B, -1, E), idx, pstate

    def encode(self, pixels, vstate, pstate, cached: bool):
        """One chunk on the cacher path (cached) or the full one ->
        (flat, kept indices, vstate, pstate); the cacher path keeps the
        references it was given.  Over sp (when the chunk's frames split
        evenly) each rank runs its share of every stream's frames."""
        sp = None if self._mesh is None else self._mesh.axis("sp")
        px = pixels if sp is None else sharding.shard_vision_sp(
            pixels, self.batch, sp)
        if px.shape[0] == pixels.shape[0]:
            sp = None
        if cached:
            c = self.scfg.cacher
            feats, _ = self.model.vision.encode_cached(
                px, vstate, c.update_token_ratio, self.batch,
                sim_source=c.sim_source, k_proxy_rank=c.k_proxy_rank)
        else:
            feats, vstate = self.model.vision.encode_full(px, self.batch)
            if sp is not None:  # the last frame lies on the last sp rank
                widths = [x.shape[-1] for x in vstate]
                vstate = sg.CacherState(*sp.broadcast(
                    torch.cat(list(vstate), dim=-1), sp.size - 1,
                    site="sp.refs").split(widths, dim=-1))
        flat, idx, pstate = self._post(feats, pstate, sp)
        return flat, idx, vstate, pstate

    def full(self, pixels, vstate, pstate):
        flat, _, vstate, pstate = self.encode(pixels, vstate, pstate, False)
        return flat, vstate, pstate

    def cached(self, pixels, vstate, pstate):
        flat, _, vstate, pstate = self.encode(pixels, vstate, pstate, True)
        return flat, vstate, pstate


class FrameEncoder:
    """frames -> pruned features (1, F * keep, E_text) of one stream, for a
    bare StreamingSession (its frame_encoder).  It runs the LlavaOVVision
    pipeline that a VLMSession drives, on the full path every
    cache_interval-th call and on the cacher path between, and owns the
    cacher and pruner state (reset per video).  ``last_kept_idx`` holds the
    pruner's kept indices (1, F, keep) of the last call (None without the
    pruner)."""

    def __init__(self, model: LlavaOV, scfg: SessionConfig, device="cuda"):
        self.model = model.to(resolve_device(device))
        self.scfg = scfg
        self.vision = LlavaOVVision(self.model, scfg)
        self.reset()

    def reset(self):
        self.chunk_idx = 0
        self.vstate, self.pstate = self.vision.init_state()
        self.last_kept_idx = None

    @torch.no_grad()
    def __call__(self, frames) -> torch.Tensor:
        """frames: (F, H, W, 3) uint8 (or 0-255 float) RGB, or pixels
        already normalised (F, 3, S, S)."""
        frames = np.asarray(frames)
        vis = self.vision
        if frames.dtype == np.uint8 or (frames.ndim == 4
                                        and frames.shape[-1] == 3):
            px = vis.device_preprocess(
                torch.as_tensor(vis.preprocess(frames)).to(vis.device))
        else:
            px = torch.as_tensor(frames).to(vis.device, vis.dtype)
        c = self.scfg.cacher
        cached = c.enabled and self.chunk_idx % c.cache_interval != 0
        out, idx, self.vstate, self.pstate = vis.encode(
            px, self.vstate, self.pstate, cached)
        self.chunk_idx += 1
        self.last_kept_idx = idx
        return out


class LlavaOVSession(VLMSession):
    def __init__(self, model: LlavaOV, scfg: SessionConfig,
                 state_dtype=torch.bfloat16, batch: int = 1, mesh=None):
        self.model = model
        if mesh is not None:
            if scfg.weights_quant != "none":  # quantize before sharding
                model.text.quantize_int8(scfg.weights_quant_group)
            if model.text.mesh is None:
                sharding.shard_module(model, mesh)
        local = batch // (1 if mesh is None else mesh.size_of("dp"))
        super().__init__(model.text, scfg,
                         LlavaOVVision(model, scfg, batch=local),
                         state_dtype=state_dtype, batch=batch, mesh=mesh)


def build_session(model: LlavaOV, scfg: SessionConfig,
                  state_dtype=torch.bfloat16, device="cuda",
                  batch: int = 1, mesh=None) -> LlavaOVSession:
    """A pixel session of `batch` streams over `model`, moved to
    `device`.  mesh: a parallel.mesh.Mesh (dp x tp, dp x sp x tp or pp x
    tp); the model is sharded onto it in place unless it already is (for
    example by parallel.sharding.init_random on a sharded module)."""
    model = model.to(resolve_device(device))
    return LlavaOVSession(model, scfg, state_dtype=state_dtype, batch=batch,
                          mesh=mesh)


@register_model("llava_ov_7b")
def load_llava_ov_7b(model_path: str, scfg: SessionConfig = None,
                     dtype=torch.bfloat16, vision_dtype=torch.float32,
                     device="cuda", batch: int = 1):
    """A session of `batch` streams over an HF LLaVA-OneVision checkpoint
    directory (config.json + *.safetensors or *.bin shards), converted
    tensor by tensor onto `device`: the LM in `dtype`, the tower and
    projector in `vision_dtype`, the session state in `dtype`.  Returns
    (session, cfg)."""
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
                         device=device, batch=batch), cfg
