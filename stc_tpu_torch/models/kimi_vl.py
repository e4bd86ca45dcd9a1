"""Kimi-VL (MoonViT + 2 x 2 patch merger + MLP projector + STC-Pruner + a
DeepSeek-V3-style LM with latent attention and experts) behind the
streaming-session API.

MoonViT (``models/moonvit.py``) runs with the STC-Cacher in the tower's
dtype; the processor's half of a frame (``PadPreprocessor``) pads it with
black at the right and the bottom to the tower's ``image_hw`` (a multiple
of 28: 360 x 640 becomes 364 x 644, 26 x 46 patches) and normalises with
mean and std 0.5.  The projector merges each 2 x 2 block of patches (4 x
1152 = 4608 wide: a 13 x 23 grid, 299 tokens), LayerNorms each patch's
1152 first, then Linear 4608 -> 4608, exact GELU, Linear -> the LM's
width.  The pruner keeps ``token_per_frame`` of the 299
(``MODEL_SPECS['kimi_vl']``), and the LM (``models/deepseek_v3.py``)
appends them to its latent store.

``check_session`` refuses, with a ValueError when the session is built,
what the latent store and the expert LM do not support: tp / sp / pp
meshes, int8 or int4 pages, int8 weights, speculative decode, the
host-side block scorers, window or retrieved-KV compression, and the
cacher's value gate and k-proxy gate.  A stream past max_blocks is refused
when it would evict (RuntimeError): the host tier moves K/V pages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from stc_tpu_torch.config import SessionConfig
from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.models import deepseek_v3 as ds
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import moonvit as mv
from stc_tpu_torch.models.siglip import layer_norm
from stc_tpu_torch.runtime.vlm import Preprocessor, VLMSession

IMAGE_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
IMAGE_STD = np.array([0.5, 0.5, 0.5], np.float32)


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    vision: mv.MoonViTConfig = dataclasses.field(
        default_factory=mv.MoonViTConfig)
    text: ds.DeepseekV3Config = dataclasses.field(
        default_factory=ds.DeepseekV3Config)
    merge: int = 2  # the patch merger's kernel, a side

    @classmethod
    def tiny(cls):
        return cls(vision=mv.MoonViTConfig.tiny(),
                   text=ds.DeepseekV3Config.tiny())


def merge_patches(x: torch.Tensor, grid_hw, k: int) -> torch.Tensor:
    """(F, gh * gw, C) -> (F, gh/k * gw/k, k * k, C): each k x k block of
    the row-major patch grid, its patches row-major."""
    n, _, C = x.shape
    gh, gw = grid_hw
    x = x.reshape(n, gh // k, k, gw // k, k, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (gh // k) * (gw // k), k * k, C)


class MergeProjector(nn.Module):
    """LayerNorm of each patch, then Linear-GELU-Linear of the merged
    k * k patches."""

    def __init__(self, c_vis: int, c_out: int, k: int, dtype, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        c_in = c_vis * k * k
        self.ln_w, self.ln_b = p(c_vis), p(c_vis)
        self.w1, self.b1 = p(c_in, c_in), p(c_in)
        self.w2, self.b2 = p(c_in, c_out), p(c_out)

    def forward(self, merged: torch.Tensor) -> torch.Tensor:
        """(F, T, k * k, C) -> (F, T, c_out)."""
        x = layer_norm(merged, self.ln_w, self.ln_b, 1e-5).flatten(-2)
        h = F.gelu(x @ self.w1 + self.b1, approximate="none")
        return h @ self.w2 + self.b2


class KimiVL(nn.Module):
    """The whole model: MoonViT and the projector (vision_dtype) and the
    LM (dtype).  Weights start zeroed; fill them with init_random_params
    or the converters."""

    def __init__(self, cfg: KimiVLConfig, dtype=torch.bfloat16,
                 vision_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision = mv.MoonViT(cfg.vision, vision_dtype, device)
        self.projector = MergeProjector(cfg.vision.hidden_size,
                                        cfg.text.hidden_size, cfg.merge,
                                        vision_dtype, device)
        self.text = ds.DeepseekV3(cfg.text, dtype, device)

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02) -> "KimiVL":
        self.vision.init_random_params(generator, scale)
        self.vision.pos_embed.copy_(torch.randn(
            self.vision.pos_embed.shape, generator=generator,
            device=generator.device) * scale)
        pj = self.projector
        pj.ln_w.fill_(1.0)
        for w in (pj.w1, pj.w2):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device) * scale)
        for b in (pj.ln_b, pj.b1, pj.b2):
            b.zero_()
        self.text.init_random_params(generator, scale)
        return self


class PadPreprocessor(Preprocessor):
    """Kimi-VL's processor on the device: (N, h, w, 3) frames (or packed
    yuv420 planes) -> (N, 3, H, W) for the tower's image_hw (H, W), the
    frame padded with black at the right and the bottom, then normalised.
    A frame whose own size padded to a multiple of 28 is not (H, W) is
    refused (the tower's grid is fixed at build)."""

    def __init__(self, image_hw, multiple: int, mean, std, dtype,
                 ingest: str = "rgb"):
        super().__init__(max(image_hw), mean, std, dtype, ingest)
        self.image_hw, self.multiple = tuple(image_hw), multiple

    def device(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:  # packed yuv420 planes
            x = self._yuv_to_rgb(x)
        x = x.to(torch.float32) / 255.0
        h, w = x.shape[1], x.shape[2]
        m = self.multiple
        H, W = self.image_hw
        if (-(-h // m) * m, -(-w // m) * m) != (H, W):
            raise ValueError(f"a {h} x {w} frame pads to another grid than "
                             f"the tower's {H} x {W}")
        x = F.pad(x.permute(0, 3, 1, 2), (0, W - w, 0, H - h))
        mean = torch.as_tensor(self.mean, device=x.device)[:, None, None]
        std = torch.as_tensor(self.std, device=x.device)[:, None, None]
        return ((x - mean) / std).contiguous().to(self.dtype)


class KimiVLVision(lo.LlavaOVVision):
    """MoonViT(+STC-Cacher) -> merger and projector -> STC-Pruner, for B
    streams (LLaVA-OV's pipeline, with its own preprocessor and post-tower
    path)."""

    def __init__(self, model: KimiVL, scfg: SessionConfig, batch: int = 1):
        super().__init__(model, scfg, batch)
        v = self.cfg.vision
        self._pre = PadPreprocessor(v.image_hw,
                                    v.patch_size * self.cfg.merge,
                                    IMAGE_MEAN, IMAGE_STD, self.dtype,
                                    ingest=scfg.ingest_format)

    def _post(self, feats, pstate, sp=None):
        c = self.cfg
        merged = merge_patches(feats, c.vision.grid_hw, c.merge)
        return self._prune(self.model.projector(merged), pstate)


def check_session(scfg: SessionConfig, mesh=None) -> None:
    """Refuse what a Kimi-VL session does not support (ValueError)."""
    rc, c = scfg.rekv, scfg.cacher
    bad = []
    if mesh is not None:
        bad.append("a mesh (tp / sp / pp / dp)")
    if rc.kv_quant != "none":
        bad.append(f"kv_quant={rc.kv_quant!r}")
    if scfg.weights_quant != "none":
        bad.append(f"weights_quant={scfg.weights_quant!r}")
    if rc.spec_decode_draft:
        bad.append("speculative decode (spec_decode_draft)")
    if rc.retrieval_scorer != "mean_dot":
        bad.append(f"retrieval_scorer={rc.retrieval_scorer!r}")
    if rc.window_kv_compression != "none":
        bad.append(f"window_kv_compression={rc.window_kv_compression!r}")
    if rc.retrieved_kv_compression != "none":
        bad.append("retrieved_kv_compression="
                   f"{rc.retrieved_kv_compression!r}")
    if c.sim_source != "key" or c.k_proxy_rank:
        bad.append("the cacher's value or k-proxy gate")
    if bad:
        raise ValueError("not supported by a Kimi-VL session (latent store, "
                         "expert LM): " + ", ".join(bad))


class KimiVLSession(VLMSession):
    def __init__(self, model: KimiVL, scfg: SessionConfig,
                 state_dtype=torch.bfloat16, batch: int = 1, mesh=None):
        check_session(scfg, mesh)
        self.model = model
        super().__init__(model.text, scfg, KimiVLVision(model, scfg, batch),
                         state_dtype=state_dtype, batch=batch)

    def _evict(self, E: int):
        raise RuntimeError(
            "host-tier eviction is not supported over a latent store: the "
            f"stream needs more than max_blocks={self.rekv.max_blocks} "
            "pages; raise max_blocks")

    def kv_memory_bytes(self) -> int:
        """The longest stream's pages times the bytes of one page of rows
        across every layer and stream."""
        n = int(self.kvs.num_blocks.max())
        blk = self.kvs.block_c
        per_block = int(np.prod(blk.shape[3:])) * blk.element_size()
        return int(blk.shape[0] * blk.shape[1] * n * per_block)


def build_session(model: KimiVL, scfg: SessionConfig,
                  state_dtype=torch.bfloat16, device="cuda",
                  batch: int = 1, mesh=None) -> KimiVLSession:
    """A pixel session of `batch` streams over `model`, moved to
    `device`."""
    model = model.to(resolve_device(device))
    return KimiVLSession(model, scfg, state_dtype=state_dtype, batch=batch,
                         mesh=mesh)

