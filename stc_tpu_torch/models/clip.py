"""CLIP vision tower with the token-level MLP-skip cacher (port of
``stc_tpu/models/clip.py``).

Tower: the standard CLIP ViT (class token, pre-layernorm, quick-gelu MLP)
of HF's CLIPVisionModel, so openai/clip-vit-large-patch14(-336)
checkpoints convert directly (models/convert.py::convert_clip).  It is
LongVA's, Video-LLaVA's and Flash-VStream's tower.

Cacher: the STC paper's second cacher, independent of SigLIP's:
  full chunk: every layer runs in full; the last frame's pre-LN2 residual
      and MLP output of every layer become that stream's references;
  cached chunk: LN1 and attention run for every token; per layer, the
      n_skip = int(T * ratio) tokens whose pre-LN2 residual is most
      cosine-similar to the reference SKIP LN2 and the MLP and take the
      reference MLP output; the other T - n_skip are computed.  The ratio
      is a SKIP ratio (the reverse of SigLIP's update ratio).
Per-layer ratios come from ``layer_ratios`` (uniform or linear
increasing).  Both paths run every layer, also past the feature layer
(HF hidden_states indexing, -2 by default), and count into the state:
tokens_processed grows by F * T a chunk, tokens_skipped by F * n_skip at
every layer that skips (so the skip ratio of cache_stats sums the layers).

With n_streams > 1 the frames of B streams ride the batch axis
stream-major (B * F); each stream's references come from its own last
frame and each stream's frames compare against its own.  Attention keeps
the JAX package's rounding points: both products accumulate in float32,
the probabilities round to the input dtype before P @ V
(siglip._attn_full).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn

from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.models.siglip import _attn_full, layer_norm
from stc_tpu_torch.ops.topk import topk_lowest


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # CLS

    @classmethod
    def tiny(cls):
        return cls(hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, image_size=56, patch_size=14)


def layer_ratios(num_layers: int, target_ratio: float,
                 strategy: str = "uniform") -> List[float]:
    """Per-layer skip ratios: the target at every layer ('uniform'), or
    rising linearly from 0.2x to 1.8x of it and rescaled to average the
    target (any other strategy, e.g. 'linear_increasing')."""
    if strategy == "uniform":
        return [target_ratio] * num_layers
    ratios = [target_ratio * (0.2 + 1.6 * (i / max(num_layers - 1, 1)))
              for i in range(num_layers)]
    avg = sum(ratios) / len(ratios)
    return [r * (target_ratio / avg) for r in ratios] if avg > 0 else ratios


def skip_counts(cfg: CLIPConfig, skip_ratio: float,
                strategy: str = "uniform") -> List[int]:
    """Tokens each layer of a cached chunk skips: int(T * ratio) clamped
    to [0, T]."""
    T = cfg.num_tokens
    return [int(max(0, min(T, int(T * r))))
            for r in layer_ratios(cfg.num_layers, skip_ratio, strategy)]


class ClipCacherState(NamedTuple):
    """Per-layer references of each stream's last full-chunk frame, (L, B,
    T, C); has_ref (L,) bool is global; the skip statistics are per
    stream.  A session file flattens the fields in this order."""
    ref_pre_ln2: torch.Tensor
    ref_mlp_post: torch.Tensor
    has_ref: torch.Tensor          # (L,) bool
    tokens_processed: torch.Tensor  # (B,) int32
    tokens_skipped: torch.Tensor    # (B,) int32


class ClipStreamBlob(NamedTuple):
    """One stream's cacher state (extract_stream / restore_stream).  The
    fields are in sorted name order, the order of the JAX package's stream
    file (it flattens a dict), not ClipCacherState's."""
    ref_mlp_post: torch.Tensor      # (L, T, C)
    ref_pre_ln2: torch.Tensor       # (L, T, C)
    tokens_processed: torch.Tensor  # () int32
    tokens_skipped: torch.Tensor    # () int32


def init_clip_cacher(cfg: CLIPConfig, dtype=torch.float32, batch: int = 1,
                     *, device) -> ClipCacherState:
    def z():
        return torch.zeros((cfg.num_layers, batch, cfg.num_tokens,
                            cfg.hidden_size), dtype=dtype, device=device)

    def counts():
        return torch.zeros((batch,), dtype=torch.int32, device=device)

    return ClipCacherState(
        ref_pre_ln2=z(), ref_mlp_post=z(),
        has_ref=torch.zeros((cfg.num_layers,), dtype=torch.bool,
                            device=device),
        tokens_processed=counts(), tokens_skipped=counts())


def cache_stats(state: ClipCacherState) -> Dict[str, float]:
    proc = int(state.tokens_processed.sum())
    skip = int(state.tokens_skipped.sum())
    return {"total_tokens_processed": proc,
            "total_tokens_skipped": skip,
            "actual_skip_ratio": skip / max(proc, 1)}


class ClipStreamsMixin:
    """Per-stream state of the CLIP-tower pipelines (LongVA, Video-LLaVA,
    Flash-VStream): the reference leaves carry the stream on axis 1, the
    counters on axis 0, and has_ref none (it stays the new state's)."""

    def select_streams(self, vstate, pstate, old_vstate, old_pstate, mask):
        m = mask.reshape(1, -1, 1, 1)
        return vstate._replace(
            ref_pre_ln2=torch.where(m, vstate.ref_pre_ln2,
                                    old_vstate.ref_pre_ln2),
            ref_mlp_post=torch.where(m, vstate.ref_mlp_post,
                                     old_vstate.ref_mlp_post),
            tokens_processed=torch.where(mask, vstate.tokens_processed,
                                         old_vstate.tokens_processed),
            tokens_skipped=torch.where(mask, vstate.tokens_skipped,
                                       old_vstate.tokens_skipped)), pstate

    def extract_stream(self, vstate, pstate, slot: int):
        """One slot's cacher state as host tensors (a ClipStreamBlob) and
        the empty pruner state."""
        return ClipStreamBlob(
            ref_mlp_post=vstate.ref_mlp_post[:, slot].cpu(),
            ref_pre_ln2=vstate.ref_pre_ln2[:, slot].cpu(),
            tokens_processed=vstate.tokens_processed[slot].cpu(),
            tokens_skipped=vstate.tokens_skipped[slot].cpu()), pstate

    def restore_stream(self, vstate, pstate, slot: int, v_blob, p_blob):
        """The live state with extract_stream's blob (in ClipStreamBlob's
        order) written into `slot`."""
        blob = ClipStreamBlob(*v_blob)

        def put(cur, new, refs):
            cur = cur.clone()
            if refs:
                cur[:, slot] = torch.as_tensor(new).to(cur)
            else:
                cur[slot] = torch.as_tensor(new).to(cur)
            return cur

        return vstate._replace(
            ref_pre_ln2=put(vstate.ref_pre_ln2, blob.ref_pre_ln2, True),
            ref_mlp_post=put(vstate.ref_mlp_post, blob.ref_mlp_post, True),
            tokens_processed=put(vstate.tokens_processed,
                                 blob.tokens_processed, False),
            tokens_skipped=put(vstate.tokens_skipped, blob.tokens_skipped,
                               False)), pstate


def residual_similarity(r, ref) -> torch.Tensor:
    """(F, T) cosine similarity in float32 of each token's pre-LN2
    residual to the reference's: (r . ref) / (|r| |ref| + 1e-8)."""
    r2, rf = r.to(torch.float32), ref.to(torch.float32)
    return (r2 * rf).sum(-1) / (torch.linalg.vector_norm(r2, dim=-1)
                                * torch.linalg.vector_norm(rf, dim=-1)
                                + 1e-8)


def recompute_rows(sim: torch.Tensor, n_comp: int) -> torch.Tensor:
    """(F, n_comp) indices of each frame's least similar tokens, ascending:
    lax.top_k of the NEGATED similarity (the lower index first among equal
    values, +0.0 above -0.0), then sorted.  A bottom-k of sim would order
    -0.0 and +0.0, and exact ties, otherwise."""
    _, comp = topk_lowest(-sim, n_comp)
    return torch.sort(comp, dim=-1).values


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device):
        super().__init__()
        C, F_ = cfg.hidden_size, cfg.intermediate_size

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.ln1_w, self.ln1_b = p(C), p(C)
        self.wq, self.bq = p(C, C), p(C)
        self.wk, self.bk = p(C, C), p(C)
        self.wv, self.bv = p(C, C), p(C)
        self.wo, self.bo = p(C, C), p(C)
        self.ln2_w, self.ln2_b = p(C), p(C)
        self.fc1, self.fc1_b = p(C, F_), p(F_)
        self.fc2, self.fc2_b = p(F_, C), p(C)

    def attn(self, hn, num_heads: int):
        q = hn @ self.wq + self.bq
        k = hn @ self.wk + self.bk
        v = hn @ self.wv + self.bv
        return _attn_full(q, k, v, num_heads) @ self.wo + self.bo

    def mlp(self, x):
        return quick_gelu(x @ self.fc1 + self.fc1_b) @ self.fc2 + self.fc2_b


class CLIP(nn.Module):
    """The vision tower; weights start zeroed (init_random_params,
    weights.clip_from_jax or convert.convert_clip fill them).  The
    post-layernorm is kept but not applied: the features are an encoder
    layer's hidden states."""

    def __init__(self, cfg: CLIPConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        C, P = cfg.hidden_size, cfg.patch_size

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.class_embed = p(C)
        self.patch_w = p(3 * P * P, C)  # the patch conv has no bias
        self.pos_embed = p(cfg.num_tokens, C)
        self.pre_ln_w, self.pre_ln_b = p(C), p(C)
        self.layers = nn.ModuleList(ClipLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.post_ln_w, self.post_ln_b = p(C), p(C)
        # each layer's recomputed token rows (F, T - n_skip) of the last
        # cached chunk, None where the layer skipped nothing
        self.last_rows: List[Optional[torch.Tensor]] = []

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02) -> "CLIP":
        """N(0, 1) * scale matrices, the class and position embeddings,
        zero biases, unit norms."""
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_w") and "ln" in leaf:
                prm.fill_(1.0)
            elif prm.dim() == 2 or leaf == "class_embed":
                prm.copy_(torch.randn(prm.shape, generator=generator,
                                      device=generator.device) * scale)
            else:
                prm.zero_()
        return self

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(F, 3, H, W) -> (F, 1 + P, C): patches (pixels past grid * P
        dropped), the class token, positions, pre-layernorm."""
        F_ = pixels.shape[0]
        P, g = self.cfg.patch_size, self.cfg.grid
        x = pixels[:, :, :g * P, :g * P].reshape(F_, 3, g, P, g, P)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(F_, g * g, 3 * P * P)
        x = x @ self.patch_w
        cls = self.class_embed.to(x.dtype).expand(F_, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        return layer_norm(x, self.pre_ln_w, self.pre_ln_b,
                          self.cfg.layer_norm_eps)

    def _n_out(self, feature_layer: int) -> int:
        """Layers run before the features are taken."""
        return (self.cfg.num_layers + feature_layer + 1 if feature_layer < 0
                else feature_layer)

    @torch.no_grad()
    def encode_full(self, pixels: torch.Tensor, cacher: ClipCacherState,
                    *, feature_layer: int = -2, n_streams: int = 1):
        """Full chunk of (B * F) stream-major frames: returns (the hidden
        states of `feature_layer` (B * F, T, C), the state with every
        layer's references refreshed from each stream's last frame)."""
        eps, H = self.cfg.layer_norm_eps, self.cfg.num_heads
        n_out = self._n_out(feature_layer)
        h = self.embed(pixels)
        F_, T, C = h.shape
        B = n_streams
        out = torch.zeros_like(h)
        pre, post = [], []
        for i, lp in enumerate(self.layers):
            h = h + lp.attn(layer_norm(h, lp.ln1_w, lp.ln1_b, eps), H)
            residual2 = h
            mlp = lp.mlp(layer_norm(h, lp.ln2_w, lp.ln2_b, eps))
            h = residual2 + mlp
            if i + 1 == n_out:
                out = h
            pre.append(residual2.reshape(B, F_ // B, T, C)[:, -1])
            post.append(mlp.reshape(B, F_ // B, T, C)[:, -1])
        return out, cacher._replace(
            ref_pre_ln2=torch.stack(pre), ref_mlp_post=torch.stack(post),
            has_ref=torch.ones_like(cacher.has_ref),
            tokens_processed=cacher.tokens_processed + (F_ // B) * T)

    @torch.no_grad()
    def encode_cached(self, pixels: torch.Tensor, cacher: ClipCacherState,
                      skip_ratio: float, *, feature_layer: int = -2,
                      ratio_strategy: str = "uniform", n_streams: int = 1):
        """MLP-skip chunk of (B * F) stream-major frames: attention for
        every token; per layer LN2 and the MLP only for the T - n_skip
        tokens least similar to their stream's reference, which the rest
        reuse.  Returns (features, the state with its counters advanced;
        the references stay); last_rows keeps each layer's computed rows."""
        eps, H = self.cfg.layer_norm_eps, self.cfg.num_heads
        n_out = self._n_out(feature_layer)
        h = self.embed(pixels)
        F_, T, C = h.shape
        Fs = F_ // n_streams  # frames per stream
        n_skips = skip_counts(self.cfg, skip_ratio, ratio_strategy)
        frow = torch.arange(F_, device=h.device)[:, None]
        out = torch.zeros_like(h)
        skipped = 0
        self.last_rows = []
        for i, lp in enumerate(self.layers):
            h = h + lp.attn(layer_norm(h, lp.ln1_w, lp.ln1_b, eps), H)
            residual2 = h
            n_skip = n_skips[i]
            if n_skip == 0:
                h = residual2 + lp.mlp(layer_norm(h, lp.ln2_w, lp.ln2_b,
                                                  eps))
                self.last_rows.append(None)
            else:
                # each frame against its own stream's reference
                ref_pre = cacher.ref_pre_ln2[i].repeat_interleave(Fs, dim=0)
                ref_mlp = cacher.ref_mlp_post[i].repeat_interleave(Fs, dim=0)
                comp = recompute_rows(
                    residual_similarity(residual2, ref_pre), T - n_skip)
                toks = lp.mlp(layer_norm(h[frow, comp], lp.ln2_w, lp.ln2_b,
                                         eps))
                mlp_full = ref_mlp.to(h.dtype, copy=True)
                mlp_full[frow, comp] = toks
                h = residual2 + mlp_full
                skipped += Fs * n_skip
                self.last_rows.append(comp)
            if i + 1 == n_out:
                out = h
        return out, cacher._replace(
            tokens_processed=cacher.tokens_processed + Fs * T,
            tokens_skipped=cacher.tokens_skipped + skipped)
