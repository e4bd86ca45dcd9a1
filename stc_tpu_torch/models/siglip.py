"""SigLIP vision tower with the STC-Cacher (port of
``stc_tpu/models/siglip.py``, main-path subset).

  full chunk  (chunk_idx % cache_interval == 0): standard ViT layers; the
      chunk's last frame's K, V, attention output and MLP output become the
      cacher references.
  cached chunk: fresh K for every token; per-frame the update_ratio tokens
      least cosine-similar to the reference K are recomputed (q/v, attention
      against the scattered V, attention and MLP outputs); every other token
      takes the reference outputs.  Two variants of the gate:
      sim_source='value' ranks by fresh V against the reference V and
      attends against the fully fresh V; k_proxy_rank=r > 0 (key
      similarity only) ranks on rank-r sketches of fresh and reference K
      (a fixed numpy matrix, the JAX package's), projects fresh K only at
      the selected rows, and forms the logits as q_sel @ ref_K^T plus a
      U x U correction at the selected columns.

With n_streams > 1 the frames of B streams ride the batch axis stream-major
(B * F), each stream's references come from the last frame of its own part
of the chunk, and each stream's cached frames gate against its own.

A tower with rotary positions (MoonViT, models/moonvit.py) gives each
layer a ``rope``: queries and keys are rotated where they are projected,
so the cacher's references hold rotated keys; the gate's cosine of a
token's fresh and kept keys, both rotated at its own position, is that of
the unrotated ones.

The port gathers rows by index (the JAX package's one-hot gather exists
only for TPU costs and gives the same numbers).

On a CUDA card each path replays one CUDA graph where
runtime/graphs.py finds the call eligible: the references a full
chunk returns are then the graph's, rewritten by its next replay, and the
features and selections are copies.

Under tp (``parallel.sharding.shard_module``) each rank holds num_heads/tp
heads of q/k/v and a 1/tp share of the MLP hidden, with one all_reduce
after ``wo`` and one after ``fc2``; the cacher's K and V references are
the rank's channels, its attention and MLP references whole.  The gate's
cosine is over the whole key width, so its dot product and both squared
norms (or, with k_proxy_rank, the two sketches, each a sum over the key
channels) are all_reduced before the rows are picked: every tp rank picks
the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.ops.topk import topk_lowest
from stc_tpu_torch.runtime import graphs


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    hidden_size: int = 1152
    num_layers: int = 26
    num_heads: int = 16
    intermediate_size: int = 4304
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid

    @classmethod
    def tiny(cls):
        return cls(hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, image_size=56, patch_size=14)


class CacherState(NamedTuple):
    """Per-layer references of the last full chunk's last frame, each
    (L, B, T, C)."""
    ref_k: torch.Tensor
    ref_v: torch.Tensor
    ref_attn: torch.Tensor
    ref_mlp: torch.Tensor


def init_cacher_state(cfg: SiglipConfig, batch: int, dtype=torch.float32,
                      *, device, tp: int = 1) -> CacherState:
    """Zeroed references; under tp the K and V references hold the rank's
    hidden_size / tp channels."""
    def z(width):
        return torch.zeros((cfg.num_layers, batch, cfg.num_tokens, width),
                           dtype=dtype, device=device)
    C = cfg.hidden_size
    return CacherState(z(C // tp), z(C // tp), z(C), z(C))


def layer_norm(x, w, b, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _f32_mm(a, b):
    """a @ b accumulated in float32 from the operands' own values (bf16 to
    f32 is exact, and so is a bf16 product in f32): the JAX package's
    preferred_element_type=float32, rounded by the caller where it casts.
    Full float32 needs TF32 off on the card (PyTorch's default)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _attn_full(q, k, v, num_heads):
    """Plain bidirectional softmax attention; q/k/v: (B, Tq|Tk, C).  Both
    products accumulate in float32; p rounds to the input dtype before
    p @ V, the output once at the end."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    H, D = num_heads, C // num_heads
    qh = q.reshape(B, Tq, H, D).transpose(1, 2)
    kh = k.reshape(B, Tk, H, D).transpose(1, 2)
    vh = v.reshape(B, Tk, H, D).transpose(1, 2)
    logits = _f32_mm(qh, kh.transpose(-1, -2)) * (D ** -0.5)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = _f32_mm(p, vh)
    return o.transpose(1, 2).reshape(B, Tq, C).to(q.dtype)


def key_similarity(k, ref_k, tp=None):
    """Cosine similarity in float32 of each token's fresh key (F, T, C) to
    the reference key (1, T, C): the cacher's gate.  Under tp k and ref_k
    are this rank's channels: the dot product and both squared norms are
    summed over the ranks (one all_reduce) first."""
    kf, rf = k.to(torch.float32), ref_k.to(torch.float32)
    if tp is None:
        return (kf * rf).sum(-1) / (kf.norm(dim=-1) * rf.norm(dim=-1) + 1e-8)
    dot = (kf * rf).sum(-1)
    sums = tp.all_reduce(torch.stack([
        dot, (kf * kf).sum(-1), (rf * rf).sum(-1).expand_as(dot)]),
        site="siglip.gate")
    return sums[0] / (sums[1].sqrt() * sums[2].sqrt() + 1e-8)


_KPROXY: dict = {}


def kproxy_matrix(C: int, rank: int, dtype, device) -> torch.Tensor:
    """The fixed Johnson-Lindenstrauss sketch (C, rank) of the k-proxy
    gate: N(0, 1) / sqrt(rank) draws of numpy's default_rng(42), rounded to
    float32 and then to dtype, the JAX package's very matrix.  Cosines of
    sketched vectors rank staleness as the exact cosines do."""
    key = (C, rank, dtype, str(device))
    if key not in _KPROXY:
        r = np.random.default_rng(42).standard_normal((C, rank))
        r = (r / np.sqrt(rank)).astype(np.float32)
        _KPROXY[key] = torch.from_numpy(r).to(device=device, dtype=dtype)
    return _KPROXY[key]


def _scatter_tokens(base, idx, vals):
    """base (F, T, C) with rows idx (F, U) set to vals (F, U, C)."""
    f = torch.arange(base.shape[0], device=base.device)[:, None]
    out = base.clone()
    out[f, idx] = vals
    return out


class SiglipLayer(nn.Module):
    def __init__(self, cfg: SiglipConfig, dtype, device):
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
        self.tp = None  # the tp axis under a mesh (Siglip.set_mesh)
        # a tower with rotary positions sets rope(x, idx): x (F, T, C), or
        # the tokens idx (F, U) of each frame, rotated at their positions
        self.rope = None

    def _rope(self, x, idx=None):
        return x if self.rope is None else self.rope(x, idx)

    def _tp_sum(self, x, site):
        return x if self.tp is None else self.tp.all_reduce(x, site=site)

    def _heads(self, cfg: SiglipConfig) -> int:
        return cfg.num_heads // (1 if self.tp is None else self.tp.size)

    def _out(self, attn):
        return self._tp_sum(attn @ self.wo, "siglip.attn_out") + self.bo

    def _mlp(self, x):
        x = F.gelu(x @ self.fc1 + self.fc1_b, approximate="tanh")
        return self._tp_sum(x @ self.fc2, "siglip.mlp_out") + self.fc2_b

    def full(self, h, cfg: SiglipConfig):
        """Standard layer; returns (h, (k, v, attn_out, mlp_out))."""
        eps = cfg.layer_norm_eps
        hn = layer_norm(h, self.ln1_w, self.ln1_b, eps)
        k = self._rope(hn @ self.wk + self.bk)
        q = self._rope(hn @ self.wq + self.bq)
        v = hn @ self.wv + self.bv
        attn = self._out(_attn_full(q, k, v, self._heads(cfg)))
        h = h + attn
        mlp = self._mlp(layer_norm(h, self.ln2_w, self.ln2_b, eps))
        return h + mlp, (k, v, attn, mlp)

    def cached(self, h, refs, num_update: int, cfg: SiglipConfig,
               sim_source: str = "key", k_proxy_rank: int = 0):
        """Selective recompute of the num_update least similar tokens per
        frame (by key, by value with sim_source='value', or by rank-r key
        sketches with k_proxy_rank=r on key similarity); h (F, T, C), refs
        (1, T, C) each.  Returns (h, selected token indices (F, U)
        ascending)."""
        eps = cfg.layer_norm_eps
        ref_k, ref_v, ref_attn, ref_mlp = refs
        F_, T, C = h.shape
        k_proxy = k_proxy_rank if sim_source == "key" else 0
        hn = layer_norm(h, self.ln1_w, self.ln1_b, eps)
        if sim_source == "value":
            k_full = self._rope(hn @ self.wk + self.bk)
            v_fresh = hn @ self.wv + self.bv
            sim = key_similarity(v_fresh, ref_v, self.tp)
        elif k_proxy:
            # the fresh side's sketch without forming fresh K: (wk @ R) is
            # a (C, r) matmul; ref_k already holds its bias.  Under tp each
            # rank sketches its own key channels (R's rows of them)
            R = kproxy_matrix(C, k_proxy, h.dtype, h.device)
            if self.tp is None:
                sim = key_similarity(hn @ (self.wk @ R) + self.bk @ R,
                                     ref_k @ R)
            else:
                Cl = self.wk.shape[1]
                R = R[self.tp.rank * Cl:(self.tp.rank + 1) * Cl]
                fresh, ref = self.tp.all_reduce(torch.cat([
                    hn @ (self.wk @ R) + self.bk @ R, ref_k @ R]),
                    site="siglip.gate").split([F_, 1])
                sim = key_similarity(fresh, ref)
            k_full = None
        else:
            k_full = self._rope(hn @ self.wk + self.bk)
            sim = key_similarity(k_full, ref_k, self.tp)
        _, upd = topk_lowest(-sim, num_update)
        upd = torch.sort(upd, dim=-1).values                    # (F, U)
        frow = torch.arange(F_, device=h.device)[:, None]

        def merge(h, ref, vals):
            return _scatter_tokens(h + ref, upd, h[frow, upd] + vals)

        toks = hn[frow, upd]                                    # (F, U, C)
        q_sel = self._rope(toks @ self.wq + self.bq, upd)
        if sim_source == "value":  # attention against the fresh V
            attn_sel = _attn_full(q_sel, k_full, v_fresh, self._heads(cfg))
        else:
            attn_sel = self._attn_scattered_v(toks, q_sel, k_full, ref_k,
                                              ref_v, upd, k_proxy, cfg)
        attn_sel = self._out(attn_sel)
        h = merge(h, ref_attn, attn_sel)
        hn2 = layer_norm(h, self.ln2_w, self.ln2_b, eps)
        h = merge(h, ref_mlp, self._mlp(hn2[frow, upd]))
        return h, upd

    def _attn_scattered_v(self, toks, q_sel, k_full, ref_k, ref_v, upd,
                          k_proxy, cfg):
        """The selected rows' attention against the scattered V (fresh at
        the selected rows, the reference elsewhere), without forming it;
        with k_proxy against the scattered K as well.  toks: the selected
        rows' normed inputs (F, U, C).  Returns (F, U, C) in h's dtype."""
        F_, num_update, _ = toks.shape
        T = ref_v.shape[1]
        D = cfg.head_dim
        H = self._heads(cfg)
        C = H * D  # this rank's q/k/v channels
        v_sel = toks @ self.wv + self.bv
        qh = q_sel.reshape(F_, num_update, H, D).transpose(1, 2)
        if k_proxy:
            # logits against the scattered K without forming fresh K:
            # q_sel @ ref_K^T, plus q_sel @ (K_sel - ref_K[upd])^T added at
            # the selected columns; both products in float32
            k_sel = toks @ self.wk + self.bk
            rkh = ref_k[0].reshape(T, H, D).permute(1, 2, 0)     # (H, D, T)
            logits = _f32_mm(qh, rkh)
            dk = (k_sel - ref_k[0][upd]).reshape(F_, num_update, H, D)
            corr = _f32_mm(qh, dk.to(qh.dtype).permute(0, 2, 3, 1))
            logits = logits.scatter_add(3, upd[:, None, None, :].expand(
                F_, H, num_update, num_update), corr) * (D ** -0.5)
        else:
            kh = k_full.reshape(F_, T, H, D).transpose(1, 2)
            logits = _f32_mm(qh, kh.transpose(-1, -2)) * (D ** -0.5)
        p = torch.softmax(logits, dim=-1).to(q_sel.dtype)       # (F,H,U,T)
        # attention against the scattered V without forming it:
        #   p @ V = p @ ref_V + p[:, :, :, upd] @ (V_sel - ref_V[upd]),
        # both terms and their sum in float32
        rvh = ref_v[0].reshape(T, H, D).transpose(0, 1)         # (H, T, D)
        o = _f32_mm(p, rvh)
        p_sel = torch.gather(p, 3, upd[:, None, None, :].expand(
            F_, H, num_update, num_update))
        dv = (v_sel - ref_v[0][upd]).reshape(F_, num_update, H, D)
        o = o + _f32_mm(p_sel, dv.transpose(1, 2).to(p_sel.dtype))
        return o.transpose(1, 2).reshape(F_, num_update, C).to(toks.dtype)


class Siglip(nn.Module):
    """The vision tower; weights start zeroed (init_random_params or
    weights.siglip_from_jax fill them)."""

    def __init__(self, cfg: SiglipConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        C, P = cfg.hidden_size, cfg.patch_size

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.patch_w, self.patch_b = p(3 * P * P, C), p(C)
        self.pos_embed = p(cfg.num_tokens, C)
        self.layers = nn.ModuleList(SiglipLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.post_ln_w, self.post_ln_b = p(C), p(C)
        self.mesh = self.tp = None

    def set_mesh(self, mesh) -> None:
        """Take the tp axis of `mesh` (the tensors already hold this rank's
        slices, parallel/sharding.shard_module)."""
        tp = mesh.axis("tp")
        self.mesh, self.tp = mesh, (tp if tp.size > 1 else None)
        for lp in self.layers:
            lp.tp = self.tp

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02) -> "Siglip":
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1_w", "ln2_w", "post_ln_w"):
                prm.fill_(1.0)
            elif prm.dim() == 2:  # matrices and the position embedding
                prm.copy_(torch.randn(prm.shape, generator=generator,
                                      device=generator.device) * scale)
            else:
                prm.zero_()
        return self

    def patch_embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, T, C): the stride-P conv as reshape +
        matmul; pixels past grid * P are dropped (valid padding)."""
        B = pixels.shape[0]
        P, g = self.cfg.patch_size, self.cfg.grid
        x = pixels[:, :, :g * P, :g * P].reshape(B, 3, g, P, g, P)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * P * P)
        return x @ self.patch_w + self.patch_b + self.pos_embed

    def _final(self, h):
        """The features from the last layer's output (SigLIP's as they
        are; MoonViT applies its final LayerNorm)."""
        return h

    @torch.no_grad()
    def encode_full(self, pixels: torch.Tensor, n_streams: int = 1):
        """Full chunk of (B * F) stream-major frames: returns (features
        (B * F, T, C) of the last layer, the refreshed CacherState (L, B,
        T, C) from each stream's last frame)."""
        T = self.cfg.num_tokens

        def run(px):
            h = self.patch_embed(px)
            refs = []
            for lp in self.layers:
                h, saved = lp.full(h, self.cfg)
                refs.append([x.reshape(n_streams, -1, T, x.shape[-1])[:, -1]
                             for x in saved])
            return (self._final(h),) + tuple(
                torch.stack([r[j] for r in refs]) for j in range(4))

        h, *refs = graphs.run("full", run, pixels, (n_streams,),
                              keep=(1, 2, 3, 4))
        return h, CacherState(*refs)

    @torch.no_grad()
    def encode_cached(self, pixels: torch.Tensor, cacher: CacherState,
                      update_ratio: float, n_streams: int = 1,
                      sim_source: str = "key", k_proxy_rank: int = 0):
        """Selective-recompute chunk of (B * F) stream-major frames, each
        stream's against its own references (sim_source and k_proxy_rank
        as SiglipLayer.cached): returns (features, selected token indices
        (L, B * F, U)); the cacher state is unchanged."""
        T = self.cfg.num_tokens
        num_update = max(1, min(int(T * update_ratio), T))

        def run(px):
            h = self.patch_embed(px)
            F_ = h.shape[0] // n_streams
            sel = []
            for i, lp in enumerate(self.layers):
                hs, ups = [], []
                for b in range(n_streams):
                    hb, upd = lp.cached(h[b * F_:(b + 1) * F_],
                                        tuple(x[i, b:b + 1] for x in cacher),
                                        num_update, self.cfg, sim_source,
                                        k_proxy_rank)
                    hs.append(hb)
                    ups.append(upd)
                h = hs[0] if n_streams == 1 else torch.cat(hs)
                sel.append(ups[0] if n_streams == 1 else torch.cat(ups))
            return self._final(h), torch.stack(sel)

        return graphs.run(
            "cached", run, pixels,
            (update_ratio, n_streams, sim_source, k_proxy_rank), cacher)
