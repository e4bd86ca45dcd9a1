"""Plain float32 DeepSeek-V3 decoder (Kimi-VL's language model) with ReKV's
streaming attention, one layer at a time.

Written from the published description and modelling code of
DeepSeek-V3 as Kimi-VL-A3B configures it: RMSNorm (eps 1e-5); multi-head
latent attention without a query LoRA: q = x q_proj, each head's q_nope
(128) and q_pe (64); x kv_a_proj_with_mqa = [c (512) | k_pe (64)],
kv_a_layernorm on c, and kv_b_proj decompressing c into each head's
k_nope (128) and value (128), in the published, not absorbed, form; RoPE
(theta 800000) on q_pe and on the one k_pe of a token, shared by the
heads, in the published order (the modelling code's apply_rotary_pos_emb:
interleaved pairs viewed as halves, then rotate-half); softmax scale
(128 + 64) ** -0.5 (no rope scaling, so no mscale); o_proj.  Layer 0 has
a dense SwiGLU MLP; the others a float32 router (sigmoid scores, the
e_score_correction_bias added for the choice only, one group, top 6, the
chosen scores renormalised and times routed_scaling_factor), the routed
experts run one at a time in a Python loop, and the shared experts (one
SwiGLU).  ReKV's rules are reference/lm.py's, in absolute positions.

Departures from the published description, each for the comparison:

* The program's store keeps each token's row [RMSNorm(c) | k_pe] with the
  rope dims of k_pe in halves order (the program permutes them once, so
  its rotate-half needs no view): this side reads and writes rows in that
  layout (``to_store`` / ``from_store``) and computes in the published
  one.
* Near-ties of the router follow the program.  Where this side's own
  biased scores put an expert the program chose within ``ROUTE_TIE`` of
  this side's 6th score, and every other within ``ROUTE_TIE`` of its 7th,
  the router takes the program's six for that token and layer, as
  reference/vision.py follows the cacher and the pruner (``route``).  A
  score here and the program's bfloat16 one part by rounding of the
  hidden state the gate reads, up to about 1% of it after 27 layers, so
  about 2**-8 of a sigmoid score of unit logits: ``ROUTE_TIE`` is 2**-7.
  ``Router.followed`` counts the tokens whose six it took.

Every linear layer runs through a ``Precision`` (float32, or the
control's float8 e4m3 linears, experts and kv_b_proj included); the
router's gate stays float32 in both, as the configuration states it.
RoPE angles are computed in float64 and rounded once.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from stcbench.reference.lm import rms, window_mask
from stcbench.reference.precision import Precision

ROUTE_TIE = 2.0 ** -7


class KimiDims:
    """The sizes the math needs, from the configuration file (its top level
    holds the LM's published config) and its session."""

    def __init__(self, cfg: dict):
        self.E = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.N = cfg["qk_nope_head_dim"]
        self.P = cfg["qk_rope_head_dim"]
        self.V = cfg["v_head_dim"]
        self.R = cfg["kv_lora_rank"]
        self.L = cfg["num_hidden_layers"]
        self.F = cfg["intermediate_size"]
        self.Fe = cfg["moe_intermediate_size"]
        self.n_exp = cfg["n_routed_experts"]
        self.k = cfg["num_experts_per_tok"]
        self.n_shared = cfg["n_shared_experts"]
        self.dense = cfg["first_k_dense_replace"]
        self.scaling = cfg["routed_scaling_factor"]
        self.norm_topk = cfg["norm_topk_prob"]
        self.eps = cfg["rms_norm_eps"]
        self.base = float(cfg["rope_theta"])
        rekv = cfg["session"]["rekv"]
        self.n_init = rekv["n_init"]
        self.n_local = rekv["n_local"]
        self.S = rekv["block_size"]
        self.topk = rekv["topk"]

    @property
    def W(self) -> int:
        return self.R + self.P


class KimiWeights:
    """float32 copies of one layer's weights (HF names), made again on
    demand: get(name) -> the served tensor."""

    ATTN = dict(ln1="input_layernorm.weight",
                ln2="post_attention_layernorm.weight",
                wq="self_attn.q_proj.weight",
                wkva="self_attn.kv_a_proj_with_mqa.weight",
                kvln="self_attn.kv_a_layernorm.weight",
                wkvb="self_attn.kv_b_proj.weight",
                wo="self_attn.o_proj.weight")

    def __init__(self, get: Callable[[str], torch.Tensor], d: KimiDims,
                 prefix: str, head: str):
        self.get, self.d, self.prefix, self.head_name = get, d, prefix, head
        self._table = None

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        p = f"{self.prefix}layers.{i}."
        out = {k: self.get(p + n).float() for k, n in self.ATTN.items()}
        m = p + "mlp."
        if i < self.d.dense:
            for k in ("gate_proj", "up_proj", "down_proj"):
                out[k] = self.get(m + k + ".weight").float()
            return out
        out["gate"] = self.get(m + "gate.weight").float()
        out["bias"] = self.get(m + "gate.e_score_correction_bias").float()
        out["experts"] = [
            tuple(self.get(f"{m}experts.{e}.{k}.weight").float()
                  for k in ("gate_proj", "up_proj", "down_proj"))
            for e in range(self.d.n_exp)]
        out["shared"] = tuple(self.get(f"{m}shared_experts.{k}.weight")
                              .float() for k in ("gate_proj", "up_proj",
                                                 "down_proj"))
        return out

    def embed(self, ids: Sequence[int]) -> torch.Tensor:
        if self._table is None:
            self._table = self.get(self.prefix + "embed_tokens.weight")
        idx = torch.as_tensor(list(ids), dtype=torch.long,
                              device=self._table.device)
        return self._table[idx].float()

    def final(self):
        return (self.get(self.prefix + "norm.weight").float(),
                self.get(self.head_name).float())


# ------------------------------------------------------------------ rope --

def halves(P: int, device=None) -> torch.Tensor:
    """Interleaved pairs -> halves: the store's dim j is dim halves[j] of
    the published order."""
    return torch.cat([torch.arange(0, P, 2), torch.arange(1, P, 2)]).to(
        device)


def to_store(x: torch.Tensor) -> torch.Tensor:
    return x[..., halves(x.shape[-1], x.device)]


def from_store(x: torch.Tensor) -> torch.Tensor:
    inv = torch.argsort(halves(x.shape[-1], x.device))
    return x[..., inv]


def rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """DeepSeek-V3's apply_rotary_pos_emb on x (..., n, P) in the published
    order at integer positions pos (n,): the pairs viewed as halves, then
    rotate-half.  Returns the rotated rope dims in halves order."""
    P = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, P, 2, dtype=torch.float64,
                                       device=x.device) / P))
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    x = to_store(x)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


# ------------------------------------------------------------- attention --

def attend(q: torch.Tensor, groups, Dv: int) -> torch.Tensor:
    """One softmax over several key groups, per head.  q (H, T, Dq);
    groups: (q or None for q itself, k (H, Tk, Dq), v (H, Tk, Dv), mask
    (T, Tk) bool).  Scale Dq ** -0.5.  Returns (T, H * Dv); a query that
    sees nothing gets zeros."""
    H, T, Dq = q.shape
    logits, vals = [], []
    for qg, k, v, mask in groups:
        qg = q if qg is None else qg
        s = (qg @ k.transpose(1, 2)) / Dq ** 0.5
        logits.append(s.masked_fill(~mask[None], float("-inf")))
        vals.append(v)
    s = torch.cat(logits, dim=-1)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = p.sum(-1, keepdim=True)
    o = (p / torch.where(den == 0, 1.0, den)) @ torch.cat(vals, dim=1)
    return o.transpose(0, 1).reshape(T, H * Dv)


def project(d: KimiDims, W, h, prec: Precision):
    """The tokens h (T, E): (q_nope (H, T, N), q_pe (H, T, P) published
    order, the store row [RMSNorm(c) | k_pe in halves order] (T, W))."""
    T = h.shape[0]
    x = rms(h, W["ln1"], d.eps)
    q = prec.lm(x, W["wq"]).reshape(T, d.H, d.N + d.P).transpose(0, 1)
    ckv, kpe = prec.lm(x, W["wkva"]).split([d.R, d.P], dim=-1)
    row = torch.cat([rms(ckv, W["kvln"], d.eps), to_store(kpe)], dim=-1)
    return q[..., :d.N], q[..., d.N:], row


def keys(d: KimiDims, W, rows, pos, prec: Precision):
    """Store rows (n, W) at positions pos (n,) (None: unrotated) -> (k (H,
    n, N + P), v (H, n, V)): kv_b_proj decompresses c into each head's
    k_nope and value; k_pe rotated (published order in, halves out)."""
    n = rows.shape[0]
    kv = prec.lm(rows[:, :d.R], W["wkvb"]).reshape(n, d.H, d.N + d.V)
    k_nope, v = kv.transpose(0, 1).split([d.N, d.V], dim=-1)
    kpe = rows[:, d.R:]
    if pos is not None:
        kpe = rope(from_store(kpe), pos, d.base)
    k = torch.cat([k_nope, kpe[None].expand(d.H, n, d.P)], dim=-1)
    return k, v


def query(d: KimiDims, q_nope, q_pe, pos):
    return torch.cat([q_nope, rope(q_pe, pos, d.base)], dim=-1)


def attn_out(d: KimiDims, W, h, o, prec: Precision):
    return h + prec.lm(o, W["wo"])


def init_layer_attn(d: KimiDims, W, h, prec: Precision):
    """The init prompt (n_init, E) through one layer's attention: (h after
    the attention residual, rows (n_init, W) as stored)."""
    q_nope, q_pe, row = project(d, W, h, prec)
    pos = torch.arange(h.shape[0], device=h.device)
    k, v = keys(d, W, row, pos, prec)
    o = attend(query(d, q_nope, q_pe, pos),
               [(None, k, v, window_mask(pos, pos, d.n_local))], d.V)
    return attn_out(d, W, h, o, prec), row


def append_layer_attn(d: KimiDims, W, h, L: int, init_rows, win_rows,
                      win_pos, prec: Precision):
    """A video append of T tokens at positions L.. through one layer's
    attention, over the stream before it: the init rows (n_init, W) and
    the older window rows (n, W) at positions win_pos, as stored.  Returns
    (h after the attention residual, the append's rows (T, W))."""
    T = h.shape[0]
    dev = h.device
    q_nope, q_pe, row = project(d, W, h, prec)
    q_pos = L + torch.arange(T, device=dev)
    i_pos = torch.arange(d.n_init, device=dev)
    rows = torch.cat([win_rows, row], dim=0)
    k_pos = torch.cat([win_pos.to(dev), q_pos])
    ik, iv = keys(d, W, init_rows, i_pos, prec)
    wk, wv = keys(d, W, rows, k_pos, prec)
    groups = [(None, ik, iv, window_mask(q_pos, i_pos, d.n_local)),
              (None, wk, wv, window_mask(q_pos, k_pos, d.n_local))]
    if L + T > d.n_local:  # the init tokens again, at distance n_local - 1
        far = torch.full((T,), d.n_local - 1, device=dev)
        rk, rv = keys(d, W, init_rows, None, prec)
        groups.append((query(d, q_nope, q_pe, far), rk, rv,
                       torch.ones((T, d.n_init), dtype=torch.bool,
                                  device=dev)))
    o = attend(query(d, q_nope, q_pe, q_pos), groups, d.V)
    return attn_out(d, W, h, o, prec), row


# ------------------------------------------------------------------- mlp --

def swiglu(x, wg, wu, wd, prec: Precision):
    return prec.lm(F.silu(prec.lm(x, wg)) * prec.lm(x, wu), wd)


class Router:
    """The MoE router; counts the tokens whose choice followed the
    program's at a near-tie."""

    def __init__(self, d: KimiDims):
        self.d = d
        self.followed = 0

    def route(self, W, x, given=None):
        """x (n, E) normed -> (experts (n, k) int64, weights (n, k)).
        given: the program's experts (n, k), followed at near-ties."""
        d = self.d
        scores = torch.sigmoid(x @ W["gate"].T)
        biased = scores + W["bias"]
        srt, own = torch.sort(biased, dim=-1, descending=True, stable=True)
        own = own[:, :d.k]
        pick = own
        if given is not None:
            given = given.to(x.device).long()
            inside = torch.zeros_like(biased, dtype=torch.bool).scatter(
                1, given, True)
            low_in = biased.masked_fill(~inside, float("inf")).amin(-1)
            high_out = biased.masked_fill(inside, float("-inf")).amax(-1)
            ok = (low_in >= srt[:, d.k - 1] - ROUTE_TIE) & (
                high_out <= srt[:, d.k] + ROUTE_TIE)
            pick = torch.where(ok[:, None], given, own)
            differs = pick.sort(-1).values != own.sort(-1).values
            self.followed += int(differs.any(-1).sum())
        w = scores.gather(1, pick)
        if d.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return pick, w * d.scaling


def mlp(d: KimiDims, i: int, W, h, router: Router, prec: Precision,
        given=None):
    """Layer i's MLP residual on h (n, E); given: the program's experts of
    these tokens (n, k), or None."""
    x = rms(h, W["ln2"], d.eps)
    if i < d.dense:
        return h + swiglu(x, W["gate_proj"], W["up_proj"], W["down_proj"],
                          prec)
    idx, w = router.route(W, x, given)
    out = torch.zeros_like(x)
    for e, (wg, wu, wd) in enumerate(W["experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out.index_add_(0, tok, swiglu(x[tok], wg, wu, wd, prec)
                           * w[tok, slot][:, None])
    return h + out + swiglu(x, *W["shared"], prec)
