"""Plain float32 Qwen2 with ReKV's streaming attention, one layer at a time.

Written from the published description (Qwen2: RMSNorm, rotate-half RoPE,
grouped-query attention with q/k/v biases, SwiGLU MLP) and ReKV's rules,
stated here in absolute token positions (the init prompt takes positions
0..n_init-1, page p of the video takes n_init + p * S onwards):

* A video append of T tokens at positions L..L+T-1 attends, with one
  softmax, every earlier token and itself at a distance below n_local
  (init tokens and pages alike, RoPE at the true distance), and, once the
  stream is longer than the window (L + T > n_local), the init tokens a
  second time at the fixed distance n_local - 1.  Each append's keys and
  values become the stream's new page.

RoPE angles are computed in float64 from the positions and rounded once.
Every product runs through a ``Precision`` (float32, or the control's
float8 linears).  Nothing here reads the program: the caller hands in the
weights (made again from the seed), the inputs and, where the reference
follows the program step by step, the program's pages.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from stcbench.reference.precision import Precision


class LMDims:
    """The sizes the math needs, from a configuration's text_config and
    session settings."""

    def __init__(self, text: dict, rekv: dict):
        self.E = text["hidden_size"]
        self.Hq = text["num_attention_heads"]
        self.Hkv = text["num_key_value_heads"]
        self.D = self.E // self.Hq
        self.L = text["num_hidden_layers"]
        self.eps = text["rms_norm_eps"]
        self.base = float(text["rope_theta"])
        self.n_init = rekv["n_init"]
        self.n_local = rekv["n_local"]
        self.S = rekv["block_size"]
        self.topk = rekv["topk"]


class LMWeights:
    """float32 copies of one layer's (or the embedding's, the head's)
    weights, made again on demand: get(name) -> the served tensor."""

    def __init__(self, get: Callable[[str], torch.Tensor], prefix: str,
                 head: str):
        self.get, self.prefix, self.head_name = get, prefix, head
        self._table = None

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        p = f"{self.prefix}layers.{i}."
        names = dict(ln1="input_layernorm.weight",
                     ln2="post_attention_layernorm.weight",
                     wq="self_attn.q_proj.weight", bq="self_attn.q_proj.bias",
                     wk="self_attn.k_proj.weight", bk="self_attn.k_proj.bias",
                     wv="self_attn.v_proj.weight", bv="self_attn.v_proj.bias",
                     wo="self_attn.o_proj.weight",
                     wg="mlp.gate_proj.weight", wu="mlp.up_proj.weight",
                     wd="mlp.down_proj.weight")
        return {k: self.get(p + n).float() for k, n in names.items()}

    def embed(self, ids: Sequence[int]) -> torch.Tensor:
        if self._table is None:
            self._table = self.get(self.prefix + "embed_tokens.weight")
        table = self._table
        idx = torch.as_tensor(list(ids), dtype=torch.long,
                              device=table.device)
        return table[idx].float()

    def final(self):
        """(final norm weight, head (V, E)) in float32."""
        return (self.get(self.prefix + "norm.weight").float(),
                self.get(self.head_name).float())


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """x (..., n, D) rotated at integer positions pos (n,)."""
    D = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D))
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def attend(q: torch.Tensor, groups) -> torch.Tensor:
    """One softmax over several key groups.  q (Hq, T, D); groups: (q or
    None for q itself, k (Hkv, Tk, D), v, mask (T, Tk) bool).  Returns
    (T, Hq * D); a query that sees nothing gets zeros."""
    Hq, T, D = q.shape
    logits, vals = [], []
    for qg, k, v, mask in groups:
        qg = q if qg is None else qg
        G = Hq // k.shape[0]
        kk = k.repeat_interleave(G, dim=0)
        s = (qg @ kk.transpose(1, 2)) / D ** 0.5
        logits.append(s.masked_fill(~mask[None], float("-inf")))
        vals.append(v.repeat_interleave(G, dim=0))
    s = torch.cat(logits, dim=-1)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = p.sum(-1, keepdim=True)
    o = (p / torch.where(den == 0, 1.0, den)) @ torch.cat(vals, dim=1)
    return o.transpose(0, 1).reshape(T, Hq * D)


def qkv(d: LMDims, W, h, prec: Precision):
    x = rms(h, W["ln1"], d.eps)
    T = h.shape[0]
    q = (prec.lm(x, W["wq"]) + W["bq"]).reshape(T, d.Hq, d.D).transpose(0, 1)
    k = (prec.lm(x, W["wk"]) + W["bk"]).reshape(T, d.Hkv, d.D).transpose(0,
                                                                          1)
    v = (prec.lm(x, W["wv"]) + W["bv"]).reshape(T, d.Hkv, d.D).transpose(0,
                                                                          1)
    return q, k, v


def finish(d: LMDims, W, h, o, prec: Precision):
    h = h + prec.lm(o, W["wo"])
    x = rms(h, W["ln2"], d.eps)
    g, u = prec.lm(x, W["wg"]), prec.lm(x, W["wu"])
    return h + prec.lm(torch.nn.functional.silu(g) * u, W["wd"])


def window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, n_local: int):
    dist = q_pos[:, None] - k_pos[None, :]
    return (dist >= 0) & (dist < n_local)


def init_layer(d: LMDims, W, h, prec: Precision):
    """The init prompt (n_init, E) through one layer: (h, k, v), k and v
    (Hkv, n_init, D) unrotated."""
    q, k, v = qkv(d, W, h, prec)
    pos = torch.arange(h.shape[0], device=h.device)
    o = attend(rope(q, pos, d.base), [(None, rope(k, pos, d.base), v,
                                       window_mask(pos, pos, d.n_local))])
    return finish(d, W, h, o, prec), k, v


def append_layer(d: LMDims, W, h, L: int, init_k, init_v, win_k, win_v,
                 win_pos, prec: Precision):
    """A video append of T tokens at positions L.. through one layer, over
    the stream before it: init_k/init_v (Hkv, n_init, D) and the older
    window keys/values (Hkv, n, D) at positions win_pos (n,), unrotated.
    Returns (h, k, v) with the append's k, v (Hkv, T, D) unrotated."""
    T = h.shape[0]
    dev = h.device
    q, k, v = qkv(d, W, h, prec)
    q_pos = L + torch.arange(T, device=dev)
    i_pos = torch.arange(d.n_init, device=dev)
    keys = torch.cat([win_k, k], dim=1)
    vals = torch.cat([win_v, v], dim=1)
    k_pos = torch.cat([win_pos.to(dev), q_pos])
    groups = [(None, rope(init_k, i_pos, d.base), init_v,
               window_mask(q_pos, i_pos, d.n_local)),
              (None, rope(keys, k_pos, d.base), vals,
               window_mask(q_pos, k_pos, d.n_local))]
    if L + T > d.n_local:  # the init tokens again, at distance n_local - 1
        far = torch.full((1,), d.n_local - 1, device=dev)
        groups.append((rope(q, far.expand(T), d.base), init_k, init_v,
                       torch.ones((T, d.n_init), dtype=torch.bool,
                                  device=dev)))
    o = attend(rope(q, q_pos, d.base), groups)
    return finish(d, W, h, o, prec), k, v
