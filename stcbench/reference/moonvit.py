"""Plain float32 MoonViT (Kimi-VL's vision tower) with the STC-Cacher, and
Kimi-VL's patch merger and projector.

Written from MoonViT's published modelling code:

* the processor pads a frame with black at the right and the bottom to a
  multiple of 28 pixels and normalises with mean and std 0.5 (no scaling
  below 4096 patches);
* patch embedding: the stride-14 conv with a bias, plus the learned
  (64, 64, C) position grid interpolated bicubically (align_corners
  False) to the patch grid;
* 27 pre-LN layers (LayerNorm eps 1e-5): packed q/k/v with biases, a 2D
  RoPE on q and k (each head's 72 dims as 36 complex pairs, pair 2j
  turned by the token's column and pair 2j + 1 by its row at frequency
  theta ** (-4 j / 72), theta 10000), softmax attention, the output
  projection; an MLP of width 4304 with gelu-tanh;
* the final LayerNorm;
* the 2 x 2 patch merger (each block's four patches, row-major) and the
  projector: LayerNorm(1152) of each patch, Linear 4608 -> 4608, exact
  GELU, Linear 4608 -> the LM's width.

The STC-Cacher is reference/vision.py's SigLIP cacher on MoonViT's layer:
a cached frame computes every token's fresh key (rotated), recomputes the
U = int(T * ratio) tokens whose key is least cosine-similar to the kept
one (their rotated queries and values; attention against every fresh key
and the kept values with theirs in), and gives every other token the kept
attention and MLP outputs.  The pruner is reference/vision.py's.

Near-ties.  As reference/vision.py, this side takes the program's choice
at a cut (the cacher's tokens, the pruner's channels in its order and
kept tokens) where every value it puts inside lies within ``TIE`` of the
cut, and counts it (``Tower.followed`` for the cacher).  The pruner's
channels are the program's own indices, not matched by their means as
vision.py matches them.  The tower here is the
program's in bfloat16, not float32: its outputs part from this side's by
about 1% after 27 layers (bf16's 2**-9 rounding a step), so ``TIE`` is
2**-6 of the ranking's largest value, not vision.py's 2**-16.

Every linear layer runs through a ``Precision``: float32, or with the
control's precision the float8 e4m3 linears (the nearest precision below
the tower's bfloat16); attention and norms stay float32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from stcbench.reference.vision import _gauss, _unit, cosine, layer_norm, \
    ranked

MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
EPS = 1e-5
TIE = 2.0 ** -6


def follow(x: torch.Tensor, k: int, given=None) -> torch.Tensor:
    """reference/vision.py's follow at this file's TIE: the k largest
    entries of each row of x (n, T), ascending, the given ones where each
    lies within TIE of the row's k-th largest and every other entry
    within TIE of its (k+1)-th."""
    own = ranked(x)[:, :k]
    if given is None:
        return own.sort(dim=-1).values
    given = given.to(x.device).long()
    srt = torch.sort(x, dim=-1, descending=True).values
    tau = TIE * x.abs().amax(dim=-1)
    inside = torch.zeros_like(x, dtype=torch.bool).scatter(1, given, True)
    low_in = x.masked_fill(~inside, float("inf")).amin(dim=-1)
    high_out = x.masked_fill(inside, float("-inf")).amax(dim=-1)
    ok = low_in >= srt[:, k - 1] - tau
    if k < x.shape[-1]:
        ok &= high_out <= srt[:, k] + tau
    return torch.where(ok[:, None], given, own).sort(dim=-1).values


def channel_order(key, k: int, given=None):
    """The pruner's k channels of largest key (E,), in descending order of
    key; the program's own k channels in its order (given (k,)) where
    each lies within TIE of the key ranked at its place and every other
    channel within TIE of the (k+1)-th key."""
    order = ranked(key)
    if given is None:
        return order[:k]
    g = given.to(key.device).long()
    ks = key[order]
    tau = TIE * ks.abs().max()
    ok = g.unique().numel() == k and bool(
        ((key[g] - ks[:k]).abs() <= tau).all())
    if ok and k < key.numel():
        out = torch.ones_like(key, dtype=torch.bool).index_fill(0, g, False)
        ok = bool(key[out].max() <= ks[k] + tau)
    return g if ok else order[:k]


def chunk_channels(feats, channel_keep: float, given=None):
    flat = feats.reshape(-1, feats.shape[-1])
    mean = flat.mean(dim=0)
    ch = channel_order(-flat.var(dim=0, unbiased=False),
                       int(feats.shape[-1] * channel_keep), given)
    return ch, mean[ch]


def prune(feats, mean_sum, count: int, keep: int, channel_keep: float = 0.5,
          channels=None, given=None):
    """reference/vision.py's prune at this file's TIE; channels: the
    program's, followed at near-ties (channel_order)."""
    n, T, E = feats.shape
    ch, mean = chunk_channels(feats, channel_keep, channels)
    sel = feats.reshape(n * T, E)[:, ch]
    memory = (mean_sum + mean) / (count + 1)
    x = _unit(sel.reshape(n, T, -1))
    score = _gauss(x, x.mean(dim=1, keepdim=True)) + _gauss(
        x, _unit(memory)[None, None])
    idx = follow(-score, keep, given)
    return torch.gather(feats, 1, idx[..., None].expand(n, keep, E))


def preprocess(frames: torch.Tensor, hw) -> torch.Tensor:
    """(n, h, w, 3) uint8 -> (n, 3, H, W) float32: padded with zeros at the
    right and the bottom to (H, W), then (x / 255 - mean) / std."""
    x = frames.float().permute(0, 3, 1, 2) / 255.0
    H, W = hw
    x = F.pad(x, (0, W - x.shape[-1], 0, H - x.shape[-2]))
    m = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    s = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x - m) / s


class Tower:
    """MoonViT from checkpoint names under `prefix`; prec: the linears'
    precision (``lin``: x (..., in) @ w.T for w (out, in))."""

    def __init__(self, get: Callable[[str], torch.Tensor], prefix: str,
                 v: dict, lin):
        self.get, self.prefix, self.mm = get, prefix, lin
        self.C, self.P = v["hidden_size"], v["patch_size"]
        self.heads = v["num_attention_heads"]
        self.n_layers = v["num_hidden_layers"]
        self.hw = tuple(v["image_hw"])
        self.gh, self.gw = self.hw[0] // self.P, self.hw[1] // self.P
        self.theta = float(v["rope_theta"])
        self._cache = {}
        self.followed = 0

    def w(self, name):
        if name not in self._cache:
            self._cache[name] = self.get(self.prefix + name).float()
        return self._cache[name]

    @property
    def device(self):
        return self.w("patch_embed.proj.weight").device

    def lin(self, x, name):
        return self.mm(x, self.w(name + ".weight")) + self.w(name + ".bias")

    def cut(self, x, k, given=None):
        pick = follow(x, k, given)
        if given is not None:
            self.followed += int((pick != follow(x, k)).any(-1).sum())
        return pick

    def freqs(self):
        """(T, D/2) complex: pair 2j at the column, 2j + 1 at the row."""
        D = self.C // self.heads
        f = 1.0 / (self.theta ** (torch.arange(0, D, 4, dtype=torch.float64,
                                               device=self.device)[:D // 4]
                                  / D))
        t = torch.arange(self.gh * self.gw, device=self.device)
        x = (t % self.gw).double()[:, None] * f
        y = (t // self.gw).double()[:, None] * f
        ang = torch.stack([x, y], dim=-1).reshape(t.numel(), D // 2)
        return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)

    def rope(self, x, idx=None):
        """x (n, T, C) at the tokens' positions (or tokens idx (n, U))."""
        n, T, C = x.shape
        fc = self.freqs()
        fc = fc[idx] if idx is not None else fc[None]
        xc = torch.view_as_complex(x.reshape(n, T, self.heads, -1, 2)
                                   .contiguous())
        return torch.view_as_real(xc * fc[:, :, None]).reshape(n, T, C)

    def embed(self, px):
        n, P = px.shape[0], self.P
        x = px.reshape(n, 3, self.gh, P, self.gw, P).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(n, self.gh * self.gw, 3 * P * P)
        conv = self.w("patch_embed.proj.weight").reshape(self.C, -1)
        x = self.mm(x, conv) + self.w("patch_embed.proj.bias")
        grid = self.w("patch_embed.pos_emb.weight")
        pos = F.interpolate(grid.permute(2, 0, 1)[None], size=(self.gh,
                                                               self.gw),
                            mode="bicubic", align_corners=False)
        return x + pos[0].permute(1, 2, 0).reshape(-1, self.C)

    def _blk(self, i):
        return f"encoder.blocks.{i}."

    def _ln(self, i, which, x):
        p = self._blk(i) + f"norm{which}"
        return layer_norm(x, self.w(p + ".weight"), self.w(p + ".bias"), EPS)

    def _qkv(self, i, x):
        return self.lin(x, self._blk(i) + "wqkv").chunk(3, dim=-1)

    def _attn(self, q, k, v):
        n, Tq, C = q.shape
        H, D = self.heads, C // self.heads

        def heads(x):
            return x.reshape(n, x.shape[1], H, D).transpose(1, 2)

        s = heads(q) @ heads(k).transpose(-1, -2) / D ** 0.5
        o = torch.softmax(s, dim=-1) @ heads(v)
        return o.transpose(1, 2).reshape(n, Tq, C)

    def _mlp(self, i, x):
        p = self._blk(i) + "mlp."
        return self.lin(F.gelu(self.lin(x, p + "fc0"), approximate="tanh"),
                        p + "fc1")

    def final(self, h):
        return layer_norm(h, self.w("encoder.final_layernorm.weight"),
                          self.w("encoder.final_layernorm.bias"), EPS)

    def full(self, px, every: bool = False):
        """Full frames: (features after the final norm, per-layer
        references of the last frame, or with every of each frame)."""
        h = self.embed(px)
        sl = slice(None) if every else slice(-1, None)
        refs = []
        for i in range(self.n_layers):
            q, k, v = self._qkv(i, self._ln(i, 0, h))
            q, k = self.rope(q), self.rope(k)
            attn = self.lin(self._attn(q, k, v), self._blk(i) + "wo")
            h = h + attn
            mlp = self._mlp(i, self._ln(i, 1, h))
            refs.append(dict(k=k[sl], v=v[sl], attn=attn[sl], mlp=mlp[sl]))
            h = h + mlp
        return self.final(h), refs

    def cached(self, px, refs, ratio: float, given=None):
        """Frames against the kept references (one frame's, or each
        frame's own); given: the program's recomputed tokens (layers, n,
        U), followed at near-ties."""
        h = self.embed(px)
        n, T, C = h.shape
        U = max(1, min(int(T * ratio), T))
        rows = torch.arange(n, device=h.device)[:, None]
        for i in range(self.n_layers):
            r = refs[i]
            hn = self._ln(i, 0, h)
            q, k, v = self._qkv(i, hn)
            k = self.rope(k)
            upd = self.cut(-cosine(k, r["k"]), U,
                           None if given is None else given[i])
            q_sel = self.rope(q[rows, upd], upd)
            vv = r["v"].expand(n, T, C).clone()
            vv[rows, upd] = v[rows, upd]
            attn_sel = self.lin(self._attn(q_sel, k, vv), self._blk(i) + "wo")
            h2 = h + r["attn"]
            h2[rows, upd] = h[rows, upd] + attn_sel
            mlp_sel = self._mlp(i, self._ln(i, 1, h2[rows, upd]))
            h = h2 + r["mlp"]
            h[rows, upd] = h2[rows, upd] + mlp_sel
        return self.final(h)


def project(get, prefix: str, h, merge: int, grid_hw, lin):
    """Tower features (n, gh * gw, C) -> the projector's tokens (n,
    gh / merge * gw / merge, E)."""
    n, _, C = h.shape
    gh, gw = grid_hw
    x = h.reshape(n, gh // merge, merge, gw // merge, merge, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, -1, merge * merge, C)

    def w(name):
        return get(prefix + name).float()

    x = layer_norm(x, w("pre_norm.weight"), w("pre_norm.bias"), EPS)
    x = lin(x.flatten(-2), w("linear_1.weight")) + w("linear_1.bias")
    x = F.gelu(x, approximate="none")
    return lin(x, w("linear_2.weight")) + w("linear_2.bias")
