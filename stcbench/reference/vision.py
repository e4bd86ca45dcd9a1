"""Plain float32 vision side: preprocessing, the SigLIP tower with the
STC-Cacher, the CLIP tower with the MLP-skip cacher, the projector,
LLaVA-OneVision's 2x bilinear pooling with the STC-Pruner, and LongVA's 2x2
average pooling.

Written from the STC paper's description of the two cachers and the
pruner, in plain torch, one frame at a time:

* SigLIP cacher.  A full frame runs every layer and keeps, per layer, its
  keys, values, attention output and MLP output.  A cached frame computes
  every token's fresh key, recomputes the U = int(T * ratio) tokens whose
  key is least cosine-similar to the kept one (queries and values of those
  rows; attention of those rows against all fresh keys and the kept values
  with those rows' fresh values in), and gives every other token the kept
  attention and MLP outputs.
* CLIP cacher.  A cached frame runs attention for every token and, per
  layer, the MLP only for the T - int(T * skip) tokens whose pre-MLP
  residual is least cosine-similar to the kept one; the rest take the kept
  MLP output.
* Pruner.  Over the chunk's pooled tokens, keep the half of the channels
  of least variance, in ascending order of variance, add their means
  to the running sum of chunk means (position by position, so the order
  matters), and keep per frame the tokens of lowest summed Gaussian
  similarity (bandwidths 2**-3..2**1) to the frame mean and to the running
  mean, in token order.

Near-ties.  Each of these steps cuts a ranking: the cacher's top U of a
layer, the pruner's channel order and its kept tokens.  Where two values
lie within ``TIE`` of the ranking's largest value of each other, float32
rounding alone decides their order, and the program's order is as right
as this one's.  So, where the caller hands in the program's choice, the
reference takes it when every value it puts inside the cut lies within
TIE of the cut (``follow``), and its own choice otherwise.

Weights come from ``get(name)`` (made again from the seed), in the HF
layout.  Products run through a ``Precision``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from stcbench.reference.precision import Precision

# The largest gap between two values that rounding alone may order either
# way, relative to the largest value of the ranking: 2**-16.  Between the
# program and this reference the cacher's cosines part by up to 4.8e-7,
# the pruner's channel variances by 2.0e-6 of 2.6 and its token scores by
# 1.4e-6 of about 5 (PERF.md), 20 to 50 times below it.
TIE = 2.0 ** -16
SIGLIP_MEAN, SIGLIP_STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
ALPHAS = tuple(2.0 ** k for k in range(-3, 2))


def preprocess(frames: torch.Tensor, size: int, mean, std) -> torch.Tensor:
    """(n, H, W, 3) uint8 -> (n, 3, size, size) float32: half-pixel
    bilinear resize without antialias, then (x / 255 - mean) / std."""
    x = frames.float().permute(0, 3, 1, 2) / 255.0
    if x.shape[-2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False)
    m = torch.tensor(mean, device=x.device)[None, :, None, None]
    s = torch.tensor(std, device=x.device)[None, :, None, None]
    return (x - m) / s


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def cosine(a, b):
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-8)


def ranked(x: torch.Tensor) -> torch.Tensor:
    """Indices of x (..., n) in descending order, the lower index first
    among equal values."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


def follow(x: torch.Tensor, k: int, given=None) -> torch.Tensor:
    """The k largest entries of each row of x (n, T), ascending indices:
    the given ones (n, k) in a row where each of them lies within TIE of
    the row's k-th largest and every other entry within TIE of its
    (k+1)-th, else this side's own."""
    own = ranked(x)[:, :k]
    if given is None:
        return own.sort(dim=-1).values
    given = given.to(x.device).long()
    srt = torch.sort(x, dim=-1, descending=True).values
    tau = TIE * x.abs().amax(dim=-1)
    inside = torch.zeros_like(x, dtype=torch.bool).scatter(1, given, True)
    low_in = x.masked_fill(~inside, float("inf")).amin(dim=-1)
    high_out = x.masked_fill(inside, float("-inf")).amax(dim=-1)
    ok = (low_in >= srt[:, k - 1] - tau)
    if k < x.shape[-1]:
        ok &= high_out <= srt[:, k] + tau
    pick = torch.where(ok[:, None], given, own)
    return pick.sort(dim=-1).values


def channel_order(key: torch.Tensor, k: int, mean: torch.Tensor = None,
                  delta: torch.Tensor = None, width: int = 8):
    """The pruner's k channels of largest key (E,), in descending order of
    key.  With delta, the program's chunk means in its own order (k,), a
    position takes, among the channels whose key lies within TIE of the
    one ranked there (and within `width` ranks), the one whose mean (E,)
    is nearest the program's; a channel taken twice leaves both positions
    to this side's own order."""
    order = ranked(key)
    if delta is None:
        return order[:k]
    E = key.numel()
    ks, ms = key[order], mean[order]
    pos = torch.arange(k, device=key.device)
    q = (pos[:, None] + torch.arange(-width, width + 1,
                                     device=key.device)[None]).clamp(0, E - 1)
    near = (ks[q] - ks[:k, None]).abs() <= TIE * ks.abs().max()
    cost = (ms[q] - delta.to(ms.device).float()[:, None]).abs()
    pick = q.gather(1, cost.masked_fill(~near, float("inf")).argmin(
        dim=1, keepdim=True))[:, 0]
    twice = torch.zeros(E, dtype=torch.long, device=key.device).index_add_(
        0, pick, torch.ones_like(pick))[pick] > 1
    return order[torch.where(twice, pos, pick)]


class Tower:
    """A SigLIP ('siglip') or CLIP ('clip') tower from checkpoint names."""

    def __init__(self, get: Callable[[str], torch.Tensor], prefix: str,
                 v: dict, kind: str, prec: Precision):
        self.get, self.prefix, self.kind, self.prec = get, prefix, kind, prec
        self.C, self.P = v["hidden_size"], v["patch_size"]
        self.heads = v["num_attention_heads"]
        self.grid = v["image_size"] // self.P
        self.n_layers = v["run_layers"]
        self.eps = 1e-6 if kind == "siglip" else 1e-5
        self._cache = {}
        # frame-layers in which the cacher's cut took the program's tokens
        # over this side's own (near-ties followed)
        self.followed = 0

    def cut(self, x, k, given=None):
        """follow(x, k, given), counting a row that took the given tokens
        over this side's own."""
        pick = follow(x, k, given)
        if given is not None:
            self.followed += int((pick != follow(x, k)).any(-1).sum())
        return pick

    def w(self, name):
        if name not in self._cache:
            self._cache[name] = self.get(self.prefix + name).float()
        return self._cache[name]

    def lin(self, x, name, bias=True):
        y = self.prec.vis(x, self.w(name + ".weight"))
        return y + self.w(name + ".bias") if bias else y

    def embed(self, px: torch.Tensor) -> torch.Tensor:
        """(F, 3, H, W) -> (F, T, C) tokens entering the first layer."""
        n, P, g = px.shape[0], self.P, self.grid
        x = px[:, :, :g * P, :g * P].reshape(n, 3, g, P, g, P)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(n, g * g, 3 * P * P)
        W = self.w("embeddings.patch_embedding.weight").reshape(self.C, -1)
        x = self.prec.vis(x, W)
        pos = self.w("embeddings.position_embedding.weight")
        if self.kind == "siglip":
            return x + self.w("embeddings.patch_embedding.bias") + pos
        cls = self.w("embeddings.class_embedding").expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1) + pos
        return layer_norm(x, self.w("pre_layrnorm.weight"),
                          self.w("pre_layrnorm.bias"), self.eps)

    def _ln(self, i, which, x):
        p = f"encoder.layers.{i}.layer_norm{which}"
        return layer_norm(x, self.w(p + ".weight"), self.w(p + ".bias"),
                          self.eps)

    def _proj(self, i, m, x):
        return self.lin(x, f"encoder.layers.{i}.self_attn.{m}")

    def _attn(self, q, k, v):
        """q (F, Tq, C), k/v (F, Tk, C) -> (F, Tq, C)."""
        n, Tq, C = q.shape
        H, D = self.heads, C // self.heads

        def heads(x):
            return x.reshape(n, x.shape[1], H, D).transpose(1, 2)

        s = self.prec.vis_bmm(heads(q), heads(k).transpose(-1, -2)) / D ** .5
        o = self.prec.vis_bmm(torch.softmax(s, dim=-1), heads(v))
        return o.transpose(1, 2).reshape(n, Tq, C)

    def _mlp(self, i, x):
        p = f"encoder.layers.{i}.mlp."
        y = self.lin(x, p + "fc1")
        if self.kind == "siglip":
            y = F.gelu(y, approximate="tanh")
        else:
            y = y * torch.sigmoid(1.702 * y)
        return self.lin(y, p + "fc2")

    def full(self, px, every: bool = False):
        """Full frames: (features, per-layer references of the last frame,
        or with every of each frame)."""
        h = self.embed(px)
        sl = slice(None) if every else slice(-1, None)
        refs = []
        for i in range(self.n_layers):
            hn = self._ln(i, 1, h)
            q, k, v = (self._proj(i, m, hn) for m in ("q_proj", "k_proj",
                                                      "v_proj"))
            attn = self._proj(i, "out_proj", self._attn(q, k, v))
            h = h + attn
            mlp = self._mlp(i, self._ln(i, 2, h))
            refs.append(dict(k=k[sl], v=v[sl], attn=attn[sl], pre=h[sl],
                             mlp=mlp[sl]))
            h = h + mlp
        return h, refs

    def siglip_cached(self, px, refs, ratio: float, given=None):
        """SigLIP frames against the kept references (one frame's, or each
        frame's own).  given: the program's recomputed tokens (layers, n,
        U), followed at near-ties."""
        h = self.embed(px)
        n, T, C = h.shape
        U = max(1, min(int(T * ratio), T))
        rows = torch.arange(n, device=h.device)[:, None]
        for i in range(self.n_layers):
            r = refs[i]
            hn = self._ln(i, 1, h)
            k = self._proj(i, "k_proj", hn)
            upd = self.cut(-cosine(k, r["k"]), U,
                           None if given is None else given[i])
            sel = hn[rows, upd]
            q_sel = self._proj(i, "q_proj", sel)
            v = r["v"].expand(n, T, C).clone()
            v[rows, upd] = self._proj(i, "v_proj", sel)
            attn_sel = self._proj(i, "out_proj", self._attn(q_sel, k, v))
            h2 = h + r["attn"]
            h2[rows, upd] = h[rows, upd] + attn_sel
            mlp_sel = self._mlp(i, self._ln(i, 2, h2[rows, upd]))
            h = h2 + r["mlp"]
            h[rows, upd] = h2[rows, upd] + mlp_sel
        return h

    def clip_cached(self, px, refs, skip: float, n_out: int, given=None):
        """A CLIP frame against the kept references; the hidden states
        after layer n_out.  given: the program's recomputed tokens of each
        layer (n, T - n_skip), followed at near-ties."""
        h = self.embed(px)
        n, T, C = h.shape
        n_comp = T - max(0, min(T, int(T * skip)))
        rows = torch.arange(n, device=h.device)[:, None]
        for i in range(n_out):
            r = refs[i]
            hn = self._ln(i, 1, h)
            q, k, v = (self._proj(i, m, hn) for m in ("q_proj", "k_proj",
                                                      "v_proj"))
            h = h + self._proj(i, "out_proj", self._attn(q, k, v))
            comp = self.cut(-cosine(h, r["pre"]), n_comp,
                            None if given is None else given[i])
            mlp = r["mlp"].expand(n, T, C).clone()
            mlp[rows, comp] = self._mlp(i, self._ln(i, 2, h[rows, comp]))
            h = h + mlp
        return h

    def clip_features(self, px, n_out: int):
        """A full CLIP frame's hidden states after layer n_out, and the
        references of the layers up to it."""
        h = self.embed(px)
        refs = []
        for i in range(n_out):
            hn = self._ln(i, 1, h)
            q, k, v = (self._proj(i, m, hn) for m in ("q_proj", "k_proj",
                                                      "v_proj"))
            h = h + self._proj(i, "out_proj", self._attn(q, k, v))
            mlp = self._mlp(i, self._ln(i, 2, h))
            refs.append(dict(pre=h[-1:], mlp=mlp[-1:]))
            h = h + mlp
        return h, refs


def project(get, names, x, prec: Precision):
    """Linear, exact GELU, Linear; names: the two layers' prefixes."""
    a, b = names
    y = prec.vis(x, get(a + "weight").float()) + get(a + "bias").float()
    y = F.gelu(y, approximate="none")
    return prec.vis(y, get(b + "weight").float()) + get(b + "bias").float()


def bilinear_pool(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(F, grid^2, E) -> (F, ceil(grid/2)^2, E), half-pixel bilinear."""
    n, _, E = x.shape
    out = math.ceil(grid / 2)
    y = F.interpolate(x.reshape(n, grid, grid, E).permute(0, 3, 1, 2),
                      size=(out, out), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1).reshape(n, out * out, E)


def avg_pool(x: torch.Tensor, grid: int, stride: int) -> torch.Tensor:
    n, _, E = x.shape
    g = grid // stride
    return x.reshape(n, g, stride, g, stride, E).mean(dim=(2, 4)).reshape(
        n, g * g, E)


def _gauss(x, target):
    d2 = ((x - target) ** 2).sum(-1)
    return sum(torch.exp(-d2 / (2.0 * a)) for a in ALPHAS)


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def chunk_channels(feats: torch.Tensor, channel_keep: float, delta=None):
    """The pruner's channels of one chunk's pooled tokens (F, T, E) and
    their means, in its order (channel_order; delta as there)."""
    flat = feats.reshape(-1, feats.shape[-1])
    mean = flat.mean(dim=0)
    ch = channel_order(-flat.var(dim=0, unbiased=False),
                       int(feats.shape[-1] * channel_keep), mean, delta)
    return ch, mean[ch]


def prune(feats: torch.Tensor, mean_sum: torch.Tensor, count: int,
          keep: int, channel_keep: float = 0.5, delta=None, given=None):
    """feats (F, T, E) of one chunk; mean_sum (C_sel,) and count: the
    running memory before it; delta and given: the program's chunk means
    in its channel order and its kept tokens (F, keep), followed at
    near-ties.  Returns the kept tokens (F, keep, E)."""
    n, T, E = feats.shape
    ch, mean = chunk_channels(feats, channel_keep, delta)
    sel = feats.reshape(n * T, E)[:, ch]
    memory = (mean_sum + mean) / (count + 1)
    x = _unit(sel.reshape(n, T, -1))
    score = _gauss(x, x.mean(dim=1, keepdim=True)) + _gauss(
        x, _unit(memory)[None, None])
    idx = follow(-score, keep, given)
    return torch.gather(feats, 1, idx[..., None].expand(n, keep, E))
