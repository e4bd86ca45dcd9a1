"""Kimi-VL's language model (DeepSeek-V3 layout: latent attention and
experts), for the kimi_vl family: the plain reference
(``reference/kimi_lm.py``), the counts of its pass and its
``latent_attention`` calls, and the program's store read in its layout
(``stc_tpu_torch.kvcache.state.LatentKV``: one row [RMSNorm(c) | k_pe] a
token and layer, unrotated, the rope dims in halves order; ``init_c``
(L, B, n_init, W), pages ``block_c`` (L, B, max_blocks, S, W),
``page_offset`` (L, B)).  The interface is ``stcbench/lms``'s.

The page check follows the program's router at near-ties: the family's
``instrument`` keeps the program's top-k experts of each layer for every
checked chunk (``rec['route']``, (L, T, k)) and for the init prompt
(``init_route``); the tokens whose six the reference took from the
program are printed to standard error with the check.

A chunk's routed-expert bytes are those of the experts the program's
router hit: the family's ``instrument`` zeroes the program's routing
counters as the window starts, and ``chunk_work`` reads them once after
it (``experts_hit``, the window's mean over chunks and MoE layers).
"""

from __future__ import annotations

import sys

import torch

from stcbench import counts
from stcbench.compare import rel
from stcbench.lms import Op
from stcbench.reference import kimi_lm as rk
from stcbench.reference.precision import Precision

# latent_attention's kernels: the tile (its combine is counted with it)
LATENT = ("latent_attention",)


def latent_launches():
    """The program's latent_attention launch counter, or None where it is
    gone."""
    try:
        from stc_tpu_torch.ops import latent_attention as la
        return int(la.launches)
    except (ImportError, AttributeError):
        return None


def latent_call(d: rk.KimiDims, T: int, L: int) -> counts.Work:
    """One latent_attention call at one stream: queries at two angles,
    the init rows (rotated and raw), the live window rows and the output,
    in bf16; products over W dims for scores and R for P @ V of each
    visible (query, key) pair and head."""
    pairs, live = counts.stream_pairs(T, L, d.n_init, d.n_local)
    by = 2 * (2 * T * d.H * d.W + T * d.H * d.R + 2 * d.n_init * d.W
              + live * d.W)
    return counts.Work(bf16=2 * d.H * (d.W + d.R) * pairs, bytes=by,
                       exps=d.H * pairs)


def lm_pass(d: rk.KimiDims, T: int, hit: float) -> counts.Work:
    """The append's pass outside its attention calls: every layer's MLA
    projections (the absorbed W_UK and W_UV included), the dense layer,
    and each MoE layer's float32 gate, shared experts and routed experts
    (products of the k chosen a token; bytes of the `hit` experts an MoE
    layer routed a token to); weights read once in bf16, the hidden
    states in and out."""
    E, H, N, P, V, R = d.E, d.H, d.N, d.P, d.V, d.R
    attn = E * H * (N + P) + E * d.W + H * N * R + H * R * V + H * V * E
    w = counts.Work()
    for i in range(d.L):
        w = w + counts.Work(bf16=2 * T * attn, bytes=2 * (attn + 2 * E))
        if i < d.dense:
            w = w + counts.Work(bf16=2 * T * 3 * E * d.F,
                                bytes=2 * 3 * E * d.F)
            continue
        expert = 3 * E * d.Fe
        shared = expert * d.n_shared
        w = w + counts.Work(
            f32=2 * T * E * d.n_exp,
            bf16=2 * T * (shared + d.k * expert),
            bytes=2 * (E * d.n_exp + shared
                       + hit * expert))
    return w + counts.Work(bytes=2 * 2 * T * E)


class KimiLM:
    """prefix, head: the LM's and the head's checkpoint names."""

    def __init__(self, cfg: dict, get, device, prefix: str, head: str):
        self.d = rk.KimiDims(cfg)
        self.get, self.dev = get, torch.device(device)
        self.prefix, self.head = prefix, head
        self.n_init, self.vocab_size = self.d.n_init, cfg["vocab_size"]
        self.ops = {"latent_attention": Op(LATENT, "latent_attention_tc",
                                           latent_launches)}
        # the program's experts for the init prompt (L, n_init, k), kept by
        # the family's instrument
        self.init_route = None
        # the window's routing as the program counted it
        # (utils.metrics.moe_counts), read once: set by the family's
        # instrument; hit, the experts an MoE layer routed a chunk's
        # tokens to, the window's mean
        self.routing = None
        self.hit = None

    def experts_hit(self) -> float:
        """The experts an MoE layer hit in a window's chunk, the mean over
        the window's chunks and MoE layers, from the program's counters."""
        if self.hit is None:
            if self.routing is None:
                raise RuntimeError("no routing counters: the experts a "
                                   "chunk hit are read from the program")
            c = self.routing()
            n_moe = self.d.L - self.d.dense
            self.hit = float(c["hits"].sum()) / (n_moe * c["appends"])
            busiest = c["tokens"].max(dim=1).values.float() / c[
                "tokens"].sum(dim=1).clamp(min=1)
            print(f"stcbench: the router hit {self.hit:.3f} of "
                  f"{self.d.n_exp} experts an MoE layer and chunk over "
                  f"{c['appends']} appends; the busiest expert took "
                  f"{busiest[self.d.dense:].min():.4f}-"
                  f"{busiest[self.d.dense:].max():.4f} of a layer's tokens",
                  file=sys.stderr)
        return self.hit

    def weights(self):
        return rk.KimiWeights(self.get, self.d, self.prefix, self.head)

    def chunk_work(self, k: int) -> dict:
        d = self.d
        call = latent_call(d, d.S, d.n_init + k * d.S)
        attn = counts.Work()
        for _ in range(d.L):
            attn = attn + call
        return dict(ops={"latent_attention": [call] * d.L},
                    lm=lm_pass(d, d.S, self.experts_hit()) + attn)

    def _mlp(self, l, Wl, hs, router, prec, given):
        """Layer l's MLP of every record's tokens at once."""
        x = rk.mlp(self.d, l, Wl, torch.cat(hs), router, prec,
                   None if given is None else torch.cat(given))
        return list(x.split([h.shape[0] for h in hs]))

    def page_gaps(self, recs, control=None):
        d = self.d
        W = self.weights()
        span = -(-d.n_local // d.S) + 1
        h = [r["flat"].float().clone() for r in recs]
        hc = [x.clone() for x in h] if control is not None else None
        worst = [0.0] * len(recs)
        cworst = [0.0] * len(recs)
        router, crouter = rk.Router(d), rk.Router(d)
        have = all("route" in r for r in recs)
        for l in range(d.L):
            Wl = W.layer(l)
            for i, r in enumerate(recs):
                kv, k = r["kvs"], r["k"]
                if int(kv.page_offset[l, 0]) != 0:
                    raise RuntimeError("a checked stream was evicted")
                p0 = max(0, k - span)
                init = kv.init_c[l, 0].float()
                win = kv.block_c[l, 0, p0:k].float().flatten(0, 1)
                pos = d.n_init + torch.arange(p0 * d.S, k * d.S,
                                              device=self.dev)
                L = d.n_init + k * d.S
                h[i], row = rk.append_layer_attn(d, Wl, h[i], L, init, win,
                                                 pos, Precision())
                worst[i] = max(worst[i], rel(kv.block_c[l, 0, k], row))
                if hc is not None:
                    hc[i], crow = rk.append_layer_attn(
                        d, Wl, hc[i], L, init, win, pos, control)
                    cworst[i] = max(cworst[i], rel(crow, row))
            given = [r["route"][l] for r in recs] if have else None
            h = self._mlp(l, Wl, h, router, Precision(), given)
            if hc is not None:
                hc = self._mlp(l, Wl, hc, crouter, control, None)
            del Wl
        n = sum(x.shape[0] for x in h) * (d.L - d.dense)
        print(f"stcbench: page check followed the program's router for "
              f"{router.followed} of {n} token choices", file=sys.stderr)
        return worst, (cworst if hc is not None else None)

    def init_gaps(self, stores: dict, init_ids, control=None):
        d = self.d
        W = self.weights()
        x = W.embed(init_ids)
        hr, hc = x, x
        router, crouter = rk.Router(d), rk.Router(d)
        gap, cgap = 0.0, 0.0
        for l in range(d.L):
            Wl = W.layer(l)
            hr, row = rk.init_layer_attn(d, Wl, hr, Precision())
            for kv in stores.values():
                gap = max(gap, rel(kv.init_c[l, 0], row))
            given = None if self.init_route is None else self.init_route[l]
            hr = rk.mlp(d, l, Wl, hr, router, Precision(), given)
            if control is not None:
                hc, crow = rk.init_layer_attn(d, Wl, hc, control)
                cgap = max(cgap, rel(crow, row))
                hc = rk.mlp(d, l, Wl, hc, crouter, control)
        return gap, (cgap if control is not None else None)
