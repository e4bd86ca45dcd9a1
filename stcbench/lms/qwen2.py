"""Dense Qwen2 (grouped-query attention, RoPE, SwiGLU), the language model
of the llava_ov and longva families: the plain reference
(``reference/lm.py``), the counts of its pass and its ``stream_attention``
calls (``counts.py``), and the program's page store read in its layout
(``stc_tpu_torch.kvcache.state.StreamKV``: unrotated keys and values per
KV head, ``init_k`` / ``init_v`` (L, B, Hkv, n_init, D), pages ``block_k`` /
``block_v`` (L, B, Hkv, max_blocks, S, D), ``page_offset`` (L, B) the
absolute index of page slot 0).  The interface is ``stcbench/lms``'s.
"""

from __future__ import annotations

import torch

from stcbench import counts
from stcbench.compare import rel
from stcbench.lms import Op
from stcbench.reference import lm as rlm
from stcbench.reference.precision import Precision

# stream_attention's kernels: the cover pre-pass, the tile and its combine
STREAM = ("stream_attention", "stream_cover")


def stream_launches():
    """The program's stream_attention launch counter, or None where it is
    gone."""
    try:
        from stc_tpu_torch.ops import stream_attention as sa
        return sum(sa.launches.values())
    except (ImportError, AttributeError):
        return None


class Qwen2LM:
    """prefix, head: the LM's and the head's checkpoint names."""

    def __init__(self, cfg: dict, get, device, prefix: str, head: str):
        self.text = cfg["text_config"]
        self.d = rlm.LMDims(self.text, cfg["session"]["rekv"])
        self.get, self.dev = get, torch.device(device)
        self.prefix, self.head = prefix, head
        self.n_init, self.vocab_size = self.d.n_init, self.text["vocab_size"]
        self.ops = {"stream_attention": Op(STREAM, "stream_attention",
                                           stream_launches)}

    def weights(self):
        return rlm.LMWeights(self.get, self.prefix, self.head)

    def chunk_work(self, k: int) -> dict:
        d = self.d
        L = d.n_init + k * d.S
        call = counts.stream_attention(d.Hq, d.Hkv, d.D, d.S, L, d.n_init,
                                       d.n_local)
        attn = counts.Work()
        for _ in range(d.L):
            attn = attn + call
        return dict(ops={"stream_attention": [call] * d.L},
                    lm=counts.lm_pass(self.text, d.S, attn))

    def page_gaps(self, recs, control=None):
        d = self.d
        W = self.weights()
        span = -(-d.n_local // d.S) + 1
        h = [r["flat"].float().clone() for r in recs]
        hc = [x.clone() for x in h] if control is not None else None
        worst = [0.0] * len(recs)
        cworst = [0.0] * len(recs)
        for l in range(d.L):
            Wl = W.layer(l)
            for i, r in enumerate(recs):
                kv, k = r["kvs"], r["k"]
                if int(kv.page_offset[l, 0]) != 0:
                    raise RuntimeError("a checked stream was evicted")
                p0 = max(0, k - span)
                ik, iv = kv.init_k[l, 0].float(), kv.init_v[l, 0].float()
                wk = kv.block_k[l, 0, :, p0:k].float().flatten(1, 2)
                wv = kv.block_v[l, 0, :, p0:k].float().flatten(1, 2)
                pos = d.n_init + torch.arange(p0 * d.S, k * d.S,
                                              device=self.dev)
                L = d.n_init + k * d.S
                h[i], nk, nv = rlm.append_layer(d, Wl, h[i], L, ik, iv, wk,
                                                wv, pos, Precision())
                got_k = kv.block_k[l, 0, :, k]
                got_v = kv.block_v[l, 0, :, k]
                worst[i] = max(worst[i], rel(got_k, nk), rel(got_v, nv))
                if hc is not None:
                    hc[i], ck, cv = rlm.append_layer(
                        d, Wl, hc[i], L, ik, iv, wk, wv, pos, control)
                    cworst[i] = max(cworst[i], rel(ck, nk), rel(cv, nv))
            del Wl
        return worst, (cworst if hc is not None else None)

    def init_gaps(self, stores: dict, init_ids, control=None):
        d = self.d
        W = self.weights()
        x = W.embed(init_ids)
        h = {s: (x, x) for s in stores}
        gap, cgap = 0.0, 0.0
        for l in range(d.L):
            Wl = W.layer(l)
            for key, kv in stores.items():
                hr, hc = h[key]
                hr, k, v = rlm.init_layer(d, Wl, hr, Precision())
                gap = max(gap, rel(kv.init_k[l, 0], k),
                          rel(kv.init_v[l, 0], v))
                if control is not None:
                    hc, ck, cv = rlm.init_layer(d, Wl, hc, control)
                    cgap = max(cgap, rel(ck, k), rel(cv, v))
                h[key] = (hr, hc)
        return gap, (cgap if control is not None else None)
