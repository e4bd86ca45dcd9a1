"""Kimi-VL (MoonViT + merger and projector + STC-Pruner + a DeepSeek-V3 LM
with latent attention and experts) on the CPU at a tiny size, against the
benchmark's plain float32 reference (stcbench/reference/kimi_lm.py and
moonvit.py), on the benchmark's seeded weights read through the port's
own converters.

The program runs in float32 here, so it and the reference differ only by
the order of their sums and by the absorbed form of the attention (q_nope
W_UK . c against q_nope . c W_UK): about 1e-7 of each output.  Every
comparison below allows 1e-5 of the reference (``TOL``), a hundred times
that, and a thousand times below what a planted fault moves (a RoPE over
the whole latent row, the router's correction bias dropped, the shared
expert dropped: 1e-2 and more, test_planted_faults_fail).  The router's
inputs are built well apart: the correction bias puts the two experts of
every token 0.25 above the rest (scores within 0.01 of 0.5), so the
choices are equal as integers, and dropping the bias changes them.
"""

import json
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import pytest
import torch

from stc_tpu_torch.config import ReKVConfig
from stc_tpu_torch.kvcache import latent
from stc_tpu_torch.models import kimi_vl as kv
from stc_tpu_torch.models.convert import (convert_deepseek_v3,
                                          convert_kimi_projector,
                                          convert_moonvit)
from stc_tpu_torch.utils import metrics
from stcbench import weights
from stcbench.compare import rel, row_rel
from stcbench.families import kimi_vl as fam
from stcbench.lms.kimi import KimiLM
from stcbench.reference import kimi_lm as rk
from stcbench.reference import moonvit as rm
from stcbench.reference.lm import rms
from stcbench.reference.precision import Precision

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 19
TOL = 1e-5
F32 = Precision()


def tiny_cfg(n_local=24, topk=4, max_blocks=64) -> dict:
    """The cell's configuration file cut to test size: hidden 64, 4 heads,
    latent 32 + rope 16, 1 dense + 3 MoE layers of 8 experts (top 2, one
    shared); a 2-layer MoonViT on 56 x 84 frames (4 x 6 patches, 6 merged
    tokens, 3 kept); float32."""
    cfg = json.loads((ROOT / "stcbench/configs/kimi-vl-a3b.json")
                     .read_text())
    cfg.update(hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=4,
               num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
               num_experts_per_tok=2, kv_lora_rank=32, qk_rope_head_dim=16,
               qk_nope_head_dim=16, v_head_dim=16, vocab_size=256,
               rope_theta=10000.0, dtype="float32")
    cfg["vision_config"].update(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_hw=[56, 84], init_pos_emb_height=8,
        init_pos_emb_width=8, dtype="float32")
    s = cfg["session"]
    s["rekv"].update(n_init=4, n_local=n_local, block_size=3,
                     exc_block_size=3, topk=topk, max_blocks=max_blocks,
                     max_new_tokens=4, max_prompt_tokens=16)
    s["pruner"]["token_per_frame"] = 3
    return cfg


class Weights(Mapping):
    """The benchmark's seeded weights, with each router made well apart:
    gate rows at a hundredth of their draw (scores within 0.001 of 0.5)
    and a correction bias of 0.25 and 0.3 on experts 2 and 5, 0 on the
    others."""

    def __init__(self, cfg):
        self.specs = fam.specs(cfg)

    def __getitem__(self, name):
        x = weights.make(SEED, name, self.specs[name], "cpu")
        if name.endswith("gate.weight"):
            return x * 0.01
        if name.endswith("e_score_correction_bias"):
            b = torch.zeros_like(x)
            b[[2, 5]] = torch.tensor([0.25, 0.3])
            return b
        return x

    def __iter__(self):
        return iter(self.specs)

    def __len__(self):
        return len(self.specs)


def build(cfg):
    w = Weights(cfg)
    model = kv.KimiVL(fam.model_config(cfg), dtype=torch.float32,
                      vision_dtype=torch.float32, device="cpu")
    convert_moonvit(w, model.vision, prefix=fam.VISION)
    convert_kimi_projector(w, model.projector, prefix=fam.PROJ)
    convert_deepseek_v3(w, model.text, prefix=fam.LM, head=fam.HEAD)
    sess = kv.build_session(model, fam.session_config(cfg),
                            state_dtype=torch.float32, device="cpu")
    return sess, w.__getitem__


def frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 50, 80, 3),
                                                dtype=np.uint8)


def stream(sess, n_frames):
    """Init prompt and n_frames one-frame chunks; returns each chunk's
    record as the benchmark keeps it (vision output, routes, store)."""
    recs = []
    vis = sess.vision
    enc = vis.encode

    def keep(*a):
        out = enc(*a)
        recs.append(dict(flat=out[0][0]))
        return out

    vis.encode = keep
    sess.encode_init_prompt([3, 1, 4, 1])
    for k, f in enumerate(frames(n_frames)):
        sess.encode_video(f[None])
        recs[-1].update(k=k, kvs=sess.kvs, route=sess.lm.route.clone())
    vis.encode = enc
    return recs


def ref_lm(cfg, get):
    return KimiLM(cfg, get, "cpu", fam.LM, fam.HEAD)


@pytest.fixture(scope="module")
def streamed():
    cfg = tiny_cfg()
    sess, get = build(cfg)
    recs = stream(sess, 12)  # past n_local: all three key groups
    return cfg, sess, get, recs


def test_pages_and_init_rows_match_the_reference(streamed):
    """Every layer's latent rows of 12 appends (the window full, the init
    rows at the one angle active after the 7th) and of the init prompt,
    against the reference's decompressed MLA and looped experts following
    the stream; the router never needed to follow the program."""
    cfg, sess, get, recs = streamed
    lm = ref_lm(cfg, get)
    lm.init_route = sess.lm.route_init.clone()
    gaps, _ = lm.page_gaps(recs)
    assert max(gaps) < TOL, gaps
    gap, _ = lm.init_gaps({0: sess.kvs}, [3, 1, 4, 1])
    assert gap < TOL
    assert int(sess.kvs.length[0, 0]) == 4 + 12 * 3 > cfg["session"][
        "rekv"]["n_local"]
    # the routing counters: each MoE layer's 12 appends of 3 tokens, top
    # 2; the experts each layer hit, summed over the appends, from the
    # routes the records kept
    counts = metrics.moe_counts(sess.lm)
    tokens = counts["tokens"]
    assert tokens[0].sum() == 0 and tokens[1:].sum(1).tolist() == [72] * 3
    hits = [sum(r["route"][l].unique().numel() for r in recs)
            for l in range(1, 4)]
    assert counts["hits"].tolist() == [0] + hits
    assert counts["appends"] == 12
    metrics.reset_moe_counts(sess.lm)
    counts = metrics.moe_counts(sess.lm)
    assert counts["tokens"].sum() == counts["hits"].sum() == 0
    assert counts["appends"] == 0


def test_absorbed_twin_matches_decompressed_attention(streamed):
    """Layer 1's attention output of the last append (all three key groups
    and their masks, through ops.latent_attention's plain twin) against
    the reference's decompressed attention over the program's rows."""
    cfg, sess, get, recs = streamed
    d = rk.KimiDims(cfg)
    W = rk.KimiWeights(get, d, fam.LM, fam.HEAD).layer(1)
    lm, kvs, k = sess.lm, sess.kvs, 11
    h = torch.randn((d.S, d.E), generator=torch.Generator().manual_seed(1))
    # the program: the store as it was before the append's own page
    store = type(kvs)(*(x[1].clone() for x in kvs))
    store.num_blocks.fill_(k)
    store.length.fill_(d.n_init + k * d.S)
    lp = lm.layers[1]
    q_abs, q_pe, rows = lm._latent_qkv(lp, rms(h, W["ln1"], d.eps)[None])
    rc = ReKVConfig(**cfg["session"]["rekv"])
    o = latent.append_latent(store, q_abs, q_pe, rows, rc, is_init=False,
                             scale=lm.cfg.scale, rope_base=lm.cfg.rope_base)
    got = h + lm._attn_out(lp, o)[0]
    win = kvs.block_c[1, 0, :k].flatten(0, 1)
    pos = d.n_init + torch.arange(k * d.S)
    want, row = rk.append_layer_attn(d, W, h, d.n_init + k * d.S,
                                     kvs.init_c[1, 0], win, pos, F32)
    assert rel(got, want) < TOL
    assert rel(rows[0], row) < TOL


def test_experts_match_with_equal_choices(streamed):
    """An MoE layer's routed + shared output and its top-2 choices (equal
    as integers) against the reference's router and Python loop."""
    cfg, sess, get, _ = streamed
    d = rk.KimiDims(cfg)
    W = rk.KimiWeights(get, d, fam.LM, fam.HEAD).layer(2)
    x = torch.randn((2, 9, d.E), generator=torch.Generator().manual_seed(2))
    lm = sess.lm
    idx, _ = lm.route_tokens(lm.layers[2], x.reshape(-1, d.E))
    got = lm._moe(2, lm.layers[2], x, None, False).reshape(-1, d.E)
    router = rk.Router(d)
    want_idx, _ = router.route(W, x.reshape(-1, d.E))
    assert torch.equal(idx.sort(-1).values, want_idx.sort(-1).values)
    # the reference's MLP residual in float64, so that taking its input
    # back off leaves its output exact: mlp normalises the input itself
    def f64(v):
        if torch.is_tensor(v):
            return v.double()
        return type(v)(f64(t) for t in v)

    h = x.reshape(-1, d.E).double()
    W64 = {n: f64(v) for n, v in W.items()}
    W64["ln2"] = torch.ones(d.E, dtype=torch.float64)
    want = rk.mlp(d, 2, W64, h, router, F32) - h
    normed = rms(h, W64["ln2"], d.eps).float()
    got = lm._moe(2, lm.layers[2], normed[None], None, False)[0]
    assert rel(got, want) < TOL
    assert router.followed == 0


def test_moonvit_and_pruner_match_the_reference(streamed):
    """MoonViT's features on the full path and the cacher's (the
    recomputed tokens equal as integers), and the pruner's kept tokens of
    a chunk, against the reference tower, merger, projector and pruner."""
    cfg, sess, get, _ = streamed
    vis, tower = sess.vision, sess.vision.model.vision
    f = torch.as_tensor(frames(2, seed=3))
    px = vis.device_preprocess(torch.as_tensor(vis.preprocess(f.numpy())))
    ref = fam.VisionReference(cfg, get, F32)
    assert rel(px, ref.px(f)) == 0.0
    h, refs = tower.encode_full(px[:1])
    want, rrefs = ref.tower.full(ref.px(f[:1]))
    assert rel(h, want) < TOL
    hc, sel = tower.encode_cached(px[1:], refs, 0.5)
    # handed the program's tokens, the reference takes none it would not
    # take itself: the choices are equal as integers
    wc = ref.tower.cached(ref.px(f[1:]), rrefs, 0.5, sel)
    assert rel(hc, wc) < TOL and ref.tower.followed == 0
    vstate, pstate = vis.init_state()
    flat, idx, _, _ = vis.encode(px[:1], vstate, pstate, False)
    kept = ref.chunk(None, f[:1], False, (torch.zeros(ref.n_sel), 0))
    assert row_rel(flat[0], kept) < TOL
    assert idx.shape == (1, 1, 3)


def test_question_answering_matches_the_reference_forward():
    """A question over a stream whose every block it retrieves (topk 8,
    6 blocks): each layer's blocks equal as integers, then the prompt's
    logits and four teacher-forced decode steps' against the reference's
    forward of the same tokens over the program's retrieved rows at their
    decode-cache slots."""
    cfg = tiny_cfg(n_local=256, topk=8, max_blocks=128)
    sess, get = build(cfg)
    stream(sess, 6)
    lm, rc = sess.lm, sess.rekv
    d = rk.KimiDims(cfg)
    dkvs = lm.init_decode_state(rc, 1, torch.float32)
    q, p, teach = [7, 8, 9], [10, 11], [12, 13, 14, 15]
    dkvs, abs_idx, exists = lm.qa_retrieve_step(
        rc, sess.kvs, dkvs, lm.embed_tokens(torch.tensor([q])),
        n_tokens=torch.tensor([len(q)]))
    for l in range(d.L):
        assert abs_idx[l, 0][exists[l, 0]].tolist() == list(range(6))
    logits, dkvs = lm.decode_step(rc, dkvs, lm.embed_tokens(
        torch.tensor([p])), torch.tensor([len(p)]))
    got = [logits[0]]
    for t in teach:
        logits, dkvs = lm.decode_step(rc, dkvs, lm.embed_tokens(
            torch.tensor([[t]])), torch.ones(1, dtype=torch.int32))
        got.append(logits[0])
    got = torch.cat(got)

    Wt = rk.KimiWeights(get, d, fam.LM, fam.HEAD)
    h = Wt.embed(p + teach)
    n_ctx = d.n_init + 6 * d.S
    pos = n_ctx + torch.arange(h.shape[0])
    ctx_pos = torch.arange(n_ctx)
    router = rk.Router(d)
    for l in range(d.L):
        W = Wt.layer(l)
        ctx = torch.cat([sess.kvs.init_c[l, 0],
                         sess.kvs.block_c[l, 0, :6].flatten(0, 1)])
        q_nope, q_pe, row = rk.project(d, W, h, F32)
        ck, cv = rk.keys(d, W, ctx, ctx_pos, F32)
        ok, ov = rk.keys(d, W, row, pos, F32)
        mask = rk.window_mask(pos, pos, d.n_local)
        o = rk.attend(rk.query(d, q_nope, q_pe, pos), [
            (None, ck, cv, rk.window_mask(pos, ctx_pos, d.n_local)),
            (None, ok, ov, mask)], d.V)
        h = rk.mlp(d, l, W, rk.attn_out(d, W, h, o, F32), router, F32)
    norm, head = Wt.final()
    want = rms(h, norm, d.eps) @ head.T
    assert rel(got, want) < TOL
    assert router.followed == 0


@pytest.mark.parametrize("fault", ["rope_whole_row", "no_bias",
                                   "no_shared"])
def test_planted_faults_fail(fault, monkeypatch):
    """A RoPE over the whole latent row (queries and init rows), the
    router's correction bias dropped, or the shared expert dropped: the
    page check reads 1e-2 or more, a thousand times TOL."""
    cfg = tiny_cfg()
    sess, get = build(cfg)
    lm = sess.lm
    if fault == "rope_whole_row":
        rot = latent._rot_tail

        def whole(x, P, cos, sin):
            n = x.shape[-1] // P
            return rot(x, x.shape[-1], torch.cat([cos] * n, -1),
                       torch.cat([sin] * n, -1))

        monkeypatch.setattr(latent, "_rot_tail", whole)
    for lp in lm.layers[1:]:
        if fault == "no_bias":
            lp.e_bias.zero_()
        if fault == "no_shared":
            lp.s_down.zero_()
    recs = stream(sess, 9)
    ref = ref_lm(cfg, get)
    ref.init_route = lm.route_init.clone()
    gaps, _ = ref.page_gaps(recs)
    gap, _ = ref.init_gaps({0: sess.kvs}, [3, 1, 4, 1])
    assert max(max(gaps), gap) > 1e3 * TOL, (fault, gaps, gap)


@pytest.mark.parametrize("setting", [
    dict(rekv=dict(kv_quant="int8")), dict(weights_quant="int8"),
    dict(rekv=dict(spec_decode_draft=2)),
    dict(rekv=dict(retrieval_scorer="aks")),
    dict(rekv=dict(window_kv_compression="select_top_half")),
    dict(rekv=dict(retrieved_kv_compression="filter_tokens_random")),
    dict(cacher=dict(sim_source="value")), dict(mesh=True)])
def test_unsupported_settings_raise_at_build(setting, streamed):
    from stc_tpu_torch.config import CacherConfig, SessionConfig
    from stc_tpu_torch.parallel.mesh import Mesh
    base = fam.session_config(tiny_cfg())
    rekv = ReKVConfig(**{**base.rekv.__dict__, **setting.get("rekv", {})})
    cacher = CacherConfig(**{**base.cacher.__dict__,
                             **setting.get("cacher", {})})
    scfg = SessionConfig(rekv=rekv, cacher=cacher, pruner=base.pruner,
                         weights_quant=setting.get("weights_quant", "none"))
    mesh = Mesh(("dp", "tp"), (1, 2), coord={"dp": 0, "tp": 0}) \
        if "mesh" in setting else None
    with pytest.raises(ValueError, match="not supported by a Kimi-VL"):
        kv.KimiVLSession(streamed[1].model, scfg, state_dtype=torch.float32,
                         mesh=mesh)


def test_eviction_and_the_latent_decode_on_a_card_refuse():
    """A stream past max_blocks refuses to evict; the latent decode's
    functions refuse any device but the CPU with the error that names the
    open item (the card half of this is test_torch_cuda.py's)."""
    cfg = tiny_cfg(max_blocks=24)
    sess, _ = build(cfg)
    sess.encode_init_prompt([3, 1, 4, 1])
    sess.encode_video(frames(24))
    with pytest.raises(RuntimeError, match="latent store"):
        sess.encode_video(frames(1))
    rc = sess.rekv
    dkv = latent.init_latent_decode(rc, 1, 48, device="meta")
    rows = torch.zeros((1, 2, 48), device="meta")
    with pytest.raises(NotImplementedError) as err:
        latent.latent_decode_write(dkv, rows, 2, 16, rope_base=1e4)
    assert str(err.value) == latent.LATENT_DECODE_ON_CARD
    with pytest.raises(NotImplementedError):
        latent.latent_decode_attend(
            torch.zeros((1, 2, 4, 32), device="meta"),
            torch.zeros((1, 2, 4, 16), device="meta"),
            torch.zeros((1, 2), dtype=torch.int64, device="meta"), dkv, rc,
            scale=0.1, rope_base=1e4)
