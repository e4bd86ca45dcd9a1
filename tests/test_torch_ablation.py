"""The port's ablation paths against stc_tpu's on the CPU
(tests/test_ablation.py's configuration: tiny Qwen2, block 8, topk 4):

- engine: compress_retrieved for every deterministic filter_tokens_*
  strategy (kept tokens equal, pages to F32_TOL), and the window
  compression of append_stream (stream_attention's plain twin with
  page_keep against stc_tpu's jnp append) on a float store, an int8 store,
  a ragged batch and a store past eviction: keep rows equal, outputs to
  F32_TOL (int8 store: the bf16-free dequantized arithmetic, same limit);
- sessions: each host-side block scorer, each compression, window
  compression and combinations, on one stream, a batch, ragged streams,
  a host tier and a pixel session: answer ids and every layer's retrieved
  blocks equal to stc_tpu's.  filter_tokens_random draws from a
  torch.Generator, so its sessions are held by structure.

Inputs are numpy draws shared by both packages; top-k inputs are
continuous random floats (no exact ties; tests/test_torch_tiebreak.py
plants those)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig, SessionConfig
from stc_tpu.kvcache import engine as je
from stc_tpu.kvcache import host_tier as jh
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.kvcache import host_tier as th
from stc_tpu_torch.kvcache.state import layer
from stc_tpu_torch.ops import stream_attention as sa
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg, tt)

pytestmark = pytest.mark.usefixtures("one_thread")

HQ, HKV, D = 4, 2, 16
CFG = ReKVConfig(n_init=4, n_local=64, block_size=8, exc_block_size=8,
                 topk=4, chunk_size=1, max_blocks=64,
                 max_prompt_tokens=16, max_new_tokens=8)
DETERMINISTIC = ("filter_tokens_simple", "filter_tokens_percentile",
                 "filter_tokens_magnitude",
                 "filter_tokens_euclidean_distance",
                 "filter_tokens_inverse_cosine", "filter_tokens_top_half")


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

class Both:
    """stc_tpu's and the port's stream state for B streams (the port's
    layer-stacked with one layer, so host_tier.evict_pages applies), fed
    the same draws."""

    def __init__(self, cfg, batch=1, seed=0):
        self.cfg, self.pc = cfg, port_cfg(cfg)
        self.rng = np.random.default_rng(seed)
        self.B = batch
        self.j = je.init_stream_kv(cfg, batch, HKV, D, dtype=jnp.float32)
        self.t_all = te.init_stream_kv(self.pc, batch, HKV, D,
                                       dtype=torch.float32, device="cpu",
                                       layers=1)
        self.append(cfg.n_init, is_init=True)

    @property
    def t(self):
        return layer(self.t_all, 0)

    def append(self, n, is_init=False, active=None):
        B, r = self.B, self.rng
        q = r.normal(size=(B, HQ, n, D)).astype(np.float32)
        k = r.normal(size=(B, HKV, n, D)).astype(np.float32)
        v = r.normal(size=(B, HKV, n, D)).astype(np.float32)
        oj, self.j = je.append_stream(
            self.j, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), self.cfg,
            is_init=is_init,
            active=None if active is None else jnp.asarray(active))
        ot, _ = te.append_stream(
            self.t, tt(q), tt(k), tt(v), self.pc, is_init=is_init,
            active=None if active is None else torch.as_tensor(active))
        return np.asarray(oj), ot.numpy()

    def evict(self, n):
        *_, new = jh.evict_pages(jax.tree.map(lambda x: x[None], self.j), n)
        self.j = jax.tree.map(lambda x: x[0], new)
        th.evict_pages(self.t_all, n, None)


def _assert_pages_equal(both):
    j, t = both.j, both.t
    for name in ("num_blocks", "length", "page_offset"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    np.testing.assert_array_equal(t.page_keep.numpy(),
                                  np.asarray(j.page_keep))


@pytest.mark.parametrize("strategy", DETERMINISTIC)
def test_compress_retrieved_matches_jax(strategy):
    cfg = dataclasses.replace(CFG, retrieved_kv_compression=strategy)
    both = Both(cfg)
    for _ in range(7):
        both.append(8)
    q = np.random.default_rng(1).normal(size=(1, HQ, 6, D)).astype(
        np.float32)
    jr = je.retrieve_blocks(both.j, jnp.asarray(q), cfg)
    ck, cv, nv = je.compress_retrieved(both.j, cfg, jr[0], jr[1], jr[3])
    tr = te.retrieve_blocks(both.t, tt(q), both.pc)
    gk, gv, gn = te.compress_retrieved(both.t, both.pc, tr[0], tr[1], tr[3])
    np.testing.assert_array_equal(gn.numpy(), np.asarray(nv))
    assert gk.shape[2] == cfg.n_init + cfg.topk * cfg.block_size // 2
    np.testing.assert_allclose(gk.numpy(), np.asarray(ck), **F32_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(cv), **F32_TOL)
    # the kept rows are rows of the retrieved prefix, block order kept
    kept = tr[0][0, 0, cfg.n_init:]
    for row in gk[0, 0, cfg.n_init:]:
        assert (kept == row).all(dim=-1).any()


def test_compress_retrieved_random_structure():
    cfg = dataclasses.replace(CFG,
                              retrieved_kv_compression="filter_tokens_random")
    both = Both(cfg)
    for _ in range(9):
        both.append(8)
    q = tt(np.random.default_rng(2).normal(size=(1, HQ, 5, D)))
    rk, rv, _, vl = te.retrieve_blocks(both.t, q, both.pc)

    def run(seed):
        return te.compress_retrieved(both.t, both.pc, rk, rv, vl,
                                     torch.Generator().manual_seed(seed))

    a, b = run(3), run(3)
    assert torch.equal(a[0], b[0]) and int(a[2][0]) == 4 + 4 * 4
    S, nI = cfg.block_size, cfg.n_init
    for f in range(cfg.topk):  # half of each block, from that block
        blk = rk[0, :, nI + f * S:nI + (f + 1) * S]
        for j in range(S // 2):
            row = a[0][0, :, nI + f * (S // 2) + j]
            assert (blk == row[:, None]).all(dim=-1).all(dim=0).any()
    with pytest.raises(ValueError, match="Generator"):
        te.compress_retrieved(both.t, both.pc, rk, rv, vl)


WIN = dataclasses.replace(CFG, window_kv_compression="select_top_half",
                          max_blocks=16)


@pytest.mark.parametrize("case", ["f32", "int8", "ragged", "evicted",
                                  "multi-page"])
def test_window_compression_append_matches_jax(case):
    """Every append: the output (stream_attention's twin with the window's
    keep rows) to F32_TOL, keep rows and counters exactly."""
    cfg = WIN
    if case == "int8":
        cfg = dataclasses.replace(cfg, kv_quant="int8")
    if case == "multi-page":
        cfg = dataclasses.replace(cfg, exc_block_size=24)
    both = Both(cfg, batch=2 if case == "ragged" else 1, seed=3)
    rng = np.random.default_rng(4)
    T = 24 if case == "multi-page" else 8
    n = 5 if case == "multi-page" else 12
    for step in range(n):
        active = None
        if case == "ragged":
            active = np.array([True, bool(rng.integers(0, 2))])
        if case == "evicted" and step == 10:
            both.evict(4)
        oj, ot = both.append(T, active=active)
        rows = slice(None) if active is None else active
        np.testing.assert_allclose(ot[rows], oj[rows], err_msg=str(step),
                                   **F32_TOL)
        _assert_pages_equal(both)
    keep = both.t.page_keep[0].numpy()
    written = int(both.t.num_blocks[0] - both.t.page_offset[0])
    assert (keep[:written].sum(-1) == 4).all()
    assert keep[written:].all()
    if case == "evicted":
        assert int(both.t.page_offset[0]) == 4


def test_page_keep_none_equals_all_ones():
    """The kernel wrapper's plain twin: no mask and an all-ones mask give
    the same output, bit for bit; a mask that drops keys changes it."""
    both = Both(CFG, seed=5)
    for _ in range(10):
        both.append(8)
    kv = both.t
    rng = np.random.default_rng(6)
    q = tt(rng.normal(size=(1, HQ, 8, D)))
    rc = te.make_rope_cache(kv.length, kv.num_blocks - 1, 8, both.pc, D,
                            10000.0, kv.page_offset)
    from stc_tpu_torch.ops.rope import rotate
    q_rot = rotate(q, rc.cos_q, rc.sin_q).contiguous()
    q_one = rotate(q, rc.cos_one, rc.sin_one).contiguous()
    k_ir = rotate(kv.init_k, rc.cos_init[:, None],
                  rc.sin_init[:, None]).contiguous()
    args = (q_rot, q_one, kv.block_k, kv.block_v, rc.cos_cover,
            rc.sin_cover, k_ir, kv.init_v, kv.init_k, rc.scalars)
    none = sa.stream_attention(*args, n_local=CFG.n_local)
    ones = sa.stream_attention(*args, n_local=CFG.n_local,
                               page_keep=torch.ones_like(kv.page_keep))
    assert torch.equal(none, ones)
    half = torch.ones_like(kv.page_keep)
    half[:, :, ::2] = False
    dropped = sa.stream_attention(*args, n_local=CFG.n_local,
                                  page_keep=half)
    assert not torch.allclose(none, dropped)
    with pytest.raises(ValueError, match="page_keep"):
        sa.stream_attention(*args, n_local=CFG.n_local,
                            page_keep=half.to(torch.uint8))


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

MCFG = jq.Qwen2Config.tiny()
BASE = dict(n_init=6, n_local=256, block_size=8, exc_block_size=8, topk=4,
            chunk_size=1, max_blocks=64, max_prompt_tokens=64,
            max_new_tokens=8)


def make_sessions(rekv_kw, batch=1, seed=0, kv_dtype=(jnp.float32,
                                                      torch.float32)):
    rekv = ReKVConfig(**dict(BASE, **rekv_kw))
    scfg = SessionConfig(rekv=rekv)
    params = jq.init_params(MCFG, jax.random.key(seed))
    j = JSession(params, MCFG, scfg, batch=batch, state_dtype=kv_dtype[0])
    t = TSession(weights.qwen2_from_jax(np_tree(params),
                                        port_model_cfg(MCFG), device="cpu"),
                 port_cfg(scfg), batch=batch, state_dtype=kv_dtype[1])
    for s in (j, t):
        s.encode_init_prompt(list(range(6)))
    return j, t


def feed(j, t, feats, active=None):
    j.encode_video_features(feats, active=active)
    t.encode_video_features(torch.from_numpy(feats), active=active)


def ask_both(j, t, question, prompt, scorer_indices=True):
    want = j.question_answering(question, prompt, [0], max_new_tokens=6)
    got = t.question_answering(question, prompt, [0], max_new_tokens=6)
    assert got == want
    if scorer_indices:
        assert t.last_retrieved_indices == j.last_retrieved_indices
    return got


SETTINGS = [
    dict(retrieval_scorer="aks"),
    dict(retrieval_scorer="dpc_knn"),
    dict(retrieval_scorer="l2norm", chunk_size=2),
    dict(window_kv_compression="select_top_half"),
    dict(retrieval_scorer="aks",
         retrieved_kv_compression="filter_tokens_simple"),
    dict(retrieval_scorer="dpc_knn",
         window_kv_compression="select_top_half",
         retrieved_kv_compression="filter_tokens_top_half"),
] + [dict(retrieved_kv_compression=s) for s in DETERMINISTIC]


@pytest.mark.parametrize("kw", SETTINGS, ids=lambda kw: "+".join(
    f"{v}" for v in kw.values()))
def test_session_matches_jax(kw):
    """Interleaved encode and questions: answers equal; with a host-side
    scorer every layer's blocks equal; with window compression every
    layer's keep rows equal."""
    j, t = make_sessions(kw)
    rng = np.random.default_rng(0)
    layerwise = kw.get("retrieval_scorer", "mean_dot") != "mean_dot"
    for n, (q, p) in ((12, ([3, 4, 5], [3, 4, 5, 6])),
                      (8, ([7, 8], [7, 8, 9]))):
        feed(j, t, rng.normal(size=(1, n * 8, MCFG.hidden_size)).astype(
            np.float32))
        ask_both(j, t, q, p, scorer_indices=layerwise)
        if layerwise:
            assert len(t.last_retrieved_indices) == MCFG.num_layers
    np.testing.assert_array_equal(t.kvs.page_keep.numpy(),
                                  np.asarray(j.kvs.page_keep))
    if "window_kv_compression" in kw:
        assert (t.kvs.page_keep[:, 0, :20].sum(-1) == 4).all()


def test_window_compression_int8_store_matches_jax():
    j, t = make_sessions(dict(window_kv_compression="select_top_half",
                              kv_quant="int8", retrieval_scorer="l2norm"))
    feats = np.random.default_rng(1).normal(
        size=(1, 16 * 8, MCFG.hidden_size)).astype(np.float32)
    feed(j, t, feats)
    ask_both(j, t, [3, 4, 5], [3, 4, 5, 6])
    np.testing.assert_array_equal(t.kvs.page_keep.numpy(),
                                  np.asarray(j.kvs.page_keep))


def test_random_compression_session_structure():
    """filter_tokens_random: each prefix keeps half of each retrieved
    block (the cursor is stc_tpu's), and a session is reproducible."""
    kw = dict(retrieved_kv_compression="filter_tokens_random")
    feats = np.random.default_rng(2).normal(
        size=(1, 14 * 8, MCFG.hidden_size)).astype(np.float32)
    answers = []
    for _ in range(2):
        j, t = make_sessions(kw)
        feed(j, t, feats)
        answers.append(t.question_answering([3, 4], [3, 4, 5], [0],
                                            max_new_tokens=6))
        assert 1 <= len(answers[-1]) <= 6
    assert answers[0] == answers[1]
    qids = np.zeros((1, 8), np.int32)
    qids[0, :2] = [3, 4]
    jd = j._qa_retrieve_layerwise(qids, 2)
    td = t._qa_retrieve_layerwise(qids, np.array([2], np.int32))
    np.testing.assert_array_equal(td.cursor.numpy(), np.asarray(jd.cursor))
    assert int(td.cursor[0, 0]) == 6 + 4 * 4


@pytest.mark.parametrize("scorer", ["aks", "l2norm"])
def test_layerwise_scorer_batch_and_ragged_match_jax(scorer):
    """Two streams: question_answering_batch over uniform streams, then
    ragged ingest (stream 1 idle for some chunks) and a shared question:
    answers and every layer's per-stream blocks equal."""
    j, t = make_sessions(dict(retrieval_scorer=scorer), batch=2)
    rng = np.random.default_rng(3)
    feed(j, t, rng.normal(size=(2, 10 * 8, MCFG.hidden_size)).astype(
        np.float32))
    qs, ps = [[3, 4, 5], [9, 10]], [[3, 4, 5, 6], [9, 10, 11]]
    want = j.question_answering_batch(qs, ps, [0], max_new_tokens=5)
    got = t.question_answering_batch(qs, ps, [0], max_new_tokens=5)
    assert got == want
    assert t.last_retrieved_indices == j.last_retrieved_indices
    for step in range(4):
        act = np.array([True, step % 2 == 0])
        feed(j, t, rng.normal(size=(2, 8, MCFG.hidden_size)).astype(
            np.float32), active=act)
    want = j.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=5,
                                all_streams=True)
    got = t.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=5,
                               all_streams=True)
    assert got == want
    assert t.last_retrieved_indices == j.last_retrieved_indices


@pytest.mark.parametrize("kw", [
    dict(retrieval_scorer="l2norm", host_kv_quant="none"),
    dict(retrieval_scorer="dpc_knn", host_kv_quant="int8",
         retrieved_kv_compression="filter_tokens_magnitude"),
    dict(window_kv_compression="select_top_half", host_kv_quant="none"),
])
def test_host_tier_ablation_matches_jax(kw):
    """A store of 32 pages evicts to the host: the layerwise scorers fetch
    the host pages they pick, and window keep rows shift with their pages;
    answers and blocks equal stc_tpu's."""
    j, t = make_sessions(dict(kw, n_local=128, max_blocks=32,
                              max_rep_blocks=256))
    rng = np.random.default_rng(4)
    for n in (30, 14):
        feed(j, t, rng.normal(size=(1, n * 8, MCFG.hidden_size)).astype(
            np.float32))
        ask_both(j, t, [5, 6, 7], [5, 6, 7, 8],
                 scorer_indices="retrieval_scorer" in kw)
    assert t._evicted_pages == j._evicted_pages > 0
    np.testing.assert_array_equal(t.kvs.page_keep.numpy(),
                                  np.asarray(j.kvs.page_keep))
    if "retrieval_scorer" in kw:
        assert t.host_store.fetch_count == j.host_store.fetch_count > 0


def test_pixel_session_window_compression_and_scorer_match_jax():
    """The tiny LLaVA-OV pixel session of tests/test_torch_session.py with
    window compression and the dpc_knn scorer: counters, keep rows,
    answers and every layer's blocks equal."""
    from stc_tpu.config import CacherConfig, PrunerConfig
    from stc_tpu.models import llava_onevision as jlo
    from stc_tpu_torch.models import llava_onevision as tlo
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=6, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8,
                        retrieval_scorer="dpc_knn",
                        window_kv_compression="select_top_half"),
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(token_per_frame=3), encode_chunk_frames=2)
    params = jlo.init_random_params(cfg, jax.random.key(0))
    j = jlo.build_session(params, cfg, scfg, state_dtype=jnp.float32)
    t = tlo.build_session(weights.params_from_jax(
        np_tree(params), port_model_cfg(cfg), device="cpu"),
        port_cfg(scfg), state_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(56, 56, 3))
    frames = np.clip(base[None] + rng.normal(0, 40, size=(10, 56, 56, 3)),
                     0, 255).astype(np.uint8)
    for s in (j, t):
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video(frames)
    np.testing.assert_array_equal(t.kvs.page_keep.numpy(),
                                  np.asarray(j.kvs.page_keep))
    ask_both(j, t, [7, 8, 9], [7, 8, 9, 10])
