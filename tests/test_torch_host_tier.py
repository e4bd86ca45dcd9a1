"""The port's host tier against stc_tpu's, at tests/test_host_tier.py's
configuration (tiny Qwen2, n_local 128, block 8, topk 4, max_blocks 32
evicting against 256 all-device), batch 1.  Both packages' sessions are
built from the same weights and fed the same features.

Exact: counters, page_offset, host-store pages (int8 and packed int4),
retrieved indices and answer ids.  Rounds: stc_tpu repeats its
speculative round until one serves every selection; the port stages a
missing layer's pages inside its second round instead, so its rounds are
stc_tpu's capped at 2, and its fetch_count equals stc_tpu's while stc_tpu
took at most 2 rounds (more rounds fetch pages the exact forward never
selects).  Float32 host pages
and stc_tpu's host-tier scales to F32_TOL: the two packages' float pages
differ in their last bits (summation order), and stc_tpu's jitted quantizer
multiplies by the rounded reciprocal of 127 (or 7) where it divides (XLA
rewrites the division).  The port's scales are held exactly to the
correctly rounded quotient max|x| / 127 (or / 7) of its own pages.  The
evicting port session also answers exactly as an all-device port session
does (host_kv_quant none)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig, SessionConfig
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.kvcache import host_tier
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

MCFG = jq.Qwen2Config.tiny()
QUESTIONS = ([5, 6, 7], [40, 41], [99, 98, 97, 96], [1, 2, 3], [120])


def rekv(max_blocks, quant="none", chunk_size=1, max_rep_blocks=256,
         kv_quant="none"):
    return ReKVConfig(n_init=6, n_local=128, block_size=8, exc_block_size=8,
                      topk=4, chunk_size=chunk_size, max_blocks=max_blocks,
                      max_rep_blocks=max_rep_blocks, max_prompt_tokens=64,
                      max_new_tokens=8, host_kv_quant=quant,
                      kv_quant=kv_quant)


def sessions(seed, batch=1, jax_too=True, **kw):
    """(stc_tpu session or None, port session) over the same weights."""
    scfg = SessionConfig(rekv=rekv(**kw))
    params = jq.init_params(MCFG, jax.random.key(seed))
    t = TSession(weights.qwen2_from_jax(np_tree(params),
                                        port_model_cfg(MCFG), device="cpu"),
                 port_cfg(scfg), batch=batch, state_dtype=torch.float32)
    j = (JSession(params, MCFG, scfg, batch=batch, state_dtype=jnp.float32)
         if jax_too else None)
    return j, t


def feed(sessions_, feats):
    for s in sessions_:
        if s is None:
            continue
        if isinstance(s, TSession):
            s.encode_video_features(torch.from_numpy(feats))
        else:
            s.encode_video_features(feats)


def start(sessions_):
    for s in sessions_:
        if s is not None:
            s.encode_init_prompt(list(range(6)))


class Rounds:
    """Counts the rounds of the stc_tpu session's two-tier QA (calls of its
    one-round program) and holds the port's to them."""

    def __init__(self, jsess):
        self.calls, self.within_two = [], True
        inner = jsess._answer_host

        def counting(*a, **k):
            self.calls.append(1)
            return inner(*a, **k)

        jsess._answer_host = counting
        self.j = jsess

    def ask(self, t, *args, **kw):
        """(port answer, stc_tpu answer) of one question, with the port's
        rounds stc_tpu's capped at 2 and, while stc_tpu's stayed within
        2, the same fetch_count."""
        self.calls.clear()
        want = self.j.question_answering(*args, **kw)
        got = t.question_answering(*args, **kw)
        rounds = len(self.calls) or 1  # no eviction yet: one fused round
        assert t.qa_rounds == min(rounds, 2), (t.qa_rounds, rounds)
        self.within_two &= rounds <= 2
        self.check_fetch(t)
        return got, want

    def check_fetch(self, t):
        if self.within_two:
            assert t.host_store.fetch_count == \
                self.j.host_store.fetch_count


def correctly_rounded_scales(pages, qmax):
    """numpy: max(max |x| over the S rows, 1e-8) / qmax, each quotient
    correctly rounded in float32."""
    a = np.maximum(np.abs(pages).max(axis=-2), np.float32(1e-8))
    return a / np.float32(qmax)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_eviction_state_and_host_pages_match_jax(quant):
    """40 blocks through a 32-page store: one eviction of 8 pages; every
    counter equal to stc_tpu's; host pages equal (int8 / int4 values
    exactly, float32 to F32_TOL); the resident pages equal the all-device
    session's at the same absolute indices."""
    j, t = sessions(1, max_blocks=32, quant=quant)
    _, big = sessions(1, jax_too=False, max_blocks=256, quant=quant)
    start((j, t, big))
    feed((j, t, big), np.random.default_rng(1).normal(
        size=(1, 40 * 8, MCFG.hidden_size)).astype(np.float32))
    assert t._evicted_pages == j._evicted_pages == 8
    assert big._evicted_pages == 0
    for name in ("num_blocks", "page_offset", "length"):
        np.testing.assert_array_equal(getattr(t.kvs, name).numpy(),
                                      np.asarray(getattr(j.kvs, name)), name)
    assert t.kvs.page_offset.unique().tolist() == [8]
    hs, js = t.host_store, j.host_store
    assert hs.total_pages == js.total_pages == 8
    assert hs.pages_per_chunk == js.pages_per_chunk
    assert hs.quantized == js.quantized == (quant != "none")
    assert hs.nbytes() == js.nbytes()
    assert t.kv_memory_bytes() == j.kv_memory_bytes()
    # resident pages: the all-device store shifted by the 8 evicted pages
    np.testing.assert_array_equal(t.kvs.block_k[:, :, :, :32].numpy(),
                                  big.kvs.block_k[:, :, :, 8:40].numpy())
    truth = big.kvs.block_k[:, :, :, :8].numpy()
    for got, want in zip(hs.k_chunks + hs.v_chunks,
                         js.k_chunks + js.v_chunks):
        assert got.dtype == {"none": torch.float32, "int8": torch.int8,
                             "int4": torch.uint8}[quant]
        if quant == "none":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **F32_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if quant != "none":
        qmax = 127.0 if quant == "int8" else 7.0
        np.testing.assert_array_equal(hs.k_scales[0].numpy(),
                                      correctly_rounded_scales(truth, qmax))
        for got, want in zip(hs.k_scales + hs.v_scales,
                             js.k_scales + js.v_scales):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **F32_TOL)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_hosttier_qa_matches_jax_and_all_device(quant):
    """Five questions over a stream evicted to the host tier: answer ids,
    every layer's retrieved blocks, rounds and fetch_count equal to
    stc_tpu's evicting session; with exact host pages the answers equal the
    all-device port session's too."""
    j, t = sessions(2, max_blocks=32, quant=quant)
    _, big = sessions(2, jax_too=False, max_blocks=256)
    start((j, t, big))
    feed((j, t, big), np.random.default_rng(2).normal(
        size=(1, 40 * 8, MCFG.hidden_size)).astype(np.float32))
    rounds = Rounds(j)
    for q in QUESTIONS:
        p = q + [8]
        got, want = rounds.ask(t, q, p, [0], max_new_tokens=6)
        assert got == want, q
        assert t.last_retrieved_indices == j.last_retrieved_indices, q
        if quant == "none":
            assert got == big.question_answering(q, p, [0],
                                                 max_new_tokens=6), q
            assert big.last_retrieved_indices == t.last_retrieved_indices
    assert t.host_store.fetch_count > 0


def test_hosttier_qa_at_3x_capacity_chunked():
    """96 blocks through a 32-page store (64 pages evicted), chunk_size 2
    scoring: answers and retrieval equal to stc_tpu's evicting session and
    to the all-device port session."""
    j, t = sessions(4, max_blocks=32, chunk_size=2)
    _, big = sessions(4, jax_too=False, max_blocks=128, chunk_size=2)
    start((j, t, big))
    feed((j, t, big), np.random.default_rng(4).normal(
        size=(1, 96 * 8, MCFG.hidden_size)).astype(np.float32))
    assert t._evicted_pages == j._evicted_pages >= 64
    rounds = Rounds(j)
    for q in QUESTIONS[:4]:
        got, want = rounds.ask(t, q, q + [8], [0], max_new_tokens=6)
        assert got == want == big.question_answering(q, q + [8], [0],
                                                     max_new_tokens=6), q
        assert t.last_retrieved_indices == j.last_retrieved_indices \
            == big.last_retrieved_indices, q
    assert t.host_store.fetch_count > 0


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_external_indices_served_from_host(quant):
    """External retrieval of pages 0-3, all evicted: staged from the host
    before the first round (one round), answers equal stc_tpu's and, with
    exact pages, the all-device session's."""
    j, t = sessions(5, max_blocks=32, quant=quant)
    _, big = sessions(5, jax_too=False, max_blocks=256)
    start((j, t, big))
    feed((j, t, big), np.random.default_rng(5).normal(
        size=(1, 40 * 8, MCFG.hidden_size)).astype(np.float32))
    assert t._evicted_pages >= 4
    ext = [0, 1, 2, 3]
    fc0 = t.host_store.fetch_count
    want = j.question_answering([9, 8], [9, 8, 7], [0], max_new_tokens=6,
                                retrieved_indices=ext)
    got = t.question_answering([9, 8], [9, 8, 7], [0], max_new_tokens=6,
                               retrieved_indices=ext)
    assert got == want
    assert t.qa_rounds == 1
    assert t.host_store.fetch_count - fc0 == 4 * MCFG.num_layers
    assert t.host_store.fetch_count == j.host_store.fetch_count
    assert t.staged_bytes == 4 * MCFG.num_layers * 2 * 2 * 8 * 16 * (
        4 if quant == "none" else 1) + (
        0 if quant == "none" else 4 * MCFG.num_layers * 2 * 2 * 16 * 4)
    assert t.last_retrieved_indices == [ext] * MCFG.num_layers
    if quant == "none":
        assert got == big.question_answering([9, 8], [9, 8, 7], [0],
                                             max_new_tokens=6,
                                             retrieved_indices=ext)


def test_hosttier_qa_rounds_bounded():
    """At most 2 rounds cold and 1 warm (the table persists across
    questions); where stc_tpu's speculative loop needs a third round, the
    port's staged second round answers the same, exactly as the
    all-device session."""
    j, t = sessions(2, max_blocks=32)
    _, big = sessions(2, jax_too=False, max_blocks=256)
    start((j, t, big))
    feed((j, t, big), np.random.default_rng(2).normal(
        size=(1, 40 * 8, MCFG.hidden_size)).astype(np.float32))
    rounds = Rounds(j)
    for q in ([5, 6, 7], [5, 6, 7], [99, 98, 97, 96], [99, 98, 97, 96]):
        got, want = rounds.ask(t, q, q + [8], [0], max_new_tokens=4)
        assert got == want == big.question_answering(q, q + [8], [0],
                                                     max_new_tokens=4)
        assert t.qa_rounds <= 2
    assert not rounds.within_two  # stc_tpu took 3 rounds on one question
    assert t.qa_rounds == 1 and t.repair_layers == 0  # warm


def test_rep_capacity_overflow_raises():
    """Past rep_cap both sessions refuse the next block."""
    j, t = sessions(6, max_blocks=32, max_rep_blocks=40)
    start((j, t))
    rng = np.random.default_rng(6)
    feed((j, t), rng.normal(size=(1, 40 * 8, MCFG.hidden_size)).astype(
        np.float32))  # exactly rep_cap blocks: fine
    one = rng.normal(size=(1, 8, MCFG.hidden_size)).astype(np.float32)
    with pytest.raises(RuntimeError, match="rep-key capacity"):
        j.encode_video_features(one)
    with pytest.raises(RuntimeError, match="rep-key capacity"):
        t.encode_video_features(torch.from_numpy(one))


def test_rep_capacity_guard_covers_pixel_path():
    """The pixel path funnels through the same rep-capacity check."""
    from stc_tpu_torch.config import (CacherConfig, PrunerConfig,
                                      ReKVConfig as TReKV,
                                      SessionConfig as TSCfg)
    from stc_tpu_torch.models import llava_onevision as lo
    scfg = TSCfg(
        rekv=TReKV(n_init=4, n_local=128, block_size=3, exc_block_size=3,
                   topk=4, max_blocks=64, max_rep_blocks=4,
                   max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=3))
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(
                           torch.Generator().manual_seed(6))
    sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu")
    sess.encode_init_prompt([1, 2, 3, 4])
    frames = np.random.default_rng(6).uniform(
        0, 255, size=(5, 56, 56, 3)).astype(np.uint8)
    sess.encode_video(frames[:4])  # exactly rep_cap frames: fine
    with pytest.raises(RuntimeError, match="rep-key capacity"):
        sess.encode_video(frames[4:5])


@pytest.mark.parametrize("quant,limit", [("int8", 0.375), ("int4", 0.25)])
def test_quantized_host_tier_bytes_and_error_bound(quant, limit):
    """host_kv_quant int8 (int4): host bytes at most 0.375x (0.25x) of the
    float32 tier's at S = 8, as stc_tpu's; dequantized fetches within
    absmax / 254 (absmax / 14) of the true pages."""
    _, tq = sessions(2, jax_too=False, max_blocks=32, quant=quant)
    _, tf = sessions(2, jax_too=False, max_blocks=32)
    _, big = sessions(2, jax_too=False, max_blocks=256)
    start((tq, tf, big))
    feed((tq, tf, big), np.random.default_rng(2).normal(
        size=(1, 40 * 8, MCFG.hidden_size)).astype(np.float32))
    assert tq.host_store.quantized and not tf.host_store.quantized
    assert tq.host_store.nbytes() <= limit * tf.host_store.nbytes()
    n = tq._evicted_pages
    hk, hv = tq.host_store.fetch(0, 0, range(n))          # (n, Hkv, S, D)
    div = 254.0 if quant == "int8" else 14.0
    for got, x in ((hk, big.kvs.block_k), (hv, big.kvs.block_v)):
        want = x[0, 0, :, :n].transpose(0, 1).numpy()
        bound = np.abs(want).max(axis=2, keepdims=True) / div + 1e-6
        assert np.all(np.abs(got.numpy() - want) <= bound + 1e-5)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_interleaved_stream_and_qa(quant):
    """Stream past capacity, ask, stream 16 more blocks (more evictions),
    ask, ask again (warm table, one round): every answer equal to
    stc_tpu's, the repeat equal to the first."""
    j, t = sessions(9, max_blocks=32, quant=quant)
    start((j, t))
    rng = np.random.default_rng(9)
    feed((j, t), rng.normal(size=(1, 40 * 8, MCFG.hidden_size)).astype(
        np.float32))
    ev1 = t._evicted_pages
    assert ev1 > 0
    rounds = Rounds(j)
    a1, want = rounds.ask(t, [5, 6, 7], [5, 6, 7, 8], [0], max_new_tokens=4)
    assert a1 == want
    feed((j, t), rng.normal(size=(1, 16 * 8, MCFG.hidden_size)).astype(
        np.float32))
    assert t._evicted_pages == j._evicted_pages > ev1
    a2, want = rounds.ask(t, [40, 41], [40, 41, 42], [0], max_new_tokens=4)
    assert a2 == want
    a3 = t.question_answering([40, 41], [40, 41, 42], [0], max_new_tokens=4)
    assert a3 == a2 and t.qa_rounds == 1


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_chunked_store_shift_equals_clone_shift(kv_quant):
    """evict_pages' chunked in-place shift equals the clone-based one:
    pages, scales and keep rows move left by E, vacated pages and scales
    read zero and vacated keep rows one; the E oldest pages land in the
    staging tensors; page_offset advances by E."""
    from stc_tpu_torch.config import ReKVConfig as TReKV
    from stc_tpu_torch.kvcache import engine
    cfg = TReKV(n_init=4, n_local=64, block_size=4, exc_block_size=4,
                topk=4, max_blocks=40, kv_quant=kv_quant)
    kvs = engine.init_stream_kv(cfg, 2, 2, 8, torch.float32, device="cpu",
                                layers=3)
    gen = torch.Generator().manual_seed(0)
    for x in (kvs.block_k, kvs.block_v, kvs.block_k_scale,
              kvs.block_v_scale):
        x.copy_((torch.rand(x.shape, generator=gen) * 200 - 100).to(x.dtype))
    kvs.page_keep.copy_(torch.rand(kvs.page_keep.shape, generator=gen) > .5)
    E = 9  # does not divide the 40 pages: a short last chunk
    src = [kvs.block_k, kvs.block_v]
    if kv_quant != "none":
        src += [kvs.block_k_scale, kvs.block_v_scale]
    want = [torch.cat([x[:, :, :, E:], torch.zeros_like(x[:, :, :, :E])],
                      dim=3) for x in src]
    want_keep = torch.cat([kvs.page_keep[:, :, E:],
                           torch.ones_like(kvs.page_keep[:, :, :E])], dim=2)
    heads = [x[:, :, :, :E].clone() for x in src]
    staged = [torch.empty_like(h) for h in heads]
    host_tier.evict_pages(kvs, E, staged)
    for got, w in zip(src, want):
        assert torch.equal(got, w)
    for got, w in zip(staged, heads):
        assert torch.equal(got, w)
    assert torch.equal(kvs.page_keep, want_keep)
    assert kvs.page_offset.unique().tolist() == [E]


def test_pixel_session_streams_past_max_blocks():
    """The port's pixel session no longer stops at max_blocks: 3x the
    store through evictions, with answers and retrieval equal to an
    all-device pixel session on the same frames."""
    from stc_tpu_torch.config import (CacherConfig, PrunerConfig,
                                      ReKVConfig as TReKV,
                                      SessionConfig as TSCfg)
    from stc_tpu_torch.models import llava_onevision as lo

    def scfg(max_blocks):
        return TSCfg(
            rekv=TReKV(n_init=4, n_local=24, block_size=3, exc_block_size=3,
                       topk=4, max_blocks=max_blocks, max_rep_blocks=64,
                       max_prompt_tokens=32, max_new_tokens=8,
                       host_kv_quant="none"),
            cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                                cache_interval=2),
            pruner=PrunerConfig(strategy="stc", token_per_frame=3))

    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(
                           torch.Generator().manual_seed(3))
    small, big = (lo.build_session(model, scfg(mb), device="cpu",
                                   state_dtype=torch.float32)
                  for mb in (24, 64))
    frames = np.random.default_rng(3).uniform(
        0, 255, size=(48, 56, 56, 3)).astype(np.uint8)
    for s in (small, big):
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video(frames)
    assert small._evicted_pages == 24 and big._evicted_pages == 0
    assert small.kvs.num_blocks.unique().tolist() == [48]
    for q in ([7, 8, 9], [5, 6]):
        assert small.question_answering(q, q + [3], [0], max_new_tokens=6) \
            == big.question_answering(q, q + [3], [0], max_new_tokens=6)
        assert small.last_retrieved_indices == big.last_retrieved_indices
    assert small.host_store.fetch_count > 0
