"""Continuous-batching serving in the port (tests/test_serving.py's cases):
per-stream questions, the serving tick (StreamingSession.serve and
VLMSession.serve) and the ServingEngine.

Contract: the serve tick equals an encode followed by the batched QA, on
answers and on every state leaf (bit for bit, the same code runs); each
slot answers as an independent session over the chunks it drained; and
the engine's answers and counters equal stc_tpu's engine on the same
traffic (answer ids exactly; stc_tpu's measured-cost router is not ported,
so the fused-tick count is the port's eligibility count)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.serving import ServingEngine as JEngine
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.runtime.serving import ServingEngine as TEngine
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from test_torch_common import (np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

RC = ReKVConfig(n_init=4, n_local=128, block_size=8, exc_block_size=8,
                topk=4, chunk_size=1, max_blocks=64,
                max_prompt_tokens=16, max_new_tokens=8)
STOP = [0]
QUESTIONS = [([5, 6, 7], [5, 6, 7, 8]),
             ([9, 10], [9, 10, 11, 12, 13]),
             ([14, 15, 16, 17, 18], [14, 15])]
MCFG = jq.Qwen2Config.tiny()


def _setup(seed=7):
    params = jq.init_params(MCFG, jax.random.key(seed))
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(MCFG),
                                device="cpu")

    def port(batch, rc=RC):
        s = TSession(lm, port_cfg(SessionConfig(rekv=rc)), batch=batch,
                     state_dtype=torch.float32)
        s.encode_init_prompt(list(range(rc.n_init)))
        return s

    def jax_(batch, rc=RC):
        s = JSession(params, MCFG, SessionConfig(rekv=rc), batch=batch,
                     state_dtype=jnp.float32)
        s.encode_init_prompt(list(range(rc.n_init)))
        return s

    return port, jax_


def _feats(rng, *shape):
    return rng.normal(size=shape + (MCFG.hidden_size,)).astype(np.float32)


def test_per_stream_questions_match_independent_sessions():
    """question_answering_batch: a different question (and length) per
    stream in one call; each row equals a batch-1 session's answer and
    stc_tpu's batched answer."""
    port, jax_ = _setup()
    feats = _feats(np.random.default_rng(0), 1, 24)
    qs, ps = [q for q, _ in QUESTIONS], [p for _, p in QUESTIONS]
    got = []
    for s in (port(3), jax_(3)):
        s.encode_video_features(np.repeat(feats, 3, 0))
        got.append(s.question_answering_batch(qs, ps, STOP,
                                              max_new_tokens=6))
    assert got[0] == got[1]
    for b, (q, p) in enumerate(QUESTIONS):
        solo = port(1)
        solo.encode_video_features(torch.from_numpy(feats))
        assert got[0][b] == solo.question_answering(q, p, STOP,
                                                    max_new_tokens=6)


def test_serve_matches_sequential_calls_and_jax():
    """One serve() tick (a ragged encode, then per-stream questions over
    the new state) equals encode_video_features + question_answering_batch
    on answers, blocks and every KV state leaf bit for bit, and stc_tpu's
    serve on answers; the tick took the serve path."""
    port, jax_ = _setup()
    rng = np.random.default_rng(1)
    warm = _feats(rng, 2, 16)
    chunk = _feats(rng, 2, 8)
    active = [True, False]
    qs = [QUESTIONS[0][0], QUESTIONS[1][0]]
    ps = [QUESTIONS[0][1], QUESTIONS[1][1]]
    sa, sb, sj = port(2), port(2), jax_(2)
    for s in (sa, sb, sj):
        s.encode_video_features(warm)
    tok, cnt = sa.serve(torch.from_numpy(chunk), active, qs, ps, STOP,
                        max_new_tokens=6)
    assert sa.last_serve_fused
    served = [tok[b, :cnt[b]].tolist() for b in range(2)]
    sb.encode_video_features(chunk, active=active)
    assert served == sb.question_answering_batch(qs, ps, STOP,
                                                 max_new_tokens=6)
    assert sa.last_retrieved_indices == sb.last_retrieved_indices
    for name in sa.kvs._fields:
        assert torch.equal(getattr(sa.kvs, name), getattr(sb.kvs, name)), \
            name
    assert sa._stream_blocks.tolist() == sb._stream_blocks.tolist()
    tj, cj = sj.serve(chunk, active, qs, ps, STOP, max_new_tokens=6)
    assert served == [tj[b, :cj[b]].tolist() for b in range(2)]


def _uneven_traffic(eng, rng):
    """stc_tpu's uneven-streams scenario: slot 0 ticks every tick, slot 1
    every other, slot 2 once; questions at ticks 2 and 3; then slot 2 is
    retired, re-admitted and fed again.  Returns the answers and the
    chunks each slot drained."""
    chunks = {b: [] for b in range(3)}
    res = {}

    def feed(slot):
        c = _feats(rng, 8)
        chunks[slot].append(c)
        eng.submit_chunk(slot, c)

    for tick in range(4):
        feed(0)
        if tick % 2 == 0:
            feed(1)
        if tick == 1:
            feed(2)
        if tick == 2:
            eng.submit_question(0, *QUESTIONS[0])
            eng.submit_question(2, *QUESTIONS[1])
        if tick == 3:
            eng.submit_question(1, *QUESTIONS[2])
        res.update(eng.step())
    res.update(eng.run())
    eng.retire(2)
    slot = eng.admit()
    chunks[slot] = []
    feed(slot)
    feed(0)
    eng.submit_question(slot, *QUESTIONS[0])
    res.update(eng.run())
    return res, chunks


def test_serving_engine_uneven_streams_match_jax_and_solo_sessions():
    """Three slots at different rates with interleaved questions and a
    recycled slot: the answers and every counter of the engine's stats
    equal stc_tpu's engine on the same traffic, and each answer equals a
    batch-1 session over the chunks that slot had drained."""
    port, jax_ = _setup()
    out = []
    for sess, Engine in ((port(3), TEngine), (jax_(3), JEngine)):
        eng = Engine(sess, STOP, max_new_tokens=6)
        res, chunks = _uneven_traffic(eng, np.random.default_rng(2))
        out.append((res, eng.stats, chunks))
    (res, stats, chunks), (jres, jstats, _) = out
    assert res == jres
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.answers == 4 and stats.fused_ticks >= 1
    assert stats.streams_retired == stats.streams_admitted == 1
    solo = port(1)
    for c in chunks[2]:
        solo.encode_video_features(torch.from_numpy(c[None]))
    assert res[3]["tokens"] == solo.question_answering(
        *QUESTIONS[0], STOP, max_new_tokens=6)


def test_serving_engine_host_tier_matches_jax():
    """Two uniform streams past a 32-page store (pages evicted): the
    engine's question rides the two-tier QA and not the serve path, and
    its answer equals stc_tpu's engine's and a batch-1 session's."""
    rc = dataclasses.replace(RC, max_blocks=32)
    port, jax_ = _setup()
    rng = np.random.default_rng(3)
    chunks = [_feats(rng, 8) for _ in range(40)]
    got = []
    for sess, Engine in ((port(2, rc), TEngine), (jax_(2, rc), JEngine)):
        eng = Engine(sess, STOP, max_new_tokens=6)
        for c in chunks:
            eng.submit_chunk(0, c)
            eng.submit_chunk(1, c)
        eng.run()
        assert sess._evicted_pages > 0
        rid = eng.submit_question(1, *QUESTIONS[1])
        eng.submit_chunk(0, chunks[0])
        eng.submit_chunk(1, chunks[1])
        got.append(eng.run()[rid]["tokens"])
        assert not sess.last_serve_fused
    assert got[0] == got[1]
    solo = port(1, rc)
    for c in chunks + [chunks[1]]:
        solo.encode_video_features(torch.from_numpy(c[None]))
    assert got[0] == solo.question_answering(*QUESTIONS[1], STOP,
                                             max_new_tokens=6)


TPF = 3


def _vlm_scfg(max_prompt=32):
    return SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=TPF,
                        exc_block_size=TPF, topk=4, max_blocks=64,
                        max_prompt_tokens=max_prompt, max_new_tokens=8),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=TPF))


def _vlm(seed, batch, jax_too=False):
    cfg = jlo.LlavaOVConfig.tiny()
    params = jlo.init_random_params(cfg, jax.random.key(seed))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    scfg = _vlm_scfg()
    out = [tlo.build_session(model, port_cfg(scfg),
                             state_dtype=torch.float32, device="cpu",
                             batch=batch)]
    if jax_too:
        out.append(jlo.build_session(params, cfg, scfg,
                                     state_dtype=jnp.float32, batch=batch))
    for s in out:
        s.encode_init_prompt([1, 2, 3, 4])
    return model, out


def test_serving_engine_vlm_pixels_match_jax():
    """The engine over a 2-slot VLMSession (pixel chunks): ragged pixel
    encodes, a tick that encodes and answers, a question-only tick; the
    answers, counters and page counts equal stc_tpu's engine's."""
    _, sessions = _vlm(11, 2, jax_too=True)
    out = []
    for sess, Engine in zip(sessions, (TEngine, JEngine)):
        eng = Engine(sess, STOP, max_new_tokens=4)
        rng = np.random.default_rng(4)
        res = {}
        for tick in range(3):
            eng.submit_chunk(0, rng.uniform(0, 255, (1, 56, 56, 3)
                                            ).astype(np.uint8))
            if tick == 0:
                eng.submit_chunk(1, rng.uniform(0, 255, (1, 56, 56, 3)
                                                ).astype(np.uint8))
            if tick == 1:
                eng.submit_question(0, [5, 6], [5, 6, 7])
            res.update(eng.step())
        eng.submit_question(1, [7, 8, 9], [7, 8, 9, 10])
        res.update(eng.run())
        out.append((res, eng.stats, np.asarray(sess.kvs.num_blocks)[0],
                    sess._slot_chunk.tolist()))
    (res, stats, nb, sc), (jres, jstats, jnb, jsc) = out
    assert res == jres and len(res) == 2
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.slot_chunks == [3, 1] and stats.fused_ticks == 1
    assert nb.tolist() == jnb.tolist() == [3, 1] and sc == jsc


def test_vlm_serve_matches_sequential_calls():
    """VLMSession.serve (vision with each slot's cacher schedule, the
    ragged append and per-stream questions) equals encode_video +
    question_answering_batch on answers and on every KV, cacher and pruner
    state leaf bit for bit, over a cached tick, a ragged full tick and a
    mixed tick (slot 0 cached, slot 1 full)."""
    model, (sa,) = _vlm(12, 2)
    sb = tlo.build_session(model, port_cfg(_vlm_scfg()),
                           state_dtype=torch.float32, device="cpu", batch=2)
    sb.encode_init_prompt([1, 2, 3, 4])
    rng = np.random.default_rng(8)
    warm = rng.uniform(0, 255, size=(2, 1, 56, 56, 3)).astype(np.uint8)
    sa.encode_video(warm)
    sb.encode_video(warm)
    qs, ps = [[5, 6, 7], [9, 10]], [[5, 6, 7, 8], [9, 10, 11]]
    for active in ([True, True], [True, False], [True, True]):
        chunk = rng.uniform(0, 255, size=(2, 1, 56, 56, 3)).astype(np.uint8)
        tok, cnt = sa.serve(chunk, active, qs, ps, STOP, max_new_tokens=4,
                            asked=[True, True])
        assert sa.last_serve_fused
        sb.encode_video(chunk, active=active)
        want = sb.question_answering_batch(qs, ps, STOP, max_new_tokens=4)
        assert [tok[b, :cnt[b]].tolist() for b in range(2)] == want, active
    assert sa._slot_chunk.tolist() == sb._slot_chunk.tolist() == [4, 3]
    assert sa.chunk_idx == sb.chunk_idx
    for a, b in ((sa.kvs, sb.kvs), (sa._vstate, sb._vstate),
                 (sa._pstate, sb._pstate)):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name


def test_engine_guards_and_routes():
    """The engine refuses work for a retired slot, a second admission
    without a free slot and chunks of another shape; the port keeps no
    measured-cost router, so route_decisions is empty."""
    port, _ = _setup()
    eng = TEngine(port(2), STOP, max_new_tokens=4)
    assert eng.route_decisions == {}
    eng.submit_chunk(0, np.zeros((8, MCFG.hidden_size), np.float32))
    with pytest.raises(ValueError, match="share a shape"):
        eng.submit_chunk(1, np.zeros((16, MCFG.hidden_size), np.float32))
    eng.retire(1)
    assert eng.is_free(1) and eng.free_slots == 1
    with pytest.raises(ValueError, match="retired"):
        eng.submit_question(1, [5], [5])
    assert eng.admit() == 1
    with pytest.raises(RuntimeError, match="retire one first"):
        eng.admit()
    eng.run()
    assert eng.stats.encode_chunks == 1 and eng.pending == 0
