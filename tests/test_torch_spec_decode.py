"""Prompt-lookup speculative decode in the port (tests/test_spec_decode.py's
cases): build_spec_ctx, _spec_draft and lookahead_decode against
stc_tpu's, and every QA path with ReKVConfig.spec_decode_draft > 0 against
both stc_tpu's speculative session and the port's own greedy one.

A draft token commits only where it equals the model's greedy choice, so
the answers equal greedy's token for token.  Integers (token ids, counts,
lookup contexts, drafts, draft histories) are compared exactly."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig, SessionConfig
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.serving import ServingEngine as JEngine
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.models import qwen2 as tq
from stc_tpu_torch.runtime.serving import ServingEngine as TEngine
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from stc_tpu_torch.utils.checkpoint import load_stream_state, \
    save_stream_state
from test_torch_common import (np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

RC = ReKVConfig(n_init=4, n_local=192, block_size=8, exc_block_size=8,
                topk=4, chunk_size=1, max_blocks=64,
                max_prompt_tokens=16, max_new_tokens=12)
SPEC = dataclasses.replace(RC, spec_decode_draft=4, spec_decode_ngram=3)
STOP = [0]
QUESTIONS = [([5, 6, 7], [5, 6, 7, 8]),
             ([9, 10], [9, 10, 11, 12, 13]),
             ([14, 15, 16, 17, 18], [14, 15])]
MCFG = jq.Qwen2Config.tiny()


def _models(seed):
    params = jq.init_params(MCFG, jax.random.key(seed))
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(MCFG),
                                device="cpu")
    return params, lm


def _sessions(batch, rc=RC, spec=SPEC, seed=7, n_chunks=4):
    """(stc_tpu's speculative session, the port's greedy session, the
    port's speculative session, lm), one stream state."""
    params, lm = _models(seed)
    rng = np.random.default_rng(seed)
    chunks = [rng.normal(size=(batch, 8, MCFG.hidden_size)).astype(
        np.float32) for _ in range(n_chunks)]
    j = JSession(params, MCFG, SessionConfig(rekv=spec), batch=batch,
                 state_dtype=jnp.float32)
    ts = [TSession(lm, port_cfg(SessionConfig(rekv=r)), batch=batch,
                   state_dtype=torch.float32) for r in (rc, spec)]
    for s in [j] + ts:
        s.encode_init_prompt(list(range(rc.n_init)))
        for c in chunks:
            s.encode_video_features(c if s is j else torch.from_numpy(c))
    return j, ts[0], ts[1], lm


# --------------------------------------------------------------------- #
# the pieces
# --------------------------------------------------------------------- #

def test_spec_draft_matches_jax():
    """The longest-suffix n-gram lookup with recency ties: stc_tpu's own
    example, then 64 random small-alphabet contexts (many matches and
    ties) of 9 and 23 tokens at K 1, 2, 4 and N 1-3, each filled to a
    random length from empty to full."""
    ctx = np.asarray([[9, 1, 2, 3, 7, 7, 1, 2, 3, 4, 5, 1, 2, 3, 0, 0]],
                     np.int32)
    got = tq._spec_draft(torch.from_numpy(ctx),
                         torch.tensor([14], dtype=torch.int32), 3, 3)
    assert got.tolist() == [[4, 5, 1]]
    rng = np.random.default_rng(0)
    for C in (9, 23):
        c = rng.integers(0, 4, (64, C)).astype(np.int32)
        cl = rng.integers(0, C + 1, 64).astype(np.int32)
        for K in (1, 2, 4):
            for N in (1, 2, 3):
                want = jq._spec_draft(jnp.asarray(c), jnp.asarray(cl), K, N)
                got = tq._spec_draft(torch.from_numpy(c),
                                     torch.from_numpy(cl), K, N)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("H", [0, 12])
def test_build_spec_ctx_matches_jax(H):
    """[history | question | prompt] compacted per stream, with padding
    dropped and room for the answer: contexts and lengths exactly."""
    rng = np.random.default_rng(H)
    B, Tq, Tp = 3, 8, 16
    q = rng.integers(1, 99, (B, Tq)).astype(np.int32)
    p = rng.integers(1, 99, (B, Tp)).astype(np.int32)
    ql = np.asarray([3, 8, 1], np.int32)
    pl = np.asarray([16, 2, 5], np.int32)
    hist = {}
    if H:
        hist = dict(hist_ids=rng.integers(1, 99, (B, H)).astype(np.int32),
                    hist_len=np.asarray([0, 12, 7], np.int32))
    cj, lj = jq.build_spec_ctx(jnp.asarray(q), jnp.asarray(ql),
                               jnp.asarray(p), jnp.asarray(pl), 6,
                               **{k: jnp.asarray(v) for k, v in hist.items()})
    ct, lt = tq.build_spec_ctx(torch.from_numpy(q), torch.from_numpy(ql),
                               torch.from_numpy(p), torch.from_numpy(pl), 6,
                               **{k: torch.from_numpy(v)
                                  for k, v in hist.items()})
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("stop", ["none", "real"])
def test_lookahead_decode_matches_jax_and_greedy(stop):
    """lookahead_decode straight after a prompt prefill (stc_tpu's
    repetitive-continuation case, B = 2, 16 tokens): tokens and counts
    equal stc_tpu's lookahead_decode and the port's greedy_decode, with no
    stop token and with one that fires mid-answer; with no stop token the
    verify rounds are fewer than the tokens (drafts were accepted)."""
    params, lm = _models(0)
    rc = dataclasses.replace(SPEC, max_new_tokens=16)
    pk = port_cfg(rc)
    B = 2
    p_ids = np.tile(np.arange(1, 9, dtype=np.int32), (B, 1))
    p_len = np.full((B,), 8, np.int32)

    def prefilled_port():
        d = lm.init_decode_state(pk, B, torch.float32)
        lg, d = lm.decode_step(pk, d, lm.embed_tokens(torch.from_numpy(
            p_ids)), torch.from_numpy(p_len))
        return lg[:, 7], d

    last, d = prefilled_port()
    stops = torch.full((4,), -1, dtype=torch.int32)
    if stop == "real":
        ref = lm.greedy_decode(pk, d, last, stops, 16)[0]
        stops[0] = ref[0, 5]
    last, d = prefilled_port()
    t_greedy, c_greedy, _ = lm.greedy_decode(pk, d, last, stops, 16)
    last, d = prefilled_port()
    ctx, cl = tq.build_spec_ctx(*(torch.from_numpy(x) for x in (
        p_ids, p_len, p_ids, p_len)), 16)
    rounds = lm.spec_stream_rounds
    t_spec, c_spec, _ = lm.lookahead_decode(pk, d, last, stops, 16, ctx, cl)
    rounds = lm.spec_stream_rounds - rounds

    jd = jq.init_decode_state(MCFG, rc, B, jnp.float32)
    lg, jd = jq.decode_step(params, MCFG, rc, jd,
                            jq.embed_tokens(params, jnp.asarray(p_ids)),
                            jnp.asarray(p_len))
    jctx, jcl = jq.build_spec_ctx(*(jnp.asarray(x) for x in (
        p_ids, p_len, p_ids, p_len)), 16)
    t_j, c_j, _ = jq.lookahead_decode(params, MCFG, rc, jd, lg[:, 7],
                                      jnp.asarray(stops.numpy()), 16, jctx,
                                      jcl)
    np.testing.assert_array_equal(c_spec.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(t_spec.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(c_spec.numpy(), c_greedy.numpy())
    np.testing.assert_array_equal(t_spec.numpy(), t_greedy.numpy())
    if stop == "real":
        assert (c_spec < 16).all()
    else:
        assert rounds < int(c_spec.sum())


# --------------------------------------------------------------------- #
# the session's QA paths
# --------------------------------------------------------------------- #

def _ask(s, qs, ps, m, **kw):
    return s.question_answering_batch(qs, ps, STOP, max_new_tokens=m, **kw)


@pytest.mark.parametrize("path", ["batched", "real_stops", "host_tier",
                                  "external"])
def test_spec_sessions_match_jax_and_greedy(path):
    """Per-stream questions (12 tokens and a 3-token budget); a stop token
    that fires (the 3rd greedy token); the two-tier QA past max_blocks 40
    (48 chunks, pages evicted); external blocks [0, 2]: the speculative
    port session's answers equal stc_tpu's speculative session's and the
    port's greedy session's."""
    kw, rc, spec, n_chunks, batch = {}, RC, SPEC, 4, 3
    if path == "host_tier":
        rc = dataclasses.replace(RC, max_blocks=40)
        spec = dataclasses.replace(SPEC, max_blocks=40)
        n_chunks, batch = 48, 2
    j, off, on, _ = _sessions(batch, rc, spec, seed=3, n_chunks=n_chunks)
    qs = [q for q, _ in QUESTIONS][:batch]
    ps = [p for _, p in QUESTIONS][:batch]
    budgets = [12, 3] if path == "batched" else [8]
    if path == "external":
        kw = dict(retrieved_indices=[0, 2])
    if path == "real_stops":
        base = _ask(off, qs, ps, 10)
        stop = [base[0][2]]
        got = [s.question_answering(qs[0], ps[0], stop, max_new_tokens=10)
               for s in (j, off, on)]
        assert got[0] == got[1] == got[2] and len(got[2]) == 3
        return
    if path == "host_tier":
        assert on._evicted_pages > 0 and j._evicted_pages > 0
    for m in budgets:
        want = _ask(off, qs, ps, m, **kw)
        assert _ask(on, qs, ps, m, **kw) == want
        assert _ask(j, qs, ps, m, **kw) == want


def test_spec_in_serve_tick_matches_jax_and_greedy():
    """A serving tick (ragged encode, then the questions over the new
    state) decodes speculatively with the same answers."""
    j, off, on, _ = _sessions(2, seed=9)
    chunk = np.random.default_rng(9).normal(
        size=(2, 8, MCFG.hidden_size)).astype(np.float32)
    qs = [QUESTIONS[0][0], QUESTIONS[1][0]]
    ps = [QUESTIONS[0][1], QUESTIONS[1][1]]
    out = []
    for s in (j, off, on):
        x = chunk if s is j else torch.from_numpy(chunk)
        tok, cnt = s.serve(x, [True, False], qs, ps, STOP, max_new_tokens=8)
        assert s.last_serve_fused
        out.append([tok[b, :cnt[b]].tolist() for b in range(2)])
    assert out[0] == out[1] == out[2]


def test_spec_history_matches_jax_across_questions():
    """Cross-question draft history (spec_history_tokens 96) over repeated
    questions: the answers equal greedy's and stc_tpu's, and the history
    ring (ids and lengths) equals stc_tpu's after every question."""
    hist = dataclasses.replace(SPEC, spec_history_tokens=96)
    j, off, on, _ = _sessions(2, RC, hist, seed=17)
    for q, p in QUESTIONS + QUESTIONS[:2]:
        qs, ps = [q, q[::-1]], [p, p[::-1]]
        want = _ask(off, qs, ps, 8)
        assert _ask(on, qs, ps, 8) == want == _ask(j, qs, ps, 8)
        np.testing.assert_array_equal(on._qa_hist, j._qa_hist)
        np.testing.assert_array_equal(on._qa_hist_len, j._qa_hist_len)
    assert (on._qa_hist_len > 0).all() and off._qa_hist.shape[1] == 0


def test_spec_history_lifecycle(tmp_path):
    """The history is per stream: a serving-shaped call records only the
    streams that asked; a stream checkpoint carries its history; a
    recycled slot drops it (stc_tpu's lifecycle, step for step)."""
    hist = dataclasses.replace(SPEC, spec_history_tokens=64)
    j, _, on, _ = _sessions(2, RC, hist, seed=19)
    q, p = QUESTIONS[0]
    for s in (j, on):
        _ask(s, [q, q], [p, p], 6)
        len1 = int(s._qa_hist_len[1])
        _ask(s, [q, [0]], [p, [0]], 6, asked=[True, False])
        assert int(s._qa_hist_len[1]) == len1
    np.testing.assert_array_equal(on._qa_hist, j._qa_hist)
    path = os.path.join(tmp_path, "s.npz")
    save_stream_state(on, 0, path)
    on.reset_streams([1])
    assert int(on._qa_hist_len[1]) == 0 and not on._qa_hist[1].any()
    load_stream_state(on, 1, path)
    assert int(on._qa_hist_len[1]) == int(on._qa_hist_len[0]) > 0
    np.testing.assert_array_equal(on._qa_hist[1], on._qa_hist[0])


def test_set_spec_decode_runtime_toggle():
    """set_spec_decode on a live session: off -> on (with a 64-token
    history) -> a serving tick, and on -> off, answers equal throughout;
    the history ring is resized and keeps its most recent tokens."""
    _, off, on, _ = _sessions(2, seed=23)
    q, p = QUESTIONS[0]
    want = _ask(off, [q, q], [p, p], 8)
    on.set_spec_decode(0)
    assert on.rekv.spec_decode_draft == 0 and on._qa_hist.shape[1] == 0
    assert _ask(on, [q, q], [p, p], 8) == want
    off.set_spec_decode(4, history_tokens=64)
    assert off._qa_hist.shape[1] == 64 and off.rekv.spec_history_tokens == 64
    assert _ask(off, [q, q], [p, p], 8) == want
    assert (off._qa_hist_len > 0).all()
    last = off._qa_hist[0, :off._qa_hist_len[0]].copy()
    off.set_spec_decode(4, history_tokens=8)
    np.testing.assert_array_equal(off._qa_hist[0], last[-8:])
    chunk = np.random.default_rng(23).normal(
        size=(2, 8, MCFG.hidden_size)).astype(np.float32)
    a = off.serve(torch.from_numpy(chunk), None, [q, q], [p, p], STOP,
                  max_new_tokens=8)
    b = on.serve(torch.from_numpy(chunk), None, [q, q], [p, p], STOP,
                 max_new_tokens=8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_spec_history_through_serving_engine():
    """The engine scenario of stc_tpu's test (two slots at different rates,
    questions, a retired and re-admitted slot) with speculation and a
    96-token history: every answer equals the port's engine with
    speculation off and stc_tpu's engine with it on."""
    hist = dataclasses.replace(SPEC, spec_history_tokens=96)
    params, lm = _models(29)
    results = {}
    for name, rc in (("off", RC), ("on", hist), ("jax", hist)):
        if name == "jax":
            sess = JSession(params, MCFG, SessionConfig(rekv=rc), batch=2,
                            state_dtype=jnp.float32)
            eng = JEngine(sess, STOP, max_new_tokens=6)
        else:
            sess = TSession(lm, port_cfg(SessionConfig(rekv=rc)), batch=2,
                            state_dtype=torch.float32)
            eng = TEngine(sess, STOP, max_new_tokens=6)
        sess.encode_init_prompt(list(range(rc.n_init)))
        rng = np.random.default_rng(29)
        res = {}
        for tick in range(6):
            c = rng.normal(size=(8, MCFG.hidden_size)).astype(np.float32)
            eng.submit_chunk(0, c)
            if tick % 2 == 0:
                eng.submit_chunk(1, c)
            if tick in (2, 4):
                q, p = QUESTIONS[tick % len(QUESTIONS)]
                eng.submit_question(tick % 2, q, p)
            res.update(eng.step())
        eng.retire(1)
        slot = eng.admit()
        eng.submit_chunk(slot, rng.normal(
            size=(8, MCFG.hidden_size)).astype(np.float32))
        eng.submit_question(slot, *QUESTIONS[0])
        res.update(eng.run())
        results[name] = sorted((rid, tuple(v["tokens"]))
                               for rid, v in res.items())
    assert len(results["on"]) == 3
    assert results["on"] == results["off"] == results["jax"]
