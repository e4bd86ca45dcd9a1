"""Slot recycling and the rest of the QA API in the port
(tests/test_slot_reset.py's cases without serve / ServingEngine):
reset_streams, question_answering_batch and external retrieval.

After reset_streams([b]) slot b answers like a fresh session over what it
ingests next while the other slots continue untouched.  Against stc_tpu:
answer ids exactly, state leaves to F32_TOL (integers exactly); against the
port's own fresh and unchurned sessions: answers equal."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig, SessionConfig
from stc_tpu.kvcache import engine as je
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)
from test_torch_ragged import pixel_sessions

pytestmark = pytest.mark.usefixtures("one_thread")

RC = ReKVConfig(n_init=4, n_local=128, block_size=8, exc_block_size=8,
                topk=4, chunk_size=1, max_blocks=64,
                max_prompt_tokens=16, max_new_tokens=8)
STOP = [0]
Q, P = [5, 6, 7], [5, 6, 7, 8]
MCFG = jq.Qwen2Config.tiny()


def _setup(batch, rc=RC, seed=7, jax_too=True):
    """(stc_tpu session or None, port session, maker of port sessions)."""
    scfg = SessionConfig(rekv=rc)
    params = jq.init_params(MCFG, jax.random.key(seed))
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(MCFG),
                                device="cpu")

    def port(b):
        s = TSession(lm, port_cfg(scfg), batch=b, state_dtype=torch.float32)
        s.encode_init_prompt(list(range(rc.n_init)))
        return s

    j = None
    if jax_too:
        j = JSession(params, MCFG, scfg, batch=batch,
                     state_dtype=jnp.float32)
        j.encode_init_prompt(list(range(rc.n_init)))
    return j, port(batch), port


def _chunk(rng, n=1):
    return rng.normal(size=(n, 8, MCFG.hidden_size)).astype(np.float32)


def _feed(sessions, feats, active=None):
    for s in sessions:
        x = torch.from_numpy(feats) if isinstance(s, TSession) else feats
        s.encode_video_features(x, active=active)


def test_engine_reset_streams_matches_jax():
    """engine.reset_streams on the layer-stacked state: the reset slots'
    counters, rep keys and keep rows fresh (length back to init_len), the
    others' untouched, as stc_tpu's does."""
    cfg = dataclasses.replace(RC, n_local=64, max_blocks=16)
    pc = port_cfg(cfg)
    jkv = jax.tree.map(lambda x: jnp.stack([x, x + 1]),
                       je.init_stream_kv(cfg, 3, 2, 8, jnp.float32))
    rng = np.random.default_rng(0)
    jkv = jax.tree.map(lambda x: jnp.asarray(
        rng.integers(0, 9, x.shape).astype(x.dtype)), jkv)
    tkv = type(te.init_stream_kv(pc, 3, 2, 8, device="cpu"))(
        *(torch.from_numpy(np.array(x)) for x in jkv))
    reset = np.array([False, True, True])
    jkv = je.reset_streams(jkv, jnp.asarray(reset), 4, batch_axis=1)
    te.reset_streams(tkv, torch.from_numpy(reset), 4, batch_axis=1)
    for name in tkv._fields:
        np.testing.assert_array_equal(getattr(tkv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)
    assert tkv.length[:, 1:].unique().tolist() == [4]


def test_recycled_slot_matches_fresh_session():
    """Retire slot 1 mid-stream and ingest a new video into it while slots
    0 and 2 keep streaming (ragged): slot 1 answers like a fresh session
    over the new video alone, slots 0 and 2 like a solo session over their
    whole history; per-stream questions (question_answering_batch) equal
    stc_tpu's."""
    j3, t3, port = _setup(3)
    rng = np.random.default_rng(0)
    hist = [_chunk(rng) for _ in range(4)]
    for c in hist:
        _feed((j3, t3), np.repeat(c, 3, 0))
    for s in (j3, t3):
        s.reset_streams([1])
    assert t3._stream_blocks.tolist() == j3._stream_blocks.tolist() \
        == [4, 0, 4]
    np.testing.assert_array_equal(t3.kvs.num_blocks.numpy(),
                                  np.asarray(j3.kvs.num_blocks))
    tail = [_chunk(rng) for _ in range(2)]
    fresh = [_chunk(rng) for _ in range(3)]
    for i in range(3):
        row = [tail[i][0] if i < 2 else np.zeros_like(fresh[0][0]),
               fresh[i][0],
               tail[i][0] if i < 2 else np.zeros_like(fresh[0][0])]
        _feed((j3, t3), np.stack(row), active=[i < 2, True, i < 2])
    assert t3._stream_blocks.tolist() == [6, 3, 6]
    got = t3.question_answering_batch([Q] * 3, [P] * 3, STOP,
                                      max_new_tokens=6)
    assert got == j3.question_answering_batch([Q] * 3, [P] * 3, STOP,
                                              max_new_tokens=6)
    solo_old, solo_new = port(1), port(1)
    for c in hist + tail:
        solo_old.encode_video_features(torch.from_numpy(c))
    for c in fresh:
        solo_new.encode_video_features(torch.from_numpy(c))
    want_old = solo_old.question_answering(Q, P, STOP, max_new_tokens=6)
    assert got[0] == got[2] == want_old
    assert got[1] == solo_new.question_answering(Q, P, STOP,
                                                 max_new_tokens=6)
    assert [l[1] for l in t3.last_retrieved_indices] == \
        solo_new.last_retrieved_indices


def test_question_answering_batch_and_external_indices_match_jax():
    """Different questions and prompts per stream (different lengths) and
    an external-index question (blocks named, -1 padded to topk, one out
    of range) at batch 2: answers equal stc_tpu's; the external blocks are
    what every layer retrieved."""
    j2, t2, _ = _setup(2, seed=11)
    rng = np.random.default_rng(11)
    for _ in range(10):
        _feed((j2, t2), _chunk(rng, 2))
    qs, ps = [[5, 6, 7], [40, 41, 42, 43, 44]], [[5, 6, 7, 8], [9, 8]]
    got = t2.question_answering_batch(qs, ps, STOP, max_new_tokens=6)
    assert got == j2.question_answering_batch(qs, ps, STOP,
                                              max_new_tokens=6)
    ext = [1, 4, 30]  # block 30 does not exist: not retrieved
    got = t2.question_answering([9, 8], [9, 8, 7], STOP, max_new_tokens=6,
                                retrieved_indices=ext, all_streams=True)
    assert got == j2.question_answering([9, 8], [9, 8, 7], STOP,
                                        max_new_tokens=6,
                                        retrieved_indices=ext,
                                        all_streams=True)
    assert t2.last_retrieved_indices == [[[1, 4], [1, 4]]] * \
        MCFG.num_layers


def test_reset_refuses_host_tier():
    """Once pages were evicted the shared host-tier ring cannot be unwound
    per slot: reset_streams refuses, as stc_tpu's does."""
    rc = dataclasses.replace(RC, max_blocks=32)
    j2, t2, _ = _setup(2, rc)
    rng = np.random.default_rng(3)
    for _ in range(40):
        _feed((j2, t2), np.repeat(_chunk(rng), 2, 0))
    assert t2._evicted_pages == j2._evicted_pages > 0
    for s in (j2, t2):
        with pytest.raises(RuntimeError, match="host-evicted"):
            s.reset_streams([0])


def test_reset_streams_vlm_pixels():
    """Pixel-path recycling: the recycled slot's cacher references, pruner
    memory and chunk count reset too, so it answers like a fresh pixel
    session over its new frames, while the live slot (now on the other
    cacher parity: mixed ticks) answers like an unchurned twin; all equal
    to stc_tpu's session."""
    j2, s2, port = pixel_sessions(11, 2)
    frames = np.random.default_rng(5).uniform(
        0, 255, (6, 1, 56, 56, 3)).astype(np.uint8)

    def feed(s):
        for i in range(3):
            s.encode_video(np.stack([frames[i], frames[i]]))

    for s in (j2, s2):
        feed(s)
        s.reset_streams([1])
    assert s2._slot_chunk.tolist() == j2._slot_chunk.tolist() == [3, 0]
    for i in range(3, 5):
        for s in (j2, s2):
            s.encode_video(np.stack([frames[i], frames[i + 1]]))
    assert s2.kvs.num_blocks[0].tolist() == [5, 2]
    assert s2._slot_chunk.tolist() == [5, 2]
    np.testing.assert_allclose(s2.kvs.block_k.numpy(),
                               np.asarray(j2.kvs.block_k), **F32_TOL)
    for a, b in zip(s2._vstate, j2._vstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)
    got = s2.question_answering_batch([Q, Q], [P, P], STOP,
                                      max_new_tokens=4)
    assert got == j2.question_answering_batch([Q, Q], [P, P], STOP,
                                              max_new_tokens=4)
    solo = port(1)
    for i in (4, 5):
        solo.encode_video(frames[i])
    assert got[1] == solo.question_answering(Q, P, STOP, max_new_tokens=4)
    twin = port(2)
    feed(twin)
    for i in range(3, 5):
        twin.encode_video(np.stack([frames[i], frames[i + 1]]))
    assert got[0] == twin.question_answering_batch([Q, Q], [P, P], STOP,
                                                   max_new_tokens=4)[0]
