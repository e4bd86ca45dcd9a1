"""The whole pixel -> answer slice: the JAX LLaVA-OV session of
tests/test_llava_ov.py::make and the port's session, built from the same
weights, stream frames, answer, stream on and answer again.  Answer ids,
every layer's retrieved block indices and the page counters must be
exactly equal, with the cacher on and off, at 1-, 2- and 4-frame chunks,
across the init fill (n_local 12) and on bf16 state."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.kvcache.engine import score_blocks
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu_torch import weights
from stc_tpu_torch.models import llava_onevision as tlo
from test_llava_ov import make
from test_torch_common import (DEEP_TOL, assert_bf16_close, np_tree,
                               port_cfg, port_model_cfg)


def _jax_layer_indices(sess, question):
    """Per-layer blocks the JAX session's retrieval forward selects (the
    layer loop of qwen2.qa_retrieve_step over the session's own state)."""
    cfg, rekv, params = sess.mcfg, sess.rekv, sess.params
    ids, lens = sess._pad_ids([question])
    T = ids.shape[1]
    q_valid = jnp.arange(T)[None, :] < jnp.asarray(lens)[:, None]
    body = jq.qa_retrieve_layer_body(cfg, rekv, q_valid, None, T)
    dkvs = jq.init_decode_state(cfg, rekv, 1, sess.kvs.init_k.dtype)
    h = jq.embed_tokens(params, jnp.asarray(ids))
    out = []
    for l in range(cfg.num_layers):
        lp, kv, dkv = (jax.tree.map(lambda x: x[l], t)
                       for t in (params["layers"], sess.kvs, dkvs))
        q, _, _ = jq._qkv(lp, jq.rms_norm(h, lp["ln1"], cfg.rms_eps), cfg)
        a, e = score_blocks(kv, q, rekv, q_valid)
        out.append(np.asarray(a)[0][np.asarray(e)[0]].tolist())
        h, _ = body(h, (lp, kv, dkv))
    return out


def _port_session(jsess, cfg, seed, state_dtype=torch.float32):
    params = jlo.init_random_params(cfg, jax.random.key(seed))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    return tlo.build_session(model, port_cfg(jsess.scfg),
                             state_dtype=state_dtype, device="cpu")


def _jax_session(seed, cacher, chunk, n_local, state_dtype):
    """tests/test_llava_ov.py::make's session with `chunk`-frame chunks,
    n_local and state dtype as given."""
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=n_local, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(strategy=cacher, update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=3),
        encode_chunk_frames=chunk)
    params = jlo.init_random_params(cfg, jax.random.key(seed))
    return jlo.build_session(params, cfg, scfg,
                             state_dtype=state_dtype), cfg


@pytest.mark.parametrize("cacher,chunk,n_local,state", [
    pytest.param("cacher", 1, 128, "f32", id="cacher"),
    pytest.param("none", 1, 128, "f32", id="none"),
    pytest.param("cacher", 2, 128, "f32", id="cacher-chunk2"),
    pytest.param("cacher", 4, 128, "f32", id="cacher-chunk4"),
    pytest.param("cacher", 1, 12, "f32", id="cacher-init-fill"),
    pytest.param("cacher", 2, 12, "f32", id="cacher-init-fill-chunk2"),
    pytest.param("cacher", 1, 128, "bf16", id="cacher-bf16-state"),
    pytest.param("cacher", 2, 128, "bf16", id="cacher-bf16-state-chunk2"),
    pytest.param("none", 1, 128, "bf16", id="none-bf16-state"),
    pytest.param("none", 2, 128, "bf16", id="none-bf16-state-chunk2"),
])
def test_pixel_session_matches_jax(cacher, chunk, n_local, state):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[state]
    jsess, cfg = _jax_session(0, cacher, chunk, n_local, jdt)
    tsess = _port_session(jsess, cfg, seed=0, state_dtype=tdt)
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(56, 56, 3))
    frames = np.clip(base[None] + rng.normal(0, 40, size=(12, 56, 56, 3)),
                     0, 255).astype(np.uint8)
    for s in (jsess, tsess):
        s.encode_init_prompt([1, 2, 3, 4])
    qas = [([7, 8, 9], [7, 8, 9, 10]), ([5, 6], [5, 6, 7])]
    # 6 then 4 frames, each rounded up to whole chunks
    b1 = -(-6 // chunk) * chunk
    b2 = b1 + -(-4 // chunk) * chunk
    for (lo, hi), (question, prompt) in zip([(0, b1), (b1, b2)], qas):
        for f in range(lo, hi, chunk):
            jsess.encode_video(frames[f:f + chunk])
            tsess.encode_video(frames[f:f + chunk])
        assert tsess.chunk_idx == jsess.chunk_idx == hi // chunk
        np.testing.assert_array_equal(tsess.kvs.num_blocks.numpy(),
                                      np.asarray(jsess.kvs.num_blocks))
        np.testing.assert_array_equal(tsess.kvs.length.numpy(),
                                      np.asarray(jsess.kvs.length))
        got = tsess.kvs.block_k.float().numpy()
        want = np.asarray(jsess.kvs.block_k, np.float32)
        if state == "bf16":
            assert_bf16_close(got, want, "block_k")
        else:
            np.testing.assert_allclose(got, want, **DEEP_TOL)
        want_idx = _jax_layer_indices(jsess, question)
        want = jsess.question_answering(question, prompt, stop_token_ids=[0],
                                        max_new_tokens=6)
        got = tsess.question_answering(question, prompt, stop_token_ids=[0],
                                       max_new_tokens=6)
        assert got == want
        assert tsess.last_retrieved_indices == want_idx
        assert len(want_idx[0]) == min(hi, jsess.rekv.topk)


def test_feature_session_matches_jax():
    """The feature-level StreamingSession: interleaved encode -> QA ->
    encode -> QA over pruned features, answers and retrieval equal."""
    from stc_tpu.config import ReKVConfig, SessionConfig
    from stc_tpu.runtime.session import StreamingSession as JSession
    from stc_tpu_torch.runtime.session import StreamingSession as TSession
    mcfg = jq.Qwen2Config.tiny()
    scfg = SessionConfig(rekv=ReKVConfig(
        n_init=6, n_local=128, block_size=8, exc_block_size=16, topk=4,
        max_blocks=64, max_prompt_tokens=32, max_new_tokens=8))
    params = jq.init_params(mcfg, jax.random.key(9))
    jsess = JSession(params, mcfg, scfg, state_dtype=jnp.float32)
    tsess = TSession(weights.qwen2_from_jax(np_tree(params),
                                            port_model_cfg(mcfg),
                                            device="cpu"),
                     port_cfg(scfg), state_dtype=torch.float32)
    rng = np.random.default_rng(9)
    for s in (jsess, tsess):
        s.encode_init_prompt(list(range(6)))
    for n_frames, question in ((7, [7, 8, 9]), (5, [30, 31, 32, 33])):
        feats = rng.normal(size=(1, n_frames * 8, mcfg.hidden_size))
        jsess.encode_video_features(feats.astype(np.float32))
        tsess.encode_video_features(torch.from_numpy(feats).float())
        want_idx = _jax_layer_indices(jsess, question)
        want = jsess.question_answering(question, question + [3], [0],
                                        max_new_tokens=6)
        got = tsess.question_answering(question, question + [3], [0],
                                       max_new_tokens=6)
        assert got == want
        assert tsess.last_retrieved_indices == want_idx


def test_session_raises_where_the_jax_session_would_evict():
    """Fast-forwarded to a full device store, the port session now evicts
    to its host tier where the JAX session does (the same pages, the same
    page_offset) instead of raising; fast-forwarded to the rep-key
    capacity, both raise."""
    jsess, cfg = make(seed=1)
    tsess = _port_session(jsess, cfg, seed=1)
    frame = np.zeros((1, 56, 56, 3), np.uint8)
    for s in (jsess, tsess):
        s.encode_init_prompt([1, 2, 3, 4])
        s._total_blocks = s.rekv.max_blocks  # a full device store
        s.encode_video(frame)
    assert tsess._evicted_pages == jsess._evicted_pages > 0
    assert tsess.host_store.total_pages == jsess.host_store.total_pages
    np.testing.assert_array_equal(tsess.kvs.page_offset.numpy(),
                                  np.asarray(jsess.kvs.page_offset))
    for s in (jsess, tsess):
        s._total_blocks = s.rekv.rep_cap
        with pytest.raises(RuntimeError, match="rep-key capacity"):
            s.encode_video(frame)
