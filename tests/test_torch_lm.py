"""stc_tpu_torch.models.qwen2 against stc_tpu.models.qwen2 on the CPU, with
the same weights (weights.qwen2_from_jax): streaming encode, the retrieval
forward, prefill / decode logits, and greedy answers (ids exactly equal)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig
from stc_tpu.kvcache.engine import score_blocks
from stc_tpu.models import qwen2 as jq
from stc_tpu_torch import weights
from test_torch_common import (DEEP_TOL, F32_TOL, np_tree, port_cfg,
                               port_model_cfg, tt)

REKV = ReKVConfig(n_init=6, n_local=128, block_size=8, exc_block_size=8,
                  topk=4, max_blocks=64, max_prompt_tokens=32,
                  max_new_tokens=8)


def _models(seed=9):
    cfg = jq.Qwen2Config.tiny()
    params = jq.init_params(cfg, jax.random.key(seed))
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(cfg),
                                device="cpu")
    return cfg, params, lm


def _encode_both(cfg, params, lm, n_blocks, seed=0):
    """Init prompt + n_blocks one-page appends of random features through
    both LMs; returns (jax kvs, port kvs, last hidden states)."""
    rng = np.random.default_rng(seed)
    pk = port_cfg(REKV)
    jkv = jq.init_stream_state(cfg, REKV, 1, jnp.float32)
    tkv = lm.init_stream_state(pk, 1, torch.float32)
    ids = np.arange(REKV.n_init, dtype=np.int32)[None]
    hj, jkv = jq.encode_step(params, cfg, REKV, jkv,
                             jq.embed_tokens(params, jnp.asarray(ids)),
                             is_init=True)
    ht, tkv = lm.encode_step(pk, tkv, lm.embed_tokens(torch.from_numpy(ids)),
                             is_init=True)
    for _ in range(n_blocks):
        x = rng.normal(size=(1, 8, cfg.hidden_size)).astype(np.float32)
        hj, jkv = jq.encode_step(params, cfg, REKV, jkv, jnp.asarray(x),
                                 is_init=False)
        ht, tkv = lm.encode_step(pk, tkv, tt(x), is_init=False)
    return jkv, tkv, np.asarray(hj), ht.numpy()


def test_encode_step_matches_jax():
    cfg, params, lm = _models()
    jkv, tkv, hj, ht = _encode_both(cfg, params, lm, 5)
    np.testing.assert_allclose(ht, hj, **DEEP_TOL)
    np.testing.assert_array_equal(tkv.num_blocks.numpy(),
                                  np.asarray(jkv.num_blocks))
    np.testing.assert_array_equal(tkv.length.numpy(), np.asarray(jkv.length))
    for name in ("block_k", "block_v", "block_rep", "init_k"):
        np.testing.assert_allclose(getattr(tkv, name).numpy(),
                                   np.asarray(getattr(jkv, name)),
                                   err_msg=name, **DEEP_TOL)


def _jax_layer_indices(params, cfg, jkv, q_ids, q_len):
    """Per-layer retrieved blocks of the JAX retrieval forward (the layer
    loop of qwen2.qa_retrieve_step, scoring each layer's queries)."""
    T = q_ids.shape[1]
    q_valid = jnp.arange(T)[None, :] < jnp.asarray(q_len)[:, None]
    body = jq.qa_retrieve_layer_body(cfg, REKV, q_valid, None, T)
    dkvs = jq.init_decode_state(cfg, REKV, 1, jnp.float32)
    h = jq.embed_tokens(params, jnp.asarray(q_ids))
    out = []
    for l in range(cfg.num_layers):
        sl = (lambda x: x[l])
        lp, kv, dkv = (jax.tree.map(sl, t) for t in
                       (params["layers"], jkv, dkvs))
        q, _, _ = jq._qkv(lp, jq.rms_norm(h, lp["ln1"], cfg.rms_eps), cfg)
        a, e = score_blocks(kv, q, REKV, q_valid)
        out.append(np.asarray(a)[0][np.asarray(e)[0]].tolist())
        h, _ = body(h, (lp, kv, dkv))
    return out


def test_qa_retrieve_and_decode_step_match_jax():
    cfg, params, lm = _models()
    jkv, tkv, _, _ = _encode_both(cfg, params, lm, 9, seed=1)
    pk = port_cfg(REKV)
    q_ids = np.asarray([[11, 12, 13, 14, 15, 0, 0, 0]], np.int32)
    q_len = np.asarray([5], np.int32)
    jd = jq.qa_retrieve_step(params, cfg, REKV, jkv,
                             jq.init_decode_state(cfg, REKV, 1, jnp.float32),
                             jq.embed_tokens(params, jnp.asarray(q_ids)),
                             n_tokens=jnp.asarray(q_len))
    td, abs_idx, exists = lm.qa_retrieve_step(
        pk, tkv, lm.init_decode_state(pk, 1, torch.float32),
        lm.embed_tokens(torch.from_numpy(q_ids)),
        n_tokens=torch.from_numpy(q_len))
    np.testing.assert_array_equal(td.cursor.numpy(), np.asarray(jd.cursor))
    want_idx = _jax_layer_indices(params, cfg, jkv, q_ids, q_len)
    got_idx = [abs_idx[l, 0][exists[l, 0]].tolist()
               for l in range(cfg.num_layers)]
    assert got_idx == want_idx
    cur = int(td.cursor.max())
    np.testing.assert_allclose(td.k.numpy()[..., :cur, :],
                               np.asarray(jd.k)[..., :cur, :], **DEEP_TOL)

    p_ids = np.asarray([[3, 4, 5, 6, 7, 8, 0, 0]], np.int32)
    p_len = np.asarray([6], np.int32)
    lj, jd = jq.decode_step(params, cfg, REKV, jd,
                            jq.embed_tokens(params, jnp.asarray(p_ids)),
                            jnp.asarray(p_len))
    lt, td = lm.decode_step(pk, td, lm.embed_tokens(torch.from_numpy(p_ids)),
                            torch.from_numpy(p_len))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **DEEP_TOL)
    tok = np.asarray([[42]], np.int32)
    lj, jd = jq.decode_step(params, cfg, REKV, jd,
                            jq.embed_tokens(params, jnp.asarray(tok)),
                            jnp.ones((1,), jnp.int32))
    lt, td = lm.decode_step(pk, td, lm.embed_tokens(torch.from_numpy(tok)),
                            torch.ones((1,), dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **DEEP_TOL)


@pytest.mark.parametrize("stop", [[0], [7, 200]])
def test_answer_question_ids_equal_jax(stop):
    """Greedy answers equal token for token, including the rule that step 0
    never emits a stop token."""
    cfg, params, lm = _models(seed=3)
    jkv, tkv, _, _ = _encode_both(cfg, params, lm, 12, seed=2)
    pk = port_cfg(REKV)
    q_ids = np.asarray([[21, 22, 23, 0, 0, 0, 0, 0]], np.int32)
    p_ids = np.asarray([[21, 22, 23, 24, 0, 0, 0, 0]], np.int32)
    q_len, p_len = np.asarray([3], np.int32), np.asarray([4], np.int32)
    stop_ids = np.full((4,), -1, np.int32)
    stop_ids[:len(stop)] = stop
    tj, cj = jq.answer_question(params, cfg, REKV, jkv, jnp.asarray(q_ids),
                                jnp.asarray(q_len), jnp.asarray(p_ids),
                                jnp.asarray(p_len), jnp.asarray(stop_ids), 8)
    tt_, ct, _, _ = lm.answer_question(
        pk, tkv, *(torch.from_numpy(x) for x in (q_ids, q_len, p_ids, p_len,
                                                  stop_ids)), 8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(tj))


def test_rms_norm_and_embed_match_jax():
    cfg, params, lm = _models()
    from stc_tpu_torch.models import qwen2 as tq
    x = np.random.default_rng(4).normal(size=(2, 3, 64)).astype(np.float32)
    w = np.linspace(0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(
        tq.rms_norm(tt(x), tt(w), 1e-6).numpy(),
        np.asarray(jq.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        **F32_TOL)
    ids = np.asarray([[1, 5, 255]], np.int32)
    np.testing.assert_array_equal(
        lm.embed_tokens(torch.from_numpy(ids)).numpy(),
        np.asarray(jq.embed_tokens(params, jnp.asarray(ids))))
