"""Pipeline parallelism of the port (stc_tpu_torch.parallel.pipeline) on
four gloo CPU ranks, meshes pp 4 and pp 2 x tp 2, against the JAX
package's sequential runs at tests/test_pp.py's tiny configs and the
port's sequential runs, on the same numpy params and inputs: the GPipe
append (pp_encode_step) equal to n_micro sequential appends, the whole
session (init prompt, multi- and single-chunk ingest, QA with streaming
between questions) equal to sequential, with batched streams, ragged
ingest and external blocks; speculative decode refused and host-tier
eviction failing fast.  Integers (page counters, answer ids) exactly
equal; floats to F32_TOL (1e-5).  One launch runs every case
(tests/torch_parallel_worker.py)."""

import dataclasses
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig, SessionConfig
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.parallel import dryrun
from stc_tpu_torch.parallel.mesh import Mesh
from stc_tpu_torch.runtime.session import StreamingSession
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ("pp4", "pp2_tp2")
N_MICRO = {"pp4": 2, "pp2_tp2": 3}
REKV = ReKVConfig(n_init=4, n_local=24, block_size=4, exc_block_size=8,
                  topk=2, chunk_size=1, max_blocks=32, max_prompt_tokens=16,
                  max_new_tokens=6)
QS = [([5, 6, 7], [8, 9]), ([10], [11, 12, 13])]


def _cfg(n_layers, vocab=96):
    return jq.Qwen2Config(vocab_size=vocab, hidden_size=32,
                          num_layers=n_layers, num_heads=4, num_kv_heads=2,
                          head_dim=8, intermediate_size=64,
                          rope_base=10000.0)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(1)
    enc_cfg = _cfg(4, vocab=64)
    enc_params = jq.init_params(enc_cfg, jax.random.key(0))
    Tm = REKV.exc_block_size
    enc = dict(cfg=port_model_cfg(enc_cfg), rekv=port_cfg(REKV),
               tree=np_tree(enc_params),
               init=rng.normal(size=(2, REKV.n_init, 32)).astype(np.float32),
               embeds={n: rng.normal(size=(2, n * Tm, 32)).astype(np.float32)
                       for n in (2, 3)})
    s_cfg = _cfg(8)
    s_params = jq.init_params(s_cfg, jax.random.key(0))
    r7 = np.random.default_rng(7)
    sess = dict(cfg=port_model_cfg(s_cfg), tree=np_tree(s_params),
                scfg=port_cfg(SessionConfig(rekv=REKV)),
                feats1=r7.normal(size=(1, 16, 32)).astype(np.float32),
                feats2=r7.normal(size=(1, 8, 32)).astype(np.float32),
                qs=QS, more=[r7.normal(size=(1, 8, 32)).astype(np.float32)
                             for _ in QS])
    b_cfg = _cfg(4)
    b_params = jq.init_params(b_cfg, jax.random.key(5))
    r11 = np.random.default_rng(11)
    batch = dict(cfg=port_model_cfg(b_cfg), tree=np_tree(b_params),
                 scfg=port_cfg(SessionConfig(rekv=REKV)),
                 feats=r11.normal(size=(2, 16, 32)).astype(np.float32),
                 more=r11.normal(size=(2, 8, 32)).astype(np.float32))
    e_params = jq.init_params(b_cfg, jax.random.key(12))
    evict = dict(cfg=port_model_cfg(b_cfg), tree=np_tree(e_params),
                 scfg=port_cfg(SessionConfig(rekv=dataclasses.replace(
                     REKV, max_blocks=8))),
                 feats=np.random.default_rng(14).normal(
                     size=(1, 32, 32)).astype(np.float32))
    d = dict(enc=enc, sess=sess, batch=batch, evict=evict)
    path = tmp_path_factory.mktemp("pp") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    ranks = dryrun.launch(4, "torch_parallel_worker:pp_cases", (str(path),),
                          timeout=240, env={"PYTHONPATH": os.pathsep.join(
                              [HERE, dryrun.ROOT])})
    params = dict(enc=(enc_cfg, enc_params), sess=(s_cfg, s_params),
                  batch=(b_cfg, b_params))
    return d, params, ranks


@pytest.mark.parametrize("mesh", MESHES)
def test_pp_encode_step_matches_sequential(case, mesh):
    """pp_encode_step (the sessions' append under pp) over n_micro
    exc_block_size microbatches (pp 4: 2, pp 2 x tp 2: 3) after the
    relayed init prompt: the last stage's hidden states and every
    StreamKV leaf of every layer equal JAX's and the port's n_micro
    sequential appends."""
    d, params, ranks = case
    cfg, jparams = params["enc"]
    e = d["enc"]
    n = N_MICRO[mesh]
    Tm = REKV.exc_block_size
    kvs = jq.init_stream_state(cfg, REKV, 2, jnp.float32)
    _, kvs = jq.encode_step(jparams, cfg, REKV, kvs, jnp.asarray(e["init"]),
                            is_init=True)
    lm = weights.qwen2_from_jax(e["tree"], e["cfg"], device="cpu")
    tkvs = lm.init_stream_state(e["rekv"], 2, torch.float32)
    lm.encode_step(e["rekv"], tkvs, torch.as_tensor(e["init"]), is_init=True)
    hs, ths = [], []
    for i in range(n):
        x = e["embeds"][n][:, i * Tm:(i + 1) * Tm]
        h, kvs = jq.encode_step(jparams, cfg, REKV, kvs, jnp.asarray(x),
                                is_init=False)
        hs.append(np.asarray(h))
        ths.append(lm.encode_step(e["rekv"], tkvs, torch.as_tensor(x),
                                  is_init=False)[0].numpy())
    n_last = 0
    for r in ranks:
        got = r[mesh]["encode"]
        if got["h"] is not None:
            n_last += 1
            np.testing.assert_allclose(got["h"], np.concatenate(hs, 1),
                                       **F32_TOL)
            np.testing.assert_allclose(got["h"], np.concatenate(ths, 1),
                                       **F32_TOL)
        for name in kvs._fields:
            want = np.asarray(getattr(kvs, name))
            if name in ("num_blocks", "page_offset", "length"):
                np.testing.assert_array_equal(got["kvs"][name], want)
            else:
                np.testing.assert_allclose(got["kvs"][name], want,
                                           err_msg=name, **F32_TOL)
    # the last stage's ranks: its tp group
    assert n_last == {"pp4": 1, "pp2_tp2": 2}[mesh]


def _jax_session(cfg, params, rekv, batch=1):
    return JSession(params, cfg, SessionConfig(rekv=rekv), batch=batch,
                    state_dtype=jnp.float32)


@pytest.mark.parametrize("mesh", MESHES)
def test_pp_session_matches_sequential(case, mesh):
    """tests/test_pp.py's end-to-end session (8 layers: init prompt, a
    multi-chunk and a single-chunk ingest, two questions with streaming
    after each) on pp 4 and pp 2 x tp 2: every layer's StreamKV equals
    JAX's sequential session's before the questions, and the answers equal
    JAX's and the port's sequential answers."""
    d, params, ranks = case
    cfg, jparams = params["sess"]
    s_ = d["sess"]
    js = _jax_session(cfg, jparams, REKV)
    lm = weights.qwen2_from_jax(s_["tree"], s_["cfg"], device="cpu")
    ps = StreamingSession(lm, s_["scfg"], state_dtype=torch.float32)
    for s in (js, ps):
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video_features(s_["feats1"])
        s.encode_video_features(s_["feats2"])
    for r in ranks:
        for name in js.kvs._fields:
            want = np.asarray(getattr(js.kvs, name))
            if name in ("num_blocks", "page_offset", "length"):
                np.testing.assert_array_equal(
                    r[mesh]["session"]["kvs"][name], want)
            else:
                np.testing.assert_allclose(r[mesh]["session"]["kvs"][name],
                                           want, err_msg=name, **F32_TOL)
    answers = []
    for (q, p), more in zip(QS, s_["more"]):
        a = js.question_answering(q, p, [0], max_new_tokens=6)
        assert ps.question_answering(q, p, [0], max_new_tokens=6) == a
        answers.append(a)
        js.encode_video_features(more)
        ps.encode_video_features(more)
    for r in ranks:
        assert r[mesh]["session"]["answers"] == answers
        assert r[mesh]["session"]["blocks"] == ps.last_retrieved_indices


@pytest.mark.parametrize("mesh", MESHES)
def test_pp_session_batch_ragged_and_external_indices(case, mesh):
    """pp with two streams, a ragged tick (only stream 1 ingests),
    per-stream questions and external blocks: answers equal JAX's and the
    port's sequential sessions'."""
    d, params, ranks = case
    cfg, jparams = params["batch"]
    b_ = d["batch"]
    js = _jax_session(cfg, jparams, REKV, batch=2)
    lm = weights.qwen2_from_jax(b_["tree"], b_["cfg"], device="cpu")
    ps = StreamingSession(lm, b_["scfg"], batch=2,
                          state_dtype=torch.float32)
    out = []
    for s in (js, ps):
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video_features(b_["feats"])
        s.encode_video_features(b_["more"], active=[False, True])
        out.append({"batch": s.question_answering_batch(
            [[5, 6], [7]], [[8], [9, 10]], [0], max_new_tokens=5),
            "external": s.question_answering([5, 6], [8], [0],
                                             max_new_tokens=4,
                                             retrieved_indices=[0, 2])})
    assert out[0] == out[1]
    for r in ranks:
        assert r[mesh]["batch"] == out[0]


def test_pp_spec_decode_refused():
    """Speculative decode under pp is refused at the session's build and
    by the live toggle (ValueError; JAX asserts at build)."""
    from stc_tpu_torch.models import qwen2 as tq
    mesh = Mesh(("pp", "tp"), (2, 1), coord={"pp": 1, "tp": 0})
    cfg = tq.Qwen2Config(vocab_size=96, hidden_size=32, num_layers=4,
                         num_heads=4, num_kv_heads=2, head_dim=8,
                         intermediate_size=64)
    lm = tq.Qwen2(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="speculative decode"):
        StreamingSession(lm, port_cfg(SessionConfig(
            rekv=dataclasses.replace(REKV, spec_decode_draft=2))), mesh=mesh)
    sess = StreamingSession(lm, port_cfg(SessionConfig(rekv=REKV)),
                            state_dtype=torch.float32, mesh=mesh)
    assert len(sess.lm.layers) == 2 and sess.lm.layer_offset == 2
    with pytest.raises(ValueError, match="not supported under pp"):
        sess.set_spec_decode(2)


def test_pp_hosttier_eviction_fails_fast(case):
    """Streaming past max_blocks under pp raises before any state changes
    (every rank), as in the JAX package."""
    _, _, ranks = case
    for r in ranks:
        for mesh in MESHES:
            assert "not supported under pipeline" in r[mesh]["evict"]
