"""Ragged multi-stream ingest in the port (tests/test_ragged.py's cases):
`active` masks batch streams that tick at different rates into one call.

An inactive stream's state (pages, scales, counters, rep keys, cacher
references, pruner memory) stays bit-identical; active streams compute
what an independent session would.  Against stc_tpu's ragged sessions:
answer ids and retrieved blocks exactly, pages to F32_TOL; against the
port's own batch-1 sessions: state leaves exactly equal and answers
equal."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.kvcache import engine as je
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.kvcache import host_tier
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg, tt)

pytestmark = pytest.mark.usefixtures("one_thread")

HQ, HKV, D = 4, 2, 16
CFG = ReKVConfig(n_init=4, n_local=64, block_size=8, exc_block_size=8,
                 topk=4, chunk_size=1, max_blocks=16,
                 max_prompt_tokens=16, max_new_tokens=8)
# per-step activity of (stream 0, stream 1)
PATTERN = [(True, True), (True, False), (False, True), (True, True),
           (False, True), (True, False), (True, True)]
Q, P = [5, 6, 7], [5, 6, 7, 8]


def _arrs(rng, h, t):
    return rng.normal(size=(1, h, t, D)).astype(np.float32)


def _init_port(cfg, B, rng, kv_quant="none"):
    pc = port_cfg(dataclasses.replace(cfg, kv_quant=kv_quant))
    kv = te.init_stream_kv(pc, B, HKV, D, torch.float32, device="cpu")
    q, k, v = (np.concatenate([_arrs(rng, h, cfg.n_init)] * B)
               for h in (HQ, HKV, HKV))
    te.append_stream(kv, tt(q), tt(k), tt(v), pc, is_init=True)
    return kv, pc


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_engine_ragged_matches_independent_streams(kv_quant):
    """A B = 2 ragged run equals two B = 1 runs bit for bit on every state
    leaf, active steps' outputs too; and stc_tpu's ragged engine on the
    same inputs to F32_TOL (integer leaves exactly)."""
    rng = np.random.default_rng(0)
    data = [[(_arrs(rng, HQ, 8), _arrs(rng, HKV, 8), _arrs(rng, HKV, 8))
             for _ in PATTERN] for _ in range(2)]
    kv2, pc = _init_port(CFG, 2, np.random.default_rng(42), kv_quant)
    kv1 = [_init_port(CFG, 1, np.random.default_rng(42), kv_quant)[0]
           for _ in range(2)]
    jcfg = dataclasses.replace(CFG, kv_quant=kv_quant)
    jkv = je.init_stream_kv(jcfg, 2, HKV, D, dtype=jnp.float32)
    r = np.random.default_rng(42)
    init = [np.concatenate([_arrs(r, h, CFG.n_init)] * 2)
            for h in (HQ, HKV, HKV)]
    _, jkv = je.append_stream(jkv, *map(jnp.asarray, init), jcfg,
                              is_init=True)
    for step, act in enumerate(PATTERN):
        q, k, v = (np.concatenate([data[b][step][i] for b in range(2)])
                   for i in range(3))
        o2, _ = te.append_stream(kv2, tt(q), tt(k), tt(v), pc,
                                 is_init=False, active=torch.tensor(act))
        oj, jkv = je.append_stream(jkv, *map(jnp.asarray, (q, k, v)), jcfg,
                                   is_init=False, active=jnp.asarray(act))
        for b in range(2):
            if act[b]:
                o1, _ = te.append_stream(kv1[b], *map(tt, data[b][step]),
                                         pc, is_init=False)
                assert torch.equal(o2[b], o1[0]), (b, step)
                np.testing.assert_allclose(o2[b].numpy(), np.asarray(oj)[b],
                                           **F32_TOL)
    for name in kv2._fields:
        got = getattr(kv2, name)
        for b in range(2):
            assert torch.equal(got[b], getattr(kv1[b], name)[0]), (b, name)
        want = np.asarray(getattr(jkv, name))
        if got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        else:  # counters, keep rows, int8 / packed int4 pages
            np.testing.assert_array_equal(got.numpy(), want, name)


def test_engine_inactive_full_stream_not_clobbered():
    """An inactive stream whose store is full keeps its pages: the clipped
    write slot lands on live pages and the masked write puts them back."""
    rng = np.random.default_rng(1)
    kv, pc = _init_port(CFG, 2, rng)
    for _ in range(CFG.max_blocks):  # fill both streams
        q, k, v = (np.concatenate([_arrs(rng, h, 8)] * 2)
                   for h in (HQ, HKV, HKV))
        te.append_stream(kv, tt(q), tt(k), tt(v), pc, is_init=False)
    assert kv.num_blocks.tolist() == [CFG.max_blocks] * 2
    before = kv.block_k[1].clone()
    stacked = type(kv)(*(x[None] for x in kv))  # a one-layer stack
    host_tier.evict_pages(stacked, 1, None)
    te.append_stream(kv, tt(q), tt(k), tt(v), pc, is_init=False,
                     active=torch.tensor([True, False]))
    want = torch.cat([before[:, 1:], torch.zeros_like(before[:, :1])], 1)
    assert torch.equal(kv.block_k[1], want)
    assert kv.num_blocks.tolist() == [CFG.max_blocks + 1, CFG.max_blocks]


def _feature_sessions(batch, seed=7, max_blocks=64, jax_too=True):
    mcfg = jq.Qwen2Config.tiny()
    scfg = SessionConfig(rekv=dataclasses.replace(
        CFG, max_blocks=max_blocks, n_local=128))
    params = jq.init_params(mcfg, jax.random.key(seed))
    t = TSession(weights.qwen2_from_jax(np_tree(params),
                                        port_model_cfg(mcfg), device="cpu"),
                 port_cfg(scfg), batch=batch, state_dtype=torch.float32)
    t.encode_init_prompt(list(range(CFG.n_init)))
    j = None
    if jax_too:
        j = JSession(params, mcfg, scfg, batch=batch,
                     state_dtype=jnp.float32)
        j.encode_init_prompt(list(range(CFG.n_init)))
    return j, t, mcfg


def test_session_ragged_answers_match_independent_sessions():
    """A ragged 2-stream feature session: per-stream counters, answers and
    retrieved blocks equal to stc_tpu's ragged session and to the port's
    batch-1 sessions fed each stream's active chunks."""
    j2, t2, mcfg = _feature_sessions(2)
    singles = [_feature_sessions(1, jax_too=False)[1] for _ in range(2)]
    rng = np.random.default_rng(3)
    chunks = [[rng.normal(size=(1, 8, mcfg.hidden_size)).astype(np.float32)
               for _ in PATTERN] for _ in range(2)]
    for step, act in enumerate(PATTERN):
        feats = np.concatenate([chunks[b][step] for b in range(2)])
        t2.encode_video_features(torch.from_numpy(feats), active=act)
        j2.encode_video_features(feats, active=act)
        for b in range(2):
            if act[b]:
                singles[b].encode_video_features(
                    torch.from_numpy(chunks[b][step]))
    want_blocks = [sum(1 for a in PATTERN if a[b]) for b in range(2)]
    assert t2._stream_blocks.tolist() == j2._stream_blocks.tolist() \
        == want_blocks
    assert t2.kvs.num_blocks[0].tolist() == want_blocks
    ans = t2.question_answering(Q, P, [0], max_new_tokens=6,
                                all_streams=True)
    assert ans == j2.question_answering(Q, P, [0], max_new_tokens=6,
                                        all_streams=True)
    for b in range(2):
        assert ans[b] == singles[b].question_answering(Q, P, [0],
                                                       max_new_tokens=6)
        assert [l[b] for l in t2.last_retrieved_indices] == \
            singles[b].last_retrieved_indices


def test_session_ragged_plus_eviction_raises():
    """Diverged ragged streams cannot evict (eviction shifts every
    stream): both sessions refuse where eviction would start."""
    j2, t2, mcfg = _feature_sessions(2, max_blocks=32)
    feats = np.random.default_rng(4).normal(
        size=(2, 8, mcfg.hidden_size)).astype(np.float32)
    t2.encode_video_features(torch.from_numpy(feats), active=[True, False])
    j2.encode_video_features(feats, active=[True, False])
    for s, f in ((t2, torch.from_numpy(feats)), (j2, feats)):
        with pytest.raises(RuntimeError, match="ragged"):
            for _ in range(40):
                s.encode_video_features(f)
    assert t2._stream_blocks.tolist() == j2._stream_blocks.tolist()


def _pixel_cfg(chunk=1):
    return SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=3 * chunk, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=3),
        encode_chunk_frames=chunk)


def pixel_sessions(seed, batch, chunk=1, jax_too=True):
    """(stc_tpu pixel session or None, port pixel session, maker of more
    port sessions) over the same tiny LLaVA-OV weights."""
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = _pixel_cfg(chunk)
    params = jlo.init_random_params(cfg, jax.random.key(seed))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")

    def port(b):
        s = tlo.build_session(model, port_cfg(scfg), device="cpu",
                              state_dtype=torch.float32, batch=b)
        s.encode_init_prompt([1, 2, 3, 4])
        return s

    j = None
    if jax_too:
        j = jlo.build_session(params, cfg, scfg, state_dtype=jnp.float32,
                              batch=batch)
        j.encode_init_prompt([1, 2, 3, 4])
    return j, port(batch), port


@pytest.mark.parametrize("chunk", [1, 2])
def test_vlm_ragged_pixel_path_matches_independent_sessions(chunk):
    """The whole pixel path with ragged masks (slots' cacher parities
    diverge, so mixed ticks run): counters, chunk counts, pages, answers
    and retrieved blocks equal to stc_tpu's ragged session, and each
    stream's answers equal to a port session fed only its active
    chunks."""
    j2, t2, port = pixel_sessions(9, 2, chunk)
    rng = np.random.default_rng(5)
    pattern = [(True, True), (True, False), (False, True), (True, True),
               (True, False)]
    frames = [[rng.uniform(0, 255, size=(1, chunk, 56, 56, 3))
               .astype(np.uint8) for _ in pattern] for _ in range(2)]
    for step, act in enumerate(pattern):
        fb = np.concatenate([frames[b][step] for b in range(2)])
        t2.encode_video(fb, active=act)
        j2.encode_video(fb, active=act)
    nb = [chunk * sum(1 for a in pattern if a[b]) for b in range(2)]
    assert t2.kvs.num_blocks[0].tolist() == nb
    np.testing.assert_array_equal(np.asarray(j2.kvs.num_blocks)[0], nb)
    assert t2._slot_chunk.tolist() == j2._slot_chunk.tolist() == [
        sum(1 for a in pattern if a[b]) for b in range(2)]
    np.testing.assert_allclose(t2.kvs.block_k.numpy(),
                               np.asarray(j2.kvs.block_k), **F32_TOL)
    ans = t2.question_answering([7, 8, 9], [7, 8, 9, 10], [0],
                                max_new_tokens=4, all_streams=True)
    assert ans == j2.question_answering([7, 8, 9], [7, 8, 9, 10], [0],
                                        max_new_tokens=4, all_streams=True)
    for b in range(2):
        solo = port(1)
        for step, act in enumerate(pattern):
            if act[b]:
                solo.encode_video(frames[b][step][0])
        assert ans[b] == solo.question_answering([7, 8, 9], [7, 8, 9, 10],
                                                 [0], max_new_tokens=4)
        assert [l[b] for l in t2.last_retrieved_indices] == \
            solo.last_retrieved_indices


def test_vlm_ragged_cacher_state_isolated():
    """An inactive stream's cacher references and pruner memory are
    bit-identical through a masked full-path tick, while the active
    stream's are rewritten."""
    _, s, _ = pixel_sessions(10, 2, jax_too=False)
    va, pa = s.vision.stream_axes()  # the stream axis of each state
    assert s._vstate.ref_k.shape[va] == s._pstate.mean_sum.shape[pa] == 2
    rng = np.random.default_rng(6)
    for _ in range(2):  # both active: chunk 2 next, a full-path chunk
        s.encode_video(rng.uniform(0, 255, size=(2, 1, 56, 56, 3))
                       .astype(np.uint8))
    assert s.chunk_idx == 2 and s._slot_chunk.tolist() == [2, 2]
    v_before = [x[:, 1].clone() for x in s._vstate]
    v0_before = [x[:, 0].clone() for x in s._vstate]
    p_before = [x[1].clone() for x in s._pstate]
    s.encode_video(rng.uniform(0, 255, size=(2, 1, 56, 56, 3))
                   .astype(np.uint8), active=[True, False])
    assert any(not torch.equal(x[:, 0], b)
               for x, b in zip(s._vstate, v0_before))
    for x, b in zip(s._vstate, v_before):
        assert torch.equal(x[:, 1], b)
    for x, b in zip(s._pstate, p_before):
        assert torch.equal(x[1], b)
    assert s._slot_chunk.tolist() == [3, 2]
