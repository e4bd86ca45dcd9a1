"""The port's utils/metrics.py and FLOPs counts: StreamingStats and Timer
against stc_tpu's, estimate_flops of a matmul, each hand kernel's FLOPs
formula against FlopCounterMode over its plain version (what the wrapper
adds on the card is what the counter sees on the CPU), and
VLMSession.estimate_chunk_flops: the cacher's chunk cheaper than a full
one (the bound of tests/test_llava_ov.py:195), and the session's state
and its next chunk bit-equal to a session that never estimated."""

import jax
import numpy as np
import pytest
import torch

from stc_tpu.models import llava_onevision as jlo
from stc_tpu.utils import metrics as jm
from stc_tpu_torch import weights
from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.ops import decode_attention as da
from stc_tpu_torch.ops import stream_attention as sa
from stc_tpu_torch.utils import metrics
from test_torch_common import (np_tree, one_thread,  # noqa: F401
                               port_model_cfg)
from test_torch_cuda import BASE, _keep_half, _stream_operands

pytestmark = pytest.mark.usefixtures("one_thread")


def test_streaming_stats():
    def fill(st):
        for t in (0.01, 0.02, 0.03, 0.04):
            st.record_frame(t, tokens=60)
        st.record_qa(0.5)
        return st.summary(kv_memory_bytes=2 ** 30)

    s = fill(metrics.StreamingStats())
    assert s == fill(jm.StreamingStats())
    assert s["frames"] == 4
    assert abs(s["fps"] - 4 / 0.1) < 1e-6
    assert s["frame_p50_ms"] in (20.0, 30.0)
    assert s["encode_tokens"] == 240
    assert s["kv_memory_gb"] == 1.0
    with metrics.Timer() as t:
        pass
    assert t.seconds >= 0


def test_timer_syncs_at_both_ends():
    calls = []
    with metrics.Timer(sync=lambda: calls.append("sync")) as t:
        calls.append("work")
    assert calls == ["sync", "work", "sync"] and t.seconds >= 0
    assert metrics.device_sync("cpu") is None
    assert metrics.device_sync(None) is None


def test_estimate_flops_matmul():
    a = torch.zeros((64, 128))
    b = torch.zeros((128, 32))
    assert metrics.estimate_flops(lambda x, y: x @ y, a, b) == \
        2 * 64 * 128 * 32


def test_kernel_flops_reach_every_open_count():
    """A wrapper's add_kernel_flops lands in each estimate_flops call in
    progress (nested ones too), and in none once they have returned."""
    inner = []

    def run():
        metrics.add_kernel_flops(5)
        inner.append(metrics.estimate_flops(metrics.add_kernel_flops, 7))

    assert metrics.estimate_flops(run) == 12
    assert inner == [7]
    metrics.add_kernel_flops(3)
    assert metrics.estimate_flops(lambda: None) == 0


def stream_call(kind, keep):
    cfg = ReKVConfig(**dict(BASE, kv_quant=kind))
    scales = {} if kind != "none" else None
    ops = _stream_operands(cfg, 3, 8, seed=4, scales=scales)
    kw = dict(n_local=cfg.n_local, **(scales or {}))
    if keep:
        kw["page_keep"] = _keep_half(3, cfg.max_blocks, cfg.block_size, 3)
    B, Hq, T, D = ops[0].shape
    want = sa.stream_attention_flops(B, Hq, T, D, ops[4].shape[1],
                                     ops[6].shape[2])
    return (lambda: sa.stream_attention(*ops, **kw)), want


def decode_call(fn, return_m=False):
    g = torch.Generator().manual_seed(2)
    B, Hq, Hkv, T, D, C = 2, 4, 2, 5, 32, 64
    q = torch.randn((B, Hq, T, D), generator=g)
    k, v = (torch.randn((B, Hkv, C, D), generator=g) for _ in range(2))
    start = torch.tensor([10, 30], dtype=torch.int32)
    cursor = start + T
    if fn == "score":
        m = torch.randn((B, Hq, T), generator=g)
        return (lambda: da.decode_score(q, k, m, start, cursor,
                                        n_local=16)), \
            da.decode_score_flops(B, Hq, T, D, C)
    return (lambda: da.decode_attention(q, k, v, start, cursor, n_local=16,
                                        return_m=return_m)), \
        da.decode_attention_flops(B, Hq, T, D, C)


@pytest.mark.parametrize("case", [
    ("stream", "none", False), ("stream", "int8", False),
    ("stream", "int4", False), ("stream", "none", True),
    ("stream", "int8", True), ("stream", "int4", True),
    ("decode", False), ("decode", True), ("score",)],
    ids=lambda c: "-".join(map(str, c)))
def test_kernel_flops_formula_equals_counter_over_plain_version(case):
    """On a CPU tensor FlopCounterMode sees the plain version, which the
    wrapper runs; its count equals the formula the wrapper adds on the
    card, for every page kind, with and without page_keep."""
    if case[0] == "stream":
        call, want = stream_call(*case[1:])
    else:
        call, want = decode_call(case[0], *case[1:])
    assert metrics.estimate_flops(call) == want > 0


def port_session(chunk=1, **rekv):
    """tests/test_llava_ov.py::make's session in the port, at
    `chunk`-frame chunks, with ReKVConfig fields `rekv` replaced; init
    prompt encoded."""
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(**{**dict(
            n_init=4, n_local=128, block_size=3, exc_block_size=3 * chunk,
            topk=4, max_blocks=64, max_prompt_tokens=32, max_new_tokens=8),
            **rekv}),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=3),
        encode_chunk_frames=chunk)
    params = jlo.init_random_params(cfg, jax.random.key(3))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    sess = tlo.build_session(model, scfg, state_dtype=torch.float32,
                             device="cpu")
    sess.encode_init_prompt([1, 2, 3, 4])
    return sess


def test_cacher_flops_saving_is_real():
    """The selective-recompute chunk costs fewer FLOPs than the full one on
    the same state (the tiny config is LM-dominated, so by a few percent;
    tests/test_llava_ov.py:195's bound)."""
    sess = port_session()
    frames = np.random.default_rng(12).integers(0, 256, (2, 56, 56, 3),
                                                dtype=np.uint8)
    sess.encode_video(frames)
    full = sess.estimate_chunk_flops(cached=False)
    part = sess.estimate_chunk_flops(cached=True)
    assert 0 < part < 0.95 * full, (part, full)


def state_of(sess):
    return ([x.clone() for x in sess.kvs]
            + [x.clone() for x in sess._vstate]
            + [x.clone() for x in sess._pstate],
            (sess.chunk_idx, sess._total_blocks, sess._evicted_pages,
             sess._slot_chunk.tolist(), sess._stream_blocks.tolist()))


def assert_same_state(a, b):
    ta, ia = state_of(a)
    tb, ib = state_of(b)
    assert ia == ib
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("chunk,n_frames,rekv", [
    (1, 5, {}),
    (2, 6, {}),
    # a full 16-page store: the append's write slot is clipped onto live
    # pages, and the next chunk evicts
    (1, 16, dict(n_local=12, max_blocks=16))],
    ids=["1-frame", "2-frame", "full-store"])
def test_estimate_chunk_flops_leaves_the_session_as_it_was(chunk, n_frames,
                                                           rekv):
    frames = np.random.default_rng(5).integers(
        0, 256, (n_frames + 2 * chunk, 56, 56, 3), dtype=np.uint8)
    a, b = port_session(chunk, **rekv), port_session(chunk, **rekv)
    for s in (a, b):
        s.encode_video(frames[:n_frames])
    f_full = a.estimate_chunk_flops(cached=False)
    f_cached = a.estimate_chunk_flops(cached=True)
    assert f_full > f_cached > 0
    assert a.estimate_chunk_flops(cached=False) == f_full
    assert_same_state(a, b)
    for s in (a, b):
        s.encode_video(frames[n_frames:])
    assert_same_state(a, b)
    assert a.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=4) \
        == b.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=4)
    assert a.last_retrieved_indices == b.last_retrieved_indices
