"""The streaming append's CUDA graph (stc_tpu_torch/runtime/append_graph.py)
on the CPU: which calls it sends eager and why, what its key depends on,
that clear_cache drops the graph before it makes the new store, that init
prompts and bare sessions never reach it, and that
on the CPU every append runs the eager path, counted as such, with the
results of a session that calls pipeline.pp_encode_step itself.  The
graph's own runs are card tests (tests/test_torch_cuda.py, -k
append_graph)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.kvcache import engine
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import longva as lv
from stc_tpu_torch.ops import stream_attention as sa
from stc_tpu_torch.parallel import pipeline
from stc_tpu_torch.runtime import append_graph as ag
from stc_tpu_torch.runtime.session import StreamingSession
from stc_tpu_torch.utils import metrics
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh_counts():
    metrics.reset_append_counts()
    yield
    metrics.reset_append_counts()


def rekv(block, **kw):
    return ReKVConfig(n_init=4, n_local=128, block_size=block,
                      exc_block_size=block, topk=4, max_blocks=64,
                      max_prompt_tokens=16, max_new_tokens=4, **kw)


def ov_session(batch=1):
    gen = torch.Generator().manual_seed(0)
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(gen)
    scfg = SessionConfig(rekv=rekv(3),
                         cacher=CacherConfig(strategy="cacher",
                                             update_token_ratio=0.5,
                                             cache_interval=2),
                         pruner=PrunerConfig(token_per_frame=3))
    return lo.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu", batch=batch)


def longva_session(batch=1):
    gen = torch.Generator().manual_seed(0)
    cfg = lv.LongVAConfig.tiny()
    model = lv.ClipVLM(cfg, dtype=torch.float32,
                       device="cpu").init_random_params(gen)
    scfg = lv.default_session_config(cfg)
    scfg = SessionConfig(rekv=rekv(cfg.tokens_per_frame), cacher=scfg.cacher,
                         pruner=scfg.pruner)
    return lv.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu", batch=batch)


SESSIONS = dict(llava_ov=ov_session, longva=longva_session)


def fake_lm(**axes):
    return types.SimpleNamespace(**dict(dict(tp=None, sp=None, pp=None),
                                        **axes))


def on_card(shape=(1, 3, 8)):
    """A stand-in for a card tensor: eager_reason reads only its device."""
    return types.SimpleNamespace(device=CARD, shape=shape)


# ----------------------------------------------------------- the rule --

ELIGIBILITY = {
    "eligible": (fake_lm(), on_card(), None, None),
    "cpu": (fake_lm(), torch.zeros(1, 3, 8), None, "device"),
    "active": (fake_lm(), on_card(), torch.tensor([True, False]), "active"),
    "tp": (fake_lm(tp=object()), on_card(), None, "parallel"),
    "sp": (fake_lm(sp=object()), on_card(), None, "parallel"),
    "pp": (fake_lm(pp=object()), on_card(), None, "parallel"),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY) + ["flops"])
def test_eager_reason(case):
    """Only a CUDA append with nothing else about it takes a graph; each
    other condition sends the call eager under its own reason, whatever
    the device."""
    if case == "flops":  # inside an open estimate_flops count
        got = []
        metrics.estimate_flops(lambda: got.append(ag.eager_reason(
            fake_lm(), on_card(), None)))
        assert got == ["flops"]
        assert not metrics.counting_flops()
        return
    lm, x, active, want = ELIGIBILITY[case]
    assert ag.eager_reason(lm, x, active) == want


def store(cfg, batch=1):
    return engine.init_stream_kv(cfg, batch, 2, 16, torch.float32,
                                 device="cpu", layers=2)


KEY_CHANGES = {
    "pointers": lambda kvs, x, cfg: (store(cfg), x, cfg),
    "batch": lambda kvs, x, cfg: (kvs, torch.zeros(2, 3, 64), cfg),
    "tokens": lambda kvs, x, cfg: (kvs, torch.zeros(1, 6, 64), cfg),
    "dtype": lambda kvs, x, cfg: (kvs, x.to(torch.float64), cfg),
    "rekv": lambda kvs, x, cfg: (kvs, x, dataclasses.replace(cfg,
                                                             n_local=96)),
    "kv_quant": lambda kvs, x, cfg: (kvs, x, dataclasses.replace(
        cfg, kv_quant="int8")),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES) + ["none"])
def test_graph_key(change):
    """The key follows the store's tensors, the input's shape and dtype
    and the ReKVConfig; the same store and shape give the same key."""
    cfg = rekv(3)
    kvs, x = store(cfg), torch.zeros(1, 3, 64)
    key = ag.graph_key(kvs, x, cfg)
    if change == "none":
        assert ag.graph_key(kvs, torch.ones(1, 3, 64), rekv(3)) == key
        return
    other = KEY_CHANGES[change](kvs, x, cfg)
    assert ag.graph_key(*other) != key


def test_clear_cache_releases_the_graph_before_the_new_store():
    sess = ov_session()
    g = sess.append_graph
    seen = []
    make = sess.lm.init_stream_state

    def init_stream_state(*a, **k):
        seen.append((g._key, g._graph, g._static_in, g._static_out))
        return make(*a, **k)

    g._key, g._graph = ("held",), object()
    g._static_in = g._static_out = torch.zeros(1)
    sess.lm.init_stream_state = init_stream_state
    sess.clear_cache()
    assert seen == [(None, None, None, None)]
    assert sess.append_graph is g


@pytest.mark.parametrize("path", ["init_prompt", "bare_features"])
def test_paths_that_bypass_the_graph(path):
    """An init prompt and a bare StreamingSession's features append
    through Qwen2.encode_step itself: no append is counted, and a bare
    session holds no graph."""
    sess = ov_session()
    if path == "init_prompt":
        sess.encode_init_prompt(torch.arange(4))
        assert sess.append_graph._key is None
    else:
        bare = StreamingSession(sess.lm, sess.scfg,
                                state_dtype=torch.float32)
        bare.encode_init_prompt(torch.arange(4))
        bare.encode_video_features(torch.randn(1, 6, sess.lm.cfg.hidden_size))
        assert int(bare.kvs.num_blocks[0, 0]) == 2
        assert not hasattr(bare, "append_graph")
    assert metrics.append_counts() == dict(replays=0, captures=0, eager={})


# ------------------------------------------------------- on the CPU --

def frames(n, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, 40, 72, 3) if batch == 1 else (batch, n, 40, 72, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def eager_twin(sess):
    """The session with today's eager append in place of the graph's."""
    def append_flat(flat, active=None):
        pipeline.pp_encode_step(sess.lm, sess.rekv, sess.kvs,
                                flat.to(sess.lm.dtype), active)

    sess._append_flat = append_flat
    return sess


RUNS = {
    "llava_ov": ("llava_ov", 1, None),
    "longva": ("longva", 1, None),
    "llava_ov_ragged": ("llava_ov", 2, [True, False]),
    "longva_ragged": ("longva", 2, [False, True]),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cpu_appends_run_eager_with_the_same_results(run):
    """Four chunks and a FLOP estimate on the CPU: every append is eager
    (the device, or a ragged mask, or the open count), no graph is held,
    no kernel launch is counted, and the store equals that of a session
    that calls pipeline.pp_encode_step itself."""
    family, batch, active = RUNS[run]
    stores = []
    for twin in (False, True):
        sess = SESSIONS[family](batch)
        if twin:
            eager_twin(sess)
        sess.encode_init_prompt(torch.arange(4))
        launched = (dict(sa.launches), sa.masked_launches)
        metrics.reset_append_counts()
        for k in range(4):
            sess.encode_video(frames(1, batch, seed=k), active=active)
        if not twin:
            counts = metrics.append_counts()
            reason = "device" if active is None else "active"
            assert counts == dict(replays=0, captures=0,
                                  eager={reason: 4})
            sess.estimate_chunk_flops()
            assert metrics.append_counts()["eager"] == {reason: 4,
                                                        "flops": 1}
            assert metrics.append_hit_share() == 0.0
            assert sess.append_graph._graph is None
            assert sess.append_graph._key is None
        assert (dict(sa.launches), sa.masked_launches) == launched
        stores.append([x.clone() for x in sess.kvs])
    for a, b in zip(*stores):
        assert torch.equal(a, b)


def test_append_counts():
    assert metrics.append_hit_share() is None
    for how in ["warmup", "capture"] + ["replay"] * 97 + ["device"]:
        metrics.count_append(how)
    assert metrics.append_counts() == dict(
        replays=97, captures=1, eager={"warmup": 1, "device": 1})
    assert metrics.append_hit_share() == 0.97
    metrics.reset_append_counts()
    assert metrics.append_counts() == dict(replays=0, captures=0, eager={})
