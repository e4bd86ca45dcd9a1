"""The vision towers' CUDA graphs (stc_tpu_torch/runtime/vision_graph.py) on
the CPU: which calls go eager and why, what the key depends on, that
clear_cache drops the graphs before it makes the new store and state, that
on the CPU every tower call runs the eager path, counted as such, with the
eager body's results, and, with a stand-in for the CUDA graph whose replay
rewrites the static outputs, that a hook on the tower's encode_cached (as
the benchmark's families place one) still runs once a cached chunk and
keeps selections that no later replay touches.  The graphs' own runs are
card tests (tests/test_torch_cuda.py, -k vision_graph)."""

import types

import numpy as np
import pytest
import torch

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.models import kimi_vl as kv
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import longva as lv
from stc_tpu_torch.runtime import vision_graph as vg
from stc_tpu_torch.utils import metrics
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh_counts():
    metrics.reset_vision_counts()
    yield
    metrics.reset_vision_counts()


def rekv(block):
    return ReKVConfig(n_init=4, n_local=128, block_size=block,
                      exc_block_size=block, topk=4, max_blocks=64,
                      max_prompt_tokens=16, max_new_tokens=4)


def cacher():
    return CacherConfig(strategy="cacher", update_token_ratio=0.5,
                        cache_interval=2)


def ov_session(batch=1):
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(
                           torch.Generator().manual_seed(0))
    scfg = SessionConfig(rekv=rekv(3), cacher=cacher(),
                         pruner=PrunerConfig(token_per_frame=3))
    return lo.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu", batch=batch)


def longva_session(batch=1):
    cfg = lv.LongVAConfig.tiny()
    model = lv.ClipVLM(cfg, dtype=torch.float32,
                       device="cpu").init_random_params(
                           torch.Generator().manual_seed(0))
    scfg = lv.default_session_config(cfg)
    scfg = SessionConfig(rekv=rekv(cfg.tokens_per_frame), cacher=scfg.cacher,
                         pruner=scfg.pruner)
    return lv.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu", batch=batch)


def kimi_session(batch=1):
    model = kv.KimiVL(kv.KimiVLConfig.tiny(), dtype=torch.float32,
                      vision_dtype=torch.float32,
                      device="cpu").init_random_params(
                          torch.Generator().manual_seed(0))
    scfg = SessionConfig(rekv=rekv(3), cacher=cacher(),
                         pruner=PrunerConfig(token_per_frame=3,
                                             model_spec="kimi_vl"))
    return kv.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu", batch=batch)


SESSIONS = dict(llava_ov=ov_session, longva=longva_session,
                kimi_vl=kimi_session)
HW = dict(llava_ov=(40, 72), longva=(40, 72), kimi_vl=(50, 80))


def frames(family, n, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) + HW[family] + (3,)
    return rng.integers(0, 256, shape if batch == 1 else (batch,) + shape,
                        dtype=np.uint8)


def fake_lm(**axes):
    return types.SimpleNamespace(**dict(dict(tp=None, sp=None, pp=None),
                                        **axes))


def on_card(shape=(1, 3, 56, 56)):
    """A stand-in for a card tensor: eager_reason reads only its device."""
    return types.SimpleNamespace(device=CARD, shape=shape)


# ----------------------------------------------------------- the rule --

HELD = {
    "uniform": (fake_lm(), None, False, None),
    "active": (fake_lm(), torch.tensor([True, False]), False, "active"),
    "mixed": (fake_lm(), None, True, "mixed"),
    "active_and_mixed": (fake_lm(), torch.tensor([True, False]), True,
                         "active"),
    "tp": (fake_lm(tp=object()), None, False, "parallel"),
    "sp": (fake_lm(sp=object()), None, False, "parallel"),
    "pp": (fake_lm(pp=object()), None, False, "parallel"),
}


@pytest.mark.parametrize("case", sorted(HELD))
def test_held_reason(case):
    """What the session passes down: a ragged mask first, then a mixed
    tick, then a layout with collectives; a uniform tick on one rank holds
    nothing."""
    lm, active, mixed, want = HELD[case]
    assert vg.held_reason(lm, active, mixed) == want


OWNER = vg.VisionGraph()
ELIGIBILITY = {
    "eligible": (on_card(), OWNER, None, None),
    "held": (on_card(), OWNER, "mixed", "mixed"),
    "held_on_cpu": (torch.zeros(1, 3, 56, 56), OWNER, "active", "active"),
    "cpu": (torch.zeros(1, 3, 56, 56), OWNER, None, "device"),
    "bare": (on_card(), None, None, "bare"),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY) + ["flops"])
def test_eager_reason(case):
    """Only a CUDA call with an owner and nothing held takes a graph; each
    other condition sends the call eager under its own reason."""
    if case == "flops":  # inside an open estimate_flops count
        got = []
        metrics.estimate_flops(lambda: got.append(vg.eager_reason(
            on_card(), OWNER, None)))
        assert got == ["flops"]
        return
    x, owner, held, want = ELIGIBILITY[case]
    assert vg.eager_reason(x, owner, held) == want


REFS = [torch.zeros(2, 1, 16, 32) for _ in range(4)]
KEY_CHANGES = {
    "batch": lambda x, s, r: (torch.zeros((2,) + x.shape[1:]), s, r),
    "frame_size": lambda x, s, r: (torch.zeros(1, 3, 84, 56), s, r),
    "dtype": lambda x, s, r: (x.to(torch.float64), s, r),
    "ratio": lambda x, s, r: (x, (0.25,) + s[1:], r),
    "streams": lambda x, s, r: (x, s[:1] + (2,) + s[2:], r),
    "sim_source": lambda x, s, r: (x, s[:2] + ("value",) + s[3:], r),
    "k_proxy_rank": lambda x, s, r: (x, s[:3] + (64,), r),
    "reference_moved": lambda x, s, r: (x, s, [REFS[0].clone()] + r[1:]),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES) + ["none"])
def test_graph_key(change):
    """The key follows the pixels' shape and dtype, the path's settings and
    the addresses of the state it reads; other pixel values and the same
    state give the same key."""
    x, settings = torch.zeros(1, 3, 56, 56), (0.5, 1, "key", 0)
    key = vg.graph_key(x, settings, REFS)
    if change == "none":
        assert vg.graph_key(torch.ones(1, 3, 56, 56), (0.5, 1, "key", 0),
                            list(REFS)) == key
        return
    assert vg.graph_key(*KEY_CHANGES[change](x, settings, REFS)) != key


@pytest.mark.parametrize("family", sorted(SESSIONS))
def test_clear_cache_releases_the_graphs_before_the_new_store(family):
    """The graphs (and the references they hold) go before the new store
    and the fresh cacher state are made; the session keeps its owner."""
    sess = SESSIONS[family]()
    g = sess.vision_graph
    seen = []

    def watch(obj, name):
        make = getattr(obj, name)

        def f(*a, **k):
            seen.append((name, dict(g._held), dict(g.pool_bytes)))
            return make(*a, **k)

        setattr(obj, name, f)

    g._held = {"full": object(), "cached": object()}
    g.pool_bytes = {"full": 1}
    watch(sess.lm, "init_stream_state")
    watch(sess.vision, "init_state")
    sess.clear_cache()
    assert seen == [("init_stream_state", {}, {}), ("init_state", {}, {})]
    assert sess.vision_graph is g


def test_frame_encoder_reset_releases_its_graphs():
    sess = ov_session()
    enc = lo.FrameEncoder(sess.model, sess.scfg, device="cpu")
    enc.graph._held = {"full": object()}
    enc.reset()
    assert enc.graph._held == {}


# ------------------------------------------------------- on the CPU --

def eager_twin(monkeypatch):
    """Tower calls run their eager body, as before the graphs."""
    monkeypatch.setattr(vg, "run", lambda path, fn, x, *a, **k: fn(x))


RUNS = {
    "llava_ov": ("llava_ov", 1, None, {"device": 4}),
    "longva": ("longva", 1, None, {"device": 4}),
    "kimi_vl": ("kimi_vl", 1, None, {"device": 4}),
    "llava_ov_ragged": ("llava_ov", 2, [True, False], {"active": 4}),
    "longva_ragged": ("longva", 2, [False, True], {"active": 4}),
    # slot 1 restarts after the first chunk: every later tick is mixed
    "llava_ov_mixed": ("llava_ov", 2, "reset", {"device": 1, "mixed": 6}),
    "longva_mixed": ("longva", 2, "reset", {"device": 1, "mixed": 6}),
}


def stream(sess, family, batch, active):
    for k in range(4):
        if active == "reset" and k == 1:
            sess.reset_streams([1])
        sess.encode_video(frames(family, 1, batch, seed=k),
                          active=None if active == "reset" else active)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cpu_calls_run_eager_with_the_same_results(run, monkeypatch):
    """Four chunks and a FLOP estimate on the CPU: every tower call is
    eager (the device, a ragged mask, a mixed tick, the open count), no
    graph is held, and the store and the cacher state equal those of a
    session whose towers run their eager body directly."""
    family, batch, active, want = RUNS[run]
    results = []
    for twin in (False, True):
        if twin:
            eager_twin(monkeypatch)
        sess = SESSIONS[family](batch)
        sess.encode_init_prompt(torch.arange(4))
        metrics.reset_vision_counts()
        stream(sess, family, batch, active)
        if not twin:
            assert metrics.vision_counts() == dict(replays=0, captures=0,
                                                   eager=want)
            sess.estimate_chunk_flops()
            assert metrics.vision_counts()["eager"] == dict(want, flops=1)
            assert metrics.vision_hit_share() == 0.0
            assert sess.vision_graph._held == {}
        results.append([x.clone() for x in sess.kvs]
                       + [x.clone() for x in sess._vstate])
    for a, b in zip(*results):
        assert torch.equal(a, b)


# ------------------------------------------- with a stand-in for the graph --

class StandInGraph:
    """torch.cuda.CUDAGraph's part that vision_graph uses; a replay adds 1
    to every static output of the graph (as a real replay rewrites them
    with the next chunk's values)."""
    owner = None

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        for held in StandInGraph.owner._held.values():
            if held.graph is self:
                for t in held.static_out:
                    t.add_(1)


def cached_hook(sess, family, kept, calls):
    """A hook on the tower instance like stcbench/families/*.instrument:
    each cached chunk's selections (SigLIP's and MoonViT's out[1], CLIP's
    last_rows) kept by reference."""
    tower = sess.model.vision
    encode_cached = tower.encode_cached

    def enc_cached(*a, **k):
        calls.append(1)
        out = encode_cached(*a, **k)
        kept.append(list(tower.last_rows) if family == "longva"
                    else [out[1]])
        return out

    tower.encode_cached = enc_cached


@pytest.mark.parametrize("family", sorted(SESSIONS))
def test_graph_path_keeps_hooks_and_hands_out_copies(family, monkeypatch):
    """Eight 1-frame chunks through the graph path with a stand-in graph:
    each path warms up, captures, then replays (the cached path warms up
    again once the full path's references are the graph's); the hook on
    encode_cached runs once a cached chunk; the selections of every cached
    chunk are tensors of their own, unchanged by the later replays; the
    features handed out are not the graph's static outputs; the full
    path's references are, rewritten in place by its next replay."""
    monkeypatch.setattr(vg, "eager_reason",
                        lambda x, owner, held: held)
    monkeypatch.setattr(vg, "on_side_stream", lambda dev, fn: fn())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
    sess = SESSIONS[family]()
    StandInGraph.owner = sess.vision_graph
    kept, calls = [], []
    cached_hook(sess, family, kept, calls)
    sess.encode_init_prompt(torch.arange(4))
    seen, refs = [], []
    for k in range(8):
        sess.encode_video(frames(family, 1, seed=k))
        seen.append([x.clone() for x in kept[-1]] if k % 2 else None)
        if k % 2 == 0:
            refs.append(sess._vstate[0])
    assert metrics.vision_counts() == dict(
        replays=3, captures=2, eager={"warmup": 3})
    assert metrics.vision_hit_share() == 3 / 8
    assert len(calls) == len(kept) == 4
    ptrs = [t.data_ptr() for sel in kept for t in sel if t is not None]
    assert len(set(ptrs)) == len(ptrs)
    for sel, snap in zip(kept, seen[1::2]):
        for a, b in zip(sel, snap):
            assert (a is None and b is None) or torch.equal(a, b)
    held = sess.vision_graph._held
    static = {t.data_ptr() for h in held.values() for t in h.static_out}
    assert not static & set(ptrs)
    # the references of full chunks 2, 4 and 6 are the graph's own
    assert refs[1] is refs[2] is refs[3] is held["full"].static_out[1]
    assert refs[0] is not refs[1]


def test_vision_counts():
    assert metrics.vision_hit_share() is None
    for how in ["warmup", "warmup", "capture"] + ["replay"] * 97:
        metrics.count_vision(how)
    metrics.count_vision("mixed")
    assert metrics.vision_counts() == dict(
        replays=97, captures=1, eager={"warmup": 2, "mixed": 1})
    assert metrics.vision_hit_share() == 97 / 101
    metrics.reset_vision_counts()
    assert metrics.vision_counts() == dict(replays=0, captures=0, eager={})
    metrics.count_append("replay")  # the append counts are apart
    assert metrics.vision_counts()["replays"] == 0
    metrics.reset_append_counts()
