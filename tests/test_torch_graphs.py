"""The ingest path's CUDA graphs (stc_tpu_torch/runtime/graphs.py) on the
CPU: which calls go eager and why, what a path's key depends on, that
clear_cache drops every path's graph before it makes the new store and
state, that init prompts and bare sessions never reach the append's, that
on the CPU every append and tower call runs the eager path, counted as
such, with the eager results, and, with a stand-in for the CUDA graph
whose replay rewrites the static outputs, that a hook on the tower's
encode_cached (as the benchmark's families place one) still runs once a
cached chunk and keeps selections that no later replay touches, and that
a replay adds the hand kernels' launches its capture recorded.  The
graphs' own runs are card tests (tests/test_torch_cuda.py, -k graph)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.kvcache import engine
from stc_tpu_torch.models import kimi_vl as kv
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import longva as lv
from stc_tpu_torch.ops import latent_attention as la
from stc_tpu_torch.ops import stream_attention as sa
from stc_tpu_torch.parallel import pipeline
from stc_tpu_torch.runtime import graphs
from stc_tpu_torch.runtime.session import StreamingSession
from stc_tpu_torch.utils import metrics
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CARD = torch.device("cuda", 0)
KINDS = ("append", "vision")


@pytest.fixture(autouse=True)
def fresh_counts():
    for kind in KINDS:
        metrics.reset_graph_counts(kind)
    yield
    for kind in KINDS:
        metrics.reset_graph_counts(kind)


def rekv(block, **kw):
    return ReKVConfig(n_init=4, n_local=128, block_size=block,
                      exc_block_size=block, topk=4, max_blocks=64,
                      max_prompt_tokens=16, max_new_tokens=4, **kw)


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


def on_card(shape=(1, 3, 8)):
    """A stand-in for a card tensor: eager_reason reads only its device."""
    return types.SimpleNamespace(device=CARD, shape=shape)


# ----------------------------------------------------------- the rule --

OWNER = graphs.Graphs()
RAGGED = torch.tensor([True, False])
# case: (x, owner, what the session knows of the tick, the reason): the
# append's calls (the session's own holder), the session's ticks as the
# towers see them, and the towers' own conditions
EAGER = {
    "append_eligible": (on_card(), OWNER, dict(lm=fake_lm()), None),
    "append_cpu": (torch.zeros(1, 3, 8), OWNER, dict(lm=fake_lm()),
                   "device"),
    "append_active": (on_card(), OWNER, dict(lm=fake_lm(), active=RAGGED),
                      "active"),
    "append_tp": (on_card(), OWNER, dict(lm=fake_lm(tp=object())),
                  "parallel"),
    "append_sp": (on_card(), OWNER, dict(lm=fake_lm(sp=object())),
                  "parallel"),
    "append_pp": (on_card(), OWNER, dict(lm=fake_lm(pp=object())),
                  "parallel"),
    "tick_uniform": (on_card(), OWNER, dict(lm=fake_lm()), None),
    "tick_active": (on_card(), OWNER, dict(lm=fake_lm(), active=RAGGED),
                    "active"),
    "tick_mixed": (on_card(), OWNER, dict(lm=fake_lm(), mixed=True),
                   "mixed"),
    "tick_active_and_mixed": (on_card(), OWNER, dict(
        lm=fake_lm(), active=RAGGED, mixed=True), "active"),
    "tick_tp": (on_card(), OWNER, dict(lm=fake_lm(tp=object())),
                "parallel"),
    "tick_sp": (on_card(), OWNER, dict(lm=fake_lm(sp=object())),
                "parallel"),
    "tick_pp": (on_card(), OWNER, dict(lm=fake_lm(pp=object())),
                "parallel"),
    "tower_eligible": (on_card(), OWNER, {}, None),
    "tower_held": (on_card(), OWNER, dict(mixed=True), "mixed"),
    "tower_held_on_cpu": (torch.zeros(1, 3, 56, 56), OWNER,
                          dict(active=RAGGED), "active"),
    "tower_cpu": (torch.zeros(1, 3, 56, 56), OWNER, {}, "device"),
    "tower_bare": (on_card(), None, {}, "bare"),
}


@pytest.mark.parametrize("case", sorted(EAGER) + ["append_flops",
                                                  "tower_flops"])
def test_eager_reason(case):
    """Only a CUDA call with an owner and nothing else about it takes a
    graph; each other condition sends the call eager under its own
    reason: a ragged mask first, then a mixed tick, then a layout with
    collectives, an open FLOP count, the device, no owner."""
    if case.endswith("flops"):  # inside an open estimate_flops count
        seen = dict(lm=fake_lm()) if case == "append_flops" else {}
        got = []
        metrics.estimate_flops(lambda: got.append(graphs.eager_reason(
            on_card(), OWNER, **seen)))
        assert got == ["flops"]
        assert not metrics.counting_flops()
        return
    x, owner, seen, want = EAGER[case]
    assert graphs.eager_reason(x, owner, **seen) == want


def store(cfg, batch=1):
    return engine.init_stream_kv(cfg, batch, 2, 16, torch.float32,
                                 device="cpu", layers=2)


# the append's key: the features x, (ReKVConfig,), the store
APPEND_CHANGES = {
    "pointers": lambda x, s, r: (x, s, store(s[0])),
    "batch": lambda x, s, r: (torch.zeros(2, 3, 64), s, r),
    "tokens": lambda x, s, r: (torch.zeros(1, 6, 64), s, r),
    "dtype": lambda x, s, r: (x.to(torch.float64), s, r),
    "rekv": lambda x, s, r: (x, (dataclasses.replace(s[0], n_local=96),),
                             r),
    "kv_quant": lambda x, s, r: (x, (dataclasses.replace(
        s[0], kv_quant="int8"),), r),
}
# a tower path's key: pixels x, its settings, the cacher state it reads
REFS = [torch.zeros(2, 1, 16, 32) for _ in range(4)]
TOWER_CHANGES = {
    "batch": lambda x, s, r: (torch.zeros((2,) + x.shape[1:]), s, r),
    "frame_size": lambda x, s, r: (torch.zeros(1, 3, 84, 56), s, r),
    "dtype": lambda x, s, r: (x.to(torch.float64), s, r),
    "ratio": lambda x, s, r: (x, (0.25,) + s[1:], r),
    "streams": lambda x, s, r: (x, s[:1] + (2,) + s[2:], r),
    "sim_source": lambda x, s, r: (x, s[:2] + ("value",) + s[3:], r),
    "k_proxy_rank": lambda x, s, r: (x, s[:3] + (64,), r),
    "reference_moved": lambda x, s, r: (x, s, [REFS[0].clone()] + r[1:]),
}
KEY_CASES = ([("append", c) for c in sorted(APPEND_CHANGES) + ["none"]]
             + [("tower", c) for c in sorted(TOWER_CHANGES) + ["none"]])


@pytest.mark.parametrize("path,change", KEY_CASES)
def test_graph_key(path, change):
    """The key follows the input's shape and dtype, the path's settings
    (the append's ReKVConfig; a tower path's ratio, streams and gate) and
    the addresses of the state it reads (the store's tensors; the cacher's
    references); other input values and the same state give the same
    key."""
    if path == "append":
        cfg = rekv(3)
        x, settings, reads = torch.zeros(1, 3, 64), (cfg,), store(cfg)
        same = (torch.ones(1, 3, 64), (rekv(3),), reads)
        changes = APPEND_CHANGES
    else:
        x, settings, reads = torch.zeros(1, 3, 56, 56), (0.5, 1, "key", 0), \
            REFS
        same = (torch.ones(1, 3, 56, 56), (0.5, 1, "key", 0), list(REFS))
        changes = TOWER_CHANGES
    key = graphs.graph_key(x, settings, reads)
    if change == "none":
        assert graphs.graph_key(*same) == key
        return
    assert graphs.graph_key(*changes[change](x, settings, reads)) != key


@pytest.mark.parametrize("path", ["append", "full", "cached"])
@pytest.mark.parametrize("family", sorted(SESSIONS))
def test_clear_cache_releases_the_graphs_before_the_new_store(family, path):
    """A path's graph (and what it holds: the append's static tensors, the
    full path's references) goes before the new store and the fresh
    cacher state are made; the session keeps its holder."""
    sess = SESSIONS[family]()
    g = sess.graphs
    seen = []

    def watch(obj, name):
        make = getattr(obj, name)

        def f(*a, **k):
            seen.append((name, dict(g._held), dict(g.pool_bytes)))
            return make(*a, **k)

        setattr(obj, name, f)

    held = graphs._Held(("held",))
    held.graph, held.static_in, held.static_out = object(), \
        torch.zeros(1), (torch.zeros(1),)
    g._held = {path: held}
    g.pool_bytes = {path: 1}
    watch(sess.lm, "init_stream_state")
    watch(sess.vision, "init_state")
    sess.clear_cache()
    assert seen == [("init_stream_state", {}, {}), ("init_state", {}, {})]
    assert sess.graphs is g


def test_frame_encoder_reset_releases_its_graphs():
    sess = ov_session()
    enc = lo.FrameEncoder(sess.model, sess.scfg, device="cpu")
    enc.graphs._held = {"full": object()}
    enc.reset()
    assert enc.graphs._held == {}


@pytest.mark.parametrize("path", ["init_prompt", "bare_features"])
def test_paths_that_bypass_the_graph(path):
    """An init prompt and a bare StreamingSession's features append
    through Qwen2.encode_step itself: no append is counted, and a bare
    session holds no graphs."""
    sess = ov_session()
    if path == "init_prompt":
        sess.encode_init_prompt(torch.arange(4))
        assert sess.graphs._held == {}
    else:
        bare = StreamingSession(sess.lm, sess.scfg,
                                state_dtype=torch.float32)
        bare.encode_init_prompt(torch.arange(4))
        bare.encode_video_features(torch.randn(1, 6, sess.lm.cfg.hidden_size))
        assert int(bare.kvs.num_blocks[0, 0]) == 2
        assert not hasattr(bare, "graphs")
    assert metrics.graph_counts("append") == dict(replays=0, captures=0,
                                                  eager={})


# ------------------------------------------------------- on the CPU --

def eager_twin(sess, kind, monkeypatch):
    """The session with the eager call in place of the graphs' path(s) of
    `kind`: the append as pipeline.pp_encode_step, or the towers' eager
    body."""
    if kind == "vision":
        monkeypatch.setattr(graphs, "run", lambda path, fn, x, *a, **k:
                            fn(x))
        return

    def append_flat(flat, active=None):
        pipeline.pp_encode_step(sess.lm, sess.rekv, sess.kvs,
                                flat.to(sess.lm.dtype), active)

    sess._append_flat = append_flat


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
CPU_CASES = ([("append", r) for r in ("llava_ov", "llava_ov_ragged",
                                      "longva", "longva_ragged")]
             + [("vision", r) for r in sorted(RUNS)])


def stream(sess, family, batch, active):
    for k in range(4):
        if active == "reset" and k == 1:
            sess.reset_streams([1])
        sess.encode_video(frames(family, 1, batch, seed=k),
                          active=None if active == "reset" else active)


@pytest.mark.parametrize("kind,run", CPU_CASES)
def test_cpu_calls_run_eager_with_the_same_results(kind, run, monkeypatch):
    """Four chunks and a FLOP estimate on the CPU: every call of `kind`
    is eager (the device, a ragged mask, a mixed tick, the open count),
    no graph is held, no kernel launch is counted, and the store and the
    cacher state equal those of a session that runs the eager call
    itself."""
    family, batch, active, want = RUNS[run]
    if kind == "append":  # one append a chunk, a ragged one or not
        want = {"device" if active is None else "active": 4}
    results = []
    for twin in (False, True):
        sess = SESSIONS[family](batch)
        if twin:
            eager_twin(sess, kind, monkeypatch)
        sess.encode_init_prompt(torch.arange(4))
        launched = (dict(sa.launches), sa.masked_launches, la.launches)
        metrics.reset_graph_counts(kind)
        stream(sess, family, batch, active)
        if not twin:
            assert metrics.graph_counts(kind) == dict(replays=0, captures=0,
                                                      eager=want)
            sess.estimate_chunk_flops()
            assert metrics.graph_counts(kind)["eager"] == dict(want,
                                                               flops=1)
            assert metrics.graph_hit_share(kind) == 0.0
            assert sess.graphs._held == {}
        assert (dict(sa.launches), sa.masked_launches,
                la.launches) == launched
        results.append([x.clone() for x in sess.kvs]
                       + [x.clone() for x in sess._vstate])
    for a, b in zip(*results):
        assert torch.equal(a, b)


# ------------------------------------------- with a stand-in for the graph --

class StandInGraph:
    """torch.cuda.CUDAGraph's part that runtime/graphs.py uses; a replay
    adds 1 to every static output of the graph (as a real replay rewrites
    them with the next call's values)."""
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


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs that capture and replay on the CPU: every call with an owner
    and nothing held takes the graph path."""
    monkeypatch.setattr(graphs, "eager_reason",
                        lambda x, owner, lm=None, active=None, mixed=False:
                        "active" if active is not None else
                        "mixed" if mixed else None)
    monkeypatch.setattr(graphs, "on_side_stream", lambda dev, fn: fn())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)


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
def test_graph_path_keeps_hooks_and_hands_out_copies(family, stand_in,
                                                      monkeypatch):
    """Eight 1-frame chunks through the tower paths' graphs with a
    stand-in graph (the appends eager): each path warms up, captures, then
    replays (the cached path warms up again once the full path's
    references are the graph's); the hook on encode_cached runs once a
    cached chunk; the selections of every cached chunk are tensors of
    their own, unchanged by the later replays; the features handed out
    are not the graph's static outputs; the full path's references are,
    rewritten in place by its next replay."""
    sess = SESSIONS[family]()
    eager_twin(sess, "append", monkeypatch)
    StandInGraph.owner = sess.graphs
    kept, calls = [], []
    cached_hook(sess, family, kept, calls)
    sess.encode_init_prompt(torch.arange(4))
    seen, refs = [], []
    for k in range(8):
        sess.encode_video(frames(family, 1, seed=k))
        seen.append([x.clone() for x in kept[-1]] if k % 2 else None)
        if k % 2 == 0:
            refs.append(sess._vstate[0])
    assert metrics.graph_counts("vision") == dict(
        replays=3, captures=2, eager={"warmup": 3})
    assert metrics.graph_hit_share("vision") == 3 / 8
    assert len(calls) == len(kept) == 4
    ptrs = [t.data_ptr() for sel in kept for t in sel if t is not None]
    assert len(set(ptrs)) == len(ptrs)
    for sel, snap in zip(kept, seen[1::2]):
        for a, b in zip(sel, snap):
            assert (a is None and b is None) or torch.equal(a, b)
    held = sess.graphs._held
    static = {t.data_ptr() for h in held.values() for t in h.static_out}
    assert not static & set(ptrs)
    # the references of full chunks 2, 4 and 6 are the graph's own
    assert refs[1] is refs[2] is refs[3] is held["full"].static_out[1]
    assert refs[0] is not refs[1]


@pytest.mark.parametrize("path", ["append", "full", "cached"])
def test_replays_add_the_launches_recorded_at_capture(path, stand_in):
    """Whatever the path, a capture's wrapper calls launch nothing, so the
    hand kernels' counters are put back after it, and each replay adds
    the launches the capture recorded: three calls a path's call (eager
    warm-up, capture, replay) count as three eager runs."""
    owner = graphs.Graphs()
    StandInGraph.owner = owner

    def fn(y):  # a body that launches three kernels of each counter
        sa.launches["int8"] += 3
        sa.masked_launches += 3
        la.launches += 3
        return (y * 2,)

    before = (dict(sa.launches), sa.masked_launches, la.launches)
    x = torch.ones(2, 3)
    outs = [owner.call(path, fn, x, None, (path,), keep=(0,))
            for _ in range(3)]
    assert sa.launches["int8"] - before[0]["int8"] == 9
    assert sa.launches["float"] == before[0]["float"]
    assert sa.masked_launches - before[1] == 9
    assert la.launches - before[2] == 9
    kind = "append" if path == "append" else "vision"
    assert metrics.graph_counts(kind) == dict(replays=1, captures=1,
                                              eager={"warmup": 1})
    # the capture's call and the replay's hand out the static output
    assert outs[1][0] is outs[2][0] is owner._held[path].static_out[0]


@pytest.mark.parametrize("kind", KINDS)
def test_graph_counts(kind):
    """Counts, hit share and reset of one kind; the other kind's counts
    are apart."""
    other = [k for k in KINDS if k != kind][0]
    assert metrics.graph_hit_share(kind) is None
    for how in ["warmup", "warmup", "capture"] + ["replay"] * 97:
        metrics.count_graph(kind, how)
    metrics.count_graph(kind, "mixed" if kind == "vision" else "device")
    assert metrics.graph_counts(kind) == dict(
        replays=97, captures=1, eager={
            "warmup": 2, "mixed" if kind == "vision" else "device": 1})
    assert metrics.graph_hit_share(kind) == 97 / 101
    metrics.count_graph(other, "replay")
    assert metrics.graph_counts(other)["replays"] == 1
    metrics.reset_graph_counts(kind)
    assert metrics.graph_counts(kind) == dict(replays=0, captures=0,
                                              eager={})
    assert metrics.graph_counts(other)["replays"] == 1
