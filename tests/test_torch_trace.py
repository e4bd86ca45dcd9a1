"""The port's span recorder (utils/metrics.py: tracing, span, take_spans)
and the five spans of the ingest path, on tiny LLaVA-OV and LongVA
sessions on the CPU: off, nothing is recorded and span() hands back one
shared object; on, a 3-chunk run records chunk > vision.full > pruner,
then chunk > vision.cached > pruner, and an append in every chunk, with
their parents and chunk ids; the features and pages are bit-equal with
tracing on and off."""

import numpy as np
import pytest
import torch

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import longva as lv
from stc_tpu_torch.utils import metrics
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    metrics.tracing(False)
    metrics.take_spans()
    yield
    metrics.tracing(False)
    metrics.take_spans()


def rekv(block):
    return ReKVConfig(n_init=4, n_local=128, block_size=block,
                      exc_block_size=block, topk=4, max_blocks=64,
                      max_prompt_tokens=16, max_new_tokens=4)


def ov_session():
    gen = torch.Generator().manual_seed(0)
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(gen)
    scfg = SessionConfig(rekv=rekv(3),
                         cacher=CacherConfig(strategy="cacher",
                                             update_token_ratio=0.5,
                                             cache_interval=2),
                         pruner=PrunerConfig(token_per_frame=3))
    return lo.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu")


def longva_session():
    gen = torch.Generator().manual_seed(0)
    cfg = lv.LongVAConfig.tiny()
    model = lv.ClipVLM(cfg, dtype=torch.float32,
                       device="cpu").init_random_params(gen)
    scfg = lv.default_session_config(cfg)
    scfg = SessionConfig(rekv=rekv(cfg.tokens_per_frame), cacher=scfg.cacher,
                         pruner=scfg.pruner)
    return lv.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu")


SESSIONS = dict(llava_ov=ov_session, longva=longva_session)


def frames(n=3):
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (n, 40, 72, 3), dtype=np.uint8)


def run(make, on):
    """Three 1-frame chunks after the init prompt -> (each chunk's vision
    features, the store's tensors, the spans recorded)."""
    sess = make()
    sess.encode_init_prompt(torch.arange(4))
    feats = []
    path = sess._append_flat

    def keep(flat, active=None):
        feats.append(flat.clone())
        return path(flat, active)

    sess._append_flat = keep
    metrics.tracing(on)
    try:
        sess.encode_video(frames())
    finally:
        metrics.tracing(False)
    return feats, [x.clone() for x in sess.kvs], metrics.take_spans()


def test_span_is_shared_and_records_nothing_while_off():
    assert metrics.span("chunk", 3) is metrics.span("append")
    with metrics.span("chunk", 0):
        with metrics.span("append"):
            pass
    assert metrics.take_spans() == []


def test_span_parents_and_chunks():
    metrics.tracing(True)
    with metrics.span("chunk", 7):
        with metrics.span("vision.full"):
            with metrics.span("pruner"):
                pass
        with metrics.span("append", 7):
            pass
    with metrics.span("loose"):
        pass
    got = metrics.take_spans()
    assert [(s[0], s[3], s[4]) for s in got] == [
        ("chunk", -1, 7), ("vision.full", 0, 7), ("pruner", 1, 7),
        ("append", 0, 7), ("loose", -1, -1)]
    for name, t0, t1, parent, _ in got:
        assert 0 < t0 <= t1
        if parent >= 0:
            assert got[parent][1] <= t0 and t1 <= got[parent][2]
    assert metrics.take_spans() == []


def test_take_spans_refuses_while_a_span_is_open():
    metrics.tracing(True)
    with metrics.span("chunk", 0):
        with pytest.raises(RuntimeError):
            metrics.take_spans()
    assert [s[0] for s in metrics.take_spans()] == ["chunk"]


@pytest.mark.parametrize("family", sorted(SESSIONS))
def test_ingest_spans(family):
    """Spans in the order they opened, parents and chunk ids: chunks 0 and
    2 take the full path, chunk 1 the cacher's; LongVA has no pruner."""
    _, _, off = run(SESSIONS[family], False)
    assert off == []
    _, _, spans = run(SESSIONS[family], True)
    pruner = [("pruner", 1)] if family == "llava_ov" else []
    want = []
    for k, path in enumerate(("vision.full", "vision.cached", "vision.full")):
        base = len(want)
        want += [("chunk", -1, k), (path, base, k)]
        want += [(n, base + 1, k) for n, _ in pruner]
        want += [("append", base, k)]
    assert [(s[0], s[3], s[4]) for s in spans] == want
    for name, t0, t1, parent, _ in spans:
        assert 0 < t0 <= t1
        if parent >= 0:
            assert spans[parent][1] <= t0 and t1 <= spans[parent][2]


@pytest.mark.parametrize("family", sorted(SESSIONS))
def test_tracing_leaves_the_results_alone(family):
    feats_off, pages_off, _ = run(SESSIONS[family], False)
    feats_on, pages_on, spans = run(SESSIONS[family], True)
    assert spans and len(feats_on) == len(feats_off) == 3
    for a, b in zip(feats_on + pages_on, feats_off + pages_off):
        assert torch.equal(a, b)
