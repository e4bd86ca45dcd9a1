"""A family brings its own language model: a stub family, registered by
name, whose program keeps one latent row a token in a store of its own
and whose LM (not Qwen2: its own sizes, its own store fields, its own op)
is the only thing the harness asks about the LM.  The Qwen2 reference and
counts raise if anything calls them."""

import ast
import re
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from stcbench import counts, harness, weights
from stcbench.compare import rel
from stcbench.lms import Op
from stcbench.metrics import _common
from stcbench.reference import lm as rlm
from stcbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
FAMILY = "stub_latent"
T, E, R, N_INIT, VOCAB, PAGES, LAYERS = 4, 8, 6, 3, 50, 64, 2
SPECS = {"stub.embed": ((VOCAB, E), "float32", "w"),
         "stub.latent": ((E, R), "float32", "w")}
LIMITS = dict(feature_gap=1e-6, page_gap=1e-4, init_gap=1e-4)


def features(frames):
    """(T, E) features of a (1, H, W, 3) uint8 frame."""
    return frames[0].float().reshape(-1)[:T * E].reshape(T, E) / 255.0


class LatentStore(types.SimpleNamespace):
    def __iter__(self):
        return iter((self.latent, self.init_latent))


class Vision:
    def preprocess(self, frames):
        return frames

    def full(self, frames):
        return (features(torch.as_tensor(frames))[None],)


class Session:
    """The program: every append writes its tokens' latent rows, once a
    layer, and counts one launch of its op a layer."""

    def __init__(self, seed, device, fam):
        self.dev, self.fam = torch.device(device), fam
        self.W = weights.make(seed, "stub.latent", SPECS["stub.latent"],
                              device)
        self.emb = weights.make(seed, "stub.embed", SPECS["stub.embed"],
                                device)
        self.vision = Vision()
        self.clear_cache()

    def clear_cache(self):
        self.kvs = LatentStore(
            latent=torch.zeros((PAGES, T, R), device=self.dev),
            init_latent=torch.zeros((N_INIT, R), device=self.dev), pages=0)

    def encode_init_prompt(self, ids):
        self.kvs.init_latent.copy_(self.emb[torch.as_tensor(ids)] @ self.W)

    def encode_video(self, frames):
        self._append_flat(self.vision.full(self.vision.preprocess(frames))[0])

    def _append_flat(self, flat):
        for _ in range(LAYERS):
            self.kvs.latent[self.kvs.pages] = flat[0] @ self.W
            self.fam.LAUNCHES[0] += 1
        self.kvs.pages += 1


class LatentLM:
    """Its own sizes, its store read through its own fields, its own op;
    the gaps add the family's planted offsets."""

    def __init__(self, fam, get):
        self.fam, self.get = fam, get
        self.n_init, self.vocab_size = N_INIT, VOCAB
        self.ops = {"latent_mix": Op(("latent_mix",), "latent_mix",
                                     lambda: fam.LAUNCHES[0])}

    def chunk_work(self, k):
        call = counts.Work(bf16=2 * T * E * R, bytes=4 * (T * E + E * R
                                                          + T * R))
        return dict(ops={"latent_mix": [call] * LAYERS},
                    lm=counts.Work(bytes=4 * k) + call + call)

    def page_gaps(self, recs, control=None):
        W = self.get("stub.latent")
        gaps = [rel(r["kvs"].latent[r["k"]], r["flat"].float() @ W)
                + self.fam.PLANTED["page"] for r in recs]
        return gaps, (None if control is None else gaps)

    def init_gaps(self, stores, init_ids, control=None):
        W, emb = self.get("stub.latent"), self.get("stub.embed")
        want = emb[torch.as_tensor(init_ids)] @ W
        gap = max(rel(kv.init_latent, want) for kv in stores.values()) \
            + self.fam.PLANTED["init"]
        return gap, (None if control is None else gap)


class VisionReference:
    def __init__(self, cfg, get, prec):
        self.tower = types.SimpleNamespace(followed=0)

    def chunk(self, prev, frame, cached, memory=None, prog=None):
        return features(frame)


@pytest.fixture
def stub(monkeypatch):
    """The stub family as stcbench.families.stub_latent, and the Qwen2
    reference and counts made to raise."""
    fam = types.ModuleType(f"stcbench.families.{FAMILY}")
    fam.CHECK_NAMES = tuple(LIMITS)
    fam.LAUNCHES, fam.PLANTED, fam.RUNS = [0], dict(page=0.0, init=0.0), []
    fam.specs = lambda cfg: dict(SPECS)
    fam.build = lambda cfg, seed, device: Session(seed, device, fam)
    fam.instrument = lambda session, run: fam.RUNS.append(run)
    fam.vision_work = lambda cfg, cached: counts.Work(f32=1e6, bytes=1e5)
    fam.lm = lambda cfg, get, device: LatentLM(fam, get)
    fam.VisionReference = VisionReference
    monkeypatch.setitem(sys.modules, fam.__name__, fam)

    def boom(*a, **k):
        raise AssertionError("the harness reached the Qwen2 LM")

    for name in ("LMDims", "LMWeights", "init_layer", "append_layer",
                 "attend", "qkv"):
        monkeypatch.setattr(rlm, name, boom)
    for name in ("lm_pass", "stream_attention", "lm_layer_params"):
        monkeypatch.setattr(counts, name, boom)
    return fam


def stub_spec():
    spec = tiny.spec()
    spec["config"] = dict(family=FAMILY, session=dict(cacher=dict(
        strategy="none", cache_interval=1)))
    spec["limits"] = dict(LIMITS)
    return spec


@pytest.mark.parametrize("planted, correct", [(None, True), ("page", False),
                                              ("init", False)])
def test_correct_follows_the_families_lm(stub, planted, correct):
    if planted:
        stub.PLANTED[planted] = 2 * LIMITS[f"{planted}_gap"]
    r = harness.run_cell(stub_spec(), 2 ** 31 + 77, 1.0, False, "cpu",
                         time.perf_counter())
    assert r["correct"] is correct, r["checks"]
    assert r["attempted"] > 0 and set(r["checks"]) == set(LIMITS)
    for name, c in r["checks"].items():
        assert (c["value"] > c["limit"]) == (name == f"{planted}_gap")


def test_the_families_op_is_counted_and_read_by_name(stub):
    r = harness.run_cell(stub_spec(), 2 ** 31 + 78, 2.0, True, "cpu",
                         time.perf_counter())
    assert r["correct"] is True, r["checks"]
    rec = stub.RUNS[-1].rec
    a, b = rec["profiled"]
    # the LM's counter, read around the profiled chunks: a launch a layer
    assert rec["launches"] == {"latent_mix": LAYERS * (b - a)}
    assert r["profile_counts"]["launches"] == rec["launches"]
    assert "mfu.ingest" in r["metrics"]
    assert "stream_attention_roofline" not in r["metrics"]
    # the CPU trace has no kernels; give the op one kernel a call
    calls = [c for i in range(a, b) for c in rec["items"][i]["ops"][
        "latent_mix"]]
    assert len(calls) == LAYERS * (b - a)
    dur = 2 * calls[0].least_s() * 1e6
    rec["profile"]["kernels"] = [("latent_mix_kernel", 0.0, dur),
                                 ("other", 0.0, 9.0)] * len(calls)
    assert _common.roofline(rec, "latent_mix") == pytest.approx(50.0)
    assert _common.roofline(rec, "stream_attention") is None
    rec["launches"]["latent_mix"] += 1
    assert _common.roofline(rec, "latent_mix") is None


LM_NAMES = ("Hq", "Hkv", "D", "block_k", "block_v", "init_k", "init_v",
            "page_offset", "stream_attention", "rlm")


def test_harness_names_no_language_model():
    """harness.py imports no LM reference and names no Qwen2 size, store
    field or op: the family's LM (stcbench/lms) knows them."""
    src = (ROOT / "stcbench" / "harness.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom):
            mods = [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        else:
            continue
        assert not [m for m in mods
                    if m.startswith("stcbench.reference.lm")], mods
    words = set(re.findall(r"\w+", src))
    assert not words & set(LM_NAMES), words & set(LM_NAMES)
