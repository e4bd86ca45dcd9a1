"""The check, end to end on the CPU at a tiny size with the kernels'
plain versions: the program agrees with the float32 reference, the
control (the reference at the nearest lower precision) does not, and
every fault planted in the timed path turns `correct` false."""

import json
import math
import time

import pytest
import torch

from stcbench import harness
from stcbench.tests import tiny

SEED = 2 ** 31 + 4242


def run(spec, control=False, seconds=1.0, trace=False):
    torch.manual_seed(0)
    return harness.run_cell(spec, SEED, seconds, trace, "cpu",
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("family", ["llava_ov", "longva"])
def test_program_agrees_and_the_line_is_well_formed(family):
    spec = tiny.spec(family)
    r = run(spec)
    line = json.loads(json.dumps(r))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for name, m in line["metrics"].items():
        # the CPU has no device memory to read
        assert (m["value"] > 0 or name == "peak_mem_gib") and \
            math.isfinite(m["value"])
    assert set(line["checks"]) == set(spec["limits"])
    assert line["checks"]["page_gap"]["value"] < 0.02
    assert line["checks"]["feature_gap"]["value"] < 1e-5


def test_trace_line_has_the_per_layer_metrics():
    spec = tiny.spec()
    r = run(spec, seconds=3.0, trace=True)
    assert r["correct"] is True
    names = set(r["metrics"])
    assert {"vision_ms_per_frame", "append_ms_per_frame",
            "preprocess_ms_per_frame", "mfu.ingest"} <= names
    assert names <= {m["name"] for m in spec["per_layer"]}
    assert "busy_s" in r["device"] and "breakdown" in r


# The cells' limits come from readings at the cells' sizes (PERF.md); at
# this size every reading is lower, so the control's test sets its limits
# from this size's readings by the same rule: above the program's dozen
# seeds, below the control's.
TINY_LIMITS = dict(feature_gap=1e-6, memory_gap=1e-5, page_gap=0.025,
                   init_gap=0.025)


@pytest.mark.parametrize("family", ["llava_ov", "longva"])
def test_control_is_not_correct(family):
    """The control in the program's place turns `correct` false through
    the same comparison, while the program's own numbers, computed in the
    same run, stay within the limits."""
    spec = tiny.spec(family)
    spec["config"]["text_config"]["num_hidden_layers"] = 8
    spec["limits"] = {k: TINY_LIMITS[k] for k in spec["limits"]}
    r = run(spec, control=True)
    assert r["correct"] is False, r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
    for k, lim in spec["limits"].items():
        assert r["readings"][k] <= lim, (k, r["readings"])


def plant(monkeypatch, fault):
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.runtime import vlm
    append = vlm.VLMSession._append_flat
    if fault == "state_unchanged":
        monkeypatch.setattr(vlm.VLMSession, "_append_flat",
                            lambda self, flat, active=None: None)
    elif fault == "half_left_out":
        def half(self, flat, active=None):
            flat = flat.clone()
            flat[:, flat.shape[1] // 2:] = 0
            return append(self, flat, active)
        monkeypatch.setattr(vlm.VLMSession, "_append_flat", half)
    elif fault == "token_altered":
        post = lo.LlavaOVVision._post

        def altered(self, *a, **k):
            flat, idx, pstate = post(self, *a, **k)
            flat = flat.clone()
            flat[:, 0] = -flat[:, 0]
            return flat, idx, pstate
        monkeypatch.setattr(lo.LlavaOVVision, "_post", altered)
    elif fault == "cached_chunk_altered":
        # a cacher fault: only the cacher path's chunks are off
        cached = lo.LlavaOVVision.cached

        def off(self, *a, **k):
            flat, vstate, pstate = cached(self, *a, **k)
            return flat * 1.01, vstate, pstate
        monkeypatch.setattr(lo.LlavaOVVision, "cached", off)
    elif fault == "memory_not_reset":
        clear = vlm.VLMSession.clear_cache

        def keep(self):
            pstate = getattr(self, "_pstate", None)
            clear(self)
            if pstate is not None:
                self._pstate = pstate
        monkeypatch.setattr(vlm.VLMSession, "clear_cache", keep)
    elif fault == "memory_stale":
        # the pruner's memory is read but never carried on
        post = lo.LlavaOVVision._post

        def stale(self, feats, pstate, sp=None):
            flat, idx, _ = post(self, feats, pstate, sp)
            return flat, idx, pstate
        monkeypatch.setattr(lo.LlavaOVVision, "_post", stale)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "token_altered", "cached_chunk_altered",
                                   "memory_not_reset", "memory_stale"])
def test_fault_is_not_correct(monkeypatch, fault):
    plant(monkeypatch, fault)
    r = run(tiny.spec())
    assert r["correct"] is False, r["checks"]


def test_longva_cacher_fault_is_not_correct(monkeypatch):
    """The MLP-skip cacher recomputing the most similar tokens, not the
    least: choices far from any near-tie, which the reference does not
    follow."""
    from stc_tpu_torch.models import clip
    rows = clip.recompute_rows
    monkeypatch.setattr(clip, "recompute_rows",
                        lambda sim, n_comp: rows(-sim, n_comp))
    r = run(tiny.spec("longva"))
    assert r["correct"] is False, r["checks"]
    c = r["checks"]["feature_gap"]
    assert c["value"] > c["limit"], c


@pytest.mark.parametrize("gap, takes_given", [(2.0 ** -20, True),
                                              (1e-3, False)])
def test_near_tie_follows_the_program_only_within_tie(gap, takes_given):
    from stcbench.reference import vision as rv
    x = torch.tensor([[0.9, 0.5, 0.5 + gap, 0.1]])
    given = torch.tensor([[0, 1]])
    tower = rv.Tower.__new__(rv.Tower)
    tower.followed = 0
    assert rv.follow(x, 2).tolist() == [[0, 2]]
    pick = tower.cut(x, 2, given)
    assert pick.tolist() == ([[0, 1]] if takes_given else [[0, 2]])
    assert tower.followed == int(takes_given)
