"""Batched offline eval on the port: the five tests of
tests/test_eval_batched.py.  run_eval(stream_batch=B) over one ragged port
session must give rows equal to the port's sequential solver and to
stc_tpu's sequential rows on the same params (computed once per
module)."""

import json

import jax
import pytest

from stc_tpu.eval.runner import run_eval as jax_run_eval
from stc_tpu.models import llava_onevision as jlo
from stc_tpu_torch.eval import solvers as t_sol
from stc_tpu_torch.eval.runner import run_eval
from test_eval_batched import ANNO, loader, loader_mixed_res
from test_torch_common import one_thread  # noqa: F401
from test_torch_eval import jax_adapter, port_adapter

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The params, the JAX session config and stc_tpu's sequential rows
    with the two loaders."""
    from stc_tpu.eval.solvers import BaseVQA
    cfg = jlo.LlavaOVConfig.tiny()
    params = jlo.init_random_params(cfg, jax.random.key(21))
    d = tmp_path_factory.mktemp("jax")
    anno = d / "anno.json"
    anno.write_text(json.dumps(ANNO))
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BaseVQA, "open_max_new", 8)
        model = jax_adapter(params, cfg)
        for name, ld in (("plain", loader), ("mixed", loader_mixed_res)):
            rows[name], _ = jax_run_eval(
                "mlvu", model, str(d / name), anno_path=str(anno), rank=0,
                world=1, frame_loader=ld)
    return params, cfg, model.session.scfg, rows


def port_rows(ref, tmp_path, anno, ld, batch, name):
    params, cfg, scfg, _ = ref
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(anno))
    rows, _ = run_eval("mlvu", port_adapter(params, cfg, scfg, batch=batch),
                       str(tmp_path / name), anno_path=str(path), rank=0,
                       world=1, frame_loader=ld, stream_batch=batch)
    return rows


@pytest.mark.parametrize("ld,name", [(loader, "plain"),
                                     (loader_mixed_res, "mixed")],
                         ids=["rows_match_sequential", "mixed_resolutions"])
def test_batched_eval(ref, tmp_path, monkeypatch, ld, name):
    """Batch 3 over five videos of unequal length (with mixed, two of them
    at each of two more resolutions): rows equal to the port's sequential
    solver and to stc_tpu's, no error row."""
    monkeypatch.setattr(t_sol.BaseVQA, "open_max_new", 8)
    seq = port_rows(ref, tmp_path, ANNO, ld, 1, "seq")
    bat = port_rows(ref, tmp_path, ANNO, ld, 3, "bat")
    assert not any("error" in r for r in bat)
    assert len(bat) == sum(len(s["conversations"]) for s in ANNO)
    assert bat == seq
    assert seq == ref[3][name]


def test_batched_eval_rejects_stream_protocol(ref, tmp_path):
    params, cfg, scfg, _ = ref
    anno_path = tmp_path / "anno.json"
    anno_path.write_text(json.dumps(ANNO[:1]))
    with pytest.raises(AssertionError, match="offline-protocol"):
        run_eval("rvs_ego", port_adapter(params, cfg, scfg, batch=2),
                 str(tmp_path / "x"), anno_path=str(anno_path),
                 rank=0, world=1, frame_loader=loader, stream_batch=2)


def test_batched_eval_isolates_loader_failures(ref, tmp_path, monkeypatch):
    """One unreadable video costs one error row; the rest of its group
    still evaluates and matches stc_tpu's sequential rows."""
    monkeypatch.setattr(t_sol.BaseVQA, "open_max_new", 8)

    def flaky(path, fps):
        if path == "v1":
            raise IOError("corrupt container")
        return loader(path, fps)

    bat = port_rows(ref, tmp_path, ANNO[:3], flaky, 3, "bat")
    errs = [r for r in bat if "error" in r]
    assert len(errs) == 1 and errs[0]["video_id"] == "v1"
    assert errs[0]["error"] == "corrupt container"
    want = [r for r in ref[3]["plain"] if r["video_id"] in ("v0", "v2")]
    assert [r for r in bat if "error" not in r] == want


def test_batched_eval_guards(ref, tmp_path):
    """Capacity (unequal long videos) and batch-mismatch fail fast with
    actionable messages."""
    params, cfg, scfg, _ = ref
    model = port_adapter(params, cfg, scfg, batch=2)

    def long_loader(path, fps):
        import numpy as np
        n = {"v0": 200, "v1": 3}[path]
        rng = np.random.default_rng(0)
        return rng.integers(0, 256, size=(n, 56, 56, 3), dtype=np.uint8)

    solver = t_sol.BatchedOfflineVQA(model, 0.5, long_loader)
    with pytest.raises(RuntimeError, match="max_blocks"):
        solver.run_batch(ANNO[:2])

    anno_path = tmp_path / "anno.json"
    anno_path.write_text(json.dumps(ANNO[:2]))
    with pytest.raises(AssertionError, match="batch="):
        run_eval("mlvu", model, str(tmp_path / "x"),
                 anno_path=str(anno_path), rank=0, world=1,
                 frame_loader=loader, stream_batch=4)
