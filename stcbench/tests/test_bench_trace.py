"""The trace reader and the per-layer readers on hand-made records."""

import importlib.util
import json
from pathlib import Path

import pytest

from stcbench import counts, harness
from stcbench.lms.qwen2 import Qwen2LM

ROOT = Path(__file__).resolve().parents[2]


def reader(name):
    sp = importlib.util.spec_from_file_location(
        "r", ROOT / "stcbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def test_read_trace(tmp_path):
    ev = [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=0,
               dur=2),
          dict(ph="X", cat="kernel", name="void stc::stream_cover<128>(A)",
               ts=10, dur=10),
          dict(ph="X", cat="kernel", name="void stc::stream_attention_tc<128>"
               "(A)", ts=15, dur=20),
          dict(ph="X", cat="kernel", name="void stc::combine_kernel<1>(B)",
               ts=35, dur=5),
          dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=38,
               dur=1),
          dict(ph="X", cat="kernel", name="gemm(C)", ts=60, dur=40),
          dict(ph="i", cat="kernel", name="ignored", ts=0)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=ev)))
    t = harness.read_trace(p)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(70e-6)     # 10..40 and 60..100
    assert sorted(t["gaps"], key=lambda g: -g[1])[0] == (
        "host after cudaMemcpyAsync", pytest.approx(20e-6))
    s, n = harness.op_time(t["kernels"], ("stream_attention",
                                          "stream_cover"),
                           "stream_attention")
    assert s == pytest.approx(35e-6) and n == 1
    assert dict(t["ops"])["gemm"] == pytest.approx(40e-6)


# the ops of the Qwen2 LM both families bring
OPS = Qwen2LM(dict(text_config=dict(
    hidden_size=32, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=1, rms_norm_eps=1e-6, rope_theta=1e4, vocab_size=8),
    session=dict(rekv=dict(n_init=4, n_local=30, block_size=3, topk=1))),
    None, "cpu", "", "").ops


def rec_ingest():
    call = counts.stream_attention(4, 2, 8, 3, 50, 4, 30)
    kernels = [("stream_cover", 0.0, 1.0), ("stream_attention_tc", 1.0,
                                            call.least_s() * 2e6),
               ("combine_kernel", 5.0, 0.0)] * 4
    items = [dict(ops=dict(stream_attention=[call, call]), least_s=0.01)] * 6
    return dict(kind="ingest", units=6, profiled=(2, 4),
                lat=[0.02] * 6, items=items,
                spans=dict(preprocess=[0.001] * 6, vision=[0.004] * 6,
                           append=[0.005] * 6),
                op_kernels=OPS, launches=dict(stream_attention=4),
                profile=dict(kernels=kernels, busy_s=0.5, window_s=2.0))


def test_ingest_readers():
    rec = rec_ingest()
    assert reader("vision_ms_per_frame")(rec) == pytest.approx(4.0)
    assert reader("append_ms_per_frame")(rec) == pytest.approx(5.0)
    assert reader("preprocess_ms_per_frame")(rec) == pytest.approx(1.0)
    assert reader("idle_share.ingest")(rec) == pytest.approx(75.0)
    assert reader("mfu.ingest")(rec) == pytest.approx(50.0)
    share = reader("stream_attention_roofline")(rec)
    assert 0 < share <= 100


def test_roofline_left_out_when_the_counts_disagree():
    rec = rec_ingest()
    rec["launches"] = dict(stream_attention=5)
    assert reader("stream_attention_roofline")(rec) is None
    rec = rec_ingest()
    rec["profile"]["kernels"] = []
    assert reader("stream_attention_roofline")(rec) is None
    assert reader("idle_share.ingest")(rec) is None


def test_roofline_scales_over_a_few_dropped_records():
    rec = rec_ingest()
    rec["items"] = [dict(ops=dict(stream_attention=it["ops"][
        "stream_attention"] * 50), least_s=it["least_s"])
        for it in rec["items"]]
    calls = 2 * 2 * 50                     # two profiled chunks
    triple = rec["profile"]["kernels"][:3]
    rec["launches"] = dict(stream_attention=calls)
    rec["profile"]["kernels"] = triple * calls
    whole = reader("stream_attention_roofline")(rec)
    rec["profile"]["kernels"] = triple * (calls - 1)   # one record lost
    assert reader("stream_attention_roofline")(rec) == pytest.approx(whole)
    rec["profile"]["kernels"] = triple * (calls // 2)  # half of them lost
    assert reader("stream_attention_roofline")(rec) is None
