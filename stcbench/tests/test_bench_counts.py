"""The frozen counts and the window statistics."""

import json
from pathlib import Path

import pytest

from stcbench import counts

ROOT = Path(__file__).resolve().parents[2]


def cfg(name):
    return json.loads((ROOT / "stcbench" / "configs" / name).read_text())


def test_stream_attention_call_by_hand():
    # 2 tokens at positions 5, 6 after 4 init tokens, window 3
    pairs, live = counts.stream_pairs(T=2, L=5, n_init=4, n_local=3)
    # query 5 sees init 3 and video 4, 5 ... positions 3..5: init 1, video 2
    # query 6 sees 4..6: init 0, video 3; far group (7 > 3): 4 each
    assert pairs == (1 + 2 + 4) + (0 + 3 + 4)
    assert live == 7 - 4
    w = counts.stream_attention(Hq=4, Hkv=2, D=8, T=2, L=5, n_init=4,
                                n_local=3)
    assert w.bf16 == 4 * 4 * 8 * pairs
    assert w.exps == 4 * pairs
    assert w.bytes == 2 * (3 * 4 * 2 * 8 + 3 * 2 * 4 * 8 + 2 * 2 * live * 8)


def test_decode_attention_call_by_hand():
    w = counts.decode_attention(Hq=4, Hkv=2, D=8, start=10, T=3)
    pairs = 11 + 12 + 13
    assert w.bf16 == 4 * 4 * 8 * pairs and w.exps == 4 * pairs
    assert w.bytes == 2 * (2 * 4 * 3 * 8 + 2 * 2 * 13 * 8)


@pytest.mark.parametrize("cached,tflop", [(False, 1.857), (True, 1.399)])
def test_chunk_against_the_ports_count(cached, tflop):
    """A 7B 1-frame chunk as the port's FLOPs estimate counted it (27
    SigLIP layers, every cover key of the kernel's plain version)."""
    c = cfg("llava-ov-7b.json")
    v, t = dict(c["vision_config"], run_layers=27), c["text_config"]
    r = c["session"]["rekv"]
    tower = counts.siglip_frame(v, cached, 0.25)
    proj = counts.projector(1152, 3584, 729).f32
    lm = 2 * 60 * counts.lm_layer_params(t) * 28
    cover = counts.cover_keys(r["n_local"], 60, 60)
    attn = 28 * counts.stream_attention_plain_flops(28, 60, 128, cover, 14)
    total = (tower + proj + lm + attn) / 1e12
    # the port printed its counts to three decimals; the cached path's
    # frozen count reads 1.3983, 0.05% under
    assert total == pytest.approx(tflop, abs=0.0015)


def test_no_share_passes_100_at_the_bound():
    for w in (counts.stream_attention(28, 4, 128, 60, 15014, 14, 15000),
              counts.decode_attention(28, 4, 128, 3854, 24),
              counts.Work(bf16=1e12, f32=1e11, bytes=1e9, exps=1e8)):
        t = w.least_s()
        assert w.bf16 / counts.BF16_FLOPS <= t
        assert w.bytes / counts.HBM_BYTES <= t
        assert w.exps / counts.EXPS <= t
        assert w.least_s() / t * 100 == pytest.approx(100.0)
    parts = [counts.Work(bytes=1e9), counts.Work(bf16=1e12)]
    assert counts.least_s_serial(parts) == pytest.approx(
        1e9 / counts.HBM_BYTES + 1e12 / counts.BF16_FLOPS)


def test_tail_and_rate_take_every_request_over_the_window():
    xs = list(range(1, 101))
    assert counts.tail(xs, 0.95) == 95
    assert counts.tail(xs, 0.90) == 90
    # a slow tail counts however the values are grouped
    assert counts.tail([1.0] * 94 + [9.0] * 6, 0.95) == 9.0
    assert counts.tail([3.0], 0.95) == 3.0
    # frames over the whole window, not a median of per-chunk rates
    assert counts.rate(100, 8.0) == 12.5
    with pytest.raises(ValueError):
        counts.tail([], 0.5)


# Run.chunk_work of both published cells as the harness computed it before
# the families brought their language models (stcbench/lms): (cell, k,
# least_s, stream_attention calls, one call's (bf16, f32, bytes, exps)).
# Every other chunk takes the cacher's path (cache_interval 2).
CHUNKS = [
    ("ov7b-ingest", 0, 0.010740979593129672, 28,
     (38277120, 0.0, 1456128, 74760)),
    ("ov7b-ingest", 1, 0.004402876599402985, 28,
     (89886720, 0.0, 1579008, 175560)),
    ("ov7b-ingest", 100, 0.010887030263770506, 28,
     (5199237120, 0.0, 13744128, 10154760)),
    ("ov7b-ingest", 249, 0.0046575866650746265, 28,
     (12899604480, 0.0, 32053248, 25194540)),
    ("ov7b-ingest", 250, 0.011105363845489333, 28,
     (12914442240, 0.0, 32174080, 25223520)),
    ("ov7b-ingest", 300, 0.011105363845489333, 28,
     (12914442240, 0.0, 32174080, 25223520)),
    ("longva7b-ingest", 0, 0.007888645639172008, 28,
     (178569216, 0.0, 3434496, 348768)),
    ("longva7b-ingest", 1, 0.005126563861920324, 28,
     (475840512, 0.0, 3729408, 929376)),
    ("longva7b-ingest", 100, 0.008351772315774095, 28,
     (16543973376, 0.0, 19816448, 32312448)),
    ("longva7b-ingest", 249, 0.005581278019893499, 28,
     (16543973376, 0.0, 19816448, 32312448)),
    ("longva7b-ingest", 250, 0.008351772315774095, 28,
     (16543973376, 0.0, 19816448, 32312448)),
    ("longva7b-ingest", 300, 0.008351772315774095, 28,
     (16543973376, 0.0, 19816448, 32312448)),
]
# the same cells' odd (cached) chunks with the cacher off: full chunks
FULL = [("ov7b-ingest", 1, 0.01074244009983608),
        ("ov7b-ingest", 249, 0.011104943949811241),
        ("longva7b-ingest", 1, 0.00789705815780092),
        ("longva7b-ingest", 249, 0.008351772315774095)]


def chunk_run(cell, cacher=True):
    import copy
    import time

    from stcbench import harness
    spec = copy.deepcopy(harness.resolve(cell))
    if not cacher:
        spec["config"]["session"]["cacher"]["strategy"] = "none"
    return harness.Run(spec, 1, 1.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell, k, least_s, n, call", CHUNKS,
                         ids=lambda x: str(x)[:16])
def test_chunk_work_is_the_parents(cell, k, least_s, n, call):
    w = chunk_run(cell).chunk_work(k)
    assert w["least_s"] == least_s
    assert list(w["ops"]) == ["stream_attention"]
    calls = w["ops"]["stream_attention"]
    assert len(calls) == n
    for c in calls:
        assert (c.bf16, c.f32, c.bytes, c.exps) == call


@pytest.mark.parametrize("cell, k, least_s", FULL, ids=lambda x: str(x)[:16])
def test_full_chunk_work_is_the_parents(cell, k, least_s):
    assert chunk_run(cell, cacher=False).chunk_work(k)["least_s"] == least_s
