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
