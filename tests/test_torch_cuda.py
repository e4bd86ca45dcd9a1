"""The port's CUDA kernels on the card (marked `cuda`; they skip without a
card).  Nothing here imports JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

The inputs come from the port's own engine, driven on the CPU; each kernel
is held against its plain version on the same card tensors, within the
limits scaled to the reference of stc_tpu_torch/kernels/agreement.py."""

import numpy as np
import pytest
import torch

from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.kernels.agreement import disagreement
from stc_tpu_torch.kvcache import engine
from stc_tpu_torch.ops import decode_attention as da
from stc_tpu_torch.ops import stream_attention as sa

HQ, HKV, D = 4, 2, 32
BASE = dict(n_init=4, n_local=64, block_size=8, exc_block_size=8, topk=4,
            chunk_size=1, max_blocks=64, max_prompt_tokens=16,
            max_new_tokens=8)


def assert_agrees(got, want):
    d = disagreement(got, want)
    assert d["agrees"], d


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stream_operands(cfg, n_appends, T, seed, scales=None, heads=(HQ, HKV,
                                                                  D)):
    """The kernel operands of the next append after n_appends appends; with
    kv_quant, `scales` (a dict) receives the page scales."""
    gen = torch.Generator().manual_seed(seed)
    hq, hkv, d = heads

    def r(*s):
        return torch.randn(s, generator=gen)

    kv = engine.init_stream_kv(cfg, 1, hkv, d, dtype=torch.float32,
                                device="cpu")
    n_init = cfg.n_init
    engine.append_stream(kv, r(1, hq, n_init, d), r(1, hkv, n_init, d),
                         r(1, hkv, n_init, d), cfg, is_init=True)
    for _ in range(n_appends + 1):  # the last one writes the new pages
        rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, cfg, d,
                                    1e4, kv.page_offset)
        engine.append_stream(kv, r(1, hq, T, d), r(1, hkv, T, d),
                             r(1, hkv, T, d), cfg, is_init=False)
    q = r(1, hq, T, d)
    scalars = rc.scalars.clone()
    if scales is not None:
        scales.update(k_scales=kv.block_k_scale, v_scales=kv.block_v_scale)
    return [q, q.flip(2), kv.block_k, kv.block_v, rc.cos_cover,
            rc.sin_cover, kv.init_k, kv.init_v, kv.init_k, scalars]


@pytest.mark.cuda
@pytest.mark.parametrize("exc,T,n", [(8, 8, 0), (8, 8, 3), (8, 8, 12),
                                     (32, 32, 0), (32, 32, 1), (32, 32, 2)])
def test_stream_attention_kernel_on_card(cuda_device, exc, T, n):
    cfg = ReKVConfig(**dict(BASE, exc_block_size=exc))
    ops = _stream_operands(cfg, n, T, seed=n + exc)
    kw = dict(n_local=cfg.n_local)
    for dt in (torch.float32, torch.bfloat16):
        a = [x.to(cuda_device, dt if i not in (4, 5, 9) else x.dtype)
             .contiguous() for i, x in enumerate(ops)]
        before = sa.launches["float"]
        got = sa.stream_attention(*a, **kw)
        assert sa.launches["float"] == before + 1
        assert_agrees(got, sa.stream_attention_ref(*a, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("exc,T,n", [(8, 8, 3), (8, 8, 12), (32, 32, 2)])
def test_quantized_stream_attention_kernel_on_card(cuda_device, quant, exc,
                                                   T, n):
    """Int8 and packed-int4 pages: the kernel against its plain version,
    with float32 and bfloat16 queries."""
    cfg = ReKVConfig(**dict(BASE, exc_block_size=exc, kv_quant=quant))
    scales = {}
    ops = _stream_operands(cfg, n, T, seed=n + exc, scales=scales)
    kw = dict(n_local=cfg.n_local,
              **{k: v.to(cuda_device) for k, v in scales.items()})
    for dt in (torch.float32, torch.bfloat16):
        a = [x.to(cuda_device, dt if i not in (2, 3, 4, 5, 9) else x.dtype)
             .contiguous() for i, x in enumerate(ops)]
        before = sa.launches[quant]
        got = sa.stream_attention(*a, **kw)
        assert sa.launches[quant] == before + 1
        assert_agrees(got, sa.stream_attention_ref(*a, **kw))


# the head layouts of the tensor-core tile: tiny, llava-ov-0.5b, llava-ov-7b
TC_HEADS = [(4, 2, 32), (14, 2, 64), (28, 4, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("S,T,n", [(8, 8, 0), (8, 8, 12), (12, 60, 2)])
@pytest.mark.parametrize("heads", TC_HEADS)
def test_bf16_stream_attention_tensor_core_tile_on_card(cuda_device, quant,
                                                        S, T, n, heads):
    """bf16 queries (the tensor-core tile) on the three page kinds at the
    heads of both models: G = 7 folds T = 8 or 60 tokens into 56 or 420
    rows (not multiples of 16); n = 0 is an empty window (the new pages
    only), n = 12 and the 60-token case run with init_active on."""
    cfg = ReKVConfig(**dict(BASE, block_size=S, exc_block_size=T,
                            kv_quant=quant))
    scales = {}
    ops = _stream_operands(cfg, n, T, seed=100 * n + T + heads[2],
                           scales=scales if quant != "none" else None,
                           heads=heads)
    init_active = int(ops[9][0, 3])
    assert init_active == (cfg.n_init + (n + 1) * T > cfg.n_local)
    kw = dict(n_local=cfg.n_local,
              **{k: v.to(cuda_device) for k, v in scales.items()})
    keep = (2, 3, 4, 5, 9) if quant != "none" else (4, 5, 9)
    a = [x.to(cuda_device, torch.bfloat16 if i not in keep else x.dtype)
         .contiguous() for i, x in enumerate(ops)]
    kind = "float" if quant == "none" else quant
    before = sa.launches[kind]
    got = sa.stream_attention(*a, **kw)
    assert sa.launches[kind] == before + 1
    want = sa.stream_attention_ref(*a, **kw)
    assert torch.isfinite(got.float()).all()
    assert_agrees(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 8, 60])
@pytest.mark.parametrize("heads", TC_HEADS)
def test_bf16_decode_attention_tensor_core_tile_on_card(cuda_device, T,
                                                        heads):
    """bf16 queries with return_m at both models' heads, G * T = 7, 56, 420
    folded rows; batch row 1 sees no key at all (start past the cursor and
    the window), so its output is 0 and its row maxima -inf."""
    hq, hkv, d = heads
    C, n_local = 640, 200
    gen = torch.Generator(device=cuda_device).manual_seed(T + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device)
               .to(torch.bfloat16)
               for s in ((2, hq, T, d), (2, hkv, C, d), (2, hkv, C, d)))
    cursor = torch.tensor([600, 100], dtype=torch.int32, device=cuda_device)
    start = torch.tensor([600 - T, 400], dtype=torch.int32,
                         device=cuda_device)
    before = da.launches
    got, m = da.decode_attention(q, k, v, start, cursor, n_local=n_local,
                                 return_m=True)
    assert da.launches == before + 1
    want, m_ref = da.decode_attention_ref(q, k, v, start, cursor,
                                          n_local=n_local, return_m=True)
    assert_agrees(got, want)
    fin = torch.isfinite(m_ref)
    assert torch.equal(torch.isfinite(m), fin)
    assert not fin[1].any() and fin[0].all()
    assert_agrees(m[fin], m_ref[fin])
    assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,n_local,cursors", [
    (1, 128, 96, [40, 128]), (8, 256, 200, [30, 250]),
    (24, 640, 512, [100, 640])])
def test_decode_score_kernel_on_card(cuda_device, T, C, n_local, cursors):
    gen = torch.Generator(device=cuda_device).manual_seed(C + 1)
    for cur in cursors:
        q, k = (torch.randn(s, generator=gen, device=cuda_device)
                for s in ((2, 4, T, 16), (2, 2, C, 16)))
        cursor = torch.tensor([cur, max(1, cur - 13)], dtype=torch.int32,
                              device=cuda_device)
        start = (cursor - T).clamp(min=0).to(torch.int32)
        _, m = da.decode_attention(q, k, k, start, cursor, n_local=n_local,
                                   return_m=True)
        before = (da.launches, da.score_launches)
        got = da.decode_score(q, k, m, start, cursor, n_local=n_local)
        assert (da.launches, da.score_launches) == (before[0],
                                                    before[1] + 1)
        assert_agrees(got, da.decode_score_ref(q, k, m, start, cursor,
                                               n_local=n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,n_local,start0,cursor0", [
    (45, 300, 70, 230, 263), (13, 640, 200, 600, 613),
    (256, 1100, 15000, 800, 1056), (256, 1000, 64, 900, 1000)])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_bf16_decode_score_tensor_core_tile_on_card(cuda_device, T, C,
                                                    n_local, start0,
                                                    cursor0, D):
    """bf16 queries (the tensor-core tile), G = 7, with the row maxima of
    decode_attention: ragged T and C (not multiples of 8 and of the 128-key
    tile), a window that expires inside a key tile, a prompt over a window
    of 64 whose queries from t = 163 on see no key (m = -inf), and batch
    row 1 that sees no key at all (exact zeros)."""
    hq, hkv = (14, 2) if D == 128 else (7, 1)
    gen = torch.Generator(device=cuda_device).manual_seed(T + C + D)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device)
               .to(torch.bfloat16)
               for s in ((2, hq, T, D), (2, hkv, C, D), (2, hkv, C, D)))
    cursor = torch.tensor([cursor0, 100], dtype=torch.int32,
                          device=cuda_device)
    start = torch.tensor([start0, 99 + n_local], dtype=torch.int32,
                         device=cuda_device)
    _, m = da.decode_attention(q, k, v, start, cursor, n_local=n_local,
                               return_m=True)
    assert (~torch.isfinite(m[0])).any() == (start0 + T - n_local >= cursor0)
    assert not torch.isfinite(m[1]).any()
    before = (da.launches, da.score_launches)
    got = da.decode_score(q, k, m, start, cursor, n_local=n_local)
    assert (da.launches, da.score_launches) == (before[0], before[1] + 1)
    assert torch.isfinite(got).all()
    assert_agrees(got, da.decode_score_ref(q, k, m, start, cursor,
                                           n_local=n_local))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert not got[0, :, cursor0:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,n_local,cursors", [
    (1, 128, 96, [40, 128]), (8, 256, 200, [30, 250]),
    (24, 640, 512, [100, 640])])
def test_decode_attention_kernel_on_card(cuda_device, T, C, n_local,
                                         cursors):
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    for cur in cursors:
        q, k, v = (torch.randn(s, generator=gen, device=cuda_device)
                   for s in ((2, 4, T, 16), (2, 2, C, 16), (2, 2, C, 16)))
        cursor = torch.tensor([cur, max(1, cur - 13)], dtype=torch.int32,
                              device=cuda_device)
        start = (cursor - T).clamp(min=0).to(torch.int32)
        got, m = da.decode_attention(q, k, v, start, cursor, n_local=n_local,
                                     return_m=True)
        want, m_ref = da.decode_attention_ref(q, k, v, start, cursor,
                                              n_local=n_local, return_m=True)
        assert_agrees(got, want)
        fin = torch.isfinite(m_ref)
        assert torch.equal(torch.isfinite(m), fin)
        assert_agrees(m[fin], m_ref[fin])


def decode_off_the_default_stream(where: str, dev) -> None:
    """decode_attention in float32 and bf16, launched on a side
    torch.cuda.Stream (a handle past 32 bits) or under torch.profiler,
    held to its plain version."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(21)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((2, 28, 5, 128), (2, 4, 700, 128),
                             (2, 4, 700, 128)))
        cursor = torch.tensor([700, 611], dtype=torch.int32, device=dev)
        start = (cursor - 5).to(torch.int32)
        before = da.launches
        torch.cuda.synchronize()
        if where == "side_stream":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                assert side.cuda_stream == torch.cuda.current_stream(
                    dev).cuda_stream != 0
                got = da.decode_attention(q, k, v, start, cursor,
                                          n_local=512)
            side.synchronize()
        else:
            with profile(activities=[ProfilerActivity.CUDA]):
                got = da.decode_attention(q, k, v, start, cursor,
                                          n_local=512)
                torch.cuda.synchronize()
        assert da.launches == before + 1
        assert_agrees(got, da.decode_attention_ref(q, k, v, start, cursor,
                                                   n_local=512))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["side_stream", "profiler"])
def test_decode_attention_off_the_default_stream_on_card(cuda_device,
                                                         where):
    """decode_attention off the default stream agrees with its plain
    version: the binding passes the stream whole (its nine ints, then the
    stream, as csrc/decode_attention.cu declares).  The profiler's case
    runs in a process of its own: a profiler session opened this early in
    the suite's process left the later traces of kernels_run a few
    kernels short or long (test_vision_graph_equals_eager_on_card, on an
    H100)."""
    if where == "side_stream":
        decode_off_the_default_stream(where, cuda_device)
        return
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path.insert(0, {str(here)!r}); "
            "import test_torch_cuda as t; t.decode_off_the_default_stream("
            f"'profiler', {str(cuda_device)!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=here.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


@pytest.mark.cuda
def test_tiny_session_on_card_goes_through_the_kernels(cuda_device):
    """A tiny pixel session on the card: every append and every LM forward
    of the QA launches its kernel once per layer, and the streamed pages
    match the same session on the CPU."""
    from stc_tpu_torch.models import llava_onevision as lo
    cfg = lo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(token_per_frame=3))
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 56, 3),
                                               dtype=np.uint8)
    sessions = {}
    for dev in ("cpu", cuda_device):
        gen = torch.Generator().manual_seed(0)
        model = lo.LlavaOV(cfg, dtype=torch.float32,
                           device="cpu").init_random_params(gen)
        torch.backends.cuda.matmul.allow_tf32 = False
        sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                device=dev)
        s0, d0 = sa.launches["float"], da.launches
        sess.encode_init_prompt([1, 2, 3, 4])
        for f in range(4):
            sess.encode_video(frames[f:f + 1])
        out = sess.question_answering([5, 6], [5, 6, 7], [0],
                                      max_new_tokens=4)
        sessions[str(dev)] = sess
        L = cfg.text.num_layers
        if dev != "cpu":
            assert sa.launches["float"] - s0 == 4 * L
            assert da.launches - d0 == (2 + len(out)) * L
    torch.testing.assert_close(sessions["cuda:0"].kvs.block_k.cpu(),
                               sessions["cpu"].kvs.block_k,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_tiny_int8_session_on_card_goes_through_the_quantized_kernel(
        cuda_device):
    """A tiny pixel session on an int8 page store: every video append
    launches the int8 stream_attention once per layer (no other page
    kind), and the scales match the same session on the CPU."""
    from stc_tpu_torch.models import llava_onevision as lo
    cfg = lo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8,
                        kv_quant="int8"),
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(token_per_frame=3))
    frames = np.random.default_rng(1).integers(0, 256, (4, 56, 56, 3),
                                               dtype=np.uint8)
    torch.backends.cuda.matmul.allow_tf32 = False
    scales = {}
    for dev in ("cpu", cuda_device):
        gen = torch.Generator().manual_seed(0)
        model = lo.LlavaOV(cfg, dtype=torch.float32,
                           device="cpu").init_random_params(gen)
        sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                device=dev)
        assert sess.kvs.block_k.dtype == torch.int8
        before = dict(sa.launches)
        sess.encode_init_prompt([1, 2, 3, 4])
        for f in range(4):
            sess.encode_video(frames[f:f + 1])
        out = sess.question_answering([5, 6], [5, 6, 7], [0],
                                      max_new_tokens=4)
        assert 1 <= len(out) <= 4
        ran = {k: sa.launches[k] - before[k] for k in before}
        want = 0 if dev == "cpu" else 4 * cfg.text.num_layers
        assert ran == {"float": 0, "int8": want, "int4": 0}
        scales[str(dev)] = sess.kvs.block_k_scale.cpu()
    torch.testing.assert_close(scales["cuda:0"], scales["cpu"], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.cuda
def test_decode_attend_past_the_window_on_card(cuda_device):
    """decode_cap > n_local: decode_attend runs the plain two-stage
    attention on the card (no kernel computes the init stage) and matches
    the CPU."""
    cfg = ReKVConfig(**dict(BASE, n_local=64))
    assert cfg.decode_cap > cfg.n_local
    outs = {}
    for dev in ("cpu", cuda_device):
        g = torch.Generator().manual_seed(5)
        dkv = engine.init_decode_kv(cfg, 1, HKV, D, torch.float32,
                                    device=dev)
        k, v = (torch.randn((1, HKV, 90, D), generator=g).to(dev)
                for _ in range(2))
        dkv = engine.decode_write(dkv, k, v, 90, at_start=True,
                                  raw_rows=cfg.n_init)
        q = torch.randn((1, HQ, 6, D), generator=g).to(dev)
        slots = torch.arange(84, 90, dtype=torch.int32,
                             device=dev)[None]
        before = (da.launches, da.score_launches)
        outs[str(dev)] = engine.decode_attend(q, slots, dkv, cfg).cpu()
        assert (da.launches, da.score_launches) == before
    torch.testing.assert_close(outs["cuda:0"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)


def _tiny_pixel_cfg(**kw):
    return SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(token_per_frame=3), **kw)


def _tiny_answers(sess, seed):
    frames = np.random.default_rng(seed).integers(0, 256, (4, 56, 56, 3),
                                                  dtype=np.uint8)
    sess.encode_init_prompt([1, 2, 3, 4])
    for f in range(4):
        sess.encode_video(frames[f:f + 1])
    out = sess.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=6)
    return out, sess.last_retrieved_indices


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "int8_g32"])
def test_tiny_int8_weight_session_on_card_answers_as_on_cpu(cuda_device,
                                                            quant):
    """The session quantizes the LM at build on either device: the same
    int8 weights and scales, and the same answer ids and retrieved blocks
    on the card as on the CPU."""
    from stc_tpu_torch.models import llava_onevision as lo
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for dev in ("cpu", cuda_device):
        model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                           device="cpu").init_random_params(
                               torch.Generator().manual_seed(0))
        sess = lo.build_session(model, _tiny_pixel_cfg(weights_quant=quant),
                                state_dtype=torch.float32, device=dev)
        assert sess.lm.int8_group == (32 if quant == "int8_g32" else 0)
        runs[str(dev)] = (_tiny_answers(sess, 2),
                          {k: v.cpu() for k, v in
                           sess.lm.state_dict().items()})
    (ans_cpu, w_cpu), (ans_card, w_card) = runs["cpu"], runs["cuda:0"]
    assert ans_card == ans_cpu
    for k, v in w_cpu.items():
        if k.endswith(("_q", "_s", "_gs")):
            assert torch.equal(w_card[k], v), k


@pytest.mark.cuda
def test_loader_on_card_reads_a_tiny_checkpoint(cuda_device, tmp_path):
    """chip_smoke.py's writer makes a bf16 HF checkpoint of a tiny model
    with a tied head; the loader puts it on the card bit for bit, and the
    loaded session answers as the source model does on the card."""
    import importlib.util
    import pathlib
    from stc_tpu_torch.models import MODEL_REGISTRY
    from stc_tpu_torch.models import llava_onevision as lo
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.bfloat16,
                       device=cuda_device).init_random_params(
                           torch.Generator(device=cuda_device).manual_seed(1))
    cs.tie_head_and_round_vision(model)
    cs.write_hf_checkpoint(model, str(tmp_path))
    loaded, _ = MODEL_REGISTRY["llava_ov_7b"](
        str(tmp_path), scfg=_tiny_pixel_cfg(), dtype=torch.bfloat16)
    assert loaded.lm.device.type == "cuda"
    src, got = model.state_dict(), loaded.model.state_dict()
    for k in src:
        assert got[k].device.type == "cuda", k
        assert torch.equal(got[k], src[k]), k
    source = lo.build_session(model, _tiny_pixel_cfg(),
                              state_dtype=torch.bfloat16, device=cuda_device)
    assert _tiny_answers(loaded, 3) == _tiny_answers(source, 3)


def _ragged_stream_operands(cfg, heads, T, states, seed, quant=None):
    """The kernel operands of one append to B streams that sit each at its
    own (blocks before the append, page_offset): per-stream L, start_tile,
    total and init_active differ, and so do the offsets.  Random pages;
    with quant, quantized by the engine's quantizer (the scales returned
    beside)."""
    hq, hkv, d = heads
    B, S, Nb = len(states), cfg.block_size, cfg.max_blocks
    gen = torch.Generator().manual_seed(seed)
    nb = torch.tensor([s[0] for s in states], dtype=torch.int32)
    off = torch.tensor([s[1] for s in states], dtype=torch.int32)
    assert int((nb + T // S - off).max()) <= Nb  # resident pages fit
    rc = engine.make_rope_cache(cfg.n_init + nb * S, nb, T, cfg, d, 1e4, off)
    pages = [torch.randn((B, hkv, Nb, S, d), generator=gen)
             for _ in range(2)]
    kw = {}
    if quant:
        qfn = (engine._quantize_page_int4 if quant == "int4"
               else engine._quantize_page)
        (pages[0], ks), (pages[1], vs) = qfn(pages[0]), qfn(pages[1])
        kw = dict(k_scales=ks, v_scales=vs)
    q = torch.randn((B, hq, T, d), generator=gen)
    ki, vi = (torch.randn((B, hkv, cfg.n_init, d), generator=gen)
              for _ in range(2))
    return [q, q.flip(2), pages[0], pages[1], rc.cos_cover, rc.sin_cover,
            ki, vi, ki, rc.scalars], kw


# (blocks before the append, page_offset) of four streams: an empty store,
# an evicted mid-stream one, and two past the init-fill crossing
RAGGED_STATES = [(3, 0), (20, 8), (60, 24), (70, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("heads", TC_HEADS)
def test_stream_attention_at_batch4_diverged_streams_on_card(
        cuda_device, quant, heads):
    """B = 4 streams with their own scalars and page offsets (> 0 after
    evictions) in one launch, f32 and bf16 queries: the whole batch and
    each stream against the plain version on that stream alone, so a
    kernel that read stream 0's scalars for every stream fails."""
    cfg = ReKVConfig(**dict(BASE, kv_quant=quant))
    ops, kw = _ragged_stream_operands(cfg, heads, 8, RAGGED_STATES,
                                      seed=sum(heads),
                                      quant=None if quant == "none"
                                      else quant)
    sc = ops[9]
    assert len(set(sc[:, 1].tolist())) > 1 and sc[:, 4].max() > 0
    assert set(sc[:, 3].tolist()) == {0, 1}
    kw = {k: v.to(cuda_device) for k, v in kw.items()}
    keep = (4, 5, 9) if quant == "none" else (2, 3, 4, 5, 9)
    kind = "float" if quant == "none" else quant
    for dt in (torch.float32, torch.bfloat16):
        a = [x.to(cuda_device, dt if i not in keep else x.dtype)
             .contiguous() for i, x in enumerate(ops)]
        before = sa.launches[kind]
        got = sa.stream_attention(*a, n_local=cfg.n_local, **kw)
        assert sa.launches[kind] == before + 1
        assert_agrees(got, sa.stream_attention_ref(*a, n_local=cfg.n_local,
                                                   **kw))
        for b in range(len(RAGGED_STATES)):
            one = [x[b:b + 1].contiguous() for x in a]
            kw1 = {k: v[b:b + 1].contiguous() for k, v in kw.items()}
            assert_agrees(got[b:b + 1], sa.stream_attention_ref(
                *one, n_local=cfg.n_local, **kw1))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", TC_HEADS)
def test_decode_attention_at_batch4_diverged_cursors_on_card(cuda_device,
                                                             heads):
    """B = 4 decode caches with their own start and cursor (one past the
    n_local window), f32 and bf16: against the plain version, whole and
    stream by stream."""
    hq, hkv, d = heads
    T, C, n_local = 16, 512, 300
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    cursor = torch.tensor([16, 137, 402, 512], dtype=torch.int32,
                          device=cuda_device)
    start = (cursor - T).to(torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dt)
                   for s in ((4, hq, T, d), (4, hkv, C, d), (4, hkv, C, d)))
        before = da.launches
        got = da.decode_attention(q, k, v, start, cursor, n_local=n_local)
        assert da.launches == before + 1
        assert_agrees(got, da.decode_attention_ref(q, k, v, start, cursor,
                                                   n_local=n_local))
        for b in range(4):
            s = slice(b, b + 1)
            assert_agrees(got[s], da.decode_attention_ref(
                q[s], k[s], v[s], start[s], cursor[s], n_local=n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("quant,qmax", [("int8", 127.0), ("int4", 7.0)])
def test_page_quantizer_scales_correctly_rounded_on_card(cuda_device, quant,
                                                         qmax):
    """On the card the page quantizers' scales (device pages and the host
    tier's) are the correctly rounded f32 quotients max|x| / qmax, as
    numpy divides, and the quantized pages equal the CPU's: dividing by a
    Python number would multiply by its reciprocal there."""
    from stc_tpu_torch.kvcache import host_tier
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 2, 64, 8, 32))
         * rng.uniform(1e-3, 1e3, size=(2, 2, 64, 1, 32))).astype(np.float32)
    want = np.maximum(np.abs(x).max(axis=-2), np.float32(1e-8)) / \
        np.float32(qmax)
    qfn = engine._quantize_page_int4 if quant == "int4" else \
        engine._quantize_page
    hfn = host_tier.quantize_pages_int4 if quant == "int4" else \
        host_tier.quantize_pages
    xc = torch.from_numpy(x).to(cuda_device)
    pages, scales = qfn(xc)
    np.testing.assert_array_equal(scales.cpu().numpy(), want)
    assert torch.equal(pages.cpu(), qfn(torch.from_numpy(x))[0])
    kq, ks, vq, vs = hfn(xc[None], xc[None])
    np.testing.assert_array_equal(ks[0].cpu().numpy(), want)
    assert torch.equal(kq[0].cpu(), pages.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("host_quant", ["none", "int8"])
def test_evicting_session_on_card_answers_as_all_device(cuda_device,
                                                        host_quant):
    """A tiny 2-stream pixel session streamed to 2.5x its 24-page store on
    the card: its host chunks are pinned; with exact host pages its
    answers and retrieved blocks equal its all-device twin's on the card;
    the host pages equal the twin's device pages."""
    import dataclasses
    from stc_tpu_torch.models import llava_onevision as lo
    torch.backends.cuda.matmul.allow_tf32 = False
    base = _tiny_pixel_cfg()
    frames = np.random.default_rng(4).integers(0, 256, (2, 60, 56, 56, 3),
                                               dtype=np.uint8)
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(
                           torch.Generator().manual_seed(4))
    runs = []
    for mb in (24, 64):
        scfg = dataclasses.replace(base, rekv=dataclasses.replace(
            base.rekv, n_local=24, max_blocks=mb, host_kv_quant=host_quant))
        sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                device=cuda_device, batch=2)
        sess.encode_init_prompt([1, 2, 3, 4])
        sess.encode_video(frames)
        answers = [sess.question_answering(q, q + [3], [0], max_new_tokens=6,
                                           all_streams=True)
                   for q in ([5, 6], [7, 8, 9])]
        runs.append((sess, answers, sess.last_retrieved_indices))
    (small, ans, idx), (big, ans_big, idx_big) = runs
    assert small._evicted_pages == 36 and big._evicted_pages == 0
    hs = small.host_store
    assert all(c.is_pinned() for c in hs.k_chunks + hs.v_chunks
               + hs.k_scales + hs.v_scales)
    assert hs.fetch_count > 0 and len(hs.transfer_ms()) == 6
    if host_quant == "none":
        assert ans == ans_big and idx == idx_big
        E = hs.pages_per_chunk
        for c, chunk in enumerate(hs.k_chunks):
            torch.testing.assert_close(
                chunk, big.kvs.block_k[:, :, :, c * E:(c + 1) * E].cpu(),
                rtol=1e-5, atol=1e-5)
    else:
        assert all(c.dtype == torch.int8 for c in hs.k_chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", TC_HEADS)
def test_decode_attention_at_the_verify_shape_on_card(cuda_device, heads):
    """The speculative decode's verify forward: K + 1 = 5 queries at each
    of four streams' own cursors, f32 and bf16, against the plain version;
    the rows past each cursor (rejected drafts) do not reach the output:
    zeroing them leaves it bit for bit unchanged."""
    hq, hkv, d = heads
    C, n_local = 512, 300
    gen = torch.Generator(device=cuda_device).manual_seed(d + 5)
    start = torch.tensor([0, 37, 301, 507], dtype=torch.int32,
                         device=cuda_device)
    cursor = (start + 5).to(torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dt)
                   for s in ((4, hq, 5, d), (4, hkv, C, d), (4, hkv, C, d)))
        before = da.launches
        got = da.decode_attention(q, k, v, start, cursor, n_local=n_local)
        assert da.launches == before + 1
        assert_agrees(got, da.decode_attention_ref(q, k, v, start, cursor,
                                                   n_local=n_local))
        past = torch.arange(C, device=cuda_device)[None] >= cursor[:, None]
        k0, v0 = (x.masked_fill(past[:, None, :, None], 0) for x in (k, v))
        assert torch.equal(got, da.decode_attention(q, k0, v0, start, cursor,
                                                    n_local=n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tie_rule_on_card(cuda_device, dtype):
    """topk_lowest, top2_lowest and argmax_lowest on card tensors give the
    CPU's indices (lax.top_k's tie order) on tie-heavy rows and on a
    151936-word logit row with a planted three-way tie."""
    from stc_tpu_torch.ops.topk import argmax_lowest, top2_lowest, \
        topk_lowest
    vals = torch.tensor([-float("inf"), -1.0, -0.0, 0.0, 0.5, 1.0,
                         float("inf")])
    gen = torch.Generator().manual_seed(0)
    x = vals[torch.randint(0, 7, (64, 37), generator=gen)].to(dtype)
    row = torch.randn((2, 151936), generator=gen).to(dtype)
    row[:, [7, 4000, 151000]] = row.max() + 1
    for t in (x, row):
        c = t.to(cuda_device)
        for k in (1, 2, 5):
            assert torch.equal(topk_lowest(c, k)[1].cpu(),
                               topk_lowest(t, k)[1])
        assert torch.equal(top2_lowest(c).cpu(), top2_lowest(t))
        assert torch.equal(argmax_lowest(c).cpu(), argmax_lowest(t))
    assert top2_lowest(row.to(cuda_device))[0].tolist() == [7, 4000]


@pytest.mark.cuda
def test_spec_decode_equals_greedy_on_card(cuda_device):
    """A small bf16 model (Qwen2 tiny widths, 4096-word vocab) on the card,
    two streams: the speculative session (K = 4, a 32-token history)
    answers every question as the greedy one, or parts from it only at a
    near-tie (chip_smoke.spec_departure: greedy's top-2 gap within twice
    the T = 1 / T = 5 logit difference)."""
    import dataclasses
    import sys
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.runtime.session import StreamingSession
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    import chip_smoke
    lm = qw.Qwen2(qw.Qwen2Config.tiny(vocab=4096), dtype=torch.bfloat16,
                  device=cuda_device).init_random_params(
                      torch.Generator(device=cuda_device).manual_seed(3))
    rc = ReKVConfig(**dict(BASE, n_local=192, max_new_tokens=16))
    feats = torch.randn((2, 64, 64), generator=torch.Generator().manual_seed(
        3)).to(torch.bfloat16)
    sessions = []
    for r in (rc, dataclasses.replace(rc, spec_decode_draft=4,
                                      spec_history_tokens=32)):
        s = StreamingSession(lm, SessionConfig(rekv=r), batch=2,
                             state_dtype=torch.bfloat16)
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video_features(feats)
        sessions.append(s)
    rounds = lm.spec_rounds
    for n in range(4):
        qs = [[5 + n, 6, 7], [9, 10 + n]]
        ps = [[5, 6, 7, 8 + n], [9 + n, 10, 11]]
        want, got = (s.question_answering_batch(qs, ps, [0],
                                                max_new_tokens=16)
                     for s in sessions)
        for b in range(2):
            if got[b] != want[b]:
                dep = chip_smoke.spec_departure(sessions[0], qs, ps, b,
                                                got[b], want[b])
                assert dep["near_tie"], dep
    assert lm.spec_rounds > rounds


def _keep_half(kv_or_nb, Nb, S, seed):
    """A page_keep mask (1, Nb, S) that keeps a random half of every page
    below nb (window compression's rows) and all of the rest."""
    g = torch.Generator().manual_seed(seed)
    keep = torch.ones((1, Nb, S), dtype=torch.bool)
    order = torch.rand((kv_or_nb, S), generator=g).argsort(-1)
    keep[0, :kv_or_nb].scatter_(1, order[:, S // 2:], False)
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("heads", TC_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_stream_attention_on_card(cuda_device, quant, heads, dtype):
    """stream_attention with page_keep (window compression) on the three
    page kinds, the FMA tile (float32) and the tensor-core tile (bf16):
    the kernel against its plain version; no mask and an all-ones mask
    give the same output bit for bit; the masked launches are counted."""
    T, n = 8, 12
    cfg = ReKVConfig(**dict(BASE, kv_quant=quant))
    scales = {}
    ops = _stream_operands(cfg, n, T, seed=7 * n + heads[2],
                           scales=scales if quant != "none" else None,
                           heads=heads)
    keep_idx = (2, 3, 4, 5, 9) if quant != "none" else (4, 5, 9)
    a = [x.to(cuda_device, dtype if i not in keep_idx else x.dtype)
         .contiguous() for i, x in enumerate(ops)]
    kw = dict(n_local=cfg.n_local,
              **{k: v.to(cuda_device) for k, v in scales.items()})
    keep = _keep_half(n, cfg.max_blocks, cfg.block_size, n).to(cuda_device)
    kind = "float" if quant == "none" else quant
    before, masked = sa.launches[kind], sa.masked_launches
    got = sa.stream_attention(*a, **kw, page_keep=keep)
    assert sa.launches[kind] == before + 1
    assert sa.masked_launches == masked + 1
    want = sa.stream_attention_ref(*a, **kw, page_keep=keep)
    assert torch.isfinite(got.float()).all()
    assert_agrees(got, want)
    plain = sa.stream_attention(*a, **kw)
    ones = sa.stream_attention(*a, **kw, page_keep=torch.ones_like(keep))
    assert torch.equal(plain, ones)
    assert not disagreement(got, plain)["agrees"]


@pytest.mark.cuda
def test_failed_build_raises_and_nothing_falls_back(cuda_device,
                                                    monkeypatch):
    """A kernel library that cannot be built makes the wrapper raise on a
    CUDA tensor; the plain version is never run in its place."""
    from stc_tpu_torch.kernels import _build
    cfg = ReKVConfig(**BASE)
    ops = _stream_operands(cfg, 3, 8, seed=3)
    a = [x.to(cuda_device).contiguous() for x in ops]

    def broken(name):
        raise RuntimeError("nvcc failed: planted")

    def no_fallback(*args, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(sa, "stream_attention_ref", no_fallback)
    keep = torch.ones((1, cfg.max_blocks, cfg.block_size), dtype=torch.bool,
                      device=cuda_device)
    with pytest.raises(RuntimeError, match="planted"):
        sa.stream_attention(*a, n_local=cfg.n_local, page_keep=keep)


@pytest.mark.cuda
def test_yuv_unpack_on_card(cuda_device):
    """The packed-plane reconstruction on the card equals the numpy one
    (float32, the same operations) and the CPU's."""
    from stc_tpu_torch import native
    from stc_tpu_torch.runtime.vlm import Preprocessor
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 64, 36, 3), dtype=np.uint8)
    pre = Preprocessor(28, (0.5,) * 3, (0.5,) * 3, torch.float32,
                       ingest="yuv420")
    packed = pre.host(frames)
    np.testing.assert_array_equal(packed, native._rgb_to_yuv420_np(frames))
    h, w = 64, 36
    y = packed[:, :h * w].reshape(3, h, w).astype(np.float32)
    u = packed[:, h * w:h * w + h * w // 4].reshape(3, h // 2, w // 2)
    v = packed[:, h * w + h * w // 4:].reshape(3, h // 2, w // 2)

    def up(c):
        return c.repeat(2, 1).repeat(2, 2).astype(np.float32) - np.float32(
            128)

    uf, vf = up(u), up(v)
    want = np.clip(np.stack([y + np.float32(1.402) * vf,
                             y - np.float32(0.344136) * uf
                             - np.float32(0.714136) * vf,
                             y + np.float32(1.772) * uf], -1), 0, 255)
    x = torch.from_numpy(packed)
    got = pre._yuv_to_rgb(x.to(cuda_device)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got, pre._yuv_to_rgb(x).numpy())
    np.testing.assert_allclose(pre.device(x.to(cuda_device)).cpu().numpy(),
                               pre.device(x).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_layerwise_scorer_question_on_card(cuda_device):
    """A tiny feature session with the aks scorer, retrieved-KV compression
    and window compression on the card: every append launches the masked
    kernel once a layer, every layer of the layerwise forward one
    decode_attention, and the answer and each layer's blocks equal the
    same session's on the CPU."""
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.runtime.session import StreamingSession
    mcfg = qw.Qwen2Config.tiny()
    scfg = SessionConfig(rekv=ReKVConfig(
        n_init=6, n_local=256, block_size=8, exc_block_size=8, topk=4,
        max_blocks=64, max_prompt_tokens=64, max_new_tokens=8,
        retrieval_scorer="aks",
        retrieved_kv_compression="filter_tokens_simple",
        window_kv_compression="select_top_half"))
    feats = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 20 * 8, mcfg.hidden_size)).astype(np.float32))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for dev in ("cpu", cuda_device):
        lm = qw.Qwen2(mcfg, torch.float32, "cpu").init_random_params(
            torch.Generator().manual_seed(0)).to(dev)
        sess = StreamingSession(lm, scfg, state_dtype=torch.float32)
        m0, d0 = sa.masked_launches, da.launches
        sess.encode_init_prompt(list(range(6)))
        sess.encode_video_features(feats)
        out = sess.question_answering([3, 4, 5], [3, 4, 5, 6], [0],
                                      max_new_tokens=6)
        if dev != "cpu":
            L = mcfg.num_layers
            assert sa.masked_launches - m0 == 20 * L
            assert da.launches - d0 == (2 + len(out)) * L
        res[str(dev)] = (out, sess.last_retrieved_indices,
                         sess.kvs.page_keep.cpu())
    assert res["cuda:0"][0] == res["cpu"][0]
    assert res["cuda:0"][1] == res["cpu"][1]
    assert torch.equal(res["cuda:0"][2], res["cpu"][2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [0, 3, 9])
@pytest.mark.parametrize("S", [257, 144, 64])
def test_stream_attention_mha_clip_pages_on_card(cuda_device, S, n, dtype):
    """G = 1 (as many query heads as KV heads, Vicuna's layout) at the CLIP
    backbones' page lengths: 257 (Video-LLaVA: one page a cover tile, page
    boundaries inside every 64-key tile), 144 (LongVA, 2 a tile) and 64
    (Flash-VStream, 8 a tile); one-page appends over an empty, a partly
    filled and a full window (init_active on)."""
    cfg = ReKVConfig(**dict(BASE, n_local=4 * S, block_size=S,
                            exc_block_size=S))
    ops = _stream_operands(cfg, n, S, seed=S + n, heads=(4, 4, 64))
    assert int(ops[9][0, 3]) == (cfg.n_init + (n + 1) * S > cfg.n_local)
    kw = dict(n_local=cfg.n_local)
    a = [x.to(cuda_device, dtype if i not in (4, 5, 9) else x.dtype)
         .contiguous() for i, x in enumerate(ops)]
    before = sa.launches["float"]
    got = sa.stream_attention(*a, **kw)
    assert sa.launches["float"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert_agrees(got, sa.stream_attention_ref(*a, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 256])
def test_decode_attention_vicuna_heads_on_card(cuda_device, T, dtype):
    """decode_attention at Vicuna-7B's heads (32/32/128, G = 1) over a
    2304-slot cache: a token step and a 256-token prefill."""
    C, n_local = 2304, 8000
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((1, 32, T, 128), (1, 32, C, 128),
                         (1, 32, C, 128)))
    cursor = torch.tensor([2100], dtype=torch.int32, device=cuda_device)
    start = (cursor - T).to(torch.int32)
    before = da.launches
    got, m = da.decode_attention(q, k, v, start, cursor, n_local=n_local,
                                 return_m=True)
    assert da.launches == before + 1
    want, m_ref = da.decode_attention_ref(q, k, v, start, cursor,
                                          n_local=n_local, return_m=True)
    assert_agrees(got, want)
    assert torch.isfinite(m).all()
    assert_agrees(m, m_ref)


@pytest.mark.cuda
def test_tiny_longva_session_on_card_answers_as_on_cpu(cuda_device):
    """A tiny LongVA session (CLIP tower with the MLP-skip cacher) on the
    card: every append and LM forward launches its kernel once a layer,
    and the answers, the retrieved blocks and the cacher counters equal
    the same session's on the CPU."""
    from stc_tpu_torch.models import longva as lv
    cfg = lv.LongVAConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=4,
                        exc_block_size=4, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(strategy="none", token_per_frame=4))
    frames = np.random.default_rng(0).integers(0, 256, (6, 56, 56, 3),
                                               dtype=np.uint8)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for dev in ("cpu", cuda_device):
        model = lv.ClipVLM(cfg, dtype=torch.float32, device="cpu")
        model.init_random_params(torch.Generator().manual_seed(0))
        sess = lv.build_session(model, scfg, state_dtype=torch.float32,
                                device=dev)
        s0, d0 = sa.launches["float"], da.launches
        sess.encode_init_prompt([1, 2, 3, 4])
        for f in range(6):
            sess.encode_video(frames[f:f + 1])
        out = sess.question_answering([5, 6], [5, 6, 7], [0],
                                      max_new_tokens=4)
        if dev != "cpu":
            L = cfg.text.num_layers
            assert sa.launches["float"] - s0 == 6 * L
            assert da.launches - d0 == (2 + len(out)) * L
        res[str(dev)] = (out, sess.last_retrieved_indices,
                         sess._vstate.tokens_skipped.cpu().tolist())
    assert res["cuda:0"] == res["cpu"]


@pytest.mark.cuda
def test_timer_synchronises_on_card(cuda_device):
    """utils/metrics.Timer with device_sync waits for the card at both
    ends: a ~25-50 ms sleep kernel reads as such, while a bare host clock
    reads only its issue."""
    from stc_tpu_torch.utils import metrics
    torch.cuda.synchronize(cuda_device)
    with metrics.Timer() as bare_clock:
        torch.cuda._sleep(50_000_000)
    torch.cuda.synchronize(cuda_device)
    with metrics.Timer(metrics.device_sync(cuda_device)) as synced:
        torch.cuda._sleep(50_000_000)
    assert synced.seconds > 0.01, synced.seconds
    assert synced.seconds > 5 * bare_clock.seconds, (synced.seconds,
                                                      bare_clock.seconds)


def _flops_calls(kind, keep, dev, dtype):
    """(call on `dev` in `dtype`, formula) for each kernel case of
    tests/test_torch_metrics.py, from the same CPU operands."""
    if kind in ("none", "int8", "int4"):
        cfg = ReKVConfig(**dict(BASE, kv_quant=kind))
        scales = {} if kind != "none" else None
        ops = _stream_operands(cfg, 3, 8, seed=4, scales=scales)
        floats = (0, 1, 6, 7, 8) + ((2, 3) if kind == "none" else ())
        a = [x.to(dev, dtype if i in floats else x.dtype).contiguous()
             for i, x in enumerate(ops)]
        kw = dict(n_local=cfg.n_local,
                  **{k: v.to(dev) for k, v in (scales or {}).items()})
        if keep:
            kw["page_keep"] = _keep_half(3, cfg.max_blocks, cfg.block_size,
                                         3).to(dev)
        B, Hq, T, D = a[0].shape
        return (lambda: sa.stream_attention(*a, **kw)), \
            sa.stream_attention_flops(B, Hq, T, D, a[4].shape[1],
                                      a[6].shape[2])
    g = torch.Generator().manual_seed(2)
    B, Hq, Hkv, T, D, C = 2, 4, 2, 5, 32, 64
    q = torch.randn((B, Hq, T, D), generator=g).to(dev, dtype)
    k, v = (torch.randn((B, Hkv, C, D), generator=g).to(dev, dtype)
            for _ in range(2))
    start = torch.tensor([10, 30], dtype=torch.int32, device=dev)
    cursor = start + T
    if kind == "score":
        m = torch.randn((B, Hq, T), generator=g).to(dev)
        return (lambda: da.decode_score(q, k, m, start, cursor,
                                        n_local=16)), \
            da.decode_score_flops(B, Hq, T, D, C)
    return (lambda: da.decode_attention(q, k, v, start, cursor, n_local=16,
                                        return_m=keep)), \
        da.decode_attention_flops(B, Hq, T, D, C)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,keep", [
    ("none", False), ("int8", False), ("int4", False), ("none", True),
    ("int8", True), ("int4", True), ("decode", False), ("decode", True),
    ("score", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_flops_count_on_card_equals_cpu(cuda_device, kind, keep,
                                               dtype):
    """estimate_flops over a hand kernel on the card (the wrapper adds its
    formula; the counter cannot see a ctypes launch) equals the count over
    the plain version on the CPU for the same shapes."""
    from stc_tpu_torch.utils import metrics
    card, want = _flops_calls(kind, keep, cuda_device, dtype)
    cpu, _ = _flops_calls(kind, keep, torch.device("cpu"), torch.float32)
    assert metrics.estimate_flops(card) == want == \
        metrics.estimate_flops(cpu)


@pytest.mark.cuda
def test_frame_encoder_and_chunk_flops_on_card(cuda_device):
    """A bare session with the FrameEncoder on the card answers with the
    VLMSession's ids and blocks; estimate_chunk_flops on the card equals
    the CPU count of the same session, full and cached."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.runtime.session import StreamingSession
    cfg = lo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(token_per_frame=3))
    frames = np.random.default_rng(2).integers(0, 256, (5, 56, 56, 3),
                                               dtype=np.uint8)
    torch.backends.cuda.matmul.allow_tf32 = False
    res, flops = {}, {}
    for name, dev in (("cpu", "cpu"), ("vlm", cuda_device),
                      ("bare", cuda_device)):
        model = lo.LlavaOV(cfg, dtype=torch.float32, device="cpu")
        model.init_random_params(torch.Generator().manual_seed(0))
        if name == "bare":
            sess = StreamingSession(
                model.to(dev).text, scfg, state_dtype=torch.float32,
                frame_encoder=lo.FrameEncoder(model, scfg, device=dev))
        else:
            sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                    device=dev)
        sess.encode_init_prompt([1, 2, 3, 4])
        for f in range(5):
            sess.encode_video(frames[f:f + 1])
        res[name] = (sess.question_answering([5, 6], [5, 6, 7], [0],
                                             max_new_tokens=4),
                     sess.last_retrieved_indices)
        if name != "bare":
            flops[name] = (sess.estimate_chunk_flops(),
                           sess.estimate_chunk_flops(cached=True))
    assert res["bare"] == res["vlm"]
    assert flops["vlm"] == flops["cpu"] and flops["cpu"][0] > \
        flops["cpu"][1] > 0


# a tp 2 and a tp 4 rank's llava-ov-7b heads (28/4/128 split by kv head)
TP_HEADS = [(14, 2, 128), (7, 1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", TP_HEADS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_attention_at_tp_rank_heads_on_card(cuda_device, heads,
                                                   dtype):
    """stream_attention at a tp rank's heads (Hkv = 1 included) after 12
    appends of 60-token pages, init_active on, against its plain
    version."""
    cfg = ReKVConfig(**dict(BASE, block_size=12, exc_block_size=60))
    ops = _stream_operands(cfg, 12, 60, seed=heads[0], heads=heads)
    a = [x.to(cuda_device, dtype if i not in (4, 5, 9) else x.dtype)
         .contiguous() for i, x in enumerate(ops)]
    before = sa.launches["float"]
    got = sa.stream_attention(*a, n_local=cfg.n_local)
    assert sa.launches["float"] == before + 1
    assert_agrees(got, sa.stream_attention_ref(*a, n_local=cfg.n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 24, 36])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_attention_at_sp_query_offset_on_card(cuda_device, offset,
                                                     dtype):
    """An sp rank's queries: 24 of a 60-token append's tokens from token
    `offset` on, the offset carried in the kernel's scalars (L + offset),
    at llava-ov-7b heads, against the plain version at that offset."""
    cfg = ReKVConfig(**dict(BASE, block_size=12, exc_block_size=60))
    ops = _stream_operands(cfg, 12, 60, seed=offset, heads=(28, 4, 128))
    ops[0], ops[1] = ops[0][:, :, :24], ops[1][:, :, :24]
    ops[9] = ops[9].clone()
    ops[9][:, 0] += offset
    a = [x.to(cuda_device, dtype if i not in (4, 5, 9) else x.dtype)
         .contiguous() for i, x in enumerate(ops)]
    got = sa.stream_attention(*a, n_local=cfg.n_local)
    assert_agrees(got, sa.stream_attention_ref(*a, n_local=cfg.n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", TP_HEADS)
@pytest.mark.parametrize("T", [1, 256])
def test_decode_attention_at_tp_rank_heads_on_card(cuda_device, heads, T):
    """decode_attention at a tp rank's heads over a 2304-slot cache: a
    token step and a 256-token prefill, with the row maxima."""
    hq, hkv, d = heads
    C = 2304
    gen = torch.Generator(device=cuda_device).manual_seed(T + hq)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).bfloat16()
               for s in ((1, hq, T, d), (1, hkv, C, d), (1, hkv, C, d)))
    cursor = torch.tensor([2100], dtype=torch.int32, device=cuda_device)
    start = (cursor - T).to(torch.int32)
    got, m = da.decode_attention(q, k, v, start, cursor, n_local=8000,
                                 return_m=True)
    want, m_ref = da.decode_attention_ref(q, k, v, start, cursor,
                                          n_local=8000, return_m=True)
    assert_agrees(got, want)
    assert_agrees(m, m_ref)


def tp2_card_rank(rank, world):
    """One rank of test_tp2_session_on_card_answers_as_unsharded."""
    from stc_tpu_torch.parallel import dryrun
    from stc_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dp=1, tp=2)
    return _tiny_card_session(dryrun.tiny_model(3, mesh, device="cuda"),
                              mesh)


def _tiny_card_session(model, mesh=None):
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.parallel import dryrun
    # n_local 128 keeps the decode cache (128 slots) within the window:
    # every LM forward runs decode_attention
    sess = lo.build_session(model, dryrun.tiny_scfg(n_local=128,
                                                    max_blocks=64),
                            state_dtype=torch.float32, device="cuda",
                            batch=2, mesh=mesh)
    frames = np.random.default_rng(0).integers(0, 256, (2, 8, 56, 56, 3),
                                               dtype=np.uint8)
    before = (sa.launches["float"], da.launches)
    out = dryrun.drive(sess, frames, [([5, 6, 7], [8, 9])])
    return out, (sa.launches["float"] - before[0], da.launches - before[1])


@pytest.mark.cuda
def test_tp2_session_on_card_answers_as_unsharded(cuda_device):
    """Two gloo ranks of a tp 2 mesh on the one card (collectives staged
    through host memory): the tiny float32 LLaVA-OV session's answers and
    blocks equal the unsharded session's on the card, and every rank's
    appends and LM forwards went through the kernels."""
    import os
    from stc_tpu_torch.parallel import dryrun
    want, _ = _tiny_card_session(dryrun.tiny_model(3, device=cuda_device))
    here = os.path.dirname(os.path.abspath(__file__))
    ranks = dryrun.launch(2, "test_torch_cuda:tp2_card_rank", timeout=300,
                          env={"PYTHONPATH": os.pathsep.join(
                              [here, dryrun.ROOT])})
    for got, (n_stream, n_decode) in ranks:
        assert got == want
        assert n_stream > 0 and n_decode > 0


# the streaming append's CUDA graph (runtime/graphs.py): kv_quant
# none / int8 / int4 and window compression, at B = 1 and 2
GRAPH_CASES = [("none", False, 1), ("none", False, 2), ("int8", False, 1),
               ("int4", False, 2), ("none", True, 2), ("int8", True, 1),
               ("int4", True, 1)]


def hand_kernels_run(fn, path) -> dict:
    """{kernel name: launches} of the port's own device kernels (namespace
    stc: stream_attention's pre-pass, tile and combine) that fn runs, read
    from a torch.profiler trace (written to path) as stcbench's harness
    reads one."""
    import json
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in events if e.get("cat") == "kernel"
                   and e["name"].startswith("void stc::"))


@pytest.mark.cuda
@pytest.mark.parametrize("quant,compress,batch", GRAPH_CASES)
def test_append_graph_equals_eager_on_card(cuda_device, tmp_path, quant,
                                           compress, batch):
    """44 one-page appends of a bf16 3-layer LM through the graph and
    through pipeline.pp_encode_step, side by side: the 16-page window
    fills after 16 appends, the cover's start tile moves whenever the
    store holds 24 pages, and the store evicts 6 pages in place four
    times.  Hidden states, every
    store tensor and the stream_attention counters agree bit for bit
    after every append; the graph warmed up once, captured once and
    replayed the rest, in a pool of its own.  Then one more append of
    each, profiled: the replay runs the eager append's hand kernels, as
    many of each, and as many stream_attention tiles as the launches it
    adds to the counters."""
    from stc_tpu_torch.kvcache import host_tier
    from stc_tpu_torch.models.qwen2 import Qwen2, Qwen2Config
    from stc_tpu_torch.parallel import pipeline
    from stc_tpu_torch.runtime.graphs import Graphs
    from stc_tpu_torch.utils import metrics
    cfg = ReKVConfig(**dict(
        BASE, max_blocks=24, kv_quant=quant,
        window_kv_compression="select_top_half" if compress else "none"))
    lm = Qwen2(Qwen2Config(vocab_size=256, hidden_size=128, num_layers=3,
                           num_heads=4, num_kv_heads=2, head_dim=32,
                           intermediate_size=256, rope_base=10000.0),
               dtype=torch.bfloat16, device=cuda_device).init_random_params(
                   torch.Generator().manual_seed(7))
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    ids = torch.randint(0, 256, (batch, cfg.n_init), generator=gen,
                        device=cuda_device)
    stores = []
    for _ in range(2):
        kvs = lm.init_stream_state(cfg, batch)
        lm.encode_step(cfg, kvs, lm.embed_tokens(ids), is_init=True)
        stores.append(kvs)
    eager, graphed = stores
    graph = Graphs()
    metrics.reset_graph_counts("append")
    resident = 0

    def counters():
        return dict(sa.launches), sa.masked_launches

    for step in range(44):
        if resident + 1 > cfg.max_blocks:
            for kvs in stores:
                host_tier.evict_pages(kvs, 6, None)
            resident -= 6
        x = torch.randn((batch, cfg.block_size, 128), generator=gen,
                        device=cuda_device)
        c0 = counters()
        want = pipeline.pp_encode_step(lm, cfg, eager, x.to(lm.dtype))
        c1 = counters()
        got = graph.append(lm, cfg, graphed, x)
        c2 = counters()
        resident += 1
        assert torch.equal(got, want), step
        for a, b in zip(graphed, eager):
            assert torch.equal(a, b), step
        kind = "float" if quant == "none" else quant
        assert c1[0][kind] - c0[0][kind] == 3
        assert c2[0][kind] - c1[0][kind] == 3, step
        assert c2[1] - c1[1] == c1[1] - c0[1] == (3 if compress else 0)
    assert int(eager.page_offset.max()) == 24
    assert metrics.graph_counts("append") == dict(replays=42, captures=1,
                                                  eager={"warmup": 1})
    assert graph.pool_bytes["append"] > 0
    x = torch.randn((batch, cfg.block_size, 128), generator=gen,
                    device=cuda_device)
    want = hand_kernels_run(lambda: pipeline.pp_encode_step(
        lm, cfg, eager, x.to(lm.dtype)), tmp_path / "eager.json")
    c0 = counters()
    got = hand_kernels_run(lambda: graph.append(lm, cfg, graphed, x),
                           tmp_path / "replay.json")
    added = sum(counters()[0].values()) - sum(c0[0].values())
    assert got == want
    # stcbench's rule (harness.op_time): a combine kernel is not a launch
    assert added == 3 and sum(
        n for k, n in got.items()
        if "stream_attention" in k and "combine" not in k) == added
    assert sum(n for k, n in got.items() if "stream_cover" in k) == added
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    metrics.reset_graph_counts("append")


@pytest.mark.cuda
def test_append_graph_recaptures_after_clear_cache_on_card(cuda_device):
    """A tiny LLaVA-OV session on the card streams one video, clears its
    cache and streams a second: its store then equals a fresh session's
    after the second video alone, bit for bit; each store warmed up once
    and captured once, and an estimate_chunk_flops call ran eager."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.utils import metrics
    torch.backends.cuda.matmul.allow_tf32 = False
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(
                           torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    videos = [rng.integers(0, 256, (6, 56, 56, 3), dtype=np.uint8)
              for _ in range(2)]
    metrics.reset_graph_counts("append")
    stores = []
    for first in (videos[0], None):
        sess = lo.build_session(model, _tiny_pixel_cfg(),
                                state_dtype=torch.float32,
                                device=cuda_device)
        if first is not None:
            sess.encode_init_prompt([1, 2, 3, 4])
            sess.encode_video(first)
            sess.estimate_chunk_flops()
            sess.clear_cache()
            assert sess.graphs._held == {}
        sess.encode_init_prompt([1, 2, 3, 4])
        sess.encode_video(videos[1])
        stores.append(sess.kvs)
    for a, b in zip(*stores):
        assert torch.equal(a, b)
    assert metrics.graph_counts("append") == dict(
        replays=12, captures=3, eager={"warmup": 3, "flops": 1})
    metrics.reset_graph_counts("append")


# the vision towers' CUDA graphs (runtime/graphs.py): SigLIP and
# CLIP in float32, MoonViT in bf16, as the cells run them; three layers at
# 128 wide on 8 x 8 (MoonViT 4 x 6) patches
VISION_GRAPH_TOWERS = ("siglip", "clip", "moonvit")
# a path sequence that meets every rule: each path warms up, captures and
# replays, and the cached path warms up and captures again once the full
# path's references are the graph's (call 4)
VISION_GRAPH_PATHS = ["full", "cached", "cached"] * 4


def _graph_tower(name, dev):
    from stc_tpu_torch.models import clip as cl
    from stc_tpu_torch.models import moonvit as mv
    from stc_tpu_torch.models import siglip as sg
    widths = dict(hidden_size=128, num_layers=3, num_heads=4,
                  intermediate_size=256, patch_size=14)
    gen = torch.Generator().manual_seed(11)
    if name == "siglip":
        tower = sg.Siglip(sg.SiglipConfig(image_size=112, **widths),
                          device="cpu")
    elif name == "clip":
        tower = cl.CLIP(cl.CLIPConfig(image_size=112, **widths),
                        device="cpu")
    else:
        tower = mv.MoonViT(mv.MoonViTConfig(image_hw=(56, 84),
                                            pos_grid=(8, 8), **widths),
                           dtype=torch.bfloat16, device="cpu")
        tower.pos_embed.copy_(torch.randn(tower.pos_embed.shape,
                                          generator=gen) * 0.02)
    return tower.init_random_params(gen).to(dev)


def _tower_call(name, tower, path, px, state):
    """One call of `path`: (the tensors it hands out, the new state)."""
    if name == "clip":
        if path == "full":
            out, state = tower.encode_full(px, state)
        else:
            out, state = tower.encode_cached(px, state, 0.5)
        rows = [] if path == "full" else tower.last_rows
        return [out] + [r for r in rows if r is not None], state
    if path == "full":
        out, state = tower.encode_full(px)
        return [out], state
    out, sel = tower.encode_cached(px, state, 0.25)
    return [out, sel], state


def _tower_state(name, tower, dev):
    from stc_tpu_torch.models import clip as cl
    from stc_tpu_torch.models import siglip as sg
    if name == "clip":
        return cl.init_clip_cacher(tower.cfg, device=dev)
    return sg.init_cacher_state(tower.cfg, 1, tower.patch_w.dtype,
                                device=dev)


def kernels_run(fn, path) -> dict:
    """{kernel name: launches} of everything fn runs on the card, read
    from a torch.profiler trace (written to path), but copies: a graph may
    run a captured device-to-device copy as one of CUDA's own `memcpy*`
    kernels where the eager call used the copy engine."""
    import json
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in events if e.get("cat") == "kernel"
                   and not e["name"].startswith("memcpy"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", VISION_GRAPH_TOWERS)
def test_vision_graph_equals_eager_on_card(cuda_device, tmp_path, name):
    """Twelve calls of each tower path, full / cached / cached, through an
    owner's graphs and eagerly (no owner), side by side on the same
    pixels: the features, the selections (CLIP's last_rows), the
    references and CLIP's counters agree bit for bit after every call;
    the counts follow the rule; what a call handed out is not touched by
    the later replays.  Then one more call of each path, profiled: the
    replay runs the eager call's kernels, as many of each (copies
    aside)."""
    from stc_tpu_torch.runtime import graphs
    from stc_tpu_torch.utils import metrics
    torch.backends.cuda.matmul.allow_tf32 = False
    tower = _graph_tower(name, cuda_device)
    owner = graphs.Graphs()
    eager_state = graphed_state = _tower_state(name, tower, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    hw = getattr(tower.cfg, "image_hw", (112, 112))
    dtype = tower.patch_w.dtype
    metrics.reset_graph_counts("vision")
    handed = []
    for step, path in enumerate(VISION_GRAPH_PATHS):
        px = torch.randn((1, 3) + hw, generator=gen,
                         device=cuda_device).to(dtype)
        want, eager_state = _tower_call(name, tower, path, px, eager_state)
        with graphs.calls(owner):
            got, graphed_state = _tower_call(name, tower, path, px,
                                             graphed_state)
        handed.append([t.clone() for t in got] + got)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (step, path)
        for a, b in zip(graphed_state, eager_state):
            assert torch.equal(a, b), (step, path)
    counts = metrics.graph_counts("vision")
    assert counts == dict(replays=6, captures=3,
                          eager={"warmup": 3, "bare": 12})
    assert all(owner.pool_bytes[p] > 0 for p in ("full", "cached"))
    for snap in handed:
        n = len(snap) // 2
        for a, b in zip(snap[:n], snap[n:]):
            assert torch.equal(a, b)
    for path in ("full", "cached"):
        px = torch.randn((1, 3) + hw, generator=gen,
                         device=cuda_device).to(dtype)
        eager = kernels_run(lambda: _tower_call(
            name, tower, path, px, eager_state), tmp_path / "eager.json")

        def replay():
            with graphs.calls(owner):
                _tower_call(name, tower, path, px, graphed_state)

        assert kernels_run(replay, tmp_path / "replay.json") == eager, path
    assert metrics.graph_counts("vision")["replays"] == 8
    metrics.reset_graph_counts("vision")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("family", ["llava_ov", "longva"])
def test_vision_graph_session_on_card(cuda_device, family, batch,
                                      monkeypatch):
    """A tiny session of one or two streams streams two 12-frame videos
    with clear_cache between them, once with the tower graphs and once with
    the towers' eager body (graphs.run patched): the stores, the
    cacher state and the cached chunks' selections (kept by a hook on
    encode_cached, as the benchmark keeps them) agree bit for bit; each
    video's tower calls warm up three times, capture twice and replay the
    rest."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import longva as lv
    from stc_tpu_torch.runtime import graphs
    from stc_tpu_torch.utils import metrics
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    videos = [rng.integers(0, 256, (batch, 12, 56, 56, 3), dtype=np.uint8)
              for _ in range(2)]
    runs = []
    for eager in (False, True):
        gen = torch.Generator().manual_seed(4)
        if family == "llava_ov":
            model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                               device="cpu").init_random_params(gen)
            sess = lo.build_session(model, _tiny_pixel_cfg(),
                                    state_dtype=torch.float32,
                                    device=cuda_device, batch=batch)
        else:
            cfg = lv.LongVAConfig.tiny()
            model = lv.ClipVLM(cfg, dtype=torch.float32,
                               device="cpu").init_random_params(gen)
            sess = lv.build_session(model, SessionConfig(
                rekv=ReKVConfig(n_init=4, n_local=128, block_size=4,
                                exc_block_size=4, topk=4, max_blocks=64,
                                max_prompt_tokens=32, max_new_tokens=8),
                cacher=CacherConfig(update_token_ratio=0.5),
                pruner=PrunerConfig(strategy="none", token_per_frame=4)),
                state_dtype=torch.float32, device=cuda_device, batch=batch)
        tower, kept = sess.model.vision, []
        encode_cached = tower.encode_cached

        def hook(*a, **k):
            out = encode_cached(*a, **k)
            kept.append(list(tower.last_rows) if family == "longva"
                        else [out[1]])
            return out

        tower.encode_cached = hook
        if eager:
            monkeypatch.setattr(graphs, "run",
                                lambda path, fn, x, *a, **k: fn(x))
        metrics.reset_graph_counts("vision")
        for v in videos:
            sess.encode_init_prompt([1, 2, 3, 4])
            for f in range(12):
                sess.encode_video(v[:, f:f + 1] if batch > 1
                                  else v[0, f:f + 1])
            if v is videos[0]:
                sess.clear_cache()
                assert sess.graphs._held == {}
        if not eager:
            assert metrics.graph_counts("vision") == dict(
                replays=14, captures=4, eager={"warmup": 6})
        runs.append(([x.clone() for x in sess.kvs]
                     + [x.clone() for x in sess._vstate],
                     [t for sel in kept for t in sel if t is not None]))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert len(runs[0][1]) == len(runs[1][1]) > 0
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    ptrs = [t.data_ptr() for t in runs[0][1]]
    assert len(set(ptrs)) == len(ptrs)
    metrics.reset_graph_counts("vision")


# ---------------------------------------------------------------------------
# Kimi-VL: latent attention and the expert LM on the card
# ---------------------------------------------------------------------------

def _kimi_card_model(dev):
    import chip_smoke
    return chip_smoke.kimi_card_model(dev)


def _kimi_card_cfg():
    import chip_smoke
    return chip_smoke.kimi_card_cfg()


@pytest.mark.cuda
@pytest.mark.parametrize("n_pages", [0, 300], ids=["empty", "full"])
def test_latent_attention_agrees_with_plain_on_card(cuda_device, n_pages):
    """The latent kernel against its plain version at the kimivl-ingest
    cell's shapes (T 60, 16 heads, 576-wide rows, n_local 15000): a window
    of the append's own page, and a full one (300 pages, the init rows at
    the one angle active); one launch counted a call."""
    import chip_smoke
    from stc_tpu_torch.ops import latent_attention as la
    args, kw = chip_smoke.latent_operands(cuda_device, n_pages)
    want = la.latent_attention_ref(*args, **kw)
    n0 = la.launches
    assert_agrees(la.latent_attention(*args, **kw), want)
    assert la.launches == n0 + 1


@pytest.mark.cuda
def test_latent_attention_planted_faults_rejected_on_card(cuda_device):
    """Each planted fault (a page dropped, the far init group dropped, the
    window one page late, a RoPE over dims 0-511 of the queries) makes the
    kernel's output fail agreement.py's limits against the plain version
    of the true operands."""
    import chip_smoke
    from stc_tpu_torch.ops import latent_attention as la
    args, kw = chip_smoke.latent_operands(cuda_device, 300)
    want = la.latent_attention_ref(*args, **kw)
    for name, fargs in chip_smoke.latent_faults(args):
        d = disagreement(la.latent_attention(*fargs, **kw), want)
        assert not d["agrees"], (name, d)


@pytest.mark.cuda
def test_kimi_append_graph_equals_eager_on_card(cuda_device):
    """66 one-page appends of the Kimi LM through the graph and eagerly,
    side by side: hidden states, every store tensor, the router's choices
    and counts and the latent_attention counter agree bit for bit after
    every append; after the warm-up and the capture, the 64 appends of the
    stream are all replays (hit share 1 >= 0.99), and a replayed append
    and an eager one make no host sync."""
    from stc_tpu_torch.ops import latent_attention as la
    from stc_tpu_torch.parallel import pipeline
    from stc_tpu_torch.runtime.graphs import Graphs
    from stc_tpu_torch.utils import metrics
    lm = _kimi_card_model(cuda_device).text
    cfg = _kimi_card_cfg().rekv
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(0, 512, (1, cfg.n_init), generator=gen,
                        device=cuda_device)
    stores = []
    for _ in range(2):
        kvs = lm.init_stream_state(cfg, 1)
        lm.encode_step(cfg, kvs, lm.embed_tokens(ids), is_init=True)
        stores.append(kvs)
    eager, graphed = stores
    graph = Graphs()
    for step in range(66):
        if step == 2:
            metrics.reset_graph_counts("append")
        x = torch.randn((1, cfg.block_size, 256), generator=gen,
                        device=cuda_device)
        c0 = la.launches
        metrics.reset_moe_counts(lm)
        want = pipeline.pp_encode_step(lm, cfg, eager, x.to(lm.dtype))
        route, counts_eager = lm.route.clone(), metrics.moe_counts(lm)
        c1 = la.launches
        metrics.reset_moe_counts(lm)
        if step == 65:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = graph.append(lm, cfg, graphed, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert la.launches - c1 == c1 - c0 == 3, step
        assert torch.equal(got, want), step
        assert torch.equal(lm.route, route), step
        counts = metrics.moe_counts(lm)
        assert counts["appends"] == counts_eager["appends"] == 1, step
        for name in ("tokens", "hits"):
            assert torch.equal(counts[name], counts_eager[name]), step
        for a, b in zip(graphed, eager):
            assert torch.equal(a, b), step
    assert metrics.graph_counts("append") == dict(replays=64, captures=0,
                                                  eager={})
    assert metrics.graph_hit_share("append") >= 0.99
    # an eager routing pass makes no host sync either
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline.pp_encode_step(lm, cfg, eager, x.to(lm.dtype))
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_kimi_question_answering_raises_on_card(cuda_device):
    """A Kimi-VL session streams on the card, every append after the
    first two replayed; question_answering raises the error that names the
    open item (no latent decode kernel), and the session streams on."""
    from stc_tpu_torch.kvcache.latent import LATENT_DECODE_ON_CARD
    from stc_tpu_torch.models import kimi_vl as kv
    from stc_tpu_torch.utils import metrics
    sess = kv.build_session(_kimi_card_model(cuda_device), _kimi_card_cfg(),
                            device=cuda_device)
    frames = np.random.default_rng(0).integers(0, 256, (6, 50, 80, 3),
                                               dtype=np.uint8)
    metrics.reset_graph_counts("append")
    sess.encode_init_prompt([1, 2, 3, 4])
    sess.encode_video(frames)
    with pytest.raises(NotImplementedError) as err:
        sess.question_answering([5, 6], [7], [0], max_new_tokens=2)
    assert str(err.value) == LATENT_DECODE_ON_CARD
    sess.encode_video(frames[:2])
    assert metrics.graph_counts("append") == dict(replays=6, captures=1,
                                                  eager={"warmup": 1})
    assert int(sess.kvs.num_blocks[0, 0]) == 8
