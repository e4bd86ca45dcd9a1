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


def _stream_operands(cfg, n_appends, T, seed):
    """The kernel operands of the next append after n_appends appends."""
    gen = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=gen)

    kv = engine.init_stream_kv(cfg, 1, HKV, D, dtype=torch.float32,
                                device="cpu")
    engine.append_stream(kv, r(1, HQ, 4, D), r(1, HKV, 4, D),
                         r(1, HKV, 4, D), cfg, is_init=True)
    for _ in range(n_appends + 1):  # the last one writes the new pages
        rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, cfg, D,
                                    1e4, kv.page_offset)
        engine.append_stream(kv, r(1, HQ, T, D), r(1, HKV, T, D),
                             r(1, HKV, T, D), cfg, is_init=False)
    q = r(1, HQ, T, D)
    scalars = rc.scalars.clone()
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
        before = sa.launches
        got = sa.stream_attention(*a, **kw)
        assert sa.launches == before + 1
        assert_agrees(got, sa.stream_attention_ref(*a, **kw))


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
        s0, d0 = sa.launches, da.launches
        sess.encode_init_prompt([1, 2, 3, 4])
        for f in range(4):
            sess.encode_video(frames[f:f + 1])
        out = sess.question_answering([5, 6], [5, 6, 7], [0],
                                      max_new_tokens=4)
        sessions[str(dev)] = sess
        L = cfg.text.num_layers
        if dev != "cpu":
            assert sa.launches - s0 == 4 * L
            assert da.launches - d0 == (2 + len(out)) * L
    torch.testing.assert_close(sessions["cuda:0"].kvs.block_k.cpu(),
                               sessions["cpu"].kvs.block_k,
                               rtol=1e-3, atol=1e-3)
