"""Quantized page stores (ReKVConfig.kv_quant 'int8' and 'int4') in the
port against stc_tpu on the CPU: the quantizers and the int4 packing
exactly equal, streaming appends step by step across the init-fill trigger
(pages, scales and counters exactly equal, outputs close), retrieval from
a quantized store, the pixel session's answers and retrieved blocks, and
the complement-window decode stage that no kernel computes."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig
from stc_tpu.kvcache import engine as je
from stc_tpu.models import llava_onevision as jlo
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.ops import decode_attention as tda
from stc_tpu_torch.ops import stream_attention as tsa
from test_llava_ov import make
from test_torch_common import F32_TOL, port_cfg, tt
from test_torch_engine import BASE, D, HKV, HQ, _stream_both
from test_torch_session import _jax_layer_indices, _port_session

QUANTS = ["int8", "int4"]


def _pages(seed, shape=(2, 3, 4, 8, 16)):
    """Floats with magnitudes that differ by page and dim, an all-zero page
    (the 1e-8 scale floor) and exact halves of the int8 grid."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, size=shape[:3]
                                                     + (1, shape[4]))
    x[0, 0, 1] = 0.0
    # a page whose int8 scale is exactly 1: row 1 lies on the halves
    x[1, 2, 3] = rng.uniform(-100, 100, size=shape[3:])
    x[1, 2, 3, 0, :] = 127.0
    x[1, 2, 3, 1, :] = np.arange(shape[4]) - shape[4] / 2 + 0.5
    return x.astype(np.float32)


@pytest.mark.parametrize("quant", QUANTS)
def test_quantizers_exactly_equal_jax(quant):
    x = _pages(0)
    jfn, tfn = {"int8": (je._quantize_page, te._quantize_page),
                "int4": (je._quantize_page_int4,
                         te._quantize_page_int4)}[quant]
    jq, js = jfn(jnp.asarray(x))
    tq, ts = tfn(torch.from_numpy(x))
    assert tq.dtype == (torch.int8 if quant == "int8" else torch.uint8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt in (jnp.float32, jnp.bfloat16):
        want = je._dequant_pages(jq, js, dt)
        got = te._dequant_pages(tq, ts, getattr(torch, jnp.dtype(dt).name))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_int4_pack_and_unpack_exactly_equal_jax():
    """Every nibble value in both planes, against the JAX packing."""
    vals = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(vals, vals), -1).reshape(-1, 2)
    q = np.concatenate([q[:, :1].repeat(4, 1), q[:, 1:].repeat(4, 1)], 1)
    jp = je._pack_int4(jnp.asarray(q))
    tp = te._pack_int4(torch.from_numpy(q))
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == (256, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(te._unpack_int4(tp).numpy(),
                                  np.asarray(je._unpack_int4(jp)))
    np.testing.assert_array_equal(te._unpack_int4(tp).numpy(), q)


def _assert_quant_state_equal(jkv, tkv):
    for name in ("num_blocks", "length", "page_offset", "block_k",
                 "block_v", "block_k_scale", "block_v_scale"):
        np.testing.assert_array_equal(getattr(tkv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)
    for name in ("init_k", "init_v", "block_rep"):
        np.testing.assert_allclose(getattr(tkv, name).numpy(),
                                   np.asarray(getattr(jkv, name)),
                                   err_msg=name, **F32_TOL)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("exc,T,n", [(8, 8, 14), (32, 32, 4)])
def test_quantized_append_stream_matches_jax_step_by_step(quant, exc, T, n):
    """Pages, scales and counters exactly equal after every append, outputs
    within F32_TOL; crosses the init-fill trigger (L + T > n_local)."""
    cfg = ReKVConfig(**dict(BASE, exc_block_size=exc, kv_quant=quant))
    crossed = False
    for jkv, tkv, oj, ot, step in _stream_both(cfg, T, n, seed=exc + 1):
        np.testing.assert_allclose(ot, oj, err_msg=str(step), **F32_TOL)
        _assert_quant_state_equal(jkv, tkv)
        crossed |= int(tkv.length[0]) > cfg.n_local
    assert crossed
    Dp = D // 2 if quant == "int4" else D
    assert tuple(tkv.block_k.shape) == (1, HKV, cfg.max_blocks, 8, Dp)
    assert tuple(tkv.block_k_scale.shape) == (1, HKV, cfg.max_blocks, D)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("n_blocks,chunk", [(2, 1), (9, 1), (12, 2)])
def test_quantized_retrieval_indices_equal(quant, n_blocks, chunk):
    """Retrieved indices exactly equal (scoring reads the exact rep keys);
    the dequantized retrieved buffers close; init tokens exact."""
    cfg = ReKVConfig(**dict(BASE, chunk_size=chunk, kv_quant=quant))
    for jkv, tkv, *_ in _stream_both(cfg, 8, n_blocks, seed=n_blocks):
        pass
    pc = port_cfg(cfg)
    q = np.random.default_rng(8).normal(size=(1, HQ, 6, D)).astype(
        np.float32)
    want = je.retrieve_blocks(jkv, jnp.asarray(q), cfg)
    got = te.retrieve_blocks(tkv, tt(q), pc)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    ja, je_ = (np.asarray(x) for x in je.score_blocks(jkv, jnp.asarray(q),
                                                      cfg))
    ta, te_ = te.score_blocks(tkv, tt(q), pc)
    np.testing.assert_array_equal(te_.numpy(), je_)
    np.testing.assert_array_equal(ta.numpy()[je_], ja[je_])
    n = int(np.asarray(want[3])[0])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy()[:, :, :n],
                                   np.asarray(w)[:, :, :n], **F32_TOL)


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_pixel_session_matches_jax(quant):
    """The pixel session on an int8 / int4 page store: answer ids, every
    layer's retrieved blocks, the page counters and the quantized pages
    exactly equal to stc_tpu's session."""
    jsess0, cfg = make(seed=0)
    scfg = dataclasses.replace(jsess0.scfg, rekv=dataclasses.replace(
        jsess0.scfg.rekv, kv_quant=quant))
    jsess = jlo.build_session(jlo.init_random_params(cfg, jax.random.key(0)),
                              cfg, scfg, state_dtype=jnp.float32)
    tsess = _port_session(jsess, cfg, seed=0)
    assert tsess.kvs.block_k.dtype == (torch.int8 if quant == "int8"
                                       else torch.uint8)
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 255, size=(56, 56, 3))
    frames = np.clip(base[None] + rng.normal(0, 40, size=(10, 56, 56, 3)),
                     0, 255).astype(np.uint8)
    for s in (jsess, tsess):
        s.encode_init_prompt([1, 2, 3, 4])
    qas = [([7, 8, 9], [7, 8, 9, 10]), ([5, 6], [5, 6, 7])]
    for (lo, hi), (question, prompt) in zip([(0, 6), (6, 10)], qas):
        for f in range(lo, hi):
            jsess.encode_video(frames[f:f + 1])
            tsess.encode_video(frames[f:f + 1])
        for name in ("num_blocks", "block_k", "block_v"):
            np.testing.assert_array_equal(
                getattr(tsess.kvs, name).numpy(),
                np.asarray(getattr(jsess.kvs, name)), name)
        want_idx = _jax_layer_indices(jsess, question)
        want = jsess.question_answering(question, prompt, stop_token_ids=[0],
                                        max_new_tokens=6)
        got = tsess.question_answering(question, prompt, stop_token_ids=[0],
                                       max_new_tokens=6)
        assert got == want
        assert tsess.last_retrieved_indices == want_idx


def test_decode_attend_past_the_window_launches_no_kernel():
    """decode_cap > n_local: the complement-window init stage runs the
    plain multi-stage attention (as in the JAX engine, on every backend)
    and matches it; neither decode kernel is launched."""
    cfg = ReKVConfig(**dict(BASE, n_local=64, kv_quant="int8"))
    pc = port_cfg(cfg)
    assert cfg.decode_cap > cfg.n_local
    for jkv, tkv, *_ in _stream_both(cfg, 8, 6, seed=3):
        pass
    rng = np.random.default_rng(12)
    q = rng.normal(size=(1, HQ, 5, D)).astype(np.float32)
    ret_j = je.retrieve_blocks(jkv, jnp.asarray(q), cfg)
    ret_t = te.retrieve_blocks(tkv, tt(q), pc)
    jd = je.decode_write(je.init_decode_kv(cfg, 1, HKV, D, jnp.float32),
                         ret_j[0], ret_j[1], ret_j[3], at_start=True,
                         raw_rows=cfg.n_init)
    td = te.decode_write(te.init_decode_kv(pc, 1, HKV, D, torch.float32,
                                           device="cpu"),
                         ret_t[0], ret_t[1], ret_t[3], at_start=True,
                         raw_rows=cfg.n_init)
    kk, vv = (rng.normal(size=(1, HKV, 9, D)).astype(np.float32)
              for _ in range(2))
    start = int(np.asarray(jd.cursor)[0])
    jd = je.decode_write(jd, jnp.asarray(kk), jnp.asarray(vv), 9)
    td = te.decode_write(td, tt(kk), tt(vv), 9)
    slots = start + np.arange(9, dtype=np.int32)[None, :]
    qq = rng.normal(size=(1, HQ, 9, D)).astype(np.float32)
    before = (tda.launches, tda.score_launches, dict(tsa.launches))
    ot = te.decode_attend(tt(qq), torch.from_numpy(slots), td, pc)
    assert (tda.launches, tda.score_launches, tsa.launches) == before
    oj = je.decode_attend(jnp.asarray(qq), jnp.asarray(slots), jd, cfg)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)
