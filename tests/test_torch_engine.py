"""stc_tpu_torch.kvcache.engine against stc_tpu.kvcache.engine on the CPU:
streaming appends step by step across the init-fill trigger, block
retrieval, and the QA decode cache (write + attend, with and without the
complement-window init stage)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig
from stc_tpu.kvcache import engine as je
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.kvcache.state import DecodeKV
from test_torch_common import F32_TOL, port_cfg, tt

HQ, HKV, D = 4, 2, 32
BASE = dict(n_init=4, n_local=64, block_size=8, exc_block_size=8, topk=4,
            chunk_size=1, max_blocks=64, max_prompt_tokens=16,
            max_new_tokens=8)


def _stream_both(cfg, T, n_appends, seed):
    """Drive both engines with the same inputs; yields after each append
    (jax state, port state, jax out, port out, step)."""
    rng = np.random.default_rng(seed)
    pc = port_cfg(cfg)
    jkv = je.init_stream_kv(cfg, 1, HKV, D, dtype=jnp.float32)
    tkv = te.init_stream_kv(pc, 1, HKV, D, dtype=torch.float32,
                            device="cpu")
    for step in range(n_appends + 1):
        n = cfg.n_init if step == 0 else T
        q = rng.normal(size=(1, HQ, n, D)).astype(np.float32)
        k = rng.normal(size=(1, HKV, n, D)).astype(np.float32)
        v = rng.normal(size=(1, HKV, n, D)).astype(np.float32)
        oj, jkv = je.append_stream(jkv, jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), cfg, is_init=step == 0)
        ot, tkv = te.append_stream(tkv, tt(q), tt(k), tt(v), pc,
                                   is_init=step == 0)
        yield jkv, tkv, np.asarray(oj), ot.numpy(), step


def _assert_state_equal(jkv, tkv):
    for name in ("num_blocks", "length", "page_offset"):
        np.testing.assert_array_equal(getattr(tkv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)
    for name in ("init_k", "init_v", "block_k", "block_v", "block_rep"):
        np.testing.assert_allclose(getattr(tkv, name).numpy(),
                                   np.asarray(getattr(jkv, name)),
                                   err_msg=name, **F32_TOL)


@pytest.mark.parametrize("exc,T,n", [(8, 8, 14), (32, 32, 4)])
def test_append_stream_matches_jax_step_by_step(exc, T, n):
    """Counters exact and pages close after every append; crosses the
    init-fill trigger (L + T > n_local) in both configurations."""
    cfg = ReKVConfig(**dict(BASE, exc_block_size=exc))
    crossed = False
    for jkv, tkv, oj, ot, step in _stream_both(cfg, T, n, seed=exc):
        np.testing.assert_allclose(ot, oj, err_msg=str(step), **F32_TOL)
        _assert_state_equal(jkv, tkv)
        crossed |= int(tkv.length[0]) > cfg.n_local
    assert crossed


def _streamed(cfg, T, n, seed):
    for jkv, tkv, *_ in _stream_both(cfg, T, n, seed):
        pass
    return jkv, tkv


@pytest.mark.parametrize("n_blocks,chunk", [(2, 1), (9, 1), (12, 2)])
def test_retrieve_blocks_indices_equal(n_blocks, chunk):
    """Retrieved indices exactly equal on the valid selections (fewer blocks
    than topk, more, and chunk-grouped scoring); gathered KV close."""
    cfg = ReKVConfig(**dict(BASE, chunk_size=chunk))
    jkv, tkv = _streamed(cfg, 8, n_blocks, seed=n_blocks)
    pc = port_cfg(cfg)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(1, HQ, 6, D)).astype(np.float32)
    q_valid = np.arange(6)[None, :] < 5
    ja, je_ = je.score_blocks(jkv, jnp.asarray(q), cfg, jnp.asarray(q_valid))
    ta, te_ = te.score_blocks(tkv, tt(q), pc, torch.from_numpy(q_valid))
    ja, je_ = np.asarray(ja), np.asarray(je_)
    np.testing.assert_array_equal(te_.numpy(), je_)
    np.testing.assert_array_equal(ta.numpy()[je_], ja[je_])
    want = je.retrieve_blocks(jkv, jnp.asarray(q), cfg, jnp.asarray(q_valid))
    got = te.retrieve_blocks(tkv, tt(q), pc, torch.from_numpy(q_valid))
    valid_len = int(np.asarray(want[3])[0])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[:, :, :valid_len],
                                   np.asarray(w)[:, :, :valid_len],
                                   **F32_TOL)


@pytest.mark.parametrize("n_local", [64, 200])
def test_decode_write_and_attend_match_jax(n_local):
    """Install a retrieved prefix, write a prompt, attend, decode a token.
    n_local=64 < decode_cap runs the complement-window init stage (plain
    version, CPU only); 200 runs decode_attention."""
    cfg = ReKVConfig(**dict(BASE, n_local=n_local))
    pc = port_cfg(cfg)
    assert (cfg.decode_cap > n_local) == (n_local == 64)
    jkv, tkv = _streamed(cfg, 8, 6, seed=3)
    rng = np.random.default_rng(11)
    q = rng.normal(size=(1, HQ, 5, D)).astype(np.float32)
    ret_j = je.retrieve_blocks(jkv, jnp.asarray(q), cfg)
    ret_t = te.retrieve_blocks(tkv, tt(q), pc)
    raw = cfg.n_init if cfg.decode_cap > cfg.n_local else 0
    jd = je.init_decode_kv(cfg, 1, HKV, D, dtype=jnp.float32)
    td = te.init_decode_kv(pc, 1, HKV, D, dtype=torch.float32,
                           device="cpu")
    jd = je.decode_write(jd, ret_j[0], ret_j[1], ret_j[3], at_start=True,
                         raw_rows=raw)
    td = te.decode_write(td, ret_t[0], ret_t[1], ret_t[3], at_start=True,
                         raw_rows=raw)
    for T in (7, 1):  # a prompt, then one token
        qq = rng.normal(size=(1, HQ, T, D)).astype(np.float32)
        kk = rng.normal(size=(1, HKV, T, D)).astype(np.float32)
        vv = rng.normal(size=(1, HKV, T, D)).astype(np.float32)
        start = int(np.asarray(jd.cursor)[0])
        jd = je.decode_write(jd, jnp.asarray(kk), jnp.asarray(vv), T)
        td = te.decode_write(td, tt(kk), tt(vv), T)
        np.testing.assert_array_equal(td.cursor.numpy(),
                                      np.asarray(jd.cursor))
        cur = int(np.asarray(jd.cursor)[0])
        np.testing.assert_allclose(td.k.numpy()[:, :, :cur],
                                   np.asarray(jd.k)[:, :, :cur], **F32_TOL)
        slots = start + np.arange(T, dtype=np.int32)[None, :]
        oj = je.decode_attend(jnp.asarray(qq), jnp.asarray(slots), jd, cfg)
        ot = te.decode_attend(tt(qq), torch.from_numpy(slots), td, pc)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)


def test_init_stream_kv_checks_the_window_fits():
    with pytest.raises(ValueError, match="cover the local window"):
        te.init_stream_kv(port_cfg(ReKVConfig(**dict(BASE, max_blocks=8))),
                          1, HKV, D, device="cpu")
    dkv = te.init_decode_kv(port_cfg(ReKVConfig(**BASE)), 2, HKV, D,
                            device="cpu", layers=3)
    assert isinstance(dkv, DecodeKV)
    assert tuple(dkv.k.shape) == (3, 2, HKV, 128, D)
