"""stc_tpu_torch.ops against stc_tpu.ops on the CPU: RoPE, the multi-stage
attention, and the plain versions of the CUDA kernels
(stream_attention_ref on float, int8 and int4 pages, decode_attention_ref,
decode_score_ref) against the Pallas kernels in interpret mode and against
the JAX engine's plain math.  The CUDA kernels themselves run only on a
card: tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig
from stc_tpu.kvcache import engine as je
from stc_tpu.ops import attention as jatt
from stc_tpu.ops import rope as jrope
from stc_tpu.ops.decode_attention import decode_attention as j_decode
from stc_tpu.ops.decode_attention import decode_score as j_score
from stc_tpu.ops.decode_attention import decode_score_jnp as j_score_jnp
from stc_tpu.ops.stream_attention import stream_attention as j_stream
from stc_tpu_torch.kernels.agreement import disagreement
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.ops import attention as tatt
from stc_tpu_torch.ops import decode_attention as tda
from stc_tpu_torch.ops import rope as trope
from stc_tpu_torch.ops import stream_attention as tsa
from test_torch_common import F32_TOL, KERNEL_TOL, port_cfg, tt

HQ, HKV, D = 4, 2, 32
BASE = dict(n_init=4, n_local=64, block_size=8, exc_block_size=8, topk=4,
            chunk_size=1, max_blocks=64, max_prompt_tokens=16,
            max_new_tokens=8)


# ---------------------------------------------------------------------------
# RoPE and multi-stage attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_shape", ["T", "BT"])
def test_apply_rope_matches_jax(pos_shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 20000, size=(5,) if pos_shape == "T" else (2, 5))
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6)
    got = trope.apply_rope(tt(x), torch.tensor(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    want1 = jrope.apply_rope_one_angle(jnp.asarray(x), 15000)
    got1 = trope.apply_rope_one_angle(tt(x), 15000)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **F32_TOL)


def test_multi_stage_attention_matches_jax():
    """Two stages with their own masks and a per-stage query, as the
    complement-window init stage uses them."""
    rng = np.random.default_rng(1)
    B, Lq, L1, L2 = 2, 6, 9, 4
    q = rng.normal(size=(B, HQ, Lq, D)).astype(np.float32)
    q2 = rng.normal(size=(B, HQ, Lq, D)).astype(np.float32)
    k1, v1 = (rng.normal(size=(B, HKV, L1, D)).astype(np.float32)
              for _ in range(2))
    k2, v2 = (rng.normal(size=(B, HKV, L2, D)).astype(np.float32)
              for _ in range(2))
    m1 = rng.random((B, 1, Lq, L1)) < 0.6
    m1[:, :, :, 0] = True
    m2 = rng.random((B, 1, Lq, L2)) < 0.5
    want = jatt.multi_stage_attention(jnp.asarray(q), [
        jatt.AttnStage(jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(m1)),
        jatt.AttnStage(jnp.asarray(k2), jnp.asarray(v2), jnp.asarray(m2),
                       q=jnp.asarray(q2))])
    got = tatt.multi_stage_attention(tt(q), [
        tatt.AttnStage(tt(k1), tt(v1), torch.tensor(m1)),
        tatt.AttnStage(tt(k2), tt(v2), torch.tensor(m2), q=tt(q2))])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    pos = np.arange(6)
    np.testing.assert_array_equal(
        tatt.sliding_window_mask(torch.tensor(pos), torch.tensor(pos), 3,
                                 complement=True).numpy(),
        np.asarray(jatt.sliding_window_mask(jnp.asarray(pos),
                                            jnp.asarray(pos), 3,
                                            complement=True)))


# ---------------------------------------------------------------------------
# stream_attention: the plain version against the Pallas kernel (interpret)
# and against the JAX engine's three-group softmax
# ---------------------------------------------------------------------------

def _jax_stream_inputs(cfg, n_appends, T, seed, vary=False):
    """Drive the JAX engine to a phase, then build the exact operands its
    Pallas kernel gets for the next append (engine.py:456-480); with
    kv_quant the operands end with the page scales.  vary: keys and values
    of append i get a gain of 4 ** (i % 3 - 1), so the pages' magnitudes
    (and scales) differ from page to page."""
    rng = np.random.default_rng(seed)

    def r(*s, gain=1.0):
        return jnp.asarray(gain * rng.normal(size=s).astype(np.float32))

    kv = je.init_stream_kv(cfg, 1, HKV, D, dtype=jnp.float32)
    _, kv = je.append_stream(kv, r(1, HQ, 4, D), r(1, HKV, 4, D),
                             r(1, HKV, 4, D), cfg, is_init=True)
    gains = [4.0 ** (i % 3 - 1) if vary else 1.0
             for i in range(n_appends + 1)]
    for g in gains[:-1]:
        _, kv = je.append_stream(kv, r(1, HQ, T, D), r(1, HKV, T, D, gain=g),
                                 r(1, HKV, T, D, gain=g), cfg, is_init=False)
    q = r(1, HQ, T, D)
    k, v = r(1, HKV, T, D, gain=gains[-1]), r(1, HKV, T, D, gain=gains[-1])
    o_jnp, kv_new = je.append_stream(kv, q, k, v, cfg, is_init=False,
                                     backend="jnp")
    rc = je.make_rope_cache(kv.length, kv.num_blocks, T, cfg, D, 10000.0,
                            page_offset=kv.page_offset)
    ops = dict(
        q_rot=je._rot(q, rc.cos_q, rc.sin_q),
        q_one=je._rot(q, rc.cos_one, rc.sin_one),
        block_k=kv_new.block_k, block_v=kv_new.block_v,
        cos_cover=rc.cos_cover, sin_cover=rc.sin_cover,
        k_init_rot=je._rot(kv.init_k, rc.cos_init[:, None],
                           rc.sin_init[:, None]),
        v_init=kv.init_v, k_init_raw=kv.init_k,
        scalars=jnp.stack([kv.length, rc.start_tile, kv_new.num_blocks,
                           rc.init_active.astype(jnp.int32),
                           kv.page_offset], axis=1).astype(jnp.int32))
    if cfg.kv_quant != "none":
        ops.update(k_scales=kv_new.block_k_scale,
                   v_scales=kv_new.block_v_scale)
    o_pl = j_stream(*ops.values(), T=T, n_local=cfg.n_local,
                    n_init=cfg.n_init, interpret=True)
    return ops, np.asarray(o_jnp), np.asarray(o_pl), kv


STREAM_PHASES = [  # (exc_block_size, T, appends before): empty store,
    (8, 8, 0), (8, 8, 3), (8, 8, 12),   # pre-trigger, post-trigger
    (32, 32, 0), (32, 32, 1), (32, 32, 2)]  # 4-page appends across it


@pytest.mark.parametrize("exc,T,n", STREAM_PHASES)
def test_stream_attention_ref_matches_pallas_and_engine(exc, T, n):
    cfg = ReKVConfig(**dict(BASE, exc_block_size=exc))
    ops, o_jnp, o_pl, kv = _jax_stream_inputs(cfg, n, T, seed=n + exc)
    args = [torch.from_numpy(np.array(a)) for a in ops.values()]
    before = dict(tsa.launches)
    got = tsa.stream_attention(*args, n_local=cfg.n_local)
    assert tsa.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), o_jnp, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), o_pl, **KERNEL_TOL)
    # the port builds the same kernel operands from the same counters
    rc = te.make_rope_cache(torch.from_numpy(np.array(kv.length)),
                            torch.from_numpy(np.array(kv.num_blocks)), T,
                            port_cfg(cfg), D, 10000.0,
                            torch.from_numpy(np.array(kv.page_offset)))
    np.testing.assert_array_equal(rc.scalars.numpy(),
                                  np.asarray(ops["scalars"]))
    np.testing.assert_allclose(rc.cos_cover.numpy(),
                               np.asarray(ops["cos_cover"]), **F32_TOL)


def _port_stream_args(ops):
    """The port's positional arguments and scale keywords of `ops`."""
    t = {k: torch.from_numpy(np.array(a)) for k, a in ops.items()}
    kw = {k: t.pop(k) for k in ("k_scales", "v_scales") if k in t}
    return list(t.values()), kw


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("exc,T,n", STREAM_PHASES)
def test_quantized_stream_attention_ref_matches_pallas_and_engine(
        quant, exc, T, n):
    """Int8 and packed-int4 pages with their scales: the plain version
    against the Pallas kernel's in-VMEM dequantization (interpret mode) and
    against the JAX engine's jnp int path."""
    cfg = ReKVConfig(**dict(BASE, exc_block_size=exc, kv_quant=quant))
    ops, o_jnp, o_pl, _ = _jax_stream_inputs(cfg, n, T, seed=n + exc)
    args, scales = _port_stream_args(ops)
    assert args[2].dtype == (torch.int8 if quant == "int8" else torch.uint8)
    before = dict(tsa.launches)
    got = tsa.stream_attention(*args, n_local=cfg.n_local, **scales)
    assert tsa.launches == before
    np.testing.assert_allclose(got.numpy(), o_jnp, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), o_pl, **KERNEL_TOL)


def test_stream_attention_wrapper_rejects_what_the_kernel_does_not_take():
    cfg = ReKVConfig(**BASE)
    ops, _, _, _ = _jax_stream_inputs(cfg, 2, 8, seed=0)
    args = [torch.from_numpy(np.array(a)) for a in ops.values()]
    kw = dict(n_local=cfg.n_local)
    half = list(args)
    half[0], half[1] = (a[:, :, :4].contiguous() for a in args[:2])
    with pytest.raises(ValueError, match="whole number"):
        tsa.stream_attention(*half, **kw)
    quant = list(args)
    quant[2], quant[3] = args[2].to(torch.int8), args[3].to(torch.int8)
    with pytest.raises(ValueError, match="scales"):  # int8 pages, no scales
        tsa.stream_attention(*quant, **kw)
    B, H, Nb, _, Dh = args[2].shape
    sc = torch.ones((B, H, Nb, Dh))
    with pytest.raises(ValueError, match="scales"):  # one of the two missing
        tsa.stream_attention(*quant, k_scales=sc, **kw)
    with pytest.raises(ValueError, match="scales"):  # wrong shape
        tsa.stream_attention(*quant, k_scales=sc, v_scales=sc[:, :, :-1],
                             **kw)
    with pytest.raises(ValueError, match="no scales"):  # float pages
        tsa.stream_attention(*args, k_scales=sc, v_scales=sc, **kw)
    packed = list(quant)
    packed[2], packed[3] = (a.to(torch.uint8) for a in quant[2:4])
    with pytest.raises(ValueError, match="last dimension"):  # not D/2 wide
        tsa.stream_attention(*packed, k_scales=sc, v_scales=sc, **kw)
    strided = list(args)
    strided[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tsa.stream_attention(*strided, **kw)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_rope_cover_tables_repeat_their_first_half(D):
    """The bf16 stream_attention kernel stages only the first D/2 columns
    of each cos/sin cover row (csrc/stream_attention.cu): the engine's
    tables must hold the same values, bit for bit, in the second half."""
    cfg = port_cfg(ReKVConfig(**BASE))
    L = torch.tensor([4 + 8 * 9, 4], dtype=torch.int32)
    nb = torch.tensor([9, 0], dtype=torch.int32)
    rc = te.make_rope_cache(L, nb, 8, cfg, D, 1e6,
                            torch.tensor([2, 0], dtype=torch.int32))
    for t in (rc.cos_cover, rc.sin_cover):
        assert t.shape[-1] == D
        assert torch.equal(t[..., :D // 2], t[..., D // 2:])


def test_split_grid_follows_the_reported_tile():
    """The wrappers' split-KV grid (kernels/_build.split_grid) at the main
    path's shapes on a 132-SM H100, from the tile the kernel reports: 128
    rows x 64 keys for bf16 (tensor cores), 64 x 64 for float32 (FMA),
    one or two blocks an SM.  The split minimises (waves) x (key tiles a
    block walks + 1)."""
    from stc_tpu_torch.kernels._build import split_grid
    sms, cover = 132, 34 * 8 * 60          # 264-page window, 8-page tiles
    # 1-frame append at llava-ov-0.5b heads: 7 * 60 rows per kv head;
    # 8 x 16 blocks are one wave of 17 units
    assert split_grid(420, 2, cover, 128, 64, sms) == (8, 16)
    assert split_grid(420, 2, cover, 64, 64, sms) == (14, 9)
    # 8-page append at llava-ov-7b heads: 7 * 480 rows, 4 kv heads; 108 x
    # 6 blocks are 5 waves of 43 + 1 units (5 splits: 5 x 53, 7: 6 x 38)
    assert split_grid(3360, 4, cover, 128, 64, sms) == (108, 6)
    # prompt prefill at 7B heads; twice the resident blocks, twice the split
    assert split_grid(1792, 4, 4352, 128, 64, sms) == (56, 7)
    assert split_grid(1792, 4, 4352, 128, 64, 2 * sms) == (56, 14)
    # token step: 7 rows of each kv head spread over the slot tiles
    assert split_grid(7, 2, 4352, 128, 64, sms) == (2, 66)
    # at most one block per key tile, at least one split
    assert split_grid(7, 1, 100, 128, 64, sms) == (1, 2)
    assert split_grid(10000, 8, cover, 128, 64, sms) == (632, 5)


# ---------------------------------------------------------------------------
# decode_attention: the plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

DECODE_CASES = [(1, 128, 96, [40, 128]), (8, 256, 200, [30, 250]),
                (24, 640, 512, [100, 640])]


def _jnp_decode_math(q, k, v, start, cursor, n_local):
    """decode_attend's jnp math (one stage, affine slots)."""
    B, _, T, _ = q.shape
    C = k.shape[2]
    q_slots = start[:, None] + jnp.arange(T)[None, :]
    dist = q_slots[:, :, None] - jnp.arange(C)[None, None, :]
    mask = ((dist >= 0) & (dist < n_local)
            & (jnp.arange(C)[None, None, :] < cursor[:, None, None]))
    return jatt.multi_stage_attention(
        q, [jatt.AttnStage(k, v, mask[:, None])])


@pytest.mark.parametrize("T,C,n_local,cursors", DECODE_CASES)
def test_decode_attention_ref_matches_pallas(T, C, n_local, cursors):
    B, Hq, Hkv, Dh = 2, 4, 2, 16
    rng = np.random.default_rng(C)
    for cur in cursors:
        cursor = np.asarray([cur, max(1, cur - 13)], np.int32)
        start = np.maximum(cursor - T, 0).astype(np.int32)
        q = rng.normal(size=(B, Hq, T, Dh)).astype(np.float32)
        k = rng.normal(size=(B, Hkv, C, Dh)).astype(np.float32)
        v = rng.normal(size=(B, Hkv, C, Dh)).astype(np.float32)
        jargs = [jnp.asarray(x) for x in (q, k, v, start, cursor)]
        o_pl, m_pl = j_decode(*jargs, n_local=n_local, interpret=True,
                              return_m=True)
        o_jnp = _jnp_decode_math(*jargs, n_local)
        before = tda.launches
        o, m = tda.decode_attention(tt(q), tt(k), tt(v),
                                    torch.from_numpy(start),
                                    torch.from_numpy(cursor),
                                    n_local=n_local, return_m=True)
        assert tda.launches == before
        np.testing.assert_allclose(o.numpy(), np.asarray(o_jnp), **F32_TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), **KERNEL_TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_pl), **KERNEL_TOL)


@pytest.mark.parametrize("T,C,n_local,cursors", DECODE_CASES)
def test_decode_score_ref_matches_pallas(T, C, n_local, cursors):
    """decode_score_ref against the Pallas _score_kernel (interpret) and
    decode_score_jnp, with the row maxima of the Pallas decode_attention."""
    B, Hq, Hkv, Dh = 2, 4, 2, 16
    rng = np.random.default_rng(C + 1)
    for cur in cursors:
        cursor = np.asarray([cur, max(1, cur - 13)], np.int32)
        start = np.maximum(cursor - T, 0).astype(np.int32)
        q = rng.normal(size=(B, Hq, T, Dh)).astype(np.float32)
        k = rng.normal(size=(B, Hkv, C, Dh)).astype(np.float32)
        jargs = [jnp.asarray(x) for x in (q, k, k, start, cursor)]
        _, m = j_decode(*jargs, n_local=n_local, interpret=True,
                        return_m=True)
        sargs = (jargs[0], jargs[1], m, jargs[3], jargs[4])
        s_pl = j_score(*sargs, n_local=n_local, interpret=True)
        s_jnp = j_score_jnp(*sargs, n_local=n_local)
        before = (tda.launches, tda.score_launches)
        got = tda.decode_score(tt(q), tt(k), tt(np.asarray(m)),
                               torch.from_numpy(start),
                               torch.from_numpy(cursor), n_local=n_local)
        assert (tda.launches, tda.score_launches) == before
        assert got.shape == (B, Hq, C) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(s_jnp),
                                   **F32_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(s_pl),
                                   **KERNEL_TOL)
        assert not got.numpy()[1, :, cursor[1]:].any()  # unwritten slots


# (T, C, n_local, start, cursor) of batch row 0; batch row 1 sees no key
# (its first query's window ends just below its cursor).  T is not a
# multiple of 8 and C not one of the 128-key tile: 45 queries whose window
# of 70 expires inside a key tile; a 256-token prompt; 256 queries over a
# window of 64, of which those from t = 163 on see no key (m = -inf).
SCORE_BF16_CASES = [(45, 300, 70, 230, 263), (13, 640, 200, 600, 613),
                    (256, 1100, 15000, 800, 1056), (256, 1000, 64, 900, 1000)]


@pytest.mark.parametrize("T,C,n_local,start0,cursor0", SCORE_BF16_CASES)
def test_bf16_decode_score_ref_matches_pallas(T, C, n_local, start0,
                                              cursor0):
    """bf16 operands at 7B head geometry (G = 7, D = 128): decode_score_ref
    against the Pallas _score_kernel (interpret) and decode_score_jnp, with
    the row maxima of the Pallas decode_attention.  Every term of a query
    that sees no key is masked, so its row and batch row 1 add exactly
    0."""
    B, Hq, Hkv, Dh = 2, 7, 1, 128
    rng = np.random.default_rng(T + C)
    bf = jnp.bfloat16
    q, k = (np.asarray(jnp.asarray(rng.normal(size=s), bf).astype(
        jnp.float32)) for s in ((B, Hq, T, Dh), (B, Hkv, C, Dh)))
    cursor = np.asarray([cursor0, 100], np.int32)
    start = np.asarray([start0, 99 + n_local], np.int32)
    jq, jk = jnp.asarray(q, bf), jnp.asarray(k, bf)
    js, jc = jnp.asarray(start), jnp.asarray(cursor)
    _, m = j_decode(jq, jk, jk, js, jc, n_local=n_local, interpret=True,
                    return_m=True)
    s_pl = np.asarray(j_score(jq, jk, m, js, jc, n_local=n_local,
                              interpret=True))
    s_jnp = np.asarray(j_score_jnp(jq, jk, m, js, jc, n_local=n_local))
    before = (tda.launches, tda.score_launches)
    got = tda.decode_score(tt(q).bfloat16(), tt(k).bfloat16(),
                           tt(np.asarray(m)), torch.from_numpy(start),
                           torch.from_numpy(cursor), n_local=n_local)
    assert (tda.launches, tda.score_launches) == before
    assert got.shape == (B, Hq, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), s_jnp, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), s_pl, **KERNEL_TOL)
    assert not got.numpy()[1].any() and not s_pl[1].any()
    assert not got.numpy()[0, :, cursor0:].any()
    blind = np.asarray(m)[0, 0] < -1e29  # queries of row 0 that see no key
    assert blind.any() == (start0 + T - n_local >= cursor0)


def test_decode_score_wrapper_checks_operands():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 2, 32, 16))
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        tda.decode_score(q, k, torch.zeros((1, 4, 3)), torch.zeros(1, **i32),
                         torch.ones(1, **i32), n_local=8)
    with pytest.raises(ValueError, match="one dtype"):
        tda.decode_score(q, k.bfloat16(), torch.zeros((1, 4, 2)),
                         torch.zeros(1, **i32), torch.ones(1, **i32),
                         n_local=8)


def test_decode_attention_wrapper_checks_operands():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 2, 32, 16))
    with pytest.raises(ValueError, match="int32"):
        tda.decode_attention(q, k, k, torch.zeros(1), torch.zeros(1),
                             n_local=8)
    with pytest.raises(ValueError, match="one dtype"):
        tda.decode_attention(q, k.bfloat16(), k,
                             torch.zeros(1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32), n_local=8)


# ---------------------------------------------------------------------------
# the limits a kernel is held to (kernels/agreement.py): the Pallas kernel's
# output passes them, and outputs with a planted fault do not
# ---------------------------------------------------------------------------

STREAM_FAULTS = {"third group dropped": (3, -1),   # init_active 1 -> 0
                 "pages one page late": (4, 1)}    # page_offset + 1


@pytest.mark.parametrize("fault", sorted(STREAM_FAULTS))
def test_agreement_limits_reject_stream_faults(fault):
    cfg = ReKVConfig(**BASE)
    ops, _, o_pl, _ = _jax_stream_inputs(cfg, 12, 8, seed=20)
    args = [torch.from_numpy(np.array(a)) for a in ops.values()]
    assert int(args[9][0, 3]) == 1  # past the init-fill trigger
    ref = tsa.stream_attention(*args, n_local=cfg.n_local)
    assert disagreement(torch.tensor(o_pl), ref)["agrees"]
    col, delta = STREAM_FAULTS[fault]
    scalars = args[9].clone()
    scalars[:, col] += delta
    bad = tsa.stream_attention(*args[:9], scalars, n_local=cfg.n_local)
    assert not disagreement(bad, ref)["agrees"]


@pytest.mark.parametrize("fault", ["newest slot dropped",
                                   "window one slot longer"])
def test_agreement_limits_reject_decode_faults(fault):
    T, C, n_local = 8, 256, 200
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, T, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, C, 16)).astype(np.float32)
            for _ in range(2))
    cursor = np.asarray([250], np.int32)
    start = cursor - T
    o_pl = j_decode(*(jnp.asarray(x) for x in (q, k, v, start, cursor)),
                    n_local=n_local, interpret=True)
    args = (tt(q), tt(k), tt(v), torch.from_numpy(start))
    ref = tda.decode_attention(*args, torch.from_numpy(cursor),
                               n_local=n_local)
    assert disagreement(torch.tensor(np.asarray(o_pl)), ref)["agrees"]
    if fault == "newest slot dropped":
        bad = tda.decode_attention(*args, torch.from_numpy(cursor - 1),
                                   n_local=n_local)
    else:
        bad = tda.decode_attention(*args, torch.from_numpy(cursor),
                                   n_local=n_local + 1)
    assert not disagreement(bad, ref)["agrees"]


def _nibbles_swapped(p):
    return ((p & 0x0F) << 4) | (p >> 4)


QUANT_FAULTS = {  # page kind -> a planted fault of the page operands
    "int8: the scale rows of the neighbouring page": (
        "int8", lambda a, kw: (a, {k: v.roll(1, dims=2)
                                   for k, v in kw.items()})),
    "int4: the nibble planes swapped": (
        "int4", lambda a, kw: (a[:2] + [_nibbles_swapped(x) for x in a[2:4]]
                               + a[4:], kw)),
}


@pytest.mark.parametrize("fault", sorted(QUANT_FAULTS))
def test_agreement_limits_reject_quantized_page_faults(fault):
    """Pages whose magnitudes differ from page to page, past the init-fill
    trigger: the Pallas kernel's output agrees with the plain version, the
    plain version of the faulty operands does not."""
    quant, plant = QUANT_FAULTS[fault]
    cfg = ReKVConfig(**dict(BASE, kv_quant=quant))
    ops, _, o_pl, _ = _jax_stream_inputs(cfg, 12, 8, seed=21, vary=True)
    args, scales = _port_stream_args(ops)
    kw = dict(n_local=cfg.n_local)
    ref = tsa.stream_attention(*args, **kw, **scales)
    assert disagreement(torch.tensor(np.asarray(o_pl)), ref)["agrees"]
    bad_args, bad_scales = plant(args, scales)
    bad = tsa.stream_attention(*bad_args, **kw, **bad_scales)
    assert not disagreement(bad, ref)["agrees"]


def test_agreement_limits_reject_decode_score_window_fault():
    """decode_score with a window one slot longer than the true one."""
    T, C, n_local = 8, 256, 200
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 4, T, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, C, 16)).astype(np.float32)
    cursor = np.asarray([250], np.int32)
    start = cursor - T
    jargs = [jnp.asarray(x) for x in (q, k, k, start, cursor)]
    _, m = j_decode(*jargs, n_local=n_local, interpret=True, return_m=True)
    s_pl = j_score(jargs[0], jargs[1], m, jargs[3], jargs[4],
                   n_local=n_local, interpret=True)
    args = (tt(q), tt(k), tt(np.asarray(m)), torch.from_numpy(start),
            torch.from_numpy(cursor))
    ref = tda.decode_score(*args, n_local=n_local)
    assert disagreement(torch.tensor(np.asarray(s_pl)), ref)["agrees"]
    bad = tda.decode_score(*args, n_local=n_local + 1)
    assert not disagreement(bad, ref)["agrees"]
