"""The port's vision side against the JAX package on the CPU, same weights:
SigLIP full chunks (features + cacher references), cached chunks (features
close, recomputed rows exactly equal), the STC-Pruner's keeps over several
chunks, bilinear pooling and the projector.  The tower also runs in bf16 in
both packages: features within the bf16 limits of test_torch_common, and
the recomputed rows equal wherever the similarities are separated by more
than the two packages' difference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.compress import pruner as jp
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import siglip as jsg
from stc_tpu_torch import weights
from stc_tpu_torch.compress import pruner as tp
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.models import siglip as tsg
from test_torch_common import (DEEP_TOL, F32_TOL, assert_bf16_close, np_tree,
                               port_model_cfg, tt)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _towers(seed=0, dtype="f32"):
    jdt, tdt = DTYPES[dtype]
    cfg = jsg.SiglipConfig.tiny()
    params = jsg.init_params(cfg, jax.random.key(seed), dtype=jdt)
    tower = weights.siglip_from_jax(np_tree(params), port_model_cfg(cfg),
                                    dtype=tdt, device="cpu")
    return cfg, params, tower


def _frames(rng, n, base=None):
    """Pixels (n, 3, 56, 56): a base frame plus noise whose scale differs
    per 14x14 patch, so the cacher's per-token similarities are well
    separated (identical frames would tie)."""
    if base is None:
        base = rng.normal(size=(1, 3, 56, 56)).astype(np.float32)
    scale = np.repeat(np.repeat(
        rng.permutation(16).reshape(4, 4) * 0.1 + 0.05, 14, 0), 14, 1)
    noise = rng.normal(size=(n, 3, 56, 56)).astype(np.float32)
    return (base + noise * scale[None, None]).astype(np.float32), base


def test_encode_full_matches_jax():
    cfg, params, tower = _towers()
    px, _ = _frames(np.random.default_rng(0), 3)
    hj, cj = jsg.encode_full(params, cfg, jnp.asarray(px),
                             jsg.init_cacher_state(cfg, 1))
    ht, ct = tower.encode_full(tt(px))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **DEEP_TOL)
    for name in ("ref_k", "ref_v", "ref_attn", "ref_mlp"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)),
                                   err_msg=name, **DEEP_TOL)


def _jax_cached_rows(params, cfg, px, cacher, num_update):
    """Per-layer rows the JAX cached path recomputes (the selection of
    siglip._layer_cached, sim_source='key')."""
    h = jsg.patch_embed(params, jnp.asarray(px), cfg)
    rows = []
    for l in range(cfg.num_layers):
        lp = jax.tree.map(lambda x: x[l], params["layers"])
        refs = tuple(x[l] for x in cacher)
        hn = jsg.layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        k = hn @ lp["wk"] + lp["bk"]
        sim = jnp.sum(k * refs[0], -1) / (
            jnp.linalg.norm(k, axis=-1) * jnp.linalg.norm(refs[0], axis=-1)
            + 1e-8)
        rows.append(np.sort(np.asarray(jax.lax.top_k(-sim, num_update)[1]),
                            axis=-1))
        h = jsg._layer_cached(lp, h, refs, num_update, cfg, "key", "index")
    return np.stack(rows), np.asarray(h)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_encode_cached_matches_jax(ratio):
    cfg, params, tower = _towers(seed=1)
    rng = np.random.default_rng(1)
    ref_px, base = _frames(rng, 1)
    new_px, _ = _frames(rng, 2, base)
    _, cj = jsg.encode_full(params, cfg, jnp.asarray(ref_px),
                            jsg.init_cacher_state(cfg, 1))
    _, ct = tower.encode_full(tt(ref_px))
    U = max(1, min(int(cfg.num_tokens * ratio), cfg.num_tokens))
    rows_j, hj = _jax_cached_rows(params, cfg, new_px, cj, U)
    hj2 = jsg.encode_cached(params, cfg, jnp.asarray(new_px), cj, ratio,
                            gather_impl="index")
    np.testing.assert_allclose(np.asarray(hj2), hj, **F32_TOL)
    ht, rows_t = tower.encode_cached(tt(new_px), ct, ratio)
    np.testing.assert_array_equal(rows_t.numpy(), rows_j)
    np.testing.assert_allclose(ht.numpy(), hj, **DEEP_TOL)


@pytest.mark.parametrize("T", [16, 729])
def test_attention_bf16_rounds_where_jax_does(T):
    """bf16 attention: both products accumulate in float32 and round once,
    p to bf16 before p @ V, as stc_tpu's _attn_full.  Summation order is
    the only difference left (a probability one bf16 ulp apart): at most
    1% of the outputs differ, by at most 2^-8 of max |out| (rounding the
    products in bf16 instead makes about half of them differ)."""
    rng = np.random.default_rng(T)
    q, k, v = (rng.normal(size=(3, T, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jsg._attn_full(*(jnp.asarray(x, jnp.bfloat16)
                                       for x in (q, k, v)), 4), np.float32)
    got = tsg._attn_full(*(tt(x, torch.bfloat16) for x in (q, k, v)), 4)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert (d > 0).mean() <= 0.01, (d > 0).mean()
    assert d.max() <= 2 ** -8 * np.abs(want).max(), d.max()


def test_encode_full_bf16_within_bf16_limits():
    cfg, params, tower = _towers(dtype="bf16")
    px, _ = _frames(np.random.default_rng(0), 3)
    hj, cj = jsg.encode_full(params, cfg, jnp.asarray(px, jnp.bfloat16),
                             jsg.init_cacher_state(cfg, 1, jnp.bfloat16))
    ht, ct = tower.encode_full(tt(px, torch.bfloat16))
    assert ht.dtype == torch.bfloat16 and hj.dtype == jnp.bfloat16
    assert_bf16_close(ht.float(), np.asarray(hj, np.float32), "features")
    for name in ("ref_k", "ref_v", "ref_attn", "ref_mlp"):
        assert_bf16_close(getattr(ct, name).float(),
                          np.asarray(getattr(cj, name), np.float32), name)


def _bf16_layer_sims(params, tower, cfg, px, cj, ct, num_update):
    """Per layer, the cacher's key similarities (F, T) in each package (the
    float32 cosine of each package's cached layer, on its own stream of
    hidden states), and each package's recomputed rows (F, U)."""
    hj = jsg.patch_embed(params, jnp.asarray(px, jnp.bfloat16), cfg)
    ht = tower.patch_embed(tt(px, torch.bfloat16))
    sims, rows_t = [], []
    for l, lp in enumerate(tower.layers):
        jl = jax.tree.map(lambda x: x[l], params["layers"])
        jrefs = tuple(x[l] for x in cj)
        hn = jsg.layer_norm(hj, jl["ln1_w"], jl["ln1_b"], cfg.layer_norm_eps)
        kf = (hn @ jl["wk"] + jl["bk"]).astype(jnp.float32)
        rf = jrefs[0].astype(jnp.float32)
        sj = jnp.sum(kf * rf, -1) / (jnp.linalg.norm(kf, axis=-1)
                                     * jnp.linalg.norm(rf, axis=-1) + 1e-8)
        hj = jsg._layer_cached(jl, hj, jrefs, num_update, cfg, "key",
                               "index")
        trefs = tuple(x[l] for x in ct)
        hn_t = tsg.layer_norm(ht, lp.ln1_w, lp.ln1_b, cfg.layer_norm_eps)
        st = tsg.key_similarity(hn_t @ lp.wk + lp.bk, trefs[0])
        ht, upd = lp.cached(ht, trefs, num_update, tower.cfg)
        sims.append((np.asarray(sj), st.numpy()))
        rows_t.append(upd.numpy())
    return sims, np.stack(rows_t)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_encode_cached_bf16_within_limits_and_rows_equal_where_separated(
        ratio):
    """bf16 cached chunks: features within the bf16 limits; at each layer
    and frame where the gap between the U-th and (U+1)-th smallest JAX
    similarity exceeds twice the largest difference between the packages'
    similarities, both recompute the same rows (and most pairs qualify)."""
    cfg, params, tower = _towers(seed=1, dtype="bf16")
    rng = np.random.default_rng(1)
    ref_px, base = _frames(rng, 1)
    new_px, _ = _frames(rng, 4, base)
    _, cj = jsg.encode_full(params, cfg, jnp.asarray(ref_px, jnp.bfloat16),
                            jsg.init_cacher_state(cfg, 1, jnp.bfloat16))
    _, ct = tower.encode_full(tt(ref_px, torch.bfloat16))
    U = max(1, min(int(cfg.num_tokens * ratio), cfg.num_tokens))
    hj = jsg.encode_cached(params, cfg, jnp.asarray(new_px, jnp.bfloat16),
                           cj, ratio, gather_impl="index")
    ht, rows = tower.encode_cached(tt(new_px, torch.bfloat16), ct, ratio)
    assert_bf16_close(ht.float(), np.asarray(hj, np.float32), "features")
    sims, rows_t = _bf16_layer_sims(params, tower, cfg, new_px, cj, ct, U)
    np.testing.assert_array_equal(rows.numpy(), rows_t)
    separated = 0
    for l, (sj, st) in enumerate(sims):
        for f in range(sj.shape[0]):
            diff = np.abs(st[f] - sj[f]).max()
            order = np.sort(sj[f])
            if order[U] - order[U - 1] > 2 * diff:
                want = np.sort(np.argsort(sj[f], kind="stable")[:U])
                np.testing.assert_array_equal(rows_t[l, f], want,
                                              err_msg=f"layer {l} frame {f}")
                separated += 1
    assert separated >= len(sims) * sims[0][0].shape[0] // 2, separated


def test_pruner_keeps_equal_on_equal_bf16_features():
    """bf16 features, the same in both packages: the pruner's keeps and
    memory over several chunks are equal (both score in float32)."""
    rng = np.random.default_rng(4)
    F_, Tin, C, keep = 2, 16, 32, 5
    js = jp.init_pruner_state(1, C // 2)
    ts = tp.init_pruner_state(1, C // 2, device="cpu")
    for _ in range(4):
        feats = tt(rng.normal(size=(1, F_, Tin, C)), torch.bfloat16)
        pj, ij, js = jp.stc_prune(jnp.asarray(feats.float().numpy(),
                                              jnp.bfloat16), js, keep)
        pt, it, ts = tp.stc_prune(feats, ts, keep)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(pt.float().numpy(),
                                      np.asarray(pj, np.float32))
        np.testing.assert_allclose(ts.mean_sum.numpy(),
                                   np.asarray(js.mean_sum), **F32_TOL)


def test_pruner_keeps_equal_over_chunks():
    rng = np.random.default_rng(2)
    F_, Tin, C, keep = 2, 16, 32, 5
    js = jp.init_pruner_state(1, C // 2)
    ts = tp.init_pruner_state(1, C // 2, device="cpu")
    for _ in range(4):
        feats = rng.normal(size=(1, F_, Tin, C)).astype(np.float32)
        pj, ij, js = jp.stc_prune(jnp.asarray(feats), js, keep)
        pt, it, ts = tp.stc_prune(tt(feats), ts, keep)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **F32_TOL)
        np.testing.assert_allclose(ts.mean_sum.numpy(),
                                   np.asarray(js.mean_sum), **F32_TOL)
        np.testing.assert_array_equal(ts.count.numpy(), np.asarray(js.count))
    np.testing.assert_array_equal(
        tp.map_indices_flat(it, Tin).numpy(),
        np.asarray(jp.map_indices_flat(ij, Tin)))


@pytest.mark.parametrize("grid", [4, 27])
def test_apply_pooling_matches_jax(grid):
    rng = np.random.default_rng(grid)
    feats = rng.normal(size=(2, grid * grid, 8)).astype(np.float32)
    want = jlo.apply_pooling(jnp.asarray(feats), grid)
    got = tlo.apply_pooling(tt(feats), grid)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_projector_and_preprocess_match_jax():
    cfg = jlo.LlavaOVConfig.tiny()
    params = jlo.init_random_params(cfg, jax.random.key(2))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 16, 32)).astype(np.float32)
    np.testing.assert_allclose(
        model.projector(tt(feats)).numpy(),
        np.asarray(jlo.project(params["projector"], jnp.asarray(feats))),
        **F32_TOL)
    from stc_tpu.runtime.vlm import make_preprocessor
    from stc_tpu_torch.runtime.vlm import Preprocessor
    frames = rng.integers(0, 256, size=(2, 64, 48, 3), dtype=np.uint8)
    jpre = make_preprocessor(56, jlo.IMAGE_MEAN, jlo.IMAGE_STD, jnp.float32)
    tpre = Preprocessor(56, tlo.IMAGE_MEAN, tlo.IMAGE_STD, torch.float32)
    np.testing.assert_allclose(
        tpre.device(torch.from_numpy(tpre.host(frames))).numpy(),
        np.asarray(jpre.device(jnp.asarray(jpre.host(frames)))), **F32_TOL)
