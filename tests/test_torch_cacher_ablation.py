"""The cacher's ablation variants against stc_tpu's on the CPU, same
weights (tests/test_vision.py's cases): sim_source='value' (gate on fresh
V, attend against the fresh V) and k_proxy_rank > 0 (rank on sketches of
K, fresh K only at the selected rows, logits as q_sel @ ref_K^T plus a
U x U correction).  Recomputed rows per layer equal stc_tpu's exactly,
features within DEEP_TOL; the ratio-one equalities with the full path and
the sketch's ranking hold in the port on its own; whole pixel sessions
with either variant answer as stc_tpu's do."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.models import siglip as jsg
from stc_tpu_torch import weights
from stc_tpu_torch.models import siglip as tsg
from test_torch_common import (DEEP_TOL, np_tree, one_thread,  # noqa: F401
                               port_model_cfg, tt)

pytestmark = pytest.mark.usefixtures("one_thread")

RATIO_ONE_TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_vision.py's limit


def _towers(seed=0, cfg=None):
    cfg = cfg or jsg.SiglipConfig.tiny()
    params = jsg.init_params(cfg, jax.random.key(seed))
    tower = weights.siglip_from_jax(np_tree(params), port_model_cfg(cfg),
                                    dtype=torch.float32, device="cpu")
    return cfg, params, tower


def _frames(rng, n, base=None):
    """A base frame plus noise of a different scale per 14x14 patch, so the
    per-token similarities are well separated."""
    if base is None:
        base = rng.normal(size=(1, 3, 56, 56)).astype(np.float32)
    scale = np.repeat(np.repeat(
        rng.permutation(16).reshape(4, 4) * 0.1 + 0.05, 14, 0), 14, 1)
    noise = rng.normal(size=(n, 3, 56, 56)).astype(np.float32)
    return (base + noise * scale[None, None]).astype(np.float32), base


def _cos(a, b):
    return jnp.sum(a * b, -1) / (jnp.linalg.norm(a, axis=-1)
                                 * jnp.linalg.norm(b, axis=-1) + 1e-8)


def _jax_rows(params, cfg, px, cacher, U, sim_source, k_proxy):
    """Per-layer rows stc_tpu's cached layer recomputes under a variant,
    and its features."""
    h = jsg.patch_embed(params, jnp.asarray(px), cfg)
    rows = []
    C = cfg.hidden_size
    for l in range(cfg.num_layers):
        lp = jax.tree.map(lambda x: x[l], params["layers"])
        refs = tuple(x[l] for x in cacher)
        hn = jsg.layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        if sim_source == "value":
            sim = _cos(hn @ lp["wv"] + lp["bv"], refs[1])
        else:
            R = jnp.asarray(jsg._kproxy_matrix(C, k_proxy, jnp.float32))
            sim = _cos(hn @ (lp["wk"] @ R) + lp["bk"] @ R, refs[0] @ R)
        rows.append(np.sort(np.asarray(jax.lax.top_k(-sim, U)[1]), axis=-1))
        h = jsg._layer_cached(lp, h, refs, U, cfg, sim_source, "index",
                              k_proxy)
    return np.stack(rows), np.asarray(h)


@pytest.mark.parametrize("sim_source,k_proxy,ratio", [
    ("value", 0, 0.25), ("value", 0, 0.5), ("key", 16, 0.25),
    ("key", 8, 0.5)])
def test_cached_variant_matches_jax(sim_source, k_proxy, ratio):
    cfg, params, tower = _towers(seed=1)
    rng = np.random.default_rng(1)
    ref_px, base = _frames(rng, 1)
    new_px, _ = _frames(rng, 2, base)
    _, cj = jsg.encode_full(params, cfg, jnp.asarray(ref_px),
                            jsg.init_cacher_state(cfg, 1))
    _, ct = tower.encode_full(tt(ref_px))
    U = max(1, min(int(cfg.num_tokens * ratio), cfg.num_tokens))
    rows_j, hj = _jax_rows(params, cfg, new_px, cj, U, sim_source, k_proxy)
    hj2 = jsg.encode_cached(params, cfg, jnp.asarray(new_px), cj, ratio,
                            sim_source=sim_source, gather_impl="index",
                            k_proxy_rank=k_proxy)
    np.testing.assert_allclose(np.asarray(hj2), hj, rtol=1e-5, atol=1e-5)
    ht, rows_t = tower.encode_cached(tt(new_px), ct, ratio,
                                     sim_source=sim_source,
                                     k_proxy_rank=k_proxy)
    np.testing.assert_array_equal(rows_t.numpy(), rows_j)
    np.testing.assert_allclose(ht.numpy(), hj, **DEEP_TOL)


@pytest.mark.parametrize("kw", [dict(sim_source="value"),
                                dict(k_proxy_rank=16)])
@pytest.mark.parametrize("n_streams", [1, 2])
def test_ratio_one_equals_full(kw, n_streams):
    """Every row recomputed: the cached path is the full path (per stream
    with two streams)."""
    cfg, params, tower = _towers(seed=2)
    rng = np.random.default_rng(11)
    ref = tt(rng.normal(size=(2 * n_streams, 3, 56, 56)))
    new = tt(rng.normal(size=(2 * n_streams, 3, 56, 56)))
    _, cacher = tower.encode_full(ref, n_streams)
    want, _ = tower.encode_full(new, n_streams)
    got, rows = tower.encode_cached(new, cacher, 1.0, n_streams, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **RATIO_ONE_TOL)
    assert rows.shape[-1] == cfg.num_tokens


def test_value_sim_ignores_k_proxy_and_differs_from_key():
    cfg, params, tower = _towers(seed=2)
    rng = np.random.default_rng(13)
    pix = tt(rng.normal(size=(4, 3, 56, 56)))
    _, cacher = tower.encode_full(pix, 2)
    a = tower.encode_cached(pix, cacher, 0.25, 2, sim_source="value",
                            k_proxy_rank=16)
    b = tower.encode_cached(pix, cacher, 0.25, 2, sim_source="value")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    new = tt(np.random.default_rng(7).normal(size=(4, 3, 56, 56)))
    v = tower.encode_cached(new, cacher, 0.25, 2, sim_source="value")[0]
    k = tower.encode_cached(new, cacher, 0.25, 2)[0]
    assert not torch.allclose(v, k)


@pytest.mark.parametrize("C,rank", [(32, 16), (1152, 64)])
def test_kproxy_matrix_is_jax_matrix(C, rank):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jsg._kproxy_matrix(C, rank, jdt), np.float32)
        got = tsg.kproxy_matrix(C, rank, tdt, "cpu").float().numpy()
        np.testing.assert_array_equal(got, want)


def test_kproxy_ranks_clearly_stale_tokens_like_exact_cosine():
    cfg, params, tower = _towers(seed=0)
    rng = np.random.default_rng(3)
    T, C = cfg.num_tokens, cfg.hidden_size
    hn = rng.normal(size=(1, T, C)).astype(np.float32)
    hn_ref = hn.copy()
    stale = np.array([2, 5, 11, 14])
    hn[0, stale] = rng.normal(size=(len(stale), C)).astype(np.float32)
    lp = tower.layers[0]
    ref_k = tt(hn_ref) @ lp.wk + lp.bk
    exact = tsg.key_similarity(tt(hn) @ lp.wk + lp.bk, ref_k)
    R = tsg.kproxy_matrix(C, 16, torch.float32, "cpu")
    proxy = tsg.key_similarity(tt(hn) @ (lp.wk @ R) + lp.bk @ R, ref_k @ R)
    k = len(stale)
    assert set(torch.topk(-exact[0], k).indices.tolist()) == \
        set(torch.topk(-proxy[0], k).indices.tolist()) == set(stale.tolist())


def test_kproxy_matches_exact_cacher_on_locally_perturbed_chunk():
    cfg = jsg.SiglipConfig(hidden_size=32, num_layers=1, num_heads=4,
                           intermediate_size=64, image_size=56,
                           patch_size=14)
    cfg, params, tower = _towers(seed=1, cfg=cfg)
    rng = np.random.default_rng(5)
    base = rng.normal(size=(1, 3, 56, 56)).astype(np.float32)
    ref_pix = np.tile(base, (2, 1, 1, 1))
    new_pix = ref_pix.copy()
    for (gy, gx) in ((1, 2), (3, 0)):
        new_pix[:, :, gy * 14:(gy + 1) * 14, gx * 14:(gx + 1) * 14] = \
            rng.normal(size=(2, 3, 14, 14)).astype(np.float32)
    _, cacher = tower.encode_full(tt(ref_pix))
    ratio = 2 / cfg.num_tokens
    exact, re = tower.encode_cached(tt(new_pix), cacher, ratio)
    proxy, rp = tower.encode_cached(tt(new_pix), cacher, ratio,
                                    k_proxy_rank=16)
    assert torch.equal(re, rp) and re[0, 0].tolist() == [6, 12]
    np.testing.assert_allclose(proxy.numpy(), exact.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("cacher_kw", [dict(sim_source="value"),
                                       dict(k_proxy_rank=8)])
def test_pixel_session_with_variant_matches_jax(cacher_kw):
    from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                SessionConfig)
    from stc_tpu.models import llava_onevision as jlo
    from stc_tpu_torch.models import llava_onevision as tlo
    from test_torch_common import port_cfg
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=64,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(update_token_ratio=0.5, **cacher_kw),
        pruner=PrunerConfig(token_per_frame=3))
    params = jlo.init_random_params(cfg, jax.random.key(0))
    j = jlo.build_session(params, cfg, scfg, state_dtype=jnp.float32)
    t = tlo.build_session(weights.params_from_jax(
        np_tree(params), port_model_cfg(cfg), device="cpu"),
        port_cfg(scfg), state_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(56, 56, 3))
    frames = np.clip(base[None] + rng.normal(0, 40, size=(8, 56, 56, 3)),
                     0, 255).astype(np.uint8)
    for s in (j, t):
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video(frames)
    np.testing.assert_allclose(t.kvs.block_k.numpy(),
                               np.asarray(j.kvs.block_k), **DEEP_TOL)
    want = j.question_answering([7, 8, 9], [7, 8, 9, 10], [0],
                                max_new_tokens=6)
    assert t.question_answering([7, 8, 9], [7, 8, 9, 10], [0],
                                max_new_tokens=6) == want
