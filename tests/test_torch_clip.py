"""The port's CLIP tower and its MLP-skip cacher (stc_tpu_torch/models/clip.py)
on the CPU: the tower against HF's CLIPVisionModel, and full and cached
chunks against stc_tpu's on the same numpy weights and frames.  Features
within F32_TOL / DEEP_TOL (or the bf16 limits of test_torch_common);
every layer's recompute rows, the references' counters and has_ref equal
exactly, at skip ratios 0 to 0.9, uniform and linear-increasing, one and
two streams (stream-major), and at planted exact ties."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.models import clip as jcl
from stc_tpu_torch import weights
from stc_tpu_torch.models import clip as tcl
from test_torch_common import (DEEP_TOL, F32_TOL, assert_bf16_close,  # noqa
                               np_tree, one_thread, port_model_cfg, tt)

pytestmark = pytest.mark.usefixtures("one_thread")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _towers(seed=0, dtype="f32", cfg=None):
    jdt, tdt = DTYPES[dtype]
    cfg = cfg or jcl.CLIPConfig.tiny()
    params = jcl.init_params(cfg, jax.random.key(seed), dtype=jdt)
    tower = weights.clip_from_jax(np_tree(params), port_model_cfg(cfg),
                                  dtype=tdt, device="cpu")
    return cfg, params, tower


def _frames(rng, n, base=None):
    """Pixels (n, 3, 56, 56): a base frame plus noise whose scale differs
    per 14x14 patch, so the similarities to a reference are well apart."""
    if base is None:
        base = rng.normal(size=(1, 3, 56, 56)).astype(np.float32)
    scale = np.repeat(np.repeat(
        rng.permutation(16).reshape(4, 4) * 0.1 + 0.05, 14, 0), 14, 1)
    noise = rng.normal(size=(n, 3, 56, 56)).astype(np.float32)
    return (base + noise * scale[None, None]).astype(np.float32), base


def _stream_frames(rng, n_streams, n):
    """Stream-major (n_streams * n) frames, each stream around its own
    base, and the reference chunk (n_streams * 1) of the same bases."""
    refs, news = [], []
    for _ in range(n_streams):
        ref, base = _frames(rng, 1)
        new, _ = _frames(rng, n, base)
        refs.append(ref)
        news.append(new)
    return np.concatenate(refs), np.concatenate(news)


def _jax_cached_rows(params, cfg, px, cacher, ratio, strategy, n_streams):
    """encode_cached of stc_tpu, layer by layer, keeping each layer's
    recomputed rows (None where nothing is skipped); returns (rows, the
    output of the last layer)."""
    h = jcl.embed(params, jnp.asarray(px), cfg)
    F_, T, C = h.shape
    Fs = F_ // n_streams
    eps = cfg.layer_norm_eps
    n_skips = [int(max(0, min(T, int(T * r))))
               for r in jcl.layer_ratios(cfg.num_layers, ratio, strategy)]
    rows = []
    for li in range(cfg.num_layers):
        lp = jax.tree.map(lambda x: x[li], params["layers"])
        h = h + jcl._attn(lp, jcl._layer_norm(h, lp["ln1_w"], lp["ln1_b"],
                                              eps), cfg)
        if n_skips[li] == 0:
            h = h + jcl._mlp(lp, jcl._layer_norm(h, lp["ln2_w"],
                                                 lp["ln2_b"], eps))
            rows.append(None)
            continue
        ref_pre = jnp.repeat(cacher.ref_pre_ln2[li], Fs, axis=0)
        ref_mlp = jnp.repeat(cacher.ref_mlp_post[li], Fs, axis=0)
        r2, rf = h.astype(jnp.float32), ref_pre.astype(jnp.float32)
        sim = (r2 * rf).sum(-1) / (jnp.linalg.norm(r2, axis=-1)
                                   * jnp.linalg.norm(rf, axis=-1) + 1e-8)
        comp = jnp.sort(jax.lax.top_k(-sim, T - n_skips[li])[1], axis=-1)
        frow = jnp.arange(F_)[:, None]
        toks = jcl._mlp(lp, jcl._layer_norm(h[frow, comp], lp["ln2_w"],
                                            lp["ln2_b"], eps))
        h = h + ref_mlp.astype(h.dtype).at[frow, comp].set(toks)
        rows.append(np.asarray(comp))
    return rows, h


def _eq_counts(ct, cj):
    for name in ("has_ref", "tokens_processed", "tokens_skipped"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel
    torch.manual_seed(0)
    hf_cfg = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=56, patch_size=14,
        hidden_act="quick_gelu")
    return CLIPVisionModel(hf_cfg).eval(), hf_cfg


def test_tower_matches_hf(hf_clip):
    """The tower converted from HF's CLIPVisionModel (its pre_layrnorm
    spelling included) gives HF's hidden_states[-2]."""
    from stc_tpu_torch.models.convert import clip_config_from_hf, convert_clip
    model, hf_cfg = hf_clip
    cfg = clip_config_from_hf(hf_cfg)
    state = dict(model.state_dict())
    assert "vision_model.pre_layrnorm.weight" in state
    tower = convert_clip(state, tcl.CLIP(cfg, device="cpu"))
    px = np.random.default_rng(0).normal(size=(2, 3, 56, 56)).astype(
        np.float32)
    with torch.no_grad():
        want = model(torch.tensor(px), output_hidden_states=True
                     ).hidden_states[-2].numpy()
    got, _ = tower.encode_full(tt(px), tcl.init_clip_cacher(cfg,
                                                            device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("n_streams", [1, 2])
def test_encode_full_matches_jax(n_streams):
    """Features, every layer's references (each stream's last frame) and
    the counters of a full chunk."""
    cfg, params, tower = _towers()
    rng = np.random.default_rng(n_streams)
    _, px = _stream_frames(rng, n_streams, 3)
    hj, cj = jcl.encode_full(params, cfg, jnp.asarray(px),
                             jcl.init_clip_cacher(cfg, batch=n_streams),
                             n_streams=n_streams)
    ht, ct = tower.encode_full(tt(px), tcl.init_clip_cacher(
        tower.cfg, batch=n_streams, device="cpu"), n_streams=n_streams)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **DEEP_TOL)
    for name in ("ref_pre_ln2", "ref_mlp_post"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)),
                                   err_msg=name, **DEEP_TOL)
    _eq_counts(ct, cj)
    assert tuple(ct.ref_pre_ln2.shape) == (2, n_streams, 17, 32)


@pytest.mark.parametrize("n_streams", [1, 2])
@pytest.mark.parametrize("strategy", ["uniform", "linear_increasing"])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.8, 0.9])
def test_encode_cached_matches_jax(ratio, strategy, n_streams):
    """A cached chunk after a full one (each stream against its own
    reference): every layer's recompute rows and the counters equal, the
    features within DEEP_TOL; at ratio 0 the cached chunk is a full one."""
    cfg, params, tower = _towers(seed=1)
    rng = np.random.default_rng(10 + n_streams)
    ref_px, new_px = _stream_frames(rng, n_streams, 2)
    _, cj = jcl.encode_full(params, cfg, jnp.asarray(ref_px),
                            jcl.init_clip_cacher(cfg, batch=n_streams),
                            n_streams=n_streams)
    _, ct = tower.encode_full(tt(ref_px), tcl.init_clip_cacher(
        tower.cfg, batch=n_streams, device="cpu"), n_streams=n_streams)
    hj, cj2 = jcl.encode_cached(params, cfg, jnp.asarray(new_px), cj, ratio,
                                ratio_strategy=strategy, n_streams=n_streams)
    rows_j, h_last = _jax_cached_rows(params, cfg, new_px, cj, ratio,
                                      strategy, n_streams)
    ht, ct2 = tower.encode_cached(tt(new_px), ct, ratio,
                                  ratio_strategy=strategy,
                                  n_streams=n_streams)
    rows_t = tower.last_rows
    assert len(rows_t) == cfg.num_layers
    for li, (rt, rj) in enumerate(zip(rows_t, rows_j)):
        if rj is None:
            assert rt is None, li
        else:
            np.testing.assert_array_equal(rt.numpy(), rj, err_msg=f"{li}")
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **DEEP_TOL)
    _eq_counts(ct2, cj2)
    for name in ("ref_pre_ln2", "ref_mlp_post"):   # a cached chunk keeps
        assert torch.equal(getattr(ct2, name), getattr(ct, name))
    n_skip = tcl.skip_counts(tower.cfg, ratio, strategy)
    assert int(ct2.tokens_skipped[0]) == 2 * sum(n_skip)
    assert int(ct2.tokens_processed[0]) == 17 + 2 * 17
    if ratio == 0.0:
        full, _ = tower.encode_full(tt(new_px), ct, n_streams=n_streams)
        np.testing.assert_allclose(ht.numpy(), full.numpy(), **F32_TOL)
    # the replica of stc_tpu's loop gives stc_tpu's last layer
    h_out, _ = jcl.encode_cached(params, cfg, jnp.asarray(new_px), cj, ratio,
                                 feature_layer=-1, ratio_strategy=strategy,
                                 n_streams=n_streams)
    np.testing.assert_array_equal(np.asarray(h_last), np.asarray(h_out))


def test_bf16_tower_within_bf16_limits():
    """bf16 tower: full-chunk features and references, and a cached
    chunk's features, within the bf16 limits of stc_tpu's; at each layer
    and frame where the gap between the rows kept and dropped exceeds
    twice the packages' largest similarity difference, the rows equal."""
    cfg, params, tower = _towers(seed=2, dtype="bf16")
    rng = np.random.default_rng(3)
    ref_px, new_px = _stream_frames(rng, 1, 3)
    bj, bt = jnp.bfloat16, torch.bfloat16
    _, cj = jcl.encode_full(params, cfg, jnp.asarray(ref_px, bj),
                            jcl.init_clip_cacher(cfg, bj))
    ht, ct = tower.encode_full(tt(ref_px, bt), tcl.init_clip_cacher(
        tower.cfg, bt, device="cpu"))
    hj, _ = jcl.encode_full(params, cfg, jnp.asarray(ref_px, bj),
                            jcl.init_clip_cacher(cfg, bj))
    assert ht.dtype == bt
    assert_bf16_close(ht.float(), np.asarray(hj, np.float32), "full")
    for name in ("ref_pre_ln2", "ref_mlp_post"):
        assert_bf16_close(getattr(ct, name).float(),
                          np.asarray(getattr(cj, name), np.float32), name)
    ratio = 0.5
    hj, cj2 = jcl.encode_cached(params, cfg, jnp.asarray(new_px, bj), cj,
                                ratio)
    ht, ct2 = tower.encode_cached(tt(new_px, bt), ct, ratio)
    assert_bf16_close(ht.float(), np.asarray(hj, np.float32), "cached")
    _eq_counts(ct2, cj2)
    # each package's similarities on its own hidden states, layer by layer
    eps, T = cfg.layer_norm_eps, cfg.num_tokens
    n_comp = T - int(T * ratio)
    h_j = jcl.embed(params, jnp.asarray(new_px, bj), cfg)
    h_t = tower.embed(tt(new_px, bt))
    separated = 0
    for li, lp in enumerate(tower.layers):
        jl = jax.tree.map(lambda x: x[li], params["layers"])
        h_j = h_j + jcl._attn(jl, jcl._layer_norm(h_j, jl["ln1_w"],
                                                  jl["ln1_b"], eps), cfg)
        h_t = h_t + lp.attn(tcl.layer_norm(h_t, lp.ln1_w, lp.ln1_b, eps),
                            cfg.num_heads)
        rf = cj.ref_pre_ln2[li, 0].astype(jnp.float32)
        r2 = h_j.astype(jnp.float32)
        sj = np.asarray((r2 * rf).sum(-1) / (
            jnp.linalg.norm(r2, axis=-1) * jnp.linalg.norm(rf, axis=-1)
            + 1e-8))
        st = tcl.residual_similarity(h_t, ct.ref_pre_ln2[li, :1]).numpy()
        for f in range(sj.shape[0]):
            order = np.sort(sj[f])
            diff = np.abs(st[f] - sj[f]).max()
            if order[n_comp] - order[n_comp - 1] > 2 * diff:
                want = np.sort(np.argsort(sj[f], kind="stable")[:n_comp])
                np.testing.assert_array_equal(
                    tower.last_rows[li][f].numpy(), want,
                    err_msg=f"layer {li} frame {f}")
                separated += 1
        # on to the next layer along each package's own cached path
        frow = np.arange(h_j.shape[0])[:, None]
        comp_j = jnp.sort(jax.lax.top_k(-jnp.asarray(sj), n_comp)[1], -1)
        toks = jcl._mlp(jl, jcl._layer_norm(h_j[frow, comp_j], jl["ln2_w"],
                                            jl["ln2_b"], eps))
        h_j = h_j + jnp.repeat(cj.ref_mlp_post[li], 3, 0).astype(
            h_j.dtype).at[frow, comp_j].set(toks)
        comp_t = tower.last_rows[li]
        fr = torch.arange(3)[:, None]
        mlp = torch.repeat_interleave(ct.ref_mlp_post[li], 3, 0).clone()
        mlp[fr, comp_t] = lp.mlp(tcl.layer_norm(h_t[fr, comp_t], lp.ln2_w,
                                                lp.ln2_b, eps))
        h_t = h_t + mlp
    assert separated >= cfg.num_layers * 3 // 2, separated


def test_planted_ties_pick_jax_rows():
    """Exact ties: constant frames and zero position embeddings make every
    patch token of a frame the same, so all their similarities tie (the
    frames' colours are no multiple of the reference's, so the class
    token's similarity stands apart from theirs); and a
    cached chunk before any full one compares against zero references
    (every similarity 0).  The rows are lax.top_k's of the negated
    similarity in both packages."""
    cfg = jcl.CLIPConfig.tiny()
    params = jcl.init_params(cfg, jax.random.key(5))
    params = dict(params, pos_embed=jnp.zeros_like(params["pos_embed"]))
    tower = weights.clip_from_jax(np_tree(params), port_model_cfg(cfg),
                                  device="cpu")
    ref = np.full((1, 3, 56, 56), 0.3, np.float32)
    new = np.stack([np.broadcast_to(np.asarray(c, np.float32)[:, None, None],
                                    (3, 56, 56))
                    for c in ((0.9, -0.2, 0.4), (-0.7, 0.1, 0.5))])
    for ratio in (0.5, 0.8):
        for fresh in (True, False):
            cj = jcl.init_clip_cacher(cfg)
            ct = tcl.init_clip_cacher(tower.cfg, device="cpu")
            if not fresh:
                _, cj = jcl.encode_full(params, cfg, jnp.asarray(ref), cj)
                _, ct = tower.encode_full(tt(ref), ct)
            rows_j, _ = _jax_cached_rows(params, cfg, new, cj, ratio,
                                         "uniform", 1)
            tower.encode_cached(tt(new), ct, ratio)
            for li, (rt, rj) in enumerate(zip(tower.last_rows, rows_j)):
                np.testing.assert_array_equal(rt.numpy(), rj,
                                              err_msg=f"{ratio} {fresh} {li}")
                if fresh:   # all tie: the lowest indices
                    assert rt[0].tolist() == list(range(rt.shape[1]))


def test_recompute_rows_order_at_signed_zeros_and_ties():
    """The selection itself on planted similarities (+0.0, -0.0, exact
    ties): lax.top_k of -sim, then sorted; a bottom-k of sim by value
    would pick other rows."""
    sim = np.array([[0.0, -0.0, 0.5, -0.0, 0.0, 0.5, -0.25, 0.5],
                    [0.5, 0.5, 0.5, 0.5, -0.0, 0.0, 0.0, -0.0]], np.float32)
    for k in range(1, 8):
        want = np.sort(np.asarray(jax.lax.top_k(-jnp.asarray(sim), k)[1]),
                       axis=-1)
        got = tcl.recompute_rows(torch.from_numpy(sim), k)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
    bottom = torch.sort(torch.sort(torch.from_numpy(sim), dim=-1,
                                   stable=True).indices[:, :3], -1).values
    assert not torch.equal(bottom, tcl.recompute_rows(
        torch.from_numpy(sim), 3))


@pytest.mark.parametrize("L", [1, 4, 24])
@pytest.mark.parametrize("strategy", ["uniform", "linear_increasing"])
def test_layer_ratios_and_cache_stats_equal(L, strategy):
    for ratio in (0.0, 0.3, 0.8, 0.9):
        assert tcl.layer_ratios(L, ratio, strategy) == \
            jcl.layer_ratios(L, ratio, strategy)
    cfg = dataclasses.replace(jcl.CLIPConfig.tiny(), num_layers=L)
    cj = jcl.init_clip_cacher(cfg, batch=2)._replace(
        tokens_processed=jnp.asarray([34, 17], jnp.int32),
        tokens_skipped=jnp.asarray([20, 0], jnp.int32))
    ct = tcl.init_clip_cacher(port_model_cfg(cfg), batch=2,
                              device="cpu")._replace(
        tokens_processed=torch.tensor([34, 17], dtype=torch.int32),
        tokens_skipped=torch.tensor([20, 0], dtype=torch.int32))
    assert tcl.cache_stats(ct) == jcl.cache_stats(cj)
