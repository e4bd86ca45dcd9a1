"""The port's scoring library (stc_tpu_torch/compress/scoring.py) against
stc_tpu's (tests/test_scoring.py's cases), on the same numpy inputs.
Integers (selected frames, blocks, kept tokens) must be equal, in the JAX
package's order; float scores within F32_TOL.  filter_tokens_random draws
from a torch.Generator and is held by structure."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.compress import scoring as js
from stc_tpu_torch.compress import scoring as ts
from test_torch_common import F32_TOL


def _np(x):
    return np.asarray(x)


def test_aks_is_the_same_numpy():
    scores = np.zeros((1, 100))
    scores[0, 40:44] = 10.0
    assert ts.adaptive_keyframe_sampling(scores, max_frames=4) == \
        js.adaptive_keyframe_sampling(scores, max_frames=4) == \
        [[40, 41, 42, 43]]
    rng = np.random.default_rng(0)
    uni = rng.uniform(0.4, 0.6, size=(3, 64))
    got = ts.adaptive_keyframe_sampling(uni, max_frames=8)
    assert got == js.adaptive_keyframe_sampling(uni, max_frames=8)
    assert any(i < 32 for i in got[0]) and any(i >= 32 for i in got[0])


@pytest.mark.parametrize("n,k,n_keep,seed", [(40, 5, 10, 1), (24, 20, 8, 2),
                                              (64, 7, 64, 3)])
def test_dpc_knn_select_matches_jax(n, k, n_keep, seed):
    x = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    want = _np(js.dpc_knn_select(jnp.asarray(x), k=k, n_keep=n_keep))
    got = ts.dpc_knn_select(torch.from_numpy(x), k=k, n_keep=n_keep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dpc_knn_ties_pick_jax_integers():
    """Duplicated points tie in rho, delta and gamma: the peak's argmax and
    the top-k pick the lower index, as lax does."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(6, 4)).astype(np.float32)
    x = np.concatenate([base, base, base])
    want = _np(js.dpc_knn_select(jnp.asarray(x), k=3, n_keep=9))
    got = ts.dpc_knn_select(torch.from_numpy(x), k=3, n_keep=9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [3, 5, 40])
def test_frame_change_matches_jax(window):
    rng = np.random.default_rng(2)
    base = rng.normal(size=(16,)).astype(np.float32)
    frames = np.stack([base + rng.normal(scale=0.01, size=16)
                       for _ in range(30)]).astype(np.float32)
    frames[20] = -base
    frames[21] = -base + rng.normal(scale=0.01, size=16)
    feats = np.stack([frames, frames[::-1]])
    want = _np(js.frame_change_scores(jnp.asarray(feats), window))
    got = ts.frame_change_scores(torch.from_numpy(feats), window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    wi = js.frame_change_indices(jnp.asarray(feats), window)
    gi = ts.frame_change_indices(torch.from_numpy(feats), window)
    for g, w in zip(gi, wi):
        np.testing.assert_array_equal(g, w)
    if window == 3:
        assert any(19 <= i <= 22 for i in gi[0])


def test_attention_mass_and_keep_ratios_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 5, 8)).astype(np.float32)
    k = rng.normal(size=(1, 2, 12, 8)).astype(np.float32)
    want = _np(js.attention_mass_scores(jnp.asarray(q), jnp.asarray(k)))
    got = ts.attention_mass_scores(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-5)
    for ratios in ([0.5, 1.0], [0.34, 0.01]):
        w = _np(js.kept_token_indices(jnp.asarray(want), ratios, 6))
        g = ts.kept_token_indices(torch.tensor(want), ratios, 6)
        np.testing.assert_array_equal(g.numpy(), w)


STRATEGIES = ("filter_tokens_simple", "filter_tokens_percentile",
              "filter_tokens_magnitude", "filter_tokens_euclidean_distance",
              "filter_tokens_inverse_cosine", "filter_tokens_top_half")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_filter_tokens_matches_jax(strategy):
    rng = np.random.default_rng(4)
    toks = rng.normal(size=(24, 8)).astype(np.float32)
    mem = rng.normal(size=(8,)).astype(np.float32)
    want = _np(js.filter_tokens(strategy, jnp.asarray(toks),
                                jnp.asarray(mem), 6))
    got = ts.filter_tokens(strategy, torch.from_numpy(toks),
                           torch.from_numpy(mem), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    # batched rows give each row's own selection
    got2 = ts.filter_tokens(strategy, torch.from_numpy(np.stack([toks,
                                                                 toks])),
                            torch.from_numpy(np.stack([mem, mem])), 6)
    np.testing.assert_array_equal(got2.numpy(), np.stack([want, want]))


def test_filter_tokens_random_structure():
    """Half of each frame, distinct, inside its frame; the same under one
    generator seed, another under another."""
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.normal(size=(2, 40, 8)).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))

    def draw(seed):
        return ts.filter_tokens("filter_tokens_random", toks, mem, 8,
                                torch.Generator().manual_seed(seed)).numpy()

    a = draw(0)
    assert a.shape == (2, 20)
    for row in a:
        frames = row.reshape(5, 4)
        for f, fr in enumerate(frames):
            assert len(set(fr.tolist())) == 4
            assert ((fr >= 8 * f) & (fr < 8 * (f + 1))).all()
    np.testing.assert_array_equal(a, draw(0))
    assert not np.array_equal(a, draw(1))
    with pytest.raises(ValueError, match="Generator"):
        ts.filter_tokens("filter_tokens_random", toks, mem, 8)
    jidx = _np(js.filter_tokens("filter_tokens_random", jnp.asarray(toks[0]),
                                jnp.asarray(mem[0]), 8,
                                key=jax.random.key(0)))
    assert jidx.shape == a[0].shape


@pytest.mark.parametrize("n,chunk", [(10, 1), (29, 2), (30, 3), (4, 2)])
def test_chunked_topk_is_the_same_numpy(n, chunk):
    s = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    assert ts.chunked_topk(s, 6, chunk) == js.chunked_topk(s, 6, chunk)


@pytest.mark.parametrize("strategy", ["mean_dot", "aks", "dpc_knn",
                                      "l2norm"])
@pytest.mark.parametrize("n", [5, 37])
def test_select_blocks_matches_jax(strategy, n):
    rng = np.random.default_rng(n)
    reps = rng.normal(size=(n, 32)).astype(np.float32)
    q = rng.normal(size=(32,)).astype(np.float32)
    logits = reps @ q
    want = js.select_blocks(strategy, logits, reps, q, 8, 2)
    got = ts.select_blocks(strategy, logits, reps, q, 8, 2)
    assert got == want
    assert got == sorted(got) and 1 <= len(got) <= min(n, 8)
    with pytest.raises(ValueError):
        ts.select_blocks("cosine", logits, reps, q, 2, 1)
