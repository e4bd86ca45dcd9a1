"""The port's token-reduction baselines (stc_tpu_torch/compress/
experiments.py) and the pruner's map_indices_grid against stc_tpu's
(tests/test_experiments.py's cases, tests/test_vision.py's grid mapping),
on the same numpy inputs: indices, masks and positions equal, floats
within F32_TOL."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.compress import experiments as je
from stc_tpu.compress import pruner as jp
from stc_tpu_torch.compress import experiments as te
from stc_tpu_torch.compress import pruner as tp
from test_torch_common import F32_TOL


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **F32_TOL)


def _both_tome(metric, x, sizes, r):
    want = je.tome_merge(jnp.asarray(metric), jnp.asarray(x),
                         jnp.asarray(sizes), r)
    got = te.tome_merge(torch.from_numpy(metric), torch.from_numpy(x),
                        torch.from_numpy(sizes), r)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    return got


def test_tome_merges_most_similar_pairs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    x[0] = x[1] + 1e-3
    metric = x / np.linalg.norm(x, axis=1, keepdims=True)
    merged, sizes, keep = _both_tome(metric, x, np.ones(8, np.float32), 1)
    keep = keep.numpy()
    assert not keep[0] and keep[1] and keep.sum() == 7
    np.testing.assert_allclose(sizes[1].item(), 2.0)
    np.testing.assert_allclose(merged[1].numpy(), (x[0] + x[1]) / 2,
                               rtol=1e-5)


@pytest.mark.parametrize("r", [0, 3, 50])
def test_tome_matches_jax(r):
    rng = np.random.default_rng(r + 1)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    sizes = rng.integers(1, 4, size=16).astype(np.float32)
    _, _, keep = _both_tome(x, x, sizes, r)
    assert int(keep.sum()) == 16 - min(r, 8)


def test_dbdpc_reduce_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(scale=0.05, size=(10, 3)) + np.array([5, 0, 0])
    b = rng.normal(scale=0.05, size=(10, 3)) - np.array([5, 0, 0])
    x = np.concatenate([a, b]).astype(np.float32)
    want = je.dbdpc_reduce(jnp.asarray(x), n_keep=2, k=3)
    got = te.dbdpc_reduce(torch.from_numpy(x), n_keep=2, k=3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0])
    means = sorted(got[0].numpy()[:, 0])
    assert means[0] < -4.5 and means[1] > 4.5
    y = np.random.default_rng(3).normal(size=(30, 5)).astype(np.float32)
    want = je.dbdpc_reduce(jnp.asarray(y), n_keep=7)
    got = te.dbdpc_reduce(torch.from_numpy(y), n_keep=7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0])


def _sttm_case(H, seed, homogeneous_cells=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(H, H, 8)).astype(np.float32)
    for (y, x0) in homogeneous_cells:  # a near-identical 2x2 region
        base = x[y, x0]
        for dy in range(2):
            for dx in range(2):
                x[y + dy, x0 + dx] = base + rng.normal(scale=1e-4, size=8)
    return x


@pytest.mark.parametrize("H,seed,cells,thr", [
    (8, 3, [(0, 0), (4, 2)], 0.9),
    (7, 5, [(2, 2)], 0.0)])
def test_sttm_quadtree_matches_jax(H, seed, cells, thr):
    x = _sttm_case(H, seed, cells)
    jw = je.sttm_quadtree_candidates(jnp.asarray(x), thr)
    tw = te.sttm_quadtree_candidates(torch.from_numpy(x), thr)
    for j_lvls, t_lvls in zip(jw, tw):
        assert len(j_lvls) == len(t_lvls)
        for j, t in zip(j_lvls, t_lvls):
            if t.dtype == torch.bool:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                _close(t, j)
    for budget in (H * H, 10):
        want = je.sttm_merge(jnp.asarray(x.reshape(-1, 8)), budget, thr)
        got = te.sttm_merge(torch.from_numpy(x.reshape(-1, 8)), budget, thr)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0])


def test_sttm_budget_selection_properties():
    x = _sttm_case(8, seed=7, homogeneous_cells=[(0, 0)])
    _, p_all, v_all = te.sttm_merge(torch.from_numpy(x.reshape(-1, 8)), 84,
                                    0.9)
    budget = int(v_all.sum()) - 3
    t, p, v = te.sttm_merge(torch.from_numpy(x.reshape(-1, 8)), budget, 0.9)
    assert v.all() and tuple(t.shape) == (budget, 8)
    full = {tuple(int(i) for i in q) for q, ok in zip(p_all.numpy(),
                                                      v_all.numpy())
            if ok and q[2] < 2}
    assert full <= {tuple(int(i) for i in q) for q in p.numpy()}


@pytest.mark.parametrize("n_clusters,iters", [(2, 10), (5, 3)])
def test_kmeans_iterations_match_jax_from_its_draw(n_clusters, iters):
    """The port's Lloyd iterations from JAX's own initial draw give JAX's
    centroids and assignment (the draw itself is JAX's threefry)."""
    rng = np.random.default_rng(4)
    a = rng.normal(scale=0.05, size=(12, 3)) + np.array([4, 0, 0])
    b = rng.normal(scale=0.05, size=(12, 3)) - np.array([4, 0, 0])
    x = np.concatenate([a, b, rng.normal(size=(6, 3))]).astype(np.float32)
    key = jax.random.key(0)
    init = np.asarray(jax.random.choice(key, x.shape[0], (n_clusters,),
                                        replace=False))
    want = je.kmeans_select(jnp.asarray(x), n_clusters, iters, key=key)
    got = te.kmeans_iterate(torch.from_numpy(x), torch.tensor(init),
                            iters)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0])


def test_kmeans_select_two_clusters():
    rng = np.random.default_rng(4)
    a = rng.normal(scale=0.05, size=(12, 3)) + np.array([4, 0, 0])
    b = rng.normal(scale=0.05, size=(12, 3)) - np.array([4, 0, 0])
    x = torch.from_numpy(np.concatenate([a, b]).astype(np.float32))
    found = 0
    for seed in range(4):
        cent, assign = te.kmeans_select(
            x, 2, generator=torch.Generator().manual_seed(seed))
        init = te.kmeans_init(24, 2, torch.Generator().manual_seed(seed))
        assert len(set(init.tolist())) == 2
        if sorted(np.round(cent[:, 0].numpy())) == [-4.0, 4.0]:
            found += 1
            assign = assign.numpy()
            assert len(set(assign[:12])) == 1 and len(set(assign[12:])) == 1
    assert found >= 1


def test_select_top_half_kv_matches_jax():
    rng = np.random.default_rng(0)
    B, Hkv, Hq, S, F, D = 2, 2, 4, 7, 3, 8
    T = F * S
    k = rng.normal(size=(B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T, D)).astype(np.float32)
    o = rng.normal(size=(B, Hq, T, D)).astype(np.float32)
    want = je.select_top_half_kv(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(o), S)
    got = te.select_top_half_kv(torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(o), S)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert tuple(got[0].shape) == (B, Hkv, F * 4, D)


@pytest.mark.parametrize("grid,K", [(13, 5), (4, 3)])
def test_map_indices_grid_matches_jax(grid, K):
    rng = np.random.default_rng(grid)
    idx = np.stack([np.sort(rng.choice(grid * grid, K, replace=False))
                    for _ in range(6)]).reshape(2, 3, K).astype(np.int32)
    want = np.asarray(jp.map_indices_grid(jnp.asarray(idx), grid))
    got = tp.map_indices_grid(torch.from_numpy(idx), grid).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 3 * (K + grid))
    if grid == 13:  # test_vision.py's example: (0,0), (1,0), (12,12)
        one = tp.map_indices_grid(torch.tensor([[[0, 13, 168]]]), 13)
        assert one[0, :3].tolist() == [0, 14, 12 * 14 + 12]
        assert one[0, 3:].tolist() == [13 + 14 * r for r in range(13)]
