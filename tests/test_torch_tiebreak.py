"""One tie rule for every top-k of the port: ``jax.lax.top_k``'s, the lower
index first among equal values (stc_tpu_torch/ops/topk.py).

Ties are planted exactly (duplicated rows, negated channels, repeated
logits), so the packages' float differences cannot decide them: the port
must pick stc_tpu's integers.  ``torch.topk`` breaks ties in no stated order
(on the CPU it often puts a higher index first), so each of these tests
picked other integers before the port's top-k sites went through the
helper.  Integers are compared exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.compress import pruner as jp
from stc_tpu.config import ReKVConfig
from stc_tpu.kvcache import engine as je
from stc_tpu.models import qwen2 as jq
from stc_tpu.models import siglip as jsg
from stc_tpu_torch import weights
from stc_tpu_torch.compress import pruner as tp
from stc_tpu_torch.kvcache import engine as te
from stc_tpu_torch.models.qwen2 import build_spec_ctx
from stc_tpu_torch.ops.topk import (argmax_lowest, order_key, top2_lowest,
                                    topk_lowest)
from test_torch_common import (np_tree, one_thread, port_cfg,  # noqa: F401
                               port_model_cfg, tt)

pytestmark = pytest.mark.usefixtures("one_thread")

VALUES = np.array([-np.inf, -1.0, -0.0, 0.0, 0.5, 1.0, np.inf], np.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_helpers_follow_lax_top_k_on_tie_heavy_rows(dtype):
    """Rows drawn from seven values (signed zeros and infinities too), so
    almost every row ties: topk_lowest's indices and values, top2_lowest
    and argmax_lowest equal lax.top_k's at every k."""
    rng = np.random.default_rng(0)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    for _ in range(60):
        n = int(rng.integers(2, 40))
        x = rng.choice(VALUES, size=(3, n))
        xj, xt = jnp.asarray(x, dtype), torch.from_numpy(x).to(tdt)
        for k in {1, 2, int(rng.integers(1, n + 1)), n}:
            vj, ij = jax.lax.top_k(xj, k)
            vt, it = topk_lowest(xt, k)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_array_equal(vt.float().numpy(),
                                          np.asarray(vj, np.float32))
        two = np.asarray(jax.lax.top_k(xj, 2)[1])
        np.testing.assert_array_equal(top2_lowest(xt).numpy(), two)
        np.testing.assert_array_equal(argmax_lowest(xt).numpy(), two[:, 0])


def test_order_key_is_the_float_total_order():
    x = torch.tensor([-np.inf, -2.0, -0.0, 0.0, 1e-45, 3.0, np.inf])
    assert torch.all(order_key(x)[1:] > order_key(x)[:-1])
    assert torch.equal(order_key(torch.arange(5)), torch.arange(5))


# --------------------------------------------------------------------- #
# the greedy pick (and the lookahead loop's) on planted tied logits
# --------------------------------------------------------------------- #

REKV = ReKVConfig(n_init=4, n_local=128, block_size=8, exc_block_size=8,
                  topk=4, max_blocks=16, max_prompt_tokens=16,
                  max_new_tokens=8, spec_decode_draft=3)


def _prefilled(seed=5, dtype="float32"):
    """Both LMs (weights and caches in dtype) and their decode caches
    after one 8-token prompt."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg = jq.Qwen2Config.tiny()
    params = jq.init_params(cfg, jax.random.key(seed), dtype=jdt)
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(cfg),
                                dtype=tdt, device="cpu")
    ids = np.arange(1, 9, dtype=np.int32)[None]
    jd = jq.init_decode_state(cfg, REKV, 1, jdt)
    _, jd = jq.decode_step(params, cfg, REKV, jd,
                           jq.embed_tokens(params, jnp.asarray(ids)),
                           jnp.asarray([8], jnp.int32))
    pk = port_cfg(REKV)
    td = lm.init_decode_state(pk, 1, tdt)
    _, td = lm.decode_step(pk, td, lm.embed_tokens(torch.from_numpy(ids)),
                           torch.tensor([8], dtype=torch.int32))
    return cfg, params, lm, pk, jd, td


# (tied maximum's indices, stop ids, stc_tpu's first token): a three-way
# tie; a four-way tie whose two lowest indices are stop tokens, so step 0
# takes the second choice, itself a stop token; stop tokens tied above a
# plain one
CASES = {"three_way": ([40, 90, 200], [0], 40),
         "stop_lowest": ([40, 90, 150, 200], [40, 90], 90),
         "stop_tied_above": ([17, 30, 31, 250], [31, 250], 17)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_pick_on_tied_logits_matches_jax(case, dtype):
    """Planted tied maxima in the prompt's last logits: greedy_decode's
    first token (with the anti-stop rule at step 0) and the answer after
    it equal stc_tpu's greedy_decode; lookahead_decode commits the same
    first token."""
    cfg, params, lm, pk, jd, td = _prefilled(dtype=dtype)
    tied, stop, first = CASES[case]
    row = np.random.default_rng(1).normal(size=(1, cfg.vocab_size))
    row = row.astype(np.float32)
    row[0, tied] = row.max() + 1.0
    stops = np.full((4,), -1, np.int32)
    stops[:len(stop)] = stop
    tj, cj, _ = jq.greedy_decode(params, cfg, REKV, jd,
                                 jnp.asarray(row, getattr(jnp, dtype)),
                                 jnp.asarray(stops), 4)
    tt_, ct, _ = lm.greedy_decode(pk, td, torch.from_numpy(row).to(
        getattr(torch, dtype)), torch.from_numpy(stops), 4)
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(tt_[0, 0]) == first


def test_lookahead_on_tied_logits_matches_greedy():
    """The speculative loop picks with the same rule: on the planted tie
    whose two lowest indices are stop tokens, lookahead_decode's tokens and
    count equal greedy_decode's."""
    tied, stop, first = CASES["stop_lowest"]
    stops = torch.tensor(stop + [-1, -1], dtype=torch.int32)
    ids = torch.arange(1, 9, dtype=torch.int32)[None]
    n = torch.tensor([8], dtype=torch.int32)
    c_ids, c_len = build_spec_ctx(ids, n, ids, n, 4)
    out = []
    for spec in (False, True):
        cfg, _, lm, pk, _, td = _prefilled()
        row = torch.zeros((1, cfg.vocab_size))
        row[0, tied] = 1.0
        if spec:
            out.append(lm.lookahead_decode(pk, td, row, stops, 4, c_ids,
                                           c_len)[:2])
        else:
            out.append(lm.greedy_decode(pk, td, row, stops, 4)[:2])
    assert int(out[0][0][0, 0]) == first
    for g, s in zip(*out):
        assert torch.equal(g, s)


# --------------------------------------------------------------------- #
# block retrieval, the cacher's recompute rows, the pruner's picks
# --------------------------------------------------------------------- #

def test_block_retrieval_on_tied_scores_matches_jax():
    """Ten blocks share one rep key (equal scores above the rest): the
    top 4 are the lowest of them, as in stc_tpu's score_blocks, at
    chunk_size 1 (blocks) and 2 (four tied pairs, two kept)."""
    for cs, want in ((1, [3, 6, 7, 10]), (2, [6, 7, 10, 11])):
        cfg = ReKVConfig(n_init=4, n_local=64, block_size=8,
                         exc_block_size=8, topk=4, chunk_size=cs,
                         max_blocks=16, max_rep_blocks=32)
        rng = np.random.default_rng(cs)
        jkv = je.init_stream_kv(cfg, 2, 2, 16, jnp.float32)
        rep = rng.normal(size=(2, 32, 2, 16)).astype(np.float32) * 0.1
        q = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
        tied = [3, 6, 7, 10, 11, 12, 13, 16, 17, 20]
        rep[:, tied] = q.mean(axis=2).reshape(2, 2, 2, 16).mean(axis=2)[
            :, None] * 4.0
        jkv = jkv._replace(block_rep=jnp.asarray(rep),
                           num_blocks=jnp.asarray([24, 24], jnp.int32))
        tkv = te.init_stream_kv(port_cfg(cfg), 2, 2, 16, torch.float32,
                                device="cpu")
        tkv = tkv._replace(block_rep=torch.from_numpy(rep),
                           num_blocks=torch.tensor([24, 24],
                                                   dtype=torch.int32))
        ij, ej = je.score_blocks(jkv, jnp.asarray(q), cfg)
        it, et = te.score_blocks(tkv, tt(q), port_cfg(cfg))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        assert it[0].tolist() == it[1].tolist() == want


def test_cacher_rows_on_tied_similarities_match_jax():
    """Eight tokens of a frame are copies of one token and their reference
    keys copies of one random vector, so their similarities tie below the
    rest: the recomputed rows are the lowest of them, as stc_tpu's
    lax.top_k(-sim) picks (siglip._layer_cached's selection)."""
    cfg = jsg.SiglipConfig.tiny()
    params = jsg.init_params(cfg, jax.random.key(3))
    tower = weights.siglip_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    lp = jax.tree.map(lambda x: x[0], params["layers"])
    rng = np.random.default_rng(3)
    T, C = cfg.num_tokens, cfg.hidden_size
    h = rng.normal(size=(2, T, C)).astype(np.float32)
    tied = [2, 4, 5, 8, 9, 11, 13, 14]
    h[:, tied] = h[:, 2:3]
    hn = jsg.layer_norm(jnp.asarray(h), lp["ln1_w"], lp["ln1_b"],
                        cfg.layer_norm_eps)
    ref_k = np.asarray(hn @ lp["wk"] + lp["bk"])[:1].copy()
    ref_k[:, tied] = rng.normal(size=(C,)).astype(np.float32)
    refs = (ref_k,) + tuple(rng.normal(size=(1, T, C)).astype(np.float32)
                            for _ in range(3))
    k = hn @ lp["wk"] + lp["bk"]
    r = jnp.asarray(ref_k)
    sim = jnp.sum(k * r, -1) / (jnp.linalg.norm(k, axis=-1)
                                * jnp.linalg.norm(r, axis=-1) + 1e-8)
    U = 5
    want = np.sort(np.asarray(jax.lax.top_k(-sim, U)[1]), axis=-1)
    assert want[0].tolist() == tied[:U]
    _, got = tower.layers[0].cached(tt(h), tuple(tt(x) for x in refs), U,
                                    tower.cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pruner_picks_on_tied_scores_match_jax():
    """Ten lowest-variance channels tie exactly (copies of one channel and
    of its negation), eight kept; and tokens repeated within each frame tie
    in the combined score: stc_prune's keeps, and its running memory over
    two chunks, equal stc_tpu's."""
    rng = np.random.default_rng(4)
    B, F_, Tin, C, keep = 2, 2, 12, 16, 5
    state_j = jp.init_pruner_state(B, C // 2)
    state_t = tp.init_pruner_state(B, C // 2, device="cpu")
    for chunk in range(2):
        x = rng.normal(size=(B, F_, Tin, C)).astype(np.float32)
        low = 0.01 * rng.normal(size=(B, F_, Tin)).astype(np.float32)
        for j, c in enumerate([0, 2, 3, 5, 7, 8, 10, 11, 13, 14]):
            x[..., c] = low if j % 2 == 0 else -low
        x[:, :, [1, 4, 6, 9]] = x[:, :, 1:2]
        pj, ij, state_j = jp.stc_prune(jnp.asarray(x), state_j, keep, 0.5)
        pt, it, state_t = tp.stc_prune(tt(x), state_t, keep, 0.5)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(state_t.mean_sum.numpy(),
                                   np.asarray(state_j.mean_sum),
                                   rtol=1e-6, atol=1e-7)
