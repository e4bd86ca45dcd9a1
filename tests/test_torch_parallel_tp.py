"""Tensor and data parallelism of the port (stc_tpu_torch.parallel) on a
dp 2 x tp 2 mesh of four gloo CPU ranks, against the JAX package's runs at
tests/test_sharding.py's tiny config (its 8-virtual-device dp 2 x tp 4 mesh
and one device) and against the port's unsharded runs, on the same numpy
params and inputs.  Integers (page counters, cursors, retrieved blocks,
cacher rows, answer ids) are exactly equal; floats to F32_TOL (1e-5).

The ranks run all of this file's cases in one launch (a module-scoped
fixture; tests/torch_parallel_worker.py); each rank imports torch and the
port only, on one thread.  Traps of a straight port are held here: the
fused wqkv / w_gateup split (an even split of the concatenation gives a
rank the wrong heads), the retrieval logits summed over this rank's heads
only, and the cacher's cosine over this rank's key channels only; each
naive version selects other integers on these inputs."""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu.parallel.mesh import make_mesh as j_make_mesh
from stc_tpu.parallel.sharding import (qwen2_param_specs, shard_pytree,
                                       stream_kv_specs)
from stc_tpu_torch import weights
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.parallel import dryrun
from stc_tpu_torch.parallel.mesh import Mesh
from stc_tpu_torch.parallel.sharding import (Split, shard_module,
                                             shard_tensor)
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
MCFG = jq.Qwen2Config(vocab_size=128, hidden_size=64, num_layers=2,
                      num_heads=8, num_kv_heads=4, head_dim=8,
                      intermediate_size=128, rope_base=10000.0)
REKV = ReKVConfig(n_init=4, n_local=128, block_size=8, exc_block_size=8,
                  topk=4, chunk_size=1, max_blocks=32,
                  max_prompt_tokens=16, max_new_tokens=4)
B = 2
TREES = ("plain", "int8", "int8_g16")


def _vlm_scfg(**rekv):
    kw = dict(n_init=4, n_local=48, block_size=4, exc_block_size=8, topk=4,
              max_blocks=32, max_prompt_tokens=16, max_new_tokens=6)
    kw.update(rekv)
    return SessionConfig(rekv=ReKVConfig(**kw),
                         cacher=CacherConfig(update_token_ratio=0.5),
                         pruner=PrunerConfig(token_per_frame=4),
                         encode_chunk_frames=2)


SESSIONS = {
    "cacher_pruner": _vlm_scfg(),
    "host_tier_aks": _vlm_scfg(max_blocks=10, n_local=24,
                               retrieval_scorer="aks", host_kv_quant="none"),
    "int4_pages_int8_g16": SessionConfig(
        rekv=_vlm_scfg(kv_quant="int4").rekv,
        cacher=CacherConfig(update_token_ratio=0.5),
        pruner=PrunerConfig(token_per_frame=4), encode_chunk_frames=2,
        weights_quant="int8_g16"),
}
QUESTIONS = [([5, 6, 7], [8, 9]), ([10, 11], [12, 13, 14])]


def _vlm_cfg():
    base = jlo.LlavaOVConfig.tiny()
    import dataclasses
    return jlo.LlavaOVConfig(vision=base.vision, text=dataclasses.replace(
        base.text, vocab_size=128))


def _cacher_pixels(rng, ratio=1.3):
    """Four frames of one stream and its reference frame (last): each
    frame is the reference plus noise whose amplitude differs from patch to
    patch by powers of `ratio`, so the cacher's cosines stand well apart at
    the cut (the closest pair 0.048 apart at the first layer)."""
    base = rng.normal(size=(1, 3, 56, 56))
    frames = []
    for _ in range(4):
        amp = np.kron((0.05 * ratio ** rng.permutation(16)).reshape(4, 4),
                      np.ones((14, 14)))[None, None]
        frames.append(base + amp * rng.normal(size=(1, 3, 56, 56)))
    return np.concatenate(frames + [base]).astype(np.float32)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    params = jq.init_params(MCFG, jax.random.key(0))
    fused = jq.fuse_params(params)
    trees = {"plain": params,
             "int8": jq.quantize_params_int8(fused, group_size=0),
             "int8_g16": jq.quantize_params_int8(fused, group_size=16)}
    vcfg = _vlm_cfg()
    vparams = jlo.init_random_params(vcfg, jax.random.key(1))
    d = dict(
        mcfg=port_model_cfg(MCFG), rekv=port_cfg(REKV),
        trees={k: np_tree(v) for k, v in trees.items()},
        ids=rng.integers(0, MCFG.vocab_size, size=(B, REKV.n_init)),
        feats=rng.normal(size=(B, REKV.block_size, MCFG.hidden_size)
                         ).astype(np.float32),
        q_embeds=rng.normal(size=(B, 4, MCFG.hidden_size)
                            ).astype(np.float32),
        dp_feats=rng.normal(size=(B, 3 * REKV.block_size, MCFG.hidden_size)
                            ).astype(np.float32),
        trap_feats=rng.normal(size=(B, 12 * REKV.block_size,
                                    MCFG.hidden_size)).astype(np.float32),
        vlm_tree=np_tree(vparams), vlm_cfg=port_model_cfg(vcfg),
        sessions={k: port_cfg(v) for k, v in SESSIONS.items()},
        frames=rng.integers(0, 256, (B, 12, 56, 56, 3), dtype=np.uint8),
        questions=QUESTIONS,
        trap_pixels=_cacher_pixels(rng))
    path = tmp_path_factory.mktemp("tp") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    ranks = dryrun.launch(4, "torch_parallel_worker:tp_cases", (str(path),),
                          timeout=240, env={"PYTHONPATH": os.pathsep.join(
                              [HERE, dryrun.ROOT])})
    return d, trees, ranks


def _jax_run(params, kvs, feats, q_embeds):
    """tests/test_sharding.py's _run."""
    _, kvs = jq.encode_step(params, MCFG, REKV, kvs, feats, is_init=False)
    dkvs = jq.init_decode_state(MCFG, REKV, B, jnp.float32)
    dkvs = jq.qa_retrieve_step(params, MCFG, REKV, kvs, dkvs, q_embeds)
    logits, dkvs = jq.decode_step(params, MCFG, REKV, dkvs, q_embeds,
                                  jnp.full((B,), q_embeds.shape[1]))
    return kvs.length, dkvs.cursor, logits


def _jax_inputs(params, d):
    kvs = jq.init_stream_state(MCFG, REKV, B, jnp.float32)
    _, kvs = jq.encode_step(params, MCFG, REKV, kvs,
                            jq.embed_tokens(params, jnp.asarray(d["ids"])),
                            is_init=True)
    return kvs, jnp.asarray(d["feats"]), jnp.asarray(d["q_embeds"])


def _port_step(d, tree):
    lm = weights.qwen2_from_jax(tree, d["mcfg"], device="cpu")
    kvs = lm.init_stream_state(d["rekv"], B, torch.float32)
    lm.encode_step(d["rekv"], kvs, lm.embed_tokens(torch.as_tensor(
        d["ids"])), is_init=True)
    lm.encode_step(d["rekv"], kvs, torch.as_tensor(d["feats"]),
                   is_init=False)
    q = torch.as_tensor(d["q_embeds"])
    dkvs = lm.init_decode_state(d["rekv"], B, torch.float32)
    dkvs, abs_idx, _ = lm.qa_retrieve_step(d["rekv"], kvs, dkvs, q)
    logits, dkvs = lm.decode_step(d["rekv"], dkvs, q, torch.full((B,), 4))
    return kvs.length.numpy(), dkvs.cursor.numpy(), logits.numpy(), \
        abs_idx.numpy()


@pytest.mark.parametrize("name", TREES)
def test_sharded_step_matches_jax_and_unsharded(case, name):
    """test_sharding's step (init prompt, an append, the retrieval forward,
    a decode step) on dp 2 x tp 2, with plain, int8 and int8_g16 weights:
    counters, cursors and blocks exactly equal to the port's unsharded
    step, logits to JAX's one-device step and (plain) to JAX's dp 2 x tp 4
    mesh step."""
    d, trees, ranks = case
    params = trees[name]
    want = jax.jit(_jax_run)(params, *_jax_inputs(params, d))
    p_len, p_cur, p_logits, p_idx = _port_step(d, d["trees"][name])
    for r in ranks:
        got = r[name]
        np.testing.assert_array_equal(got["length"], np.asarray(want[0]))
        np.testing.assert_array_equal(got["cursor"], np.asarray(want[1]))
        np.testing.assert_array_equal(got["length"], p_len)
        np.testing.assert_array_equal(got["cursor"], p_cur)
        np.testing.assert_array_equal(got["abs_idx"], p_idx)
        np.testing.assert_allclose(got["logits"], p_logits, **F32_TOL)
        np.testing.assert_allclose(got["logits"], np.asarray(want[2]),
                                   **F32_TOL)
    if name == "plain":
        mesh = j_make_mesh(dp=2, tp=4)
        from jax.sharding import NamedSharding, PartitionSpec as P
        kvs, feats, q = _jax_inputs(params, d)
        sh = NamedSharding(mesh, P("dp", None, None))
        got = jax.jit(_jax_run)(
            shard_pytree(params, qwen2_param_specs(), mesh),
            shard_pytree(kvs, stream_kv_specs(), mesh),
            jax.device_put(feats, sh), jax.device_put(q, sh))
        np.testing.assert_allclose(ranks[0][name]["logits"],
                                   np.asarray(got[2]), **F32_TOL)


def test_dp2_stream_matches_two_dp1_streams(case):
    """Each dp rank's stream holds what a one-stream run holds (the init
    prompt and three appends), against the port's and JAX's batch-1
    runs."""
    d, trees, ranks = case
    lm = weights.qwen2_from_jax(d["trees"]["plain"], d["mcfg"], device="cpu")
    S = REKV.block_size
    params = trees["plain"]
    for b in range(B):
        kvs = lm.init_stream_state(d["rekv"], 1, torch.float32)
        jkvs = jq.init_stream_state(MCFG, REKV, 1, jnp.float32)
        ids = d["ids"][b:b + 1]
        lm.encode_step(d["rekv"], kvs, lm.embed_tokens(torch.as_tensor(ids)),
                       is_init=True)
        _, jkvs = jq.encode_step(params, MCFG, REKV, jkvs, jq.embed_tokens(
            params, jnp.asarray(ids)), is_init=True)
        for i in range(3):
            sl = d["dp_feats"][b:b + 1, i * S:(i + 1) * S]
            lm.encode_step(d["rekv"], kvs, torch.as_tensor(sl),
                           is_init=False)
            _, jkvs = jq.encode_step(params, MCFG, REKV, jkvs,
                                     jnp.asarray(sl), is_init=False)
        for r in ranks:
            got = r["dp_block_k"][:, b]
            np.testing.assert_allclose(got, kvs.block_k[:, 0].numpy(),
                                       **F32_TOL)
            np.testing.assert_allclose(got, np.asarray(jkvs.block_k)[:, 0],
                                       **F32_TOL)


def _port_vlm(d, name):
    model = weights.params_from_jax(d["vlm_tree"], d["vlm_cfg"],
                                    device="cpu")
    sess = tlo.build_session(model, d["sessions"][name],
                             state_dtype=torch.float32, device="cpu",
                             batch=B)
    sess.encode_init_prompt([1, 2, 3, 4])
    n = sess.scfg.encode_chunk_frames
    for s in range(0, d["frames"].shape[1], n):
        sess.encode_video(d["frames"][:, s:s + n])
    out = []
    for q, p in QUESTIONS:
        out.append((sess.question_answering(q, p, [0], max_new_tokens=6,
                                            all_streams=True),
                    sess.last_retrieved_indices))
    return {"qa": out, "evicted": sess._evicted_pages}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_vlm_session_matches_unsharded(case, name):
    """The LLaVA-OV pixel session (tower with the cacher, projector,
    pooling, pruner, LM appends, retrieval QA, decode) on dp 2 x tp 2 with
    the cacher and pruner on; then with the host tier (evictions) and the
    aks scorer; then on int4 pages with int8_g16 weights: answers and every
    layer's blocks of both streams equal to the unsharded session's, on
    every rank."""
    d, _, ranks = case
    want = _port_vlm(d, name)
    if name == "host_tier_aks":
        assert want["evicted"] > 0
    for r in ranks:
        assert r["sessions"][name] == want, (r["sessions"][name], want)


def test_fused_split_gives_each_rank_its_heads():
    """Trap: the fused wqkv holds [q | k | v]; a rank must hold q, k and v
    heads of its own, each part split by heads.  On a layout-only tp 2
    mesh, each rank's q/k/v equal the unsharded module's heads of that
    rank; an even split of the concatenation (what the JAX spec writes)
    does not."""
    from stc_tpu_torch.models import qwen2 as tq
    cfg = tq.Qwen2Config.tiny()
    full = tq.Qwen2(cfg, dtype=torch.float32, device="cpu")
    full.init_random_params(torch.Generator().manual_seed(0), scale=0.5)
    h = torch.randn((1, 3, cfg.hidden_size), generator=torch.Generator(
    ).manual_seed(1))
    q, k, v = full._qkv(full.layers[0], h)
    for r in range(2):
        part = tq.Qwen2(cfg, dtype=torch.float32, device="cpu")
        part.load_state_dict(full.state_dict())
        shard_module(part, Mesh(("dp", "tp"), (1, 2),
                                coord={"dp": 0, "tp": r}))
        ql, kl, vl = part._qkv(part.layers[0], h)
        hq, hk = cfg.num_heads // 2, cfg.num_kv_heads // 2
        torch.testing.assert_close(ql, q[:, r * hq:(r + 1) * hq])
        torch.testing.assert_close(kl, k[:, r * hk:(r + 1) * hk])
        torch.testing.assert_close(vl, v[:, r * hk:(r + 1) * hk])
        g, u = part._mm(h, part.layers[0], "w_gateup").chunk(2, dim=-1)
        gf, uf = full._mm(h, full.layers[0], "w_gateup").chunk(2, dim=-1)
        F2 = cfg.intermediate_size // 2
        torch.testing.assert_close(g, gf[..., r * F2:(r + 1) * F2])
        torch.testing.assert_close(u, uf[..., r * F2:(r + 1) * F2])
        # the naive even split of the concatenation: rank 0 would hold
        # only q heads, rank 1 the rest of q and all of k and v
        naive = shard_tensor(full.layers[0].wqkv, Split(-1), r, 2)
        assert naive.shape == part.layers[0].wqkv.shape
        assert not torch.equal(naive, part.layers[0].wqkv)


def test_retrieval_logits_reduced_over_tp(case):
    """Trap: each tp rank's rep-key logits cover its own kv heads; the
    top-k of the unreduced logits picks other blocks than the unsharded
    retrieval on these inputs, the all_reduced ones the same."""
    d, trees, ranks = case
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.kvcache.state import layer
    from stc_tpu_torch.models import qwen2 as tq
    lm = weights.qwen2_from_jax(d["trees"]["plain"], d["mcfg"], device="cpu")
    kvs = lm.init_stream_state(d["rekv"], B, torch.float32)
    lm.encode_step(d["rekv"], kvs, lm.embed_tokens(torch.as_tensor(
        d["ids"])), is_init=True)
    T = REKV.exc_block_size
    for s in range(0, d["trap_feats"].shape[1], T):
        lm.encode_step(d["rekv"], kvs,
                       torch.as_tensor(d["trap_feats"][:, s:s + T]),
                       is_init=False)
    q, _, _ = lm._qkv(lm.layers[0], tq.rms_norm(
        torch.as_tensor(d["q_embeds"]), lm.layers[0].ln1, lm.cfg.rms_eps))
    want = engine.score_blocks(layer(kvs, 0), q, d["rekv"])[0].numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["traps"]["retrieval_port"][0], want)
    assert any(not np.array_equal(r["traps"]["retrieval_naive"][0], want)
               for r in ranks)


def test_cacher_cosine_reduced_over_tp(case):
    """Trap: the cacher's cosine spans the whole key width, which tp
    splits by heads; the rows picked from one rank's channels differ from
    the unsharded rows on these inputs, the all_reduced ones are equal on
    every rank."""
    d, _, ranks = case
    model = weights.params_from_jax(d["vlm_tree"], d["vlm_cfg"],
                                    device="cpu")
    tower = model.vision
    px = torch.as_tensor(d["trap_pixels"])
    lp = tower.layers[0]
    _, saved = lp.full(tower.patch_embed(px[-1:]), tower.cfg)
    refs = tuple(x[-1:] for x in saved)
    _, want = lp.cached(tower.patch_embed(px[:-1]), refs,
                        tower.cfg.num_tokens // 4, tower.cfg)
    for r in ranks:
        np.testing.assert_array_equal(r["traps"]["cacher_port"],
                                      want.numpy())
    assert any(not np.array_equal(r["traps"]["cacher_naive"], want.numpy())
               for r in ranks)


def test_dryrun_multichip_on_cpu_ranks():
    """``python -m stc_tpu_torch.parallel.dryrun --device cpu``: every
    layout of the dry run, on four gloo CPU ranks, answers as its
    unsharded session (dryrun_multichip raises otherwise)."""
    recs = dryrun.dryrun_multichip(4, timeout=240, device="cpu")
    assert [r["case"] for r in recs] == [
        "dp x tp step", "host tier + aks scorer",
        "int4 pages + int8_g16 weights",
        "ragged ingest, slot reset, serving tick",
        "dp x sp x tp: sp vision and sp LM appends", "pp x tp session"]
    assert recs[1]["evicted_pages"] > 0
