"""Sequence parallelism of the port (stc_tpu_torch.parallel) on four gloo
CPU ranks, meshes dp 2 x sp 2 and sp 2 x tp 2, against the JAX package's
runs at tests/test_sp.py's tiny configs (its dp 2 x sp 2 x tp 2 mesh and
one device) and the port's unsharded runs, on the same numpy params and
inputs: sp vision (a chunk's frames over sp, the pooled features gathered
before the pruner, the cacher references broadcast from the last sp rank)
and sp LM appends (each sp rank's queries at their own offset, the
chunk's K/V rows gathered).  Integers (pruner keeps, page counters,
answer ids, blocks) exactly equal; floats to F32_TOL (1e-5).

One launch runs every case (tests/torch_parallel_worker.py).  The trap of
a straight port held here: pruning each sp rank's frames alone (the
pruner's channel variance and chunk mean span the whole chunk) keeps
other tokens on these inputs."""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stc_tpu.compress.pruner import init_pruner_state, stc_prune
from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu.models import siglip as jsg
from stc_tpu.parallel.mesh import make_mesh as j_make_mesh
from stc_tpu.parallel.sharding import (projector_param_specs,
                                       qwen2_param_specs, shard_pytree,
                                       shard_vision_sp, siglip_param_specs,
                                       stream_kv_specs)
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import weights
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.parallel import dryrun
from stc_tpu_torch.parallel.mesh import Mesh
from stc_tpu_torch.runtime.session import StreamingSession
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
B, F = 2, 4
MESHES = ("dp2_sp2", "sp2_tp2")
INIT_IDS = np.asarray([[1, 2, 3, 4]] * B)


def _vis_cfgs():
    vcfg = jsg.SiglipConfig(hidden_size=32, num_layers=2, num_heads=4,
                            intermediate_size=64, image_size=56,
                            patch_size=14)
    mcfg = jq.Qwen2Config(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          intermediate_size=128, rope_base=10000.0)
    cfg = jlo.LlavaOVConfig(vision=vcfg, text=mcfg)
    S = cfg.tokens_per_frame
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=32, block_size=S,
                        exc_block_size=S * F, topk=4, chunk_size=1,
                        max_blocks=32, max_prompt_tokens=16,
                        max_new_tokens=4),
        cacher=CacherConfig(update_token_ratio=0.25),
        pruner=PrunerConfig(token_per_frame=S, channel_keep_ratio=0.5))
    return cfg, scfg


LM_CFG = jq.Qwen2Config(vocab_size=128, hidden_size=64, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=16,
                        intermediate_size=128, rope_base=10000.0)
LM_REKV = ReKVConfig(n_init=4, n_local=64, block_size=8, exc_block_size=16,
                     topk=4, chunk_size=1, max_blocks=32,
                     max_prompt_tokens=16, max_new_tokens=8,
                     host_kv_quant="none")
Q, PR = [5, 6], [7, 8, 9]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    cfg, scfg = _vis_cfgs()
    params = jlo.init_random_params(cfg, jax.random.key(0))
    lm_params = jq.init_params(LM_CFG, jax.random.key(3))
    rng = np.random.default_rng(1)
    pixels = rng.normal(size=(B * F, 3, 56, 56)).astype(np.float32)
    lm_feats = np.random.default_rng(4).normal(
        size=(B, 8 * 16, LM_CFG.hidden_size)).astype(np.float32)
    d = dict(vis_tree=np_tree(params), vis_cfg=port_model_cfg(cfg),
             vis_scfg=port_cfg(scfg), vis_B=B, vis_F=F, vis_pixels=pixels,
             lm_tree=np_tree(lm_params), lm_cfg=port_model_cfg(LM_CFG),
             lm_scfg=port_cfg(SessionConfig(rekv=LM_REKV)),
             lm_feats=lm_feats, lm_q=Q, lm_p=PR)
    path = tmp_path_factory.mktemp("sp") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    ranks = dryrun.launch(4, "torch_parallel_worker:sp_cases", (str(path),),
                          timeout=240, env={"PYTHONPATH": os.pathsep.join(
                              [HERE, dryrun.ROOT])})
    return d, params, lm_params, ranks


def _jax_vision_step(params, cfg, scfg, pixels, sharded):
    """tests/test_sp.py's step (one device, or its dp 2 x sp 2 x tp 2
    mesh)."""
    vcfg, mcfg = cfg.vision, cfg.text
    S = cfg.tokens_per_frame
    kvs0 = jq.init_stream_state(mcfg, scfg.rekv, B, jnp.float32)
    _, kvs0 = jq.encode_step(params["text"], mcfg, scfg.rekv, kvs0,
                             jq.embed_tokens(params["text"],
                                             jnp.asarray(INIT_IDS)),
                             is_init=True)
    cacher0 = jsg.init_cacher_state(vcfg, B)
    pstate0 = init_pruner_state(B, int(mcfg.hidden_size * 0.5))

    def step(params, pixels, kvs, cacher, pstate):
        feats, cacher = jsg.encode_full(params["vision"], vcfg, pixels,
                                        cacher, n_streams=B)
        feats = jlo.project(params["projector"], feats)
        feats = jlo.apply_pooling(feats, vcfg.grid)
        BF, T, E = feats.shape
        pruned, idx, pstate = stc_prune(feats.reshape(B, F, T, E), pstate,
                                        keep_per_frame=S,
                                        channel_keep_ratio=0.5)
        flat = pruned.reshape(B, F * S, E)
        _, kvs = jq.encode_step(params["text"], mcfg, scfg.rekv, kvs, flat,
                                is_init=False)
        return flat, idx, kvs, cacher

    if not sharded:
        return jax.jit(step)(params, pixels, kvs0, cacher0, pstate0)
    mesh = j_make_mesh(dp=2, tp=2, sp=2)
    sparams = {
        "vision": shard_pytree(params["vision"], siglip_param_specs(), mesh),
        "projector": shard_pytree(params["projector"],
                                  projector_param_specs(), mesh),
        "text": shard_pytree(params["text"], qwen2_param_specs(), mesh)}
    pix_sh, cacher_sh = shard_vision_sp(mesh)
    return jax.jit(step)(
        sparams, jax.device_put(pixels, NamedSharding(mesh, pix_sh)),
        shard_pytree(kvs0, stream_kv_specs(), mesh),
        jax.device_put(cacher0, NamedSharding(mesh, cacher_sh)),
        jax.device_put(pstate0, NamedSharding(mesh, P("dp"))))


def _port_vision(d):
    model = weights.params_from_jax(d["vis_tree"], d["vis_cfg"],
                                    device="cpu")
    scfg = d["vis_scfg"]
    vis = tlo.LlavaOVVision(model, scfg, batch=B)
    vstate, pstate = vis.init_state()
    kvs = model.text.init_stream_state(scfg.rekv, B, torch.float32)
    model.text.encode_step(scfg.rekv, kvs, model.text.embed_tokens(
        torch.as_tensor(INIT_IDS)), is_init=True)
    px = torch.as_tensor(d["vis_pixels"])
    flat, idx, vstate, pstate2 = vis.encode(px, vstate, pstate, False)
    model.text.encode_step(scfg.rekv, kvs, flat, is_init=False)
    flat2, _, _ = vis.cached(px + 0.05, vstate, pstate2)
    return flat, idx, kvs, vstate, flat2


@pytest.mark.parametrize("mesh", MESHES)
def test_sp_vision_matches_jax_and_unsharded(case, mesh):
    """A chunk's frames over (dp, sp) (and the tower, projector and LM over
    tp): the pruned features, every StreamKV leaf and the cacher
    references equal JAX's one-device and dp x sp x tp runs and the
    port's unsharded run; the next (cacher) chunk's features equal the
    unsharded one's."""
    d, params, _, ranks = case
    cfg, scfg = _vis_cfgs()
    want = _jax_vision_step(params, cfg, scfg, d["vis_pixels"], False)
    mesh_j = _jax_vision_step(params, cfg, scfg, d["vis_pixels"], True)
    flat, _, kvs, vstate, flat2 = _port_vision(d)
    for r in ranks:
        got = r[mesh]["vision"]
        np.testing.assert_allclose(got["flat"], np.asarray(want[0]),
                                   **F32_TOL)
        np.testing.assert_allclose(got["flat"], np.asarray(mesh_j[0]),
                                   **F32_TOL)
        np.testing.assert_allclose(got["flat"], flat.numpy(), **F32_TOL)
        np.testing.assert_allclose(got["flat_cached"], flat2.numpy(),
                                   **F32_TOL)
        for name in kvs._fields:
            want_leaf = np.asarray(getattr(want[2], name))
            if name in ("num_blocks", "page_offset", "length"):
                np.testing.assert_array_equal(got["kvs"][name], want_leaf)
            else:
                np.testing.assert_allclose(got["kvs"][name], want_leaf,
                                           err_msg=name, **F32_TOL)
        np.testing.assert_allclose(got["ref_k"],
                                   np.asarray(want[3].ref_k), **F32_TOL)
        np.testing.assert_allclose(got["ref_attn"], vstate.ref_attn.numpy(),
                                   **F32_TOL)


def test_pruning_before_the_sp_gather_keeps_other_tokens(case):
    """Trap: the pruner's channel variance and chunk mean span every frame
    of a chunk, so its keeps need the whole chunk on every sp rank.  With
    half of each frame's tokens kept, the port's dp 2 x sp 2 keeps
    (features gathered, then pruned) equal the unsharded port's and JAX's
    stc_prune on the same features; pruning each sp rank's frames alone
    keeps other tokens on these inputs."""
    import dataclasses
    from stc_tpu.compress.pruner import stc_prune as j_prune
    d, _, _, ranks = case
    model = weights.params_from_jax(d["vis_tree"], d["vis_cfg"],
                                    device="cpu")
    scfg = d["vis_scfg"]
    keep = scfg.pruner.token_per_frame // 2
    half = dataclasses.replace(scfg, pruner=dataclasses.replace(
        scfg.pruner, token_per_frame=keep))
    vis = tlo.LlavaOVVision(model, half, batch=B)
    px = torch.as_tensor(d["vis_pixels"])
    _, want, _, _ = vis.encode(px, *vis.init_state(), False)
    feats, _ = model.vision.encode_full(px, B)
    pooled = tlo.apply_pooling(model.projector(feats),
                               d["vis_cfg"].vision.grid)
    _, j_keep, _ = j_prune(
        jnp.asarray(pooled.reshape(B, F, *pooled.shape[1:]).numpy()),
        init_pruner_state(B, int(LM_CFG.hidden_size * 0.5)),
        keep_per_frame=keep, channel_keep_ratio=0.5)
    np.testing.assert_array_equal(want.numpy(), np.asarray(j_keep))
    for r in ranks:
        np.testing.assert_array_equal(r["trap"]["port_keep"], want.numpy())
        assert not np.array_equal(r["trap"]["naive_keep"], want.numpy())


def _jax_sp_session(lm_params, mesh):
    s = JSession(lm_params, LM_CFG, SessionConfig(rekv=LM_REKV), batch=B,
                 state_dtype=jnp.float32, mesh=mesh)
    s.encode_init_prompt([1, 2, 3, 4])
    feats = np.random.default_rng(4).normal(
        size=(B, 8 * 16, LM_CFG.hidden_size)).astype(np.float32)
    s.encode_video_features(feats)
    ans = s.question_answering(Q, PR, [0], max_new_tokens=6)
    tok, cnt = s.serve(feats[:, :16], None, [Q, Q], [PR, PR], [0],
                       max_new_tokens=4)
    return ans, np.asarray(tok), np.asarray(cnt)


@pytest.mark.parametrize("mesh", MESHES)
def test_sp_lm_session_matches_sequential(case, mesh):
    """tests/test_sp.py's LM session (init prompt, 128 tokens of features
    in 16-token appends, a question, a serving tick): on dp 2 x sp 2 and
    sp 2 x tp 2 each append's tokens split over sp; the answer and the
    tick's tokens equal JAX's sequential session's and the port's."""
    d, _, lm_params, ranks = case
    ans, tok, cnt = _jax_sp_session(lm_params, None)
    lm = weights.qwen2_from_jax(d["lm_tree"], d["lm_cfg"], device="cpu")
    s = StreamingSession(lm, d["lm_scfg"], batch=B,
                         state_dtype=torch.float32)
    s.encode_init_prompt([1, 2, 3, 4])
    s.encode_video_features(d["lm_feats"])
    p_ans = s.question_answering(Q, PR, [0], max_new_tokens=6)
    assert p_ans == ans
    for r in ranks:
        got = r[mesh]["session"]
        assert got["answer"] == ans
        np.testing.assert_array_equal(got["serve"][0], tok)
        np.testing.assert_array_equal(got["serve"][1], cnt)


def test_sp_pp_mesh_refused():
    """A mesh with both sp and pp is refused at the session's build (JAX:
    an assertion; here a ValueError naming the two layouts)."""
    from stc_tpu_torch.models import qwen2 as tq
    lm = tq.Qwen2(tq.Qwen2Config.tiny(), dtype=torch.float32, device="cpu")
    mesh = Mesh(("pp", "sp"), (2, 2), coord={"pp": 0, "sp": 1})
    with pytest.raises(ValueError, match="sp .*composes with dp/tp"):
        StreamingSession(lm, port_cfg(SessionConfig(rekv=LM_REKV)), batch=2,
                         mesh=mesh)


def test_make_mesh_axis_names_and_coords():
    """make_mesh's axes (tp innermost, as JAX's) on layout-only meshes:
    dp x tp, dp x sp x tp and pp x tp, this rank's coordinates and the
    ranks along each axis."""
    m = Mesh(("dp", "sp", "tp"), (2, 2, 2),
             coord={"dp": 1, "sp": 0, "tp": 1})
    assert m.axis_names == ("dp", "sp", "tp") and m.rank == 5
    assert m.axis("tp").ranks == (4, 5) and m.axis("sp").ranks == (5, 7)
    assert m.axis("dp").ranks == (1, 5) and m.axis("pp").size == 1
    legacy = j_make_mesh(dp=4, tp=2)
    assert legacy.axis_names == ("dp", "tp")
