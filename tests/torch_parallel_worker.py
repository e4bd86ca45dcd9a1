"""Rank-side cases of the port's parallel tests (tests/test_torch_parallel_
*.py).  Each function runs on every rank of a gloo CPU process group
started by stc_tpu_torch.parallel.dryrun.launch; it imports torch, numpy
and stc_tpu_torch only (no JAX), reads its inputs (numpy trees and arrays
written by the test) from a pickle file and returns numpy results, which
the test holds against the JAX package and the port's unsharded runs.
Per-stream and per-head results are gathered over the mesh here, so every
rank returns whole arrays."""

from __future__ import annotations

import pickle

import numpy as np
import torch

from stc_tpu_torch import weights
from stc_tpu_torch.kvcache.state import layer
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models import siglip as sg
from stc_tpu_torch.parallel import mesh as pm
from stc_tpu_torch.parallel import pipeline
from stc_tpu_torch.runtime.session import StreamingSession

F32 = torch.float32


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _t(x, dtype=F32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _full(x, mesh, axis_dims):
    """x gathered over each (axis name, dim) of the mesh, as numpy."""
    for name, dim in axis_dims:
        x = mesh.axis(name).all_gather(x.contiguous(), dim=dim)
    return x.numpy()


def _kv_full(kvs, mesh, layer_axis=None):
    """Every StreamKV leaf (L, B, ...) of every layer (gathered over
    `layer_axis`, pp), stream and kv head, as sharding.stream_kv_specs
    lays them over the mesh."""
    from stc_tpu_torch.parallel.sharding import stream_kv_specs
    out = {}
    for name, axes in stream_kv_specs().items():
        dims = [] if layer_axis is None else [(layer_axis, 0)]
        dims += [(a, 1 + j) for j, a in enumerate(axes) if a is not None]
        out[name] = _full(getattr(kvs, name), mesh, dims)
    return out


# --------------------------------------------------------------------------
# tp and dp (test_torch_parallel_tp.py)
# --------------------------------------------------------------------------

def tp_cases(rank, world, path):
    d = _load(path)
    mesh = pm.make_mesh(dp=2, tp=2)
    dp = mesh.axis("dp")
    out = {}
    mcfg, rekv = d["mcfg"], d["rekv"]
    B = d["ids"].shape[0]
    sl = slice(dp.rank * B // 2, (dp.rank + 1) * B // 2)
    for name, tree in d["trees"].items():
        lm = weights.qwen2_from_jax(tree, mcfg, device="cpu", mesh=mesh)
        out[name] = _step(lm, rekv, d, sl, mesh)
    # dp 2: three appends of each stream's features
    lm = weights.qwen2_from_jax(d["trees"]["plain"], mcfg, device="cpu",
                                mesh=mesh)
    kvs = lm.init_stream_state(rekv, B // 2, F32)
    lm.encode_step(rekv, kvs, lm.embed_tokens(_t(d["ids"][sl], torch.int64)),
                   is_init=True)
    S = rekv.block_size
    for i in range(3):
        lm.encode_step(rekv, kvs, _t(d["dp_feats"][sl, i * S:(i + 1) * S]),
                       is_init=False)
    out["dp_block_k"] = _full(kvs.block_k, mesh, [("dp", 1), ("tp", 2)])
    out["sessions"] = _vlm_sessions(d, mesh)
    out["traps"] = _tp_traps(d, mesh)
    return out


def _step(lm, rekv, d, sl, mesh):
    """test_sharding's _run: init prompt, one append, the retrieval
    forward and a decode step of this rank's streams."""
    B = sl.stop - sl.start
    kvs = lm.init_stream_state(rekv, B, F32)
    lm.encode_step(rekv, kvs, lm.embed_tokens(_t(d["ids"][sl], torch.int64)),
                   is_init=True)
    lm.encode_step(rekv, kvs, _t(d["feats"][sl]), is_init=False)
    q = _t(d["q_embeds"][sl])
    dkvs = lm.init_decode_state(rekv, B, F32)
    dkvs, abs_idx, _ = lm.qa_retrieve_step(rekv, kvs, dkvs, q)
    logits, dkvs = lm.decode_step(rekv, dkvs, q,
                                  torch.full((B,), q.shape[1]))
    return {"length": _full(kvs.length, mesh, [("dp", 1)]),
            "cursor": _full(dkvs.cursor, mesh, [("dp", 1)]),
            "logits": _full(logits, mesh, [("dp", 0)]),
            "abs_idx": _full(abs_idx, mesh, [("dp", 1)])}


def _drive(sess, frames, qs):
    sess.encode_init_prompt([1, 2, 3, 4])
    n = sess.scfg.encode_chunk_frames
    for s in range(0, frames.shape[1], n):
        sess.encode_video(frames[:, s:s + n])
    out = []
    for q, p in qs:
        out.append((sess.question_answering(q, p, [0], max_new_tokens=6,
                                            all_streams=True),
                    sess.last_retrieved_indices))
    return {"qa": out, "evicted": sess._evicted_pages}


def _vlm_sessions(d, mesh):
    """The LLaVA-OV pixel sessions of d["sessions"] on this mesh."""
    out = {}
    for name, scfg in d["sessions"].items():
        model = weights.params_from_jax(d["vlm_tree"], d["vlm_cfg"],
                                        device="cpu")
        sess = lo.build_session(model, scfg, state_dtype=F32, device="cpu",
                                batch=d["frames"].shape[0], mesh=mesh)
        out[name] = _drive(sess, d["frames"], d["questions"])
    return out


def _tp_traps(d, mesh):
    """What the naive versions select on this rank: the retrieval top-k of
    the unreduced (this rank's heads only) logits, and the cacher rows of
    the unreduced (this rank's channels only) cosine."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.ops.topk import topk_lowest
    mcfg, rekv = d["mcfg"], d["rekv"]
    lm = weights.qwen2_from_jax(d["trees"]["plain"], mcfg, device="cpu",
                                mesh=mesh)
    dp = mesh.axis("dp")
    B = d["trap_feats"].shape[0]
    sl = slice(dp.rank * B // 2, (dp.rank + 1) * B // 2)
    kvs = lm.init_stream_state(rekv, B // 2, F32)
    lm.encode_step(rekv, kvs, lm.embed_tokens(_t(d["ids"][sl],
                                                 torch.int64)), is_init=True)
    T = rekv.exc_block_size
    for s in range(0, d["trap_feats"].shape[1], T):
        lm.encode_step(rekv, kvs, _t(d["trap_feats"][sl, s:s + T]),
                       is_init=False)
    q = _t(d["q_embeds"][sl])
    h = q
    port, naive = [], []
    for i, lp in enumerate(lm.layers):
        qq, _, _ = lm._qkv(lp, qw.rms_norm(h, lp.ln1, lm.cfg.rms_eps))
        kv = layer(kvs, i)
        port.append(engine.score_blocks(kv, qq, rekv, tp=lm.tp)[0])
        naive.append(engine.score_blocks(kv, qq, rekv)[0])
        break  # the first layer's input is the same in every layout
    out = {"retrieval_port": _full(torch.stack(port), mesh, [("dp", 1)]),
           "retrieval_naive": _full(torch.stack(naive), mesh, [("dp", 1)])}
    # the cacher: one cached layer pass of the tower, frames of stream 0
    model = weights.params_from_jax(d["vlm_tree"], d["vlm_cfg"],
                                    device="cpu", mesh=mesh)
    tower = model.vision
    px = _t(d["trap_pixels"])
    h = tower.patch_embed(px[:-1])
    refs_h = tower.patch_embed(px[-1:])
    lp = tower.layers[0]
    _, saved = lp.full(refs_h, tower.cfg)
    refs = tuple(x[-1:] for x in saved)
    T_ = tower.cfg.num_tokens
    U = T_ // 4
    _, upd = lp.cached(h, refs, U, tower.cfg)
    hn = sg.layer_norm(h, lp.ln1_w, lp.ln1_b, tower.cfg.layer_norm_eps)
    sim = sg.key_similarity(hn @ lp.wk + lp.bk, refs[0])   # unreduced
    naive_upd = torch.sort(topk_lowest(-sim, U)[1], dim=-1).values
    out["cacher_port"] = upd.numpy()
    out["cacher_naive"] = naive_upd.numpy()
    return out


# --------------------------------------------------------------------------
# sp (test_torch_parallel_sp.py)
# --------------------------------------------------------------------------

def sp_cases(rank, world, path):
    d = _load(path)
    out = {}
    for key, shape in (("dp2_sp2", (2, 1, 2)), ("sp2_tp2", (1, 2, 2))):
        dp_, tp_, sp_ = shape
        mesh = pm.make_mesh(dp=dp_, tp=tp_, sp=sp_)
        out[key] = {"vision": _sp_vision(d, mesh),
                    "session": _sp_session(d, mesh)}
    out["trap"] = {k: out["dp2_sp2"]["vision"].pop(k)
                   for k in ("port_keep", "naive_keep")}
    return out


def _sp_vision(d, mesh):
    """test_sp's step: frames over (dp, sp), the tower, projector, pooling,
    the pruner and one LM append, on the mesh; the full chunk then a
    cached one."""
    cfg, scfg = d["vis_cfg"], d["vis_scfg"]
    model = weights.params_from_jax(d["vis_tree"], cfg, device="cpu",
                                    mesh=mesh)
    dp = mesh.axis("dp")
    B, F_ = d["vis_B"], d["vis_F"]
    b = B // dp.size
    px = _t(d["vis_pixels"]).reshape((B, F_) + d["vis_pixels"].shape[1:])
    px = px[dp.rank * b:(dp.rank + 1) * b].reshape(
        (b * F_,) + d["vis_pixels"].shape[1:])
    vis = lo.LlavaOVVision(model, scfg, batch=b)
    vstate, pstate = vis.init_state()
    kvs = model.text.init_stream_state(scfg.rekv, b, F32)
    ids = torch.tensor([[1, 2, 3, 4]] * b)
    model.text.encode_step(scfg.rekv, kvs, model.text.embed_tokens(ids),
                           is_init=True)
    flat, vstate, pstate = vis.full(px, vstate, pstate)
    model.text.encode_step(scfg.rekv, kvs, flat, is_init=False)
    flat2, _, _ = vis.cached(px + 0.05, vstate, pstate)
    out = {"flat": _full(flat, mesh, [("dp", 0)]),
           "flat_cached": _full(flat2, mesh, [("dp", 0)]),
           "kvs": _kv_full(kvs, mesh),
           "ref_k": _full(vstate.ref_k, mesh, [("dp", 1), ("tp", 3)]),
           "ref_attn": _full(vstate.ref_attn, mesh, [("dp", 1)])}
    # the pruner keeping half of each frame's tokens: the port's keeps
    # (pooled features gathered over sp first), then the naive order's
    # (each sp rank pruning its own frames)
    import dataclasses
    from stc_tpu_torch.compress.pruner import stc_prune
    from stc_tpu_torch.parallel.sharding import shard_vision_sp
    half = dataclasses.replace(scfg, pruner=dataclasses.replace(
        scfg.pruner, token_per_frame=scfg.pruner.token_per_frame // 2))
    vis = lo.LlavaOVVision(model, half, batch=b)
    _, keep, _, _ = vis.encode(px, *vis.init_state(), False)
    out["port_keep"] = _full(keep, mesh, [("dp", 0)])
    mine = shard_vision_sp(px, b, mesh.axis("sp"))
    feats, _ = model.vision.encode_full(mine, b)
    pooled = lo.apply_pooling(model.projector(feats), cfg.vision.grid)
    _, keep, _ = stc_prune(pooled.reshape(b, -1, *pooled.shape[1:]),
                           vis.init_state()[1],
                           keep_per_frame=half.pruner.token_per_frame,
                           channel_keep_ratio=half.pruner.channel_keep_ratio)
    out["naive_keep"] = _full(keep, mesh, [("sp", 1), ("dp", 0)])
    return out


def _sp_session(d, mesh):
    lm = weights.qwen2_from_jax(d["lm_tree"], d["lm_cfg"], device="cpu")
    s = StreamingSession(lm, d["lm_scfg"], batch=2, state_dtype=F32,
                         mesh=mesh)
    s.encode_init_prompt([1, 2, 3, 4])
    s.encode_video_features(d["lm_feats"])
    q, p = d["lm_q"], d["lm_p"]
    ans = s.question_answering(q, p, [0], max_new_tokens=6)
    tok, cnt = s.serve(d["lm_feats"][:, :16], None, [q, q], [p, p], [0],
                       max_new_tokens=4)
    return {"answer": ans, "serve": (tok, cnt),
            "blocks": s.last_retrieved_indices}


# --------------------------------------------------------------------------
# pp (test_torch_parallel_pp.py)
# --------------------------------------------------------------------------

def pp_cases(rank, world, path):
    d = _load(path)
    out = {}
    for key, (pp_, tp_, n_micro) in (("pp4", (4, 1, 2)),
                                     ("pp2_tp2", (2, 2, 3))):
        mesh = pm.make_pp_mesh(pp=pp_, tp=tp_)
        out[key] = {"encode": _pp_encode(d, mesh, n_micro),
                    "session": _pp_session(d, mesh),
                    "batch": _pp_batch(d, mesh),
                    "evict": _pp_evict(d, mesh)}
    return out


def _pp_encode(d, mesh, n_micro):
    """The relayed init prompt, then one pp_encode_step of n_micro
    exc_block_size microbatches; the hidden states are the last
    stage's."""
    e = d["enc"]
    lm = weights.qwen2_from_jax(e["tree"], e["cfg"], device="cpu",
                                mesh=mesh)
    kvs = lm.init_stream_state(e["rekv"], 2, F32)
    lm.encode_step(e["rekv"], kvs, _t(e["init"]), is_init=True)
    h = pipeline.pp_encode_step(lm, e["rekv"], kvs,
                                _t(e["embeds"][n_micro]))
    last = mesh.coord["pp"] == mesh.size_of("pp") - 1
    return {"h": h.numpy() if last else None,
            "kvs": _kv_full(kvs, mesh, "pp")}


def _pp_session(d, mesh):
    s_ = d["sess"]
    lm = weights.qwen2_from_jax(s_["tree"], s_["cfg"], device="cpu")
    s = StreamingSession(lm, s_["scfg"], batch=1, state_dtype=F32,
                         mesh=mesh)
    s.encode_init_prompt([1, 2, 3, 4])
    s.encode_video_features(s_["feats1"])
    s.encode_video_features(s_["feats2"])
    kv = _kv_full(s.kvs, mesh, "pp")
    answers = []
    for (q, p), more in zip(s_["qs"], s_["more"]):
        answers.append(s.question_answering(q, p, [0], max_new_tokens=6))
        s.encode_video_features(more)
    return {"kvs": kv, "answers": answers,
            "blocks": s.last_retrieved_indices}


def _pp_batch(d, mesh):
    b_ = d["batch"]
    lm = weights.qwen2_from_jax(b_["tree"], b_["cfg"], device="cpu")
    s = StreamingSession(lm, b_["scfg"], batch=2, state_dtype=F32,
                         mesh=mesh)
    s.encode_init_prompt([1, 2, 3, 4])
    s.encode_video_features(b_["feats"])
    s.encode_video_features(b_["more"], active=[False, True])
    a = s.question_answering_batch([[5, 6], [7]], [[8], [9, 10]], [0],
                                   max_new_tokens=5)
    e = s.question_answering([5, 6], [8], [0], max_new_tokens=4,
                             retrieved_indices=[0, 2])
    return {"batch": a, "external": e}


def _pp_evict(d, mesh):
    v = d["evict"]
    lm = weights.qwen2_from_jax(v["tree"], v["cfg"], device="cpu")
    s = StreamingSession(lm, v["scfg"], batch=1, state_dtype=F32,
                         mesh=mesh)
    s.encode_init_prompt([1, 2, 3, 4])
    s.encode_video_features(v["feats"])
    try:
        s.encode_video_features(v["feats"][:, :8])
    except RuntimeError as e:
        return str(e)
    return None
