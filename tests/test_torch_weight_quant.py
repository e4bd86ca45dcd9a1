"""Int8 weight-only quantization in the port against stc_tpu's
quantize_params_int8 on the CPU: the int8 weights and scales are bit-equal
(per output channel and per group of 32 input rows), the quantized logits
agree at the f32 tolerance, and quantized feature sessions answer with
stc_tpu's ids and retrieve its blocks.  Also the weights_quant strings the
config takes and refuses."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import ReKVConfig, SessionConfig
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu_torch import config as tcfg
from stc_tpu_torch import weights
from stc_tpu_torch.models import qwen2 as tq
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from test_torch_common import (DEEP_TOL, np_tree, port_cfg, port_model_cfg,
                               tt)
from test_torch_session import _jax_layer_indices

REKV = ReKVConfig(n_init=6, n_local=128, block_size=8, exc_block_size=16,
                  topk=4, max_blocks=64, max_prompt_tokens=32,
                  max_new_tokens=8)


def _pair(group, seed=0):
    """The same random tiny Qwen2 in both packages, quantized by each."""
    mcfg = jq.Qwen2Config.tiny()
    params = jq.init_params(mcfg, jax.random.key(seed), dtype=jnp.float32)
    jtree = jq.quantize_params_int8(jq.fuse_params(params), group_size=group)
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(mcfg),
                                device="cpu")
    return mcfg, jtree, lm.quantize_int8(group)


def _quantized_arrays(jtree):
    """(port module path, name, JAX array) of every quantized entry."""
    out = [((), n, jtree[n]) for n in jtree
           if n.endswith(("_q", "_s", "_gs"))]
    L = jtree["layers"]
    for n in L:
        if n.endswith(("_q", "_s", "_gs")):
            out += [(("layers", i), n, L[n][i])
                    for i in range(L[n].shape[0])]
    return out


@pytest.mark.parametrize("group", [0, 32])
def test_int8_weights_and_scales_bit_equal_to_jax(group):
    mcfg, jtree, lm = _pair(group)
    arrays = _quantized_arrays(jtree)
    # 4 matrices x 2 layers + embed + lm_head, each with its scales
    assert len(arrays) == 2 * (4 * mcfg.num_layers + 2)
    for path, name, want in arrays:
        mod = lm if not path else lm.layers[path[1]]
        got = getattr(mod, name)
        assert got.dtype == (torch.int8 if name.endswith("_q")
                             else torch.float32), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{path} {name}")
    # the float matrices are gone, norms and biases stay in the model dtype
    assert not hasattr(lm, "embed") and not hasattr(lm.layers[0], "wqkv")
    assert lm.layers[0].bqkv.dtype == lm.norm_f.dtype == torch.float32
    # idempotent
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    assert lm.quantize_int8(group) is lm
    for k, v in lm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_quantize_weight_rejects_a_group_that_does_not_divide():
    with pytest.raises(ValueError, match="group size 24"):
        tq.quantize_weight(torch.ones(64, 8), 24)


@pytest.mark.parametrize("group", [0, 32])
def test_quantized_logits_match_jax(group):
    """A fresh decode_step on int8 weights: the port's logits against
    stc_tpu's quantized decode_step (DEEP_TOL, f32 through two layers);
    the port's LM loaded from stc_tpu's quantized tree (weights.py)
    computes the same logits bit for bit as the one it quantized itself."""
    mcfg, jtree, lm = _pair(group, seed=1)
    rekv = port_cfg(REKV)
    ids = np.arange(12, dtype=np.int32)[None] * 7 % mcfg.vocab_size
    dkvs = jq.init_decode_state(mcfg, REKV, 1, jnp.float32)
    want, _ = jq.decode_step(jtree, mcfg, REKV, dkvs,
                             jq.embed_tokens(jtree, jnp.asarray(ids)),
                             jnp.asarray([12], jnp.int32))
    loaded = weights.qwen2_from_jax(np_tree(jtree), port_model_cfg(mcfg),
                                    device="cpu")
    assert loaded.int8_group == group
    got = []
    for m in (lm, loaded):
        d = m.init_decode_state(rekv, 1, torch.float32)
        lg, _ = m.decode_step(rekv, d, m.embed_tokens(torch.from_numpy(ids)),
                              torch.tensor([12], dtype=torch.int32))
        got.append(lg.numpy())
    np.testing.assert_allclose(got[0], np.asarray(want), **DEEP_TOL)
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[0].argmax(-1), np.asarray(want)
                                  .argmax(-1))


def test_quantized_embed_rows_match_jax():
    mcfg, jtree, lm = _pair(0, seed=2)
    ids = np.array([[0, 5, 255, 17]], np.int32)
    np.testing.assert_array_equal(
        lm.embed_tokens(torch.from_numpy(ids)).numpy(),
        np.asarray(jq.embed_tokens(jtree, jnp.asarray(ids))))


@pytest.mark.parametrize("quant", ["int8", "int8_g32"])
def test_quantized_feature_session_answers_equal_jax(quant):
    """Both sessions quantize the same f32 weights at build; interleaved
    encode -> QA -> encode -> QA over the same features gives the same
    answer ids and every layer's retrieved blocks."""
    mcfg = jq.Qwen2Config.tiny()
    scfg = SessionConfig(rekv=REKV, weights_quant=quant)
    params = jq.init_params(mcfg, jax.random.key(9))
    jsess = JSession(params, mcfg, scfg, state_dtype=jnp.float32)
    tsess = TSession(weights.qwen2_from_jax(np_tree(params),
                                            port_model_cfg(mcfg),
                                            device="cpu"),
                     port_cfg(scfg), state_dtype=torch.float32)
    assert tsess.lm.int8_group == scfg.weights_quant_group
    rng = np.random.default_rng(9)
    for s in (jsess, tsess):
        s.encode_init_prompt(list(range(6)))
    for n_frames, question in ((7, [7, 8, 9]), (5, [30, 31, 32, 33])):
        feats = rng.normal(size=(1, n_frames * 8, mcfg.hidden_size))
        jsess.encode_video_features(feats.astype(np.float32))
        tsess.encode_video_features(tt(feats))
        want_idx = _jax_layer_indices(jsess, question)
        want = jsess.question_answering(question, question + [3], [0],
                                        max_new_tokens=6)
        got = tsess.question_answering(question, question + [3], [0],
                                       max_new_tokens=6)
        assert got == want
        assert tsess.last_retrieved_indices == want_idx


def test_weights_quant_strings_accepted_and_refused():
    """The config takes what stc_tpu's takes (tests/test_quant.py), and
    refuses what it refuses; no setting it takes stops a session."""
    S = tcfg.SessionConfig
    assert S(weights_quant="int8_g128").weights_quant_group == 128
    assert S(weights_quant="int8").weights_quant_group == 0
    assert S().weights_quant_group == 0
    for bad in ("INT8", "int8_g", "int8_gx", "int4", "int8_g0"):
        with pytest.raises(AssertionError):
            S(weights_quant=bad)
    for ok in ("int8", "int8_g32"):
        assert S(weights_quant=ok).weights_quant == ok
    assert S(ingest_format="yuv420").ingest_format == "yuv420"
    with pytest.raises(AssertionError):
        S(ingest_format="nv12")
