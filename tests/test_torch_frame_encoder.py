"""The port's FrameEncoder and the bare session's frame_encoder against
stc_tpu's on the CPU, same weights: the encoder's features (F32_TOL), the
cacher's recomputed rows and the pruner's keeps (exactly) chunk by chunk;
a bare StreamingSession with the encoder attached answering, with the same
retrieved blocks, as the port's VLMSession and as stc_tpu's bare session;
clear_cache resetting the encoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.runtime.session import StreamingSession as JaxSession
from stc_tpu_torch import weights
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.runtime.session import StreamingSession
from test_torch_session import _jax_layer_indices
from test_torch_common import (F32_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)
from test_torch_vision import _frames, _jax_cached_rows

pytestmark = pytest.mark.usefixtures("one_thread")


def configs():
    """tests/test_vision.py::test_frame_encoder_pipeline's config."""
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=256, block_size=3,
                        exc_block_size=3, topk=4, max_blocks=128,
                        max_prompt_tokens=16, max_new_tokens=4),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(token_per_frame=3),
    )
    return cfg, scfg


def models(seed=0):
    cfg, scfg = configs()
    params = jlo.init_random_params(cfg, jax.random.key(seed))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    return cfg, scfg, params, model


def test_frame_encoder_pipeline():
    """tests/test_vision.py:156 on the port: a full chunk then a cached one
    of the same frame, shapes, chunk count, reset; the full chunk equal to
    stc_tpu's."""
    cfg, scfg, params, model = models()
    enc = tlo.FrameEncoder(model, port_cfg(scfg), device="cpu")
    frames = (np.random.default_rng(0)
              .uniform(0, 255, size=(1, 56, 56, 3)).astype(np.uint8))
    out0 = enc(frames)
    out1 = enc(frames)
    assert out0.shape == (1, 3, cfg.text.hidden_size)
    assert out1.shape == (1, 3, cfg.text.hidden_size)
    assert enc.chunk_idx == 2
    np.testing.assert_allclose(out0.numpy(), out1.numpy(), rtol=0.2,
                               atol=0.2)
    jenc = jlo.FrameEncoder(params, cfg, scfg)
    np.testing.assert_allclose(out0.numpy(), np.asarray(jenc(frames)),
                               **F32_TOL)
    enc.reset()
    assert enc.chunk_idx == 0 and enc.last_kept_idx is None


def test_frame_encoder_matches_jax_chunk_by_chunk():
    """Four 2-frame chunks (full, cached, full, cached) of pixels whose
    cacher similarities are well separated: features to F32_TOL, each
    cached chunk's recomputed rows and every chunk's pruner keeps equal."""
    cfg, scfg, params, model = models(seed=1)
    jenc = jlo.FrameEncoder(params, cfg, scfg)
    enc = tlo.FrameEncoder(model, port_cfg(scfg), device="cpu")
    rows = []
    encode_cached = model.vision.encode_cached

    def capture(*a, **k):
        out = encode_cached(*a, **k)
        rows.append(out[1].numpy())
        return out

    model.vision.encode_cached = capture
    rng = np.random.default_rng(3)
    base = None
    U = max(1, int(cfg.vision.num_tokens * scfg.cacher.update_token_ratio))
    for chunk in range(4):
        px, base = _frames(rng, 2, base)
        if chunk % 2:
            want_rows, _ = _jax_cached_rows(params["vision"], cfg.vision, px,
                                            jenc.cacher, U)
        want = np.asarray(jenc(px))
        got = enc(px)
        assert enc.chunk_idx == jenc.chunk_idx == chunk + 1
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        np.testing.assert_array_equal(enc.last_kept_idx.numpy(),
                                      np.asarray(jenc.last_kept_idx))
        if chunk % 2:
            np.testing.assert_array_equal(rows[-1], want_rows)
    assert len(rows) == 2


def bare(model, scfg):
    return StreamingSession(model.text, scfg, state_dtype=torch.float32,
                            frame_encoder=tlo.FrameEncoder(model, scfg,
                                                           device="cpu"))


def run(sess, frames, questions, blocks=None):
    """Init prompt, frames one chunk a call, then each question: answers
    and every layer's retrieved blocks (the session's own record, or
    blocks(sess, question))."""
    sess.encode_init_prompt([1, 2, 3, 4])
    for f in range(len(frames)):
        sess.encode_video(frames[f:f + 1])
    out = []
    for q, p in questions:
        ans = sess.question_answering(q, p, [0], max_new_tokens=4)
        idx = (sess.last_retrieved_indices if blocks is None
               else blocks(sess, q))
        out.append((list(map(int, ans)), [list(map(int, l)) for l in idx]))
    return out


QUESTIONS = [([5, 6], [5, 6, 7]), ([9, 8, 7, 6], [11, 12])]


def test_bare_session_with_frame_encoder_answers_as_vlm_session_and_jax():
    cfg, scfg, params, model = models(seed=2)
    tscfg = port_cfg(scfg)
    frames = np.random.default_rng(4).integers(0, 256, (7, 56, 56, 3),
                                               dtype=np.uint8)
    got = run(bare(model, tscfg), frames, QUESTIONS)
    vlm = tlo.build_session(model, tscfg, state_dtype=torch.float32,
                            device="cpu")
    assert got == run(vlm, frames, QUESTIONS)
    jsess = JaxSession(params["text"], cfg.text, scfg,
                       state_dtype=jnp.float32,
                       frame_encoder=jlo.FrameEncoder(params, cfg, scfg))
    assert got == run(jsess, frames, QUESTIONS, _jax_layer_indices)


def test_clear_cache_resets_the_frame_encoder():
    """clear_cache returns the encoder to a fresh one's state: the same
    video after it answers as the first time."""
    _, scfg, _, model = models(seed=2)
    sess = bare(model, port_cfg(scfg))
    frames = np.random.default_rng(6).integers(0, 256, (5, 56, 56, 3),
                                               dtype=np.uint8)
    first = run(sess, frames, QUESTIONS[:1])
    enc = sess.frame_encoder
    assert enc.chunk_idx == 5 and enc.last_kept_idx is not None
    sess.clear_cache()
    assert enc.chunk_idx == 0 and enc.last_kept_idx is None
    fresh_v, fresh_p = enc.vision.init_state()
    for x, y in zip(list(enc.vstate) + list(enc.pstate),
                    list(fresh_v) + list(fresh_p)):
        assert torch.equal(x, y)
    assert run(sess, frames, QUESTIONS[:1]) == first
    with pytest.raises(RuntimeError, match="frame_encoder"):
        StreamingSession(model.text, port_cfg(scfg),
                         state_dtype=torch.float32).encode_video(frames)
