"""The port against the upstream models themselves: tiny `transformers`
models built here (no download), f32, eager attention, converted by the
port's own converters.

Tolerances (rtol = atol): 2e-4 for the Qwen2 logits and 3e-4 for the SigLIP
hidden states and video features, the limits stc_tpu's own HF parity tests
use (tests/test_qwen2.py, tests/test_vision.py): f32 arithmetic summed in
another order through two layers.  Argmaxes must be equal."""

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from stc_tpu_torch.config import ReKVConfig
from stc_tpu_torch.models import convert as tconv
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.models import qwen2 as tq
from stc_tpu_torch.models import siglip as tsg

LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
VISION_TOL = dict(rtol=3e-4, atol=3e-4)
REKV = ReKVConfig(n_init=4, n_local=256, block_size=8, exc_block_size=8,
                  topk=4, max_blocks=64, max_prompt_tokens=32,
                  max_new_tokens=8)


def _hf_configs(tie=False):
    from transformers import Qwen2Config, SiglipVisionConfig
    vis = SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                             num_hidden_layers=2, num_attention_heads=4,
                             image_size=56, patch_size=14,
                             attn_implementation="eager")
    txt = Qwen2Config(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0,
                      rms_norm_eps=1e-6, max_position_embeddings=512,
                      tie_word_embeddings=tie, attn_implementation="eager")
    return vis, txt


def _pixels(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, 3, 56, 56)).astype(np.float32)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_qwen2_prompt_logits_match_hf(tie):
    """A fresh decode_step over a 12-token prompt against
    Qwen2ForCausalLM's logits (the decode cache is empty and n_local
    exceeds the prompt, so the port's attention is full causal)."""
    from transformers import Qwen2ForCausalLM
    torch.manual_seed(0)
    hf = Qwen2ForCausalLM(_hf_configs(tie)[1]).eval()
    hf_cfg = hf.config
    cfg = tconv.qwen2_config_from_hf(hf_cfg)
    lm = tconv.convert_qwen2(dict(hf.state_dict()),
                             tq.Qwen2(cfg, torch.float32, "cpu"))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 12)))
    with torch.no_grad():
        want = hf(ids).logits.numpy()
    dkvs = lm.init_decode_state(REKV, 1, torch.float32)
    got, _ = lm.decode_step(REKV, dkvs, lm.embed_tokens(ids),
                            torch.tensor([12], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_siglip_encode_full_matches_hf():
    """The tower's features: the last encoder layer before the post-LN,
    SiglipVisionModel's hidden_states[-1]."""
    from transformers import SiglipVisionModel
    torch.manual_seed(0)
    hf = SiglipVisionModel(_hf_configs()[0]).eval()
    c = hf.config
    cfg = tsg.SiglipConfig(hidden_size=c.hidden_size,
                           num_layers=c.num_hidden_layers,
                           num_heads=c.num_attention_heads,
                           intermediate_size=c.intermediate_size,
                           image_size=c.image_size, patch_size=c.patch_size)
    tower = tconv.convert_siglip(dict(hf.state_dict()),
                                 tsg.Siglip(cfg, torch.float32, "cpu"),
                                 prefix="vision_model.")
    px = torch.from_numpy(_pixels(3, 1))
    with torch.no_grad():
        want = hf(px, output_hidden_states=True).hidden_states[-1].numpy()
    got, _ = tower.encode_full(px)
    np.testing.assert_allclose(got.numpy(), want, **VISION_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_vision_path_matches_hf_video_features():
    """Tower -> projector -> 2x bilinear pooling against
    LlavaOnevisionModel.get_video_features with the last layer's full
    features (what the port's pipeline feeds the pruner)."""
    from transformers import (LlavaOnevisionConfig,
                              LlavaOnevisionForConditionalGeneration)
    torch.manual_seed(0)
    vis, txt = _hf_configs()
    hf = LlavaOnevisionForConditionalGeneration(LlavaOnevisionConfig(
        vision_config=vis, text_config=txt, image_token_index=255,
        video_token_index=254)).eval()
    state = dict(hf.state_dict())
    model = tlo.LlavaOV(tlo.LlavaOVConfig.tiny(), dtype=torch.float32,
                        device="cpu")
    vpfx = tconv.find_prefix(state, "embeddings.patch_embedding.weight", (
        "vision_tower.vision_model.", "model.vision_tower.vision_model."))
    ppfx = tconv.find_prefix(state, "linear_1.weight", (
        "multi_modal_projector.", "model.multi_modal_projector."))
    tconv.convert_siglip(state, model.vision, prefix=vpfx)
    tconv.convert_projector(state, model.projector, prefix=ppfx)
    F_ = 4
    px = torch.from_numpy(_pixels(F_, 2))
    with torch.no_grad():
        want = hf.model.get_video_features(
            px[None], vision_feature_layer=-1,
            vision_feature_select_strategy="full").numpy()
        feats, _ = model.vision.encode_full(px)
        got = tlo.apply_pooling(model.projector(feats),
                                model.cfg.vision.grid)
    got = got.reshape(1, -1, got.shape[-1]).numpy()
    assert got.shape == want.shape == (1, F_ * model.cfg.tokens_per_frame,
                                       64)
    np.testing.assert_allclose(got, want, **VISION_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
