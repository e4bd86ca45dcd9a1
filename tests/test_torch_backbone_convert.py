"""The port's loaders of the CLIP backbones (LongVA, Video-LLaVA,
Flash-VStream) through its MODEL_REGISTRY, against stc_tpu's loaders on
the same synthetic on-disk checkpoints of tests/test_converters.py (no
download; Video-LLaVA's written by transformers' save_pretrained): every
converted tensor bit-equal (float32), the config helpers equal, and the
sessions giving the same answers and retrieved blocks."""

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("safetensors")
pytest.importorskip("transformers")

import jax.numpy as jnp

from stc_tpu.models import convert as jconv
from stc_tpu_torch.models import MODEL_REGISTRY
from stc_tpu_torch.models import convert as tconv
from stc_tpu_torch.models import flash_vstream  # noqa: F401  (registers)
from stc_tpu_torch.models import longva  # noqa: F401
from stc_tpu_torch.models import video_llava  # noqa: F401
from test_converters import (_mlp2x_state, _save_sharded, _tiny_clip_state,
                             _tiny_qwen_state, tiny_session_cfg)
from test_torch_common import one_thread, port_cfg  # noqa: F401
from test_torch_session import _jax_layer_indices

pytestmark = pytest.mark.usefixtures("one_thread")

LLAVA_CFG = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 2, "rope_theta": 10000.0,
             "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
             "vision_config": {"num_attention_heads": 4}}
QUESTION = [5, 6]


def _longva_dir(root):
    state = {}
    state.update(_tiny_clip_state(
        "model.vision_tower.vision_tower.vision_model."))
    state.update(_tiny_qwen_state("model."))
    state.update(_mlp2x_state("model.mm_projector.", 32, 64))
    path = root / "longva"
    path.mkdir()
    _save_sharded(state, str(path), n_shards=3)
    (path / "config.json").write_text(json.dumps(
        dict(LLAVA_CFG, model_type="llava_qwen")))
    return path


def _flash_dir(root):
    """llava_vstream layout, Llama without qkv biases, and the tower's
    pre-layernorm under the 'pre_layernorm' spelling."""
    state = {}
    for k, v in _tiny_clip_state(
            "model.vision_tower.vision_tower.vision_model.", seed=1).items():
        state[k.replace("pre_layrnorm", "pre_layernorm")] = v
    state.update(_tiny_qwen_state("model.", seed=1, bias=False))
    state.update(_mlp2x_state("model.mm_projector.", 32, 64, seed=1))
    path = root / "flash"
    path.mkdir()
    _save_sharded(state, str(path), n_shards=2)
    (path / "config.json").write_text(json.dumps(
        dict(LLAVA_CFG, model_type="llava_vstream")))
    return path


def _video_llava_dir(root):
    from transformers import (CLIPVisionConfig, LlamaConfig,
                              VideoLlavaConfig,
                              VideoLlavaForConditionalGeneration)
    torch.manual_seed(0)
    vis = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=56, patch_size=14)
    txt = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, rope_theta=10000.0,
                      tie_word_embeddings=False)
    model = VideoLlavaForConditionalGeneration(VideoLlavaConfig(
        vision_config=vis, text_config=txt, image_token_index=255,
        video_token_index=254)).eval()
    path = root / "video_llava"
    model.save_pretrained(path, safe_serialization=True)
    return path


# registry name: (checkpoint writer, tokens a frame, stc_tpu loader)
CASES = {"longva_7b": (_longva_dir, 4, "longva.load_longva_7b"),
         "video_llava_7b": (_video_llava_dir, 17,
                            "video_llava.load_video_llava_7b"),
         "flash_vstream_7b": (_flash_dir, 16,
                              "flash_vstream.load_flash_vstream")}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_ckpt")
    return {name: make(root) for name, (make, _, _) in CASES.items()}


def _jax_loader(name):
    import importlib
    mod, fn = CASES[name][2].split(".")
    return getattr(importlib.import_module(f"stc_tpu.models.{mod}"), fn)


def _eq(got: torch.Tensor, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_loader_matches_jax_loader(dirs, name):
    """Every tensor the port's loader fills equals stc_tpu's loader's, the
    configs it infers are equal, and the sessions answer alike."""
    _, tpf, _ = CASES[name]
    scfg = tiny_session_cfg(tpf, cacher="cacher" if name == "longva_7b"
                            else "none")
    jsess, jcfg = _jax_loader(name)(str(dirs[name]), scfg=scfg,
                                    dtype=jnp.float32)
    tsess, tcfg = MODEL_REGISTRY[name](
        str(dirs[name]), scfg=port_cfg(scfg), dtype=torch.float32,
        vision_dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)
    assert tcfg.tokens_per_frame == jcfg.tokens_per_frame == tpf
    assert tcfg.text.qkv_bias == (name == "longva_7b")
    P, model = jsess._all_params, tsess.model
    V = P["vision"]
    for key in ("class_embed", "patch_w", "pos_embed", "pre_ln_w",
                "pre_ln_b", "post_ln_w", "post_ln_b"):
        _eq(getattr(model.vision, key), V[key], key)
    for i, lp in enumerate(model.vision.layers):
        for key, arr in V["layers"].items():
            _eq(getattr(lp, key), arr[i], f"vision {key} {i}")
    for key in ("w1", "b1", "w2", "b2"):
        _eq(getattr(model.projector, key), P["projector"][key], key)
    text, L = P["text"], P["text"]["layers"]
    for key in ("embed", "norm_f", "lm_head"):
        _eq(getattr(model.text, key), text[key], key)
    for i, lp in enumerate(model.text.layers):
        for key in ("ln1", "ln2", "wqkv", "bqkv", "wo", "w_gateup",
                    "w_down"):
            _eq(getattr(lp, key), L[key][i], f"text {key} {i}")
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 56, 3),
                                               dtype=np.uint8)
    for s in (jsess, tsess):
        s.encode_init_prompt([1, 2, 3, 4])
        for f in range(4):
            s.encode_video(frames[f:f + 1])
    want_idx = _jax_layer_indices(jsess, QUESTION)
    ask = [s.question_answering(QUESTION, QUESTION + [7], [0],
                                max_new_tokens=3) for s in (jsess, tsess)]
    assert ask[1] == ask[0]
    assert tsess.last_retrieved_indices == want_idx
    if name == "longva_7b":
        np.testing.assert_array_equal(
            tsess._vstate.tokens_skipped.numpy(),
            np.asarray(jsess._vstate.tokens_skipped))


def test_config_helpers_equal(dirs):
    """llama_config_from_hf, clip_config_from_hf and clip_config_from_state
    give stc_tpu's configs."""
    hf = tconv.read_hf_config(str(dirs["video_llava_7b"]))
    assert dataclasses.asdict(tconv.llama_config_from_hf(hf.text_config)) \
        == dataclasses.asdict(jconv.llama_config_from_hf(hf.text_config))
    assert dataclasses.asdict(tconv.clip_config_from_hf(hf.vision_config)) \
        == dataclasses.asdict(jconv.clip_config_from_hf(hf.vision_config))
    for name, pfx in (("video_llava_7b", "video_tower.vision_model."),
                      ("longva_7b",
                       "model.vision_tower.vision_tower.vision_model.")):
        tstate = tconv.load_hf_state(str(dirs[name]))
        jstate = jconv.load_hf_state(str(dirs[name]))
        assert dataclasses.asdict(tconv.clip_config_from_state(
            tstate, pfx, 4)) == dataclasses.asdict(
            jconv.clip_config_from_state(jstate, pfx, 4))
    flash = tconv.read_hf_config(str(dirs["flash_vstream_7b"]))
    got = tconv.llama_config_from_hf(flash)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconv.llama_config_from_hf(flash))
    assert not got.qkv_bias and got.num_kv_heads == 2


def test_mlp2x_and_projector_read_the_checkpoint(dirs):
    """convert_mlp2x reads keys 0.* / 2.* and convert_projector
    linear_{1,2}.*, each transposed to (in, out)."""
    state = tconv.load_hf_state(str(dirs["longva_7b"]))
    model = MODEL_REGISTRY["longva_7b"](
        str(dirs["longva_7b"]), scfg=port_cfg(tiny_session_cfg(4)),
        dtype=torch.float32, device="cpu")[0].model
    assert torch.equal(model.projector.w2,
                       state["model.mm_projector.2.weight"].t())
    assert torch.equal(model.vision.class_embed, state[
        "model.vision_tower.vision_tower.vision_model.embeddings"
        ".class_embedding"])
    state = tconv.load_hf_state(str(dirs["video_llava_7b"]))
    model = MODEL_REGISTRY["video_llava_7b"](
        str(dirs["video_llava_7b"]), scfg=port_cfg(tiny_session_cfg(17)),
        dtype=torch.float32, device="cpu")[0].model
    key = next(k for k in state if k.endswith("linear_1.weight"))
    assert torch.equal(model.projector.w1, state[key].t())
    assert all(torch.count_nonzero(lp.bqkv) == 0
               for lp in model.text.layers)


def test_registry_has_all_four():
    from stc_tpu_torch.models import llava_onevision  # noqa: F401
    assert {"llava_ov_7b", "longva_7b", "video_llava_7b",
            "flash_vstream_7b"} <= set(MODEL_REGISTRY)
