"""The port's HF checkpoint loader on the CPU, against stc_tpu's loader on
the same tiny checkpoint directories that `transformers` writes here (no
download): every weight bit-equal and the same answer ids, in the layout
transformers saves ('language_model.model.*') and in the newer one
('model.language_model.*'), with tied and untied heads.  Also the port's
own shard reader against `safetensors`, *.bin shards, the missing-shard
error, and chip_smoke.py's checkpoint writer (phase 9) read back bit for
bit."""

import dataclasses
import glob
import importlib.util
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

torch_st = pytest.importorskip("safetensors.torch")
pytest.importorskip("transformers")

import jax.numpy as jnp

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu_torch.models import MODEL_REGISTRY
from stc_tpu_torch.models import convert as tconv
from stc_tpu_torch.models import llava_onevision as tlo
from test_torch_common import port_cfg
from test_torch_session import _jax_layer_indices

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCFG = SessionConfig(
    rekv=ReKVConfig(n_init=4, n_local=128, block_size=3, exc_block_size=3,
                    topk=4, max_blocks=64, max_prompt_tokens=32,
                    max_new_tokens=8),
    cacher=CacherConfig(update_token_ratio=0.5, cache_interval=2),
    pruner=PrunerConfig(token_per_frame=3))

QUESTION = [7, 8, 9]

# transformers' save layout -> the newer 'model.'-nested one
NEW_LAYOUT = (("language_model.model.", "model.language_model."),
              ("language_model.lm_head.", "lm_head."),
              ("vision_tower.", "model.vision_tower."),
              ("multi_modal_projector.", "model.multi_modal_projector."))


def _hf_dir(root, tie, layout):
    """A tiny LlavaOnevisionForConditionalGeneration saved by transformers
    (several shards), its keys renamed to `layout`."""
    from transformers import (LlavaOnevisionConfig,
                              LlavaOnevisionForConditionalGeneration,
                              Qwen2Config, SiglipVisionConfig)
    torch.manual_seed(0)
    vis = SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                             num_hidden_layers=2, num_attention_heads=4,
                             image_size=56, patch_size=14)
    txt = Qwen2Config(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0,
                      tie_word_embeddings=tie)
    model = LlavaOnevisionForConditionalGeneration(LlavaOnevisionConfig(
        vision_config=vis, text_config=txt, image_token_index=255,
        video_token_index=254)).eval()
    path = root / f"hf_tie{int(tie)}_{layout}"
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="100KB")
    if layout == "new":
        for f in glob.glob(str(path / "*.safetensors")):
            st = torch_st.load_file(f)
            out = {}
            for k, v in st.items():
                for old, new in NEW_LAYOUT:
                    if k.startswith(old):
                        k = new + k[len(old):]
                        break
                out[k] = v
            torch_st.save_file(out, f)
    return path


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {(tie, layout): _hf_dir(root, tie, layout)
            for tie in (True, False) for layout in ("old", "new")}


def _port_load(path, **kw):
    return MODEL_REGISTRY["llava_ov_7b"](
        str(path), scfg=port_cfg(SCFG), dtype=torch.float32, device="cpu",
        **kw)


def _stream(sess):
    """Init prompt and five one-frame chunks (full and cached paths)."""
    frames = np.random.default_rng(5).integers(0, 256, (5, 56, 56, 3),
                                               dtype=np.uint8)
    sess.encode_init_prompt([1, 2, 3, 4])
    for f in range(5):
        sess.encode_video(frames[f:f + 1])


def _ask(sess):
    return sess.question_answering(QUESTION, QUESTION + [10], [0],
                                   max_new_tokens=6)


def _eq(got: torch.Tensor, want, name):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=name)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("layout", ["old", "new"])
def test_loader_matches_jax_loader(hf_dirs, tie, layout):
    """Same directory, both loaders: every weight bit-equal (f32), the
    head tied or not as the checkpoint says, the same answer ids."""
    from stc_tpu.models.llava_onevision import load_llava_ov_7b
    path = hf_dirs[tie, layout]
    jsess, jcfg = load_llava_ov_7b(str(path), scfg=SCFG, dtype=jnp.float32)
    tsess, tcfg = _port_load(path)
    assert tcfg.text.tie_embeddings == tie
    assert (tcfg.vision.num_layers, tcfg.text.num_layers) == (2, 2)
    P = jsess._all_params
    model = tsess.model
    text, L = P["text"], P["text"]["layers"]
    for name in ("embed", "norm_f", "lm_head"):
        _eq(getattr(model.text, name), text[name], name)
    for i, lp in enumerate(model.text.layers):
        for name in ("ln1", "ln2", "wqkv", "bqkv", "wo", "w_gateup",
                     "w_down"):
            _eq(getattr(lp, name), L[name][i], f"text {name} {i}")
    V = P["vision"]
    for name in ("patch_w", "patch_b", "pos_embed", "post_ln_w",
                 "post_ln_b"):
        _eq(getattr(model.vision, name), V[name], name)
    for i, lp in enumerate(model.vision.layers):
        for name, arr in V["layers"].items():
            _eq(getattr(lp, name), arr[i], f"vision {name} {i}")
    for name in ("w1", "b1", "w2", "b2"):
        _eq(getattr(model.projector, name), P["projector"][name], name)
    if tie:
        assert torch.equal(model.text.lm_head, model.text.embed.t())
    else:
        assert not torch.equal(model.text.lm_head, model.text.embed.t())
    for s in (jsess, tsess):
        _stream(s)
    want_idx = _jax_layer_indices(jsess, QUESTION)
    assert _ask(tsess) == _ask(jsess)
    assert tsess.last_retrieved_indices == want_idx


def test_loader_fills_from_the_checkpoint_tensors(hf_dirs):
    """Spot checks against the raw checkpoint: q/k/v and gate/up fused
    and transposed, the patch conv flattened, the untied head."""
    state = tconv.load_hf_state(str(hf_dirs[False, "old"]))
    model = _port_load(hf_dirs[False, "old"])[0].model
    lp, pre = model.text.layers[1], "language_model.model.layers.1."
    q = state[pre + "self_attn.q_proj.weight"]
    assert torch.equal(lp.wqkv[:, :q.shape[0]], q.t())
    assert torch.equal(lp.bqkv[-32:], state[pre + "self_attn.v_proj.bias"])
    assert torch.equal(lp.w_gateup[:, 128:],
                       state[pre + "mlp.up_proj.weight"].t())
    assert torch.equal(model.text.lm_head,
                       state["language_model.lm_head.weight"].t())
    conv = state["vision_tower.vision_model.embeddings.patch_embedding"
                 ".weight"]
    assert torch.equal(model.vision.patch_w, conv.reshape(32, -1).t())


def test_absent_qkv_biases_load_as_zeros(hf_dirs, tmp_path):
    path = tmp_path / "nobias"
    shutil.copytree(hf_dirs[True, "old"], path)
    for f in glob.glob(str(path / "*.safetensors")):
        st = torch_st.load_file(f)
        torch_st.save_file({k: v for k, v in st.items()
                            if not (k.endswith("_proj.bias")
                                    and "self_attn" in k
                                    and "language_model" in k)}, f)
    model = _port_load(path)[0].model
    assert all(torch.count_nonzero(lp.bqkv) == 0
               for lp in model.text.layers)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_shard_reader_matches_safetensors(tmp_path, dtype):
    """read_safetensors against safetensors.torch.load_file: odd sizes
    (offsets that break the item alignment of the next tensor), a scalar,
    an empty tensor and int64 beside the dtype under test."""
    gen = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=gen).to(dtype),
               "b.odd": torch.randn(7, generator=gen).to(torch.bfloat16),
               "c": torch.randn(4, 2, 3, generator=gen).to(dtype),
               "ids": torch.arange(11, dtype=torch.int64),
               "s": torch.tensor(2.5).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    f = tmp_path / "x.safetensors"
    torch_st.save_file(tensors, f, metadata={"format": "pt"})
    want = torch_st.load_file(f)
    got = tconv.read_safetensors(str(f))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_shard_reader_names_a_dtype_it_does_not_take(tmp_path):
    f = tmp_path / "x.safetensors"
    torch_st.save_file({"w": torch.ones(2, dtype=torch.int32)}, f)
    with pytest.raises(ValueError, match="I32"):
        tconv.read_safetensors(str(f))


def test_bin_shards_load_like_safetensors(hf_dirs, tmp_path):
    """The same checkpoint as *.bin shards (torch.save, read with
    weights_only): the same state and the same weights."""
    src = hf_dirs[False, "new"]
    shutil.copy(src / "config.json", tmp_path / "config.json")
    files = sorted(glob.glob(str(src / "*.safetensors")))
    for i, f in enumerate(files):
        torch.save(torch_st.load_file(f),
                   tmp_path / f"pytorch_model-{i:05d}.bin")
    want = tconv.load_hf_state(str(src))
    got = tconv.load_hf_state(str(tmp_path))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    a = _port_load(src)[0].model.state_dict()
    b = _port_load(tmp_path)[0].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_missing_shards_raise_file_not_found(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        tconv.load_hf_state(str(tmp_path))


def test_loader_defaults_to_cuda_and_raises_without_it(hf_dirs,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlo.load_llava_ov_7b(str(hf_dirs[True, "old"]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_checkpoint_round_trips(tmp_path):
    """Phase 9's writer on a tiny model with a tied head, in bf16 shards:
    safetensors reads what it wrote, and the port's loader gives back
    every tensor bit for bit (vision weights hold bf16 values, as phase 9
    makes them)."""
    cs = _chip_smoke()
    cfg = tlo.LlavaOVConfig.tiny()
    model = tlo.LlavaOV(cfg, dtype=torch.bfloat16, device="cpu")
    model.init_random_params(torch.Generator().manual_seed(3))
    cs.tie_head_and_round_vision(model)
    nbytes = cs.write_hf_checkpoint(model, str(tmp_path), n_shards=2)
    files = sorted(glob.glob(str(tmp_path / "*.safetensors")))
    assert len(files) == 2
    assert nbytes == sum(os.path.getsize(f) for f in files)
    for f in files:
        want = torch_st.load_file(f)
        got = tconv.read_safetensors(f)
        assert all(torch.equal(got[k], want[k]) for k in want)
    hf = json.loads((tmp_path / "config.json").read_text())
    assert hf["text_config"]["tie_word_embeddings"] is True
    loaded, lcfg = tlo.load_llava_ov_7b(str(tmp_path), dtype=torch.bfloat16,
                                        device="cpu")
    assert lcfg.vision == cfg.vision
    assert lcfg.text == dataclasses.replace(cfg.text, tie_embeddings=True)
    src, got = model.state_dict(), loaded.model.state_dict()
    assert sorted(src) == sorted(got)
    for k in src:
        assert got[k].dtype == src[k].dtype, k
        assert torch.equal(got[k], src[k]), k
