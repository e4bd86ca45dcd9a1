"""Shared helpers of the PyTorch-port tests (stc_tpu_torch against stc_tpu on
the CPU), and tests of the port's configuration and device rules.

Tolerances used across the port tests:
- F32_TOL (1e-5 abs/rel): both packages run the same float32 arithmetic;
  only summation order differs (XLA vs PyTorch CPU kernels).
- KERNEL_TOL (2e-2 abs/rel): against the Pallas kernels in interpret mode,
  which round their matmul operands to bfloat16 (the bound the JAX
  package's own kernel tests use, tests/test_stream_attention.py).
- DEEP_TOL (1e-4 abs/rel): through several layers of a model, where f32
  summation-order differences compound.
- BF16_MAX_REL / BF16_RMS_REL (2^-6 of max |want|, 2^-7 of RMS want): bf16
  outputs of the same arithmetic summed in another order.  One bf16 ulp
  is at most 2^-7 of a value, so the max limit allows two ulps at the
  largest magnitude; the RMS limit, one on average (assert_bf16_close).
"""

import dataclasses

import numpy as np
import pytest
import torch

from stc_tpu import config as jcfg
from stc_tpu_torch import config as tcfg

F32_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)
DEEP_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_MAX_REL = 2 ** -6
BF16_RMS_REL = 2 ** -7


@pytest.fixture
def one_thread():
    """Run a test on one CPU thread, restoring the count after: the tiny
    shapes of the port's session tests run several times faster so (torch's
    thread pool costs more than the work) and the count does not leak into
    the tests that run next in the same process.  Import it into a test
    module as ``pytestmark = pytest.mark.usefixtures("one_thread")``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def assert_bf16_close(got, want, err_msg=""):
    """max |got - want| <= BF16_MAX_REL * max |want| and RMS(got - want) <=
    BF16_RMS_REL * RMS(want), in float64."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape, err_msg)
    d = g - w
    max_err, scale = np.abs(d).max(), np.abs(w).max()
    rms_err, rms = np.sqrt((d * d).mean()), np.sqrt((w * w).mean())
    assert max_err <= BF16_MAX_REL * scale, (err_msg, max_err, scale)
    assert rms_err <= BF16_RMS_REL * rms, (err_msg, rms_err, rms)


def port_cfg(jax_cfg):
    """The port's copy of a JAX config dataclass (same field values; the
    port's ReKVConfig has no decode_attn_backend)."""
    cls = getattr(tcfg, type(jax_cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = port_cfg(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def port_model_cfg(jax_cfg):
    """The port's Qwen2Config / SiglipConfig / CLIPConfig or backbone
    config (LLaVA-OV, LongVA, Video-LLaVA, Flash-VStream) of a JAX one."""
    from stc_tpu_torch.models import clip as cl
    from stc_tpu_torch.models import flash_vstream as fv
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import longva as lv
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg
    from stc_tpu_torch.models import video_llava as vl
    name = type(jax_cfg).__name__
    backbones = {"LlavaOVConfig": lo.LlavaOVConfig,
                 "LongVAConfig": lv.LongVAConfig,
                 "VideoLlavaConfig": vl.VideoLlavaConfig,
                 "FlashVStreamConfig": fv.FlashVStreamConfig}
    if name in backbones:
        kw = {f.name: getattr(jax_cfg, f.name)
              for f in dataclasses.fields(jax_cfg)}
        kw.update(vision=port_model_cfg(jax_cfg.vision),
                  text=port_model_cfg(jax_cfg.text))
        return backbones[name](**kw)
    cls = {"Qwen2Config": qw.Qwen2Config, "SiglipConfig": sg.SiglipConfig,
           "CLIPConfig": cl.CLIPConfig}
    return cls[name](**dataclasses.asdict(jax_cfg))


def np_tree(tree):
    """A JAX parameter tree as numpy arrays."""
    import jax
    return jax.tree.map(np.asarray, tree)


def np32(x):
    return np.asarray(x, dtype=np.float32)


def tt(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def test_port_configs_match_jax_derived_sizes():
    rk = jcfg.ReKVConfig(n_init=14, n_local=15000, block_size=60,
                         exc_block_size=480, topk=64, max_prompt_tokens=256)
    pk = port_cfg(rk)
    for name in ("rep_cap", "local_cap", "retrieve_len", "decode_cap",
                 "rope_max_pos"):
        assert getattr(pk, name) == getattr(rk, name), name
    assert not hasattr(pk, "decode_attn_backend")
    s = port_cfg(jcfg.SessionConfig(rekv=rk, encode_chunk_frames=8))
    assert s.rekv == pk and s.encode_chunk_frames == 8
    assert tcfg.MODEL_SPECS["llava_ov"].tokens_per_frame == 196


@pytest.mark.parametrize("kw", [
    dict(window_kv_compression="select_top_half"),
    dict(retrieval_scorer="aks"),
    dict(retrieved_kv_compression="filter_tokens_top_half"),
    dict(sim_source="value"),
    dict(ingest_format="yuv420")])
def test_unported_settings_raise(kw, one_thread):
    """The settings the port once refused (they raised NotImplementedError
    until the ablation slice) now build a tiny CPU pixel session that
    streams frames and answers."""
    from stc_tpu_torch.models import llava_onevision as lo
    rk = {k: v for k, v in kw.items() if hasattr(tcfg.ReKVConfig, k)}
    ck = {k: v for k, v in kw.items() if hasattr(tcfg.CacherConfig, k)}
    sk = {k: v for k, v in kw.items() if k == "ingest_format"}
    scfg = tcfg.SessionConfig(
        rekv=tcfg.ReKVConfig(n_init=4, n_local=128, block_size=3,
                             exc_block_size=3, topk=4, max_blocks=64,
                             max_prompt_tokens=32, max_new_tokens=8, **rk),
        cacher=tcfg.CacherConfig(update_token_ratio=0.5, **ck),
        pruner=tcfg.PrunerConfig(token_per_frame=3), **sk)
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       device="cpu").init_random_params(
        torch.Generator().manual_seed(0))
    sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu")
    sess.encode_init_prompt([1, 2, 3, 4])
    sess.encode_video(np.random.default_rng(0).integers(
        0, 256, (6, 56, 56, 3), dtype=np.uint8))
    out = sess.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=4)
    assert 1 <= len(out) <= 4
    assert [len(p) for p in sess.last_retrieved_indices] == [4, 4]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Every public constructor runs on the card unless the caller asks for
    the CPU; with no card it raises instead of carrying on quietly."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: qw.Qwen2(qw.Qwen2Config.tiny()),
                 lambda: sg.Siglip(sg.SiglipConfig.tiny()),
                 lambda: lo.LlavaOV(lo.LlavaOVConfig.tiny())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lo.build_session(model, tcfg.SessionConfig())
