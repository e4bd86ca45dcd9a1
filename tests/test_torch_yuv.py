"""YUV 4:2:0 ingest and the host frame pipeline of the port against
stc_tpu's (tests/test_yuv_ingest.py and tests/test_native.py's cases):
the port's C++ packer (csrc/frameproc.cpp, built with g++ here) bit-equal
to its numpy twin and to stc_tpu's packer; the C++ preprocessor bit-equal
to stc_tpu's; the device reconstruction equal to stc_tpu's and to a numpy
reference; pixel sessions on packed planes answering as stc_tpu's yuv420
session and the port's RGB session do; FramePrefetcher's order, errors
and routing; stream_encode equal to encode_video."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu import native as jnative
from stc_tpu.runtime import vlm as jvlm
from stc_tpu_torch import native
from stc_tpu_torch import weights
from stc_tpu_torch.runtime import pipeline
from stc_tpu_torch.runtime.pipeline import FramePrefetcher
from stc_tpu_torch.runtime.vlm import Preprocessor
from test_torch_common import (np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


def _smooth_frames(n, h, w, seed=0):
    """Video-like frames: a shared luminance structure, gentle per-channel
    tints and mild noise (tests/test_yuv_ingest.py's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((n, h, w, 3), np.float32)
    for i in range(n):
        a, b, ph = rng.uniform(0.5, 2), rng.uniform(0.5, 2), rng.uniform()
        luma = 90 * np.sin(a * xx / w * 6.28 + ph) * np.cos(b * yy / h * 6.28)
        for c in range(3):
            tint = 25 * np.sin(xx / w * 3.14 + rng.uniform()) \
                * np.cos(yy / h * 3.14)
            out[i, :, :, c] = 128 + luma + tint
    out += rng.normal(0, 2, size=out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _numpy_rgb(packed, h, w):
    """numpy reference of the unpack: nearest 2x2 chroma, BT.601 full range,
    float32, clipped."""
    n = packed.shape[0]
    y = packed[:, :h * w].reshape(n, h, w).astype(np.float32)
    u = packed[:, h * w:h * w + h * w // 4].reshape(n, h // 2, w // 2)
    v = packed[:, h * w + h * w // 4:].reshape(n, h // 2, w // 2)

    def up(c):
        return c.repeat(2, axis=1).repeat(2, axis=2).astype(np.float32)

    uf, vf = up(u) - np.float32(128), up(v) - np.float32(128)
    return np.clip(np.stack([y + np.float32(1.402) * vf,
                             y - np.float32(0.344136) * uf
                             - np.float32(0.714136) * vf,
                             y + np.float32(1.772) * uf], axis=-1), 0, 255)


@pytest.mark.parametrize("shape", [(3, 28, 42), (1, 2, 2), (5, 64, 36)])
def test_packer_bit_equal_to_twin_and_stc_tpu(shape):
    frames = np.random.default_rng(sum(shape)).integers(
        0, 256, size=shape + (3,), dtype=np.uint8)
    got = native.rgb_to_yuv420(frames)
    n, h, w = shape
    assert got.shape == (n, h * w * 3 // 2) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, native._rgb_to_yuv420_np(frames))
    np.testing.assert_array_equal(got, jnative.rgb_to_yuv420(frames))
    np.testing.assert_array_equal(got, native.rgb_to_yuv420(frames,
                                                            n_threads=1))
    with pytest.raises(ValueError):
        native.rgb_to_yuv420(frames[:, :, :w - 1])


def test_native_preprocess_bit_equal_to_stc_tpu():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(7, 73, 91, 3), dtype=np.uint8)
    mean = np.array([0.4, 0.5, 0.6], np.float32)
    std = np.array([0.2, 0.3, 0.4], np.float32)
    got = pipeline.native_preprocess(frames, 56, mean, std)
    np.testing.assert_array_equal(
        got, jnative.preprocess_frames(frames, 56, mean, std))
    np.testing.assert_array_equal(
        native.preprocess_frames(frames, 56, mean, std, n_threads=1), got)
    # the port's device preprocess (torch half-pixel bilinear) agrees
    pre = Preprocessor(56, mean, std, torch.float32)
    np.testing.assert_allclose(pre.device(torch.from_numpy(frames)).numpy(),
                               got, rtol=2e-3, atol=2e-3)


def test_build_without_gxx_raises(monkeypatch, tmp_path):
    """The frame library is built with g++ at first use; without it the
    binding raises instead of falling back."""
    from stc_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.rgb_to_yuv420(np.zeros((1, 2, 2, 3), np.uint8))


@pytest.mark.parametrize("h,w", [(28, 28), (64, 36), (48, 48)])
def test_device_reconstruction_matches_jax_and_numpy(h, w):
    frames = _smooth_frames(2, h, w, seed=h)
    pre = Preprocessor(28, MEAN, STD, torch.float32, ingest="yuv420")
    packed = pre.host(frames)
    assert packed.shape == (2, h * w * 3 // 2) and pre.src_hw == (h, w)
    got = pre._yuv_to_rgb(torch.from_numpy(packed)).numpy()
    np.testing.assert_allclose(got, _numpy_rgb(packed, h, w), rtol=0,
                               atol=1e-3)
    jpre = jvlm.make_preprocessor(28, MEAN, STD, jnp.float32,
                                  ingest="yuv420")
    jpre.src_hw = (h, w)
    want = np.asarray(jpre._yuv_to_rgb(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want)
    rms = np.sqrt(np.mean((got - frames.astype(np.float32)) ** 2))
    assert rms < 3.0, rms
    # normalised pixels against stc_tpu's device half
    np.testing.assert_allclose(
        pre.device(torch.from_numpy(packed)).numpy(),
        np.asarray(jpre(packed)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pre.host(packed), packed)


def test_packed_geometry_follows_src_hw():
    """64x36 and 48x48 both pack to 3456 bytes a frame: each unpacks with
    its own geometry, as a fresh preprocessor would; a length that fits
    neither raises, as do packed planes before any geometry."""
    assert 64 * 36 * 3 // 2 == 48 * 48 * 3 // 2
    pre = Preprocessor(28, MEAN, STD, torch.float32, ingest="yuv420")
    with pytest.raises(ValueError, match="src_hw"):
        pre.host(np.zeros((1, 3456), np.uint8))
    for (h, w) in ((64, 36), (48, 48)):
        packed = pre.host(_smooth_frames(2, h, w, seed=h))
        assert pre.src_hw == (h, w)
        fresh = Preprocessor(28, MEAN, STD, torch.float32, ingest="yuv420")
        fresh.src_hw = (h, w)
        x = torch.from_numpy(packed)
        assert torch.equal(pre.device(x), fresh.device(x))
    pre.src_hw = (64, 36)
    with pytest.raises(ValueError, match="does not match src_hw"):
        pre.device(torch.zeros((2, 100), dtype=torch.uint8))


def _sessions(fmt, jax_too=True):
    from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                SessionConfig)
    from stc_tpu.models import llava_onevision as jlo
    from stc_tpu_torch.models import llava_onevision as tlo
    cfg = jlo.LlavaOVConfig.tiny()
    params = jlo.init_random_params(cfg, jax.random.key(0))
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=96, block_size=3,
                        exc_block_size=3, topk=2, chunk_size=1,
                        max_blocks=64, max_prompt_tokens=8,
                        max_new_tokens=6),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=3),
        encode_chunk_frames=1, ingest_format=fmt)
    t = tlo.build_session(weights.params_from_jax(
        np_tree(params), port_model_cfg(cfg), device="cpu"),
        port_cfg(scfg), state_dtype=torch.float32, device="cpu")
    j = (jlo.build_session(params, cfg, scfg, state_dtype=jnp.float32)
         if jax_too else None)
    return j, t


@pytest.mark.usefixtures("one_thread")
def test_yuv_session_answers_match_stc_tpu_and_rgb():
    """Packed-plane ingest: answers equal stc_tpu's yuv420 session's and
    the port's RGB session's on smooth frames; the serve tick and a staged
    chunk (stage_chunk: packed planes, half RGB's bytes) run too."""
    frames = _smooth_frames(6, 56, 56, seed=3)
    answers = {}
    for fmt in ("rgb", "yuv420"):
        j, t = _sessions(fmt, jax_too=fmt == "yuv420")
        t.encode_init_prompt([1, 2, 3, 4])
        t.encode_video(frames)
        answers[fmt] = t.question_answering([5, 6, 7], [5, 6, 7, 8], [0],
                                            max_new_tokens=6)
        if j is not None:
            j.encode_init_prompt([1, 2, 3, 4])
            j.encode_video(frames)
            assert j.question_answering([5, 6, 7], [5, 6, 7, 8], [0],
                                        max_new_tokens=6) == answers[fmt]
            np.testing.assert_allclose(t.kvs.block_k.numpy(),
                                       np.asarray(j.kvs.block_k),
                                       rtol=1e-4, atol=1e-4)
        tok, cnt = t.serve(frames[None, :1], None, [[5, 6]], [[5, 6, 7]],
                           [0], max_new_tokens=2)
        assert int(cnt[0]) >= 1
        staged = t.stage_chunk(frames[:1])
        assert staged.dim() == (2 if fmt == "yuv420" else 4)
        assert staged.numel() == (56 * 56 * 3 // (2 if fmt == "yuv420"
                                                  else 1))
        t.encode_video(staged)
        assert int(t.kvs.num_blocks[0, 0]) == 8
    assert answers["yuv420"] == answers["rgb"]


@pytest.mark.usefixtures("one_thread")
def test_yuv_session_equals_rgb_session_on_reconstruction():
    """A yuv420 session and an RGB session fed the numpy reconstruction of
    the same planes (0-255 floats) see the same pixels: equal pages and
    answers."""
    frames = _smooth_frames(4, 56, 56, seed=4)
    packed = native.rgb_to_yuv420(frames)
    rgb = _numpy_rgb(packed, 56, 56)
    _, ty = _sessions("yuv420", jax_too=False)
    _, tr = _sessions("rgb", jax_too=False)
    ty.vision.src_hw = (56, 56)
    for s, x in ((ty, packed), (tr, rgb)):
        s.encode_init_prompt([1, 2, 3, 4])
        s.encode_video(x)
    assert torch.equal(ty.kvs.block_k, tr.kvs.block_k)
    assert ty.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=5) \
        == tr.question_answering([5, 6], [5, 6, 7], [0], max_new_tokens=5)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_stream_encode_equals_encode_video(fmt):
    frames = _smooth_frames(5, 56, 56, seed=5)
    _, a = _sessions(fmt, jax_too=False)
    _, b = _sessions(fmt, jax_too=False)
    for s in (a, b):
        s.encode_init_prompt([1, 2, 3, 4])
    a.encode_video(frames)
    n_bytes = pipeline.stream_encode(b, frames)
    assert n_bytes == 5 * 56 * 56 * 3 // (2 if fmt == "yuv420" else 1)
    assert torch.equal(a.kvs.block_k, b.kvs.block_k)
    assert a.chunk_idx == b.chunk_idx == 5


def test_frame_prefetcher_order_and_errors():
    chunks = [np.full((1, 2, 2, 3), i, np.uint8) for i in range(5)]
    out = list(FramePrefetcher(iter(chunks), lambda c: int(c[0, 0, 0, 0])))
    assert out == [0, 1, 2, 3, 4]

    def bad(c):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(FramePrefetcher(iter(chunks), bad))


def test_frame_prefetcher_core_count_routing(monkeypatch):
    chunks = [np.full((1, 2, 2, 3), i, np.uint8) for i in range(5)]

    def pre(c):
        return int(c[0, 0, 0, 0])

    sync = FramePrefetcher(iter(chunks), pre, overlap=False)
    assert not hasattr(sync, "_t")
    assert list(sync) == [0, 1, 2, 3, 4]
    threaded = FramePrefetcher(iter(chunks), pre, overlap=True)
    assert hasattr(threaded, "_t")
    assert list(threaded) == [0, 1, 2, 3, 4]

    def bad(c):
        raise ValueError("boom")

    with pytest.raises(ValueError):
        list(FramePrefetcher(iter(chunks), bad, overlap=False))
    monkeypatch.delenv("STC_PREFETCH_OVERLAP", raising=False)
    monkeypatch.setattr(pipeline.os, "cpu_count", lambda: 1)
    assert not hasattr(FramePrefetcher(iter(chunks), pre), "_t")
    monkeypatch.setattr(pipeline.os, "cpu_count", lambda: 8)
    assert hasattr(FramePrefetcher(iter(chunks), pre), "_t")
    monkeypatch.setenv("STC_PREFETCH_OVERLAP", "0")
    assert not hasattr(FramePrefetcher(iter(chunks), pre), "_t")
