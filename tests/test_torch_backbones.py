"""The CLIP backbones of the port (LongVA, Video-LLaVA, Flash-VStream) on
the CPU, against stc_tpu's sessions built from the same numpy weights and
fed the same frames: every case of tests/test_backbones.py mirrored.  Answer
ids, every layer's retrieved blocks, num_blocks, chunk_idx and the
cacher's tokens_processed / tokens_skipped must be equal; pages within
DEEP_TOL.  Also LongVA stream and session files crossing between the
packages, and a LongVA yuv420 session."""

import dataclasses
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.models import flash_vstream as jfv
from stc_tpu.models import longva as jlv
from stc_tpu.models import video_llava as jvl
from stc_tpu.utils import checkpoint as jck
from stc_tpu_torch import weights
from stc_tpu_torch.models import flash_vstream as tfv
from stc_tpu_torch.models import longva as tlv
from stc_tpu_torch.models import video_llava as tvl
from stc_tpu_torch.utils import checkpoint as tck
from test_torch_common import (DEEP_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)
from test_torch_session import _jax_layer_indices

pytestmark = pytest.mark.usefixtures("one_thread")

# backbone: (JAX module, its session class, port module)
BACKBONES = {"longva": (jlv, jlv.LongVASession, tlv),
             "video_llava": (jvl, jvl.VideoLlavaSession, tvl),
             "flash_vstream": (jfv, jfv.FlashVStreamSession, tfv)}
QUESTION, PROMPT = [5, 6], [5, 6, 7]


def _session_cfg(tpf, n_local=256, chunk_frames=1, cacher="none",
                 ingest="rgb"):
    """tests/test_backbones.py's session config."""
    return SessionConfig(
        rekv=ReKVConfig(n_init=4, n_local=n_local, block_size=tpf,
                        exc_block_size=tpf, topk=4, max_blocks=128,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(strategy=cacher, update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="none", token_per_frame=tpf),
        encode_chunk_frames=chunk_frames, ingest_format=ingest)


def _makers(name, seed, **kw):
    """Makers of stc_tpu's and the port's session of `batch` streams over
    one backbone's tiny weights, init prompt encoded."""
    jmod, jsess, tmod = BACKBONES[name]
    cfg = (jmod.LongVAConfig if name == "longva" else
           jmod.VideoLlavaConfig if name == "video_llava" else
           jmod.FlashVStreamConfig).tiny()
    scfg = _session_cfg(cfg.tokens_per_frame, **kw)
    params = jmod.init_random_params(cfg, jax.random.key(seed))
    model = weights.backbone_from_jax(np_tree(params), port_model_cfg(cfg),
                                      device="cpu")

    def jax_(batch=1):
        s = jsess(params, cfg, scfg, state_dtype=jnp.float32, batch=batch)
        s.encode_init_prompt([1, 2, 3, 4])
        return s

    def port(batch=1):
        s = tmod.build_session(model, port_cfg(scfg),
                               state_dtype=torch.float32, device="cpu",
                               batch=batch)
        s.encode_init_prompt([1, 2, 3, 4])
        return s

    return jax_, port


def _frames(seed, shape):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.uint8)


def _ask(s, all_streams=False):
    return s.question_answering(QUESTION, PROMPT, [0], max_new_tokens=4,
                                all_streams=all_streams)


def _same_state(t, j):
    """Integer state equal, pages within DEEP_TOL, cacher counters equal."""
    assert t.chunk_idx == j.chunk_idx
    np.testing.assert_array_equal(t._slot_chunk, j._slot_chunk)
    for name in ("num_blocks", "length"):
        np.testing.assert_array_equal(getattr(t.kvs, name).numpy(),
                                      np.asarray(getattr(j.kvs, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.kvs.block_k.numpy(),
                               np.asarray(j.kvs.block_k), **DEEP_TOL)
    for name in ("has_ref", "tokens_processed", "tokens_skipped"):
        np.testing.assert_array_equal(getattr(t._vstate, name).numpy(),
                                      np.asarray(getattr(j._vstate, name)),
                                      err_msg=name)


@pytest.mark.parametrize("name,chunk", [("longva", 1), ("video_llava", 1),
                                        ("video_llava", 2),
                                        ("flash_vstream", 1)])
def test_session_matches_jax(name, chunk):
    """Each backbone's tiny session (tests/test_backbones.py's drive, and
    Video-LLaVA at 2-frame chunks): 4 frames, a question, 2 more frames,
    another; answers, every layer's retrieved blocks and the state equal."""
    jax_, port = _makers(name, {"longva": 0, "video_llava": 1,
                                "flash_vstream": 2}[name],
                         chunk_frames=chunk,
                         cacher="cacher" if name == "longva" else "none")
    j, t = jax_(), port()
    frames = _frames(0, (6, 56, 56, 3))
    for lo, hi in ((0, 4), (4, 6)):
        for f in range(lo, hi, chunk):
            j.encode_video(frames[f:f + chunk])
            t.encode_video(frames[f:f + chunk])
        _same_state(t, j)
        want_idx = _jax_layer_indices(j, QUESTION)
        assert _ask(t) == _ask(j)
        assert t.last_retrieved_indices == want_idx
    assert int(t.kvs.num_blocks[0, 0]) == 6
    assert t.chunk_idx == 6 // chunk
    if name == "longva":   # 3 full and 3 cached one-frame chunks
        T, L = 17, 2
        assert int(t._vstate.tokens_processed[0]) == 6 * T
        assert int(t._vstate.tokens_skipped[0]) == 3 * L * int(T * 0.5)


def test_longva_ragged_matches_jax_and_solo():
    """B = 2 ragged LongVA streams (per-stream references and schedules):
    answers and state equal to stc_tpu's B = 2 session, and each stream's
    answer equal to a solo port session's."""
    jax_, port = _makers("longva", 3, cacher="cacher")
    pattern = [(True, True), (True, False), (False, True), (True, True)]
    frames = [[_frames(100 * b + i, (1, 56, 56, 3)) for i in range(4)]
              for b in range(2)]
    j2, t2 = jax_(2), port(2)
    for step, act in enumerate(pattern):
        x = np.stack([frames[b][step] for b in range(2)])
        j2.encode_video(x, active=act)
        t2.encode_video(x, active=act)
    _same_state(t2, j2)
    ans = _ask(t2, True)
    assert ans == _ask(j2, True)
    for b in range(2):
        solo = port(1)
        for step, act in enumerate(pattern):
            if act[b]:
                solo.encode_video(frames[b][step])
        assert ans[b] == _ask(solo), b


def test_longva_churn_mixed_ticks_matches_jax():
    """Slot recycling drives the mixed full/cached tick: the port's churned
    session equals stc_tpu's (answers, counters, schedules), its live slot
    equals an unchurned twin's, its new tenant a fresh solo session's."""
    jax_, port = _makers("longva", 6, cacher="cacher")
    frames = [_frames(200 + i, (1, 56, 56, 3)) for i in range(8)]
    got = {}
    for pkg, make in (("jax", jax_), ("port", port)):
        s = make(2)
        for i in range(3):
            s.encode_video(np.stack([frames[i], frames[i]]))
        s.reset_streams([1])
        assert s._slot_chunk.tolist() == [3, 0]
        assert int(np.asarray(s._vstate.tokens_processed)[1]) == 0
        for i in range(3, 5):
            s.encode_video(np.stack([frames[i], frames[i + 2]]))
        got[pkg] = (s, _ask(s, True))
    (j, ja), (t, ta) = got["jax"], got["port"]
    _same_state(t, j)
    assert ta == ja
    twin = port(2)
    for i in range(3):
        twin.encode_video(np.stack([frames[i], frames[i]]))
    for i in range(3, 5):
        twin.encode_video(np.stack([frames[i], frames[i + 2]]))
    assert ta[0] == _ask(twin, True)[0]
    solo = port(1)
    solo.encode_video(frames[5])
    solo.encode_video(frames[6])
    assert ta[1] == _ask(solo)
    assert int(t._vstate.tokens_processed[1]) == \
        int(solo._vstate.tokens_processed[0])


def test_video_llava_churn_and_migration_matches_jax(tmp_path):
    """Video-LLaVA slot recycling and stream migration, in both packages:
    the recycled slot answers as a fresh solo stream, and slot 0 saved by
    either package and restored into slot 1 of a third session of either
    package answers as it did."""
    jax_, port = _makers("video_llava", 4)
    frames = [_frames(300 + i, (1, 56, 56, 3)) for i in range(6)]
    mods = {"jax": jck, "port": tck}
    got, want0, paths = {}, {}, {}
    for pkg, make in (("jax", jax_), ("port", port)):
        s = make(2)
        for i in range(3):
            s.encode_video(np.stack([frames[i], frames[i]]))
        want0[pkg] = _ask(s, True)[0]
        paths[pkg] = str(tmp_path / f"{pkg}.npz")
        mods[pkg].save_stream_state(s, 0, paths[pkg])
        s.reset_streams([1])
        for i in (3, 4):
            s.encode_video(np.stack([frames[i], frames[i + 1]]),
                           active=[False, True])
        got[pkg] = (s, _ask(s, True))
    _same_state(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]
    assert want0["port"] == want0["jax"]
    solo = port(1)
    solo.encode_video(frames[4])
    solo.encode_video(frames[5])
    assert got["port"][1][1] == _ask(solo)
    for dst, make in (("jax", jax_), ("port", port)):
        for src in ("jax", "port"):
            s3 = make(2)
            s3.encode_video(np.stack([frames[5], frames[5]]))
            mods[dst].load_stream_state(s3, 1, paths[src])
            assert _ask(s3, True)[1] == want0[src], (dst, src)


def test_flash_vstream_multistream_matches_jax():
    """Batched Flash-VStream streams equal stc_tpu's and each equals a solo
    port session."""
    jax_, port = _makers("flash_vstream", 5)
    fa = _frames(9, (3, 1, 56, 56, 3))
    fb = _frames(10, (3, 1, 56, 56, 3))
    j2, t2 = jax_(2), port(2)
    for i in range(3):
        j2.encode_video(np.stack([fa[i], fb[i]]))
        t2.encode_video(np.stack([fa[i], fb[i]]))
    _same_state(t2, j2)
    ans = _ask(t2, True)
    assert ans == _ask(j2, True)
    for b, fr in enumerate((fa, fb)):
        solo = port(1)
        for i in range(3):
            solo.encode_video(fr[i])
        assert ans[b] == _ask(solo), b


def _file_layout(a, b):
    """Two .npz files of one state: the same keys, dtypes, shapes and
    integers; floats within DEEP_TOL."""
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        x, y = da[k], db[k]
        assert (x.dtype.str, x.shape) == (y.dtype.str, y.shape), k
        if x.dtype.kind in "iub":
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, err_msg=k, **DEEP_TOL)
    return da


@pytest.mark.parametrize("what", ["session", "stream"])
def test_longva_files_cross_between_packages(tmp_path, what):
    """A LongVA session's (or one stream's) file written by each package
    loads into the other, which answers as the source does; both files
    have one layout.  A stream file lists the cacher leaves by sorted name
    (ref_mlp_post, ref_pre_ln2, tokens_processed, tokens_skipped), a
    session file in ClipCacherState's order."""
    jax_, port = _makers("longva", 13, cacher="cacher")
    frames = _frames(11, (5, 1, 56, 56, 3))
    src = {"port": port(2), "jax": jax_(2)}
    for s in src.values():
        for f in frames:
            s.encode_video(np.stack([f, f[:, ::-1]]))
    paths = {k: str(tmp_path / f"{k}.npz") for k in src}
    mods = {"port": tck, "jax": jck}
    for k, s in src.items():
        if what == "session":
            mods[k].save_session_state(s, paths[k])
        else:
            mods[k].save_stream_state(s, 1, paths[k])
    data = _file_layout(paths["port"], paths["jax"])
    n_kv = len(src["port"].kvs)
    L, T, C = 2, 17, 32
    if what == "stream":
        tail = [data[f"leaf_{n_kv + i}"] for i in range(4)]
        assert [x.shape for x in tail] == [(L, T, C), (L, T, C), (), ()]
        np.testing.assert_array_equal(
            tail[2], src["port"]._vstate.tokens_processed[1].numpy())
        np.testing.assert_array_equal(
            tail[0], src["port"]._vstate.ref_mlp_post[:, 1].numpy())
    else:
        n = sum(1 for f in data.files if f.startswith("leaf_"))
        tail = [data[f"leaf_{i}"] for i in range(n - 5, n)]
        assert [x.shape for x in tail] == [(L, 2, T, C), (L, 2, T, C), (L,),
                                           (2,), (2,)]
        assert tail[2].dtype == np.bool_
        np.testing.assert_array_equal(
            tail[0], src["port"]._vstate.ref_pre_ln2.numpy())
    with zipfile.ZipFile(paths["port"]) as z:
        assert {i.compress_type for i in z.infolist()} == {
            zipfile.ZIP_STORED}
    want = {k: _ask(s, True) for k, s in src.items()}
    assert want["port"] == want["jax"]
    for dst, frm in (("port", "jax"), ("jax", "port")):
        s = port(2) if dst == "port" else jax_(2)
        if what == "session":
            mods[dst].load_session_state(s, paths[frm])
            assert _ask(s, True) == want[frm]
            for name in ("tokens_processed", "tokens_skipped"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(s._vstate, name)),
                    np.asarray(getattr(src[frm]._vstate, name)))
        else:
            s.encode_video(np.stack([frames[0], frames[0]]))
            mods[dst].load_stream_state(s, 0, paths[frm])
            assert s._slot_chunk.tolist() == [5, 1]
            assert _ask(s, True)[0] == want[frm][1]
            assert int(np.asarray(s._vstate.tokens_skipped)[0]) == int(
                np.asarray(src[frm]._vstate.tokens_skipped)[1])


def test_longva_yuv420_session_matches_jax():
    """LongVA on packed yuv420 planes (the host packer, the device
    unpack): answers, blocks and counters equal stc_tpu's yuv420 session;
    the staged chunk holds half RGB's bytes and src_hw the geometry."""
    jax_, port = _makers("longva", 8, cacher="cacher", ingest="yuv420")
    j, t = jax_(), port()
    frames = _frames(12, (5, 56, 56, 3))
    for f in range(5):
        j.encode_video(frames[f:f + 1])
        t.encode_video(frames[f:f + 1])
    assert t.vision.src_hw == (56, 56)
    _same_state(t, j)
    want_idx = _jax_layer_indices(j, QUESTION)
    assert _ask(t) == _ask(j)
    assert t.last_retrieved_indices == want_idx
    staged = t.stage_chunk(frames[:1])
    assert staged.dim() == 2 and staged.numel() == 56 * 56 * 3 // 2


def test_default_session_configs_and_geometry():
    """The backbones' default session configs equal stc_tpu's at the
    published widths, and give the window rounding and cover tiles of the
    engine: 64, 40 and 64 window pages, 2, 1 and 8 pages a tile."""
    from stc_tpu_torch.kvcache.engine import n_window_pages
    from stc_tpu_torch.ops.stream_attention import pages_per_tile
    want = {"longva": (144, 64, 2), "video_llava": (257, 40, 1),
            "flash_vstream": (64, 64, 8)}
    for name, (jmod, _, tmod) in BACKBONES.items():
        jc = (jmod.LongVAConfig if name == "longva" else
              jmod.VideoLlavaConfig if name == "video_llava" else
              jmod.FlashVStreamConfig)()
        tc = port_model_cfg(jc)
        assert tc == type(tc)(**{f.name: getattr(tc, f.name)
                                 for f in dataclasses.fields(tc)})
        ts = tmod.default_session_config(tc)
        assert ts == port_cfg(jmod.default_session_config(jc)), name
        S, W, ppt = want[name]
        assert ts.rekv.block_size == tc.tokens_per_frame == S
        assert n_window_pages(ts.rekv) == W, name
        assert pages_per_tile(S) == ppt, name
    assert tvl.llama7b_config() == port_model_cfg(jvl.llama7b_config())


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card every backbone's model and session constructor
    raises unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, cfg in ((tlv, tlv.LongVAConfig.tiny()),
                     (tvl, tvl.VideoLlavaConfig.tiny()),
                     (tfv, tfv.FlashVStreamConfig.tiny())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlv.ClipVLM(cfg)
        model = tlv.ClipVLM(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.build_session(model)
