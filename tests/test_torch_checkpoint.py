"""Session checkpoints and stream migration in the port
(tests/test_migration.py's and test_utils.py's checkpoint cases), and the
.npz files crossing between the packages in both directions.

Both packages write the same file: leaf_<i> in stc_tpu's jax.tree.flatten
order, bf16 leaves as two-byte voids holding the bf16 bits, host-tier
chunks as host_k_<i> / host_v_<i> (+ scales).  Integer leaves and answer
ids are compared exactly; float leaves written by the two packages from
their own runs to DEEP_TOL (the same float32 arithmetic in another
summation order); a file loaded and saved again is byte-identical."""

import dataclasses
import os
import zipfile

import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime.session import StreamingSession as JSession
from stc_tpu.utils import checkpoint as jck
from stc_tpu_torch import weights
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.runtime.session import StreamingSession as TSession
from stc_tpu_torch.utils import checkpoint as tck
from test_torch_common import (DEEP_TOL, np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

RC = ReKVConfig(n_init=4, n_local=128, block_size=8, exc_block_size=8,
                topk=4, chunk_size=1, max_blocks=64, max_prompt_tokens=16,
                max_new_tokens=8, spec_decode_draft=3,
                spec_history_tokens=24)
STOP = [0]
Q, P = [5, 6, 7], [5, 6, 7, 8]
MCFG = jq.Qwen2Config.tiny()


def _bare(seed=7, rc=RC, dtype="float32"):
    """Makers of stc_tpu and port feature sessions over one model."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = jq.init_params(MCFG, jax.random.key(seed), dtype=jdt)
    lm = weights.qwen2_from_jax(np_tree(params), port_model_cfg(MCFG),
                                dtype=tdt, device="cpu")

    def port(batch, rc=rc):
        s = TSession(lm, port_cfg(SessionConfig(rekv=rc)), batch=batch,
                     state_dtype=tdt)
        s.encode_init_prompt(list(range(rc.n_init)))
        return s

    def jax_(batch, rc=rc):
        s = JSession(params, MCFG, SessionConfig(rekv=rc), batch=batch,
                     state_dtype=jdt)
        s.encode_init_prompt(list(range(rc.n_init)))
        return s

    return port, jax_


def _feats(rng, batch, n=8):
    return rng.normal(size=(batch, n, MCFG.hidden_size)).astype(np.float32)


def _feed(s, x, active=None):
    s.encode_video_features(x if isinstance(s, JSession)
                            else torch.from_numpy(x), active=active)


def _ask(s, batch, m=6):
    return s.question_answering_batch([Q] * batch, [P] * batch, STOP,
                                      max_new_tokens=m)


def _ragged(s, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    for _ in range(2):
        _feed(s, _feats(rng, s.batch))
    _feed(s, _feats(rng, s.batch), active=[True] + [False] * (s.batch - 1))


def test_session_roundtrip_keeps_ragged_counters(tmp_path):
    """save / load_session_state round-trips a ragged session with its
    draft history: counters, history and every state leaf equal, and the
    restored session answers as the source does."""
    port, _ = _bare()
    s = port(2)
    _ragged(s)
    _ask(s, 2)
    assert s._stream_blocks.tolist() == [3, 2] and s._qa_hist_len.all()
    path = str(tmp_path / "full.npz")
    tck.save_session_state(s, path)
    s2 = tck.load_session_state(port(2), path)
    assert s2._ragged and s2._stream_blocks.tolist() == [3, 2]
    assert s2._init_len == RC.n_init and s2._total_blocks == 3
    np.testing.assert_array_equal(s2._qa_hist, s._qa_hist)
    for x, y in zip(s.kvs, s2.kvs):
        assert torch.equal(x, y)
    assert _ask(s2, 2) == _ask(s, 2)


def _vlm(seed=11, batch=2):
    cfg = jlo.LlavaOVConfig.tiny()
    scfg = SessionConfig(
        rekv=dataclasses.replace(RC, block_size=3, exc_block_size=3,
                                 max_prompt_tokens=32),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=3))
    params = jlo.init_random_params(cfg, jax.random.key(seed))
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")

    def port(b=batch):
        s = tlo.build_session(model, port_cfg(scfg),
                              state_dtype=torch.float32, device="cpu",
                              batch=b)
        s.encode_init_prompt([1, 2, 3, 4])
        return s

    def jax_(b=batch):
        s = jlo.build_session(params, cfg, scfg, state_dtype=jnp.float32,
                              batch=b)
        s.encode_init_prompt([1, 2, 3, 4])
        return s

    return port, jax_


def _frames(seed, n=4):
    return np.random.default_rng(seed).uniform(
        0, 255, (n, 1, 56, 56, 3)).astype(np.uint8)


def test_vlm_session_roundtrip_continues_the_stream(tmp_path):
    """A pixel session (cacher and pruner state, per-slot schedules)
    saved after three frames and restored into a fresh session streams on
    and answers exactly as the uninterrupted one."""
    port, _ = _vlm()
    frames = _frames(0, 5)
    a = port()
    for f in frames[:3]:
        a.encode_video(np.stack([f, f]))
    path = str(tmp_path / "state.npz")
    tck.save_session_state(a, path)
    b = tck.load_session_state(port(), path)
    assert b.chunk_idx == 3 and b._slot_chunk.tolist() == [3, 3]
    for s in (a, b):
        for f in frames[3:]:
            s.encode_video(np.stack([f, f]))
    assert _ask(b, 2, 4) == _ask(a, 2, 4)
    for x, y in zip(a._vstate + a._pstate, b._vstate + b._pstate):
        assert torch.equal(x, y)


def test_stream_migration_between_sessions(tmp_path):
    """Slot 1 of a 2-stream session (ragged, with history) moves into slot
    2 of a 3-stream session and answers as it did; the target's other
    slots answer as before; the stream goes on streaming there."""
    port, _ = _bare()
    rng = np.random.default_rng(0)
    sa = port(2)
    for _ in range(4):
        _feed(sa, _feats(rng, 2))
    _feed(sa, _feats(rng, 2), active=[False, True])
    want = _ask(sa, 2)[1]
    path = str(tmp_path / "stream.npz")
    tck.save_stream_state(sa, 1, path)
    sb = port(3)
    for _ in range(3):
        _feed(sb, _feats(rng, 3))
    before = _ask(sb, 3)
    tck.load_stream_state(sb, 2, path)
    assert sb._stream_blocks.tolist() == [3, 3, 5]
    np.testing.assert_array_equal(sb._qa_hist[2], sa._qa_hist[1])
    after = _ask(sb, 3)
    assert after[2] == want and after[:2] == before[:2]
    _feed(sb, _feats(rng, 3), active=[False, False, True])
    assert sb._stream_blocks.tolist() == [3, 3, 6]


def test_stream_migration_vlm(tmp_path):
    """Pixel-path migration: the cacher references, pruner memory and
    cacher-schedule count move with the stream, which answers as in its
    source session."""
    port, _ = _vlm()
    frames = _frames(2)
    sa = port()
    for f in frames:
        sa.encode_video(np.stack([f, f]))
    want = _ask(sa, 2, 4)[0]
    path = str(tmp_path / "vlm.npz")
    tck.save_stream_state(sa, 0, path)
    sb = port()
    sb.encode_video(np.stack([frames[0], frames[0]]))
    tck.load_stream_state(sb, 1, path)
    assert sb._slot_chunk.tolist() == [1, 4]
    for x, y in zip(sb._vstate, sa._vstate):     # (L, B, T, C)
        assert torch.equal(x[:, 1], y[:, 0])
    for x, y in zip(sb._pstate, sa._pstate):     # (B, ...)
        assert torch.equal(x[1], y[0])
    assert _ask(sb, 2, 4)[1] == want


def _same_file_layout(a, b, float_tol=DEEP_TOL):
    """Two .npz files of one state: the same keys, dtypes and shapes,
    integer and bool arrays equal, floats within float_tol."""
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        x, y = da[k], db[k]
        assert (x.dtype.str, x.shape) == (y.dtype.str, y.shape), k
        if x.dtype.kind in "iub":
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, err_msg=k, **float_tol)


@pytest.mark.parametrize("what", ["session", "stream"])
def test_files_cross_between_packages(tmp_path, what):
    """A pixel session's (or one stream's) file saved by stc_tpu loads into
    the port and the port's into stc_tpu: each answers as the source
    session does; and both packages' files of the same stream have one
    layout (keys, leaf order, dtypes, shapes, integers), the port's
    members stored and stc_tpu's compressed."""
    port, jax_ = _vlm(seed=13)
    frames = _frames(5)
    src = {"port": port(), "jax": jax_()}
    for s in src.values():
        for f in frames:
            s.encode_video(np.stack([f, f[::-1]]))
        _ask(s, 2, 4)   # a draft history to carry
    paths = {k: str(tmp_path / f"{k}.npz") for k in src}
    for k, s in src.items():
        if what == "session":
            (tck if k == "port" else jck).save_session_state(s, paths[k])
        else:
            (tck if k == "port" else jck).save_stream_state(s, 1, paths[k])
    _same_file_layout(paths["port"], paths["jax"])
    for k, kind in (("port", zipfile.ZIP_STORED),
                    ("jax", zipfile.ZIP_DEFLATED)):
        with zipfile.ZipFile(paths[k]) as z:
            assert {i.compress_type for i in z.infolist()} == {kind}
    want = {k: _ask(s, 2, 4) for k, s in src.items()}
    assert want["port"] == want["jax"]
    for dst, mod, frm in (("port", tck, "jax"), ("jax", jck, "port")):
        s = port() if dst == "port" else jax_()
        if what == "session":
            mod.load_session_state(s, paths[frm])
            assert _ask(s, 2, 4) == want[frm]
        else:
            s.encode_video(np.stack([frames[0], frames[0]]))
            mod.load_stream_state(s, 0, paths[frm])
            assert s._slot_chunk.tolist() == [4, 1]
            assert _ask(s, 2, 4)[0] == want[frm][1]


def test_bf16_leaves_keep_their_bits(tmp_path, monkeypatch):
    """bf16 leaves are stored as the bf16 bits in two-byte voids: a bf16
    file of stc_tpu's loads into the port bit for bit (the bytes
    reinterpreted, not converted), and the port saves it back
    byte-identical.  stc_tpu's own loader cannot convert those voids back
    (numpy has no cast from them), so it reads the port's file here with
    the voids viewed as bfloat16, and answers as the port does."""
    port, jax_ = _bare(dtype="bfloat16")
    j = jax_(2)
    _ragged(j)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_session_state(j, jpath)
    assert np.load(jpath)["leaf_3"].dtype.str == "|V2"
    t = tck.load_session_state(port(2), jpath)
    for x, y in zip(t.kvs, j.kvs):
        y = np.asarray(y)
        got = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
        want = y.view(np.int16) if y.dtype == ml_dtypes.bfloat16 else y
        np.testing.assert_array_equal(got, want)
    tck.save_session_state(t, tpath)
    dj, dt = np.load(jpath), np.load(tpath)
    for k in dj.files:
        assert dj[k].dtype.str == dt[k].dtype.str and \
            dj[k].tobytes() == dt[k].tobytes(), k
    with pytest.raises(ValueError, match="cast"):
        jck.load_session_state(jax_(2), jpath)
    load = np.load

    class Viewed:
        def __init__(self, path, **kw):
            self.d = load(path, **kw)
            self.files = self.d.files

        def __contains__(self, k):
            return k in self.d

        def __getitem__(self, k):
            x = self.d[k]
            return x.view(ml_dtypes.bfloat16) if x.dtype.str == "|V2" else x

    monkeypatch.setattr(np, "load", Viewed)
    j2 = jck.load_session_state(jax_(2), tpath)
    monkeypatch.undo()
    assert _ask(j2, 2) == _ask(t, 2)


@pytest.mark.parametrize("host_quant", ["none", "int8"])
def test_host_tier_chunks_cross_between_packages(tmp_path, host_quant):
    """Two streams past a 32-page store (three evictions): the session
    file carries the host-tier chunks (exact pages, or int8 with scales);
    the port's file and stc_tpu's hold the same chunk layout, each loads
    into the other package and the restored sessions answer as the
    sources do."""
    rc = dataclasses.replace(RC, max_blocks=32, host_kv_quant=host_quant)
    port, jax_ = _bare(rc=rc)
    rng = np.random.default_rng(3)
    chunks = [_feats(rng, 2) for _ in range(40)]
    src = {"port": port(2), "jax": jax_(2)}
    paths = {k: str(tmp_path / f"{k}.npz") for k in src}
    for k, s in src.items():
        for c in chunks:
            _feed(s, c)
        assert s._evicted_pages > 0
        (tck if k == "port" else jck).save_session_state(s, paths[k])
    data = np.load(paths["port"])
    assert ("host_ks_0" in data) == (host_quant == "int8")
    _same_file_layout(paths["port"], paths["jax"],
                      dict(rtol=1e-4, atol=1e-4))
    want = {k: _ask(s, 2) for k, s in src.items()}
    assert want["port"] == want["jax"]
    back = tck.load_session_state(port(2), paths["jax"])
    assert back.host_store.total_pages == src["port"].host_store.total_pages
    assert _ask(back, 2) == want["jax"]
    assert _ask(jck.load_session_state(jax_(2), paths["port"]),
                2) == want["port"]


def test_checkpoint_guards(tmp_path):
    """Refused: a stream encoded with another init-prompt length, a bare
    session's stream into a VLM session, a file of other shapes or of
    another format, another history length, and a per-stream checkpoint
    once pages were evicted."""
    port, _ = _bare()
    sa = port(2)
    _feed(sa, _feats(np.random.default_rng(1), 2))
    path = str(tmp_path / "s.npz")
    tck.save_stream_state(sa, 0, path)
    with pytest.raises(ValueError, match="init prompt length"):
        tck.load_stream_state(port(2, dataclasses.replace(RC, n_init=8)), 0,
                              path)
    vport, _ = _vlm()
    with pytest.raises(ValueError, match="leaves"):
        tck.load_stream_state(vport(), 0, path)
    with pytest.raises(ValueError, match="configs must match"):
        tck.load_stream_state(port(2, dataclasses.replace(RC,
                                                          max_blocks=48)),
                              0, path)
    with pytest.raises(ValueError, match="spec_history_tokens"):
        tck.load_stream_state(port(2, dataclasses.replace(
            RC, spec_history_tokens=8)), 0, path)
    full = str(tmp_path / "full.npz")
    tck.save_session_state(sa, full)
    data = dict(np.load(full))
    data["fmt"] = np.asarray(2)
    old = str(tmp_path / "old.npz")
    np.savez(old, **data)
    with pytest.raises(ValueError, match="format v2"):
        tck.load_session_state(port(2), old)
    ev = port(2, dataclasses.replace(RC, max_blocks=32))
    rng = np.random.default_rng(2)
    for _ in range(36):
        _feed(ev, _feats(rng, 2))
    assert ev._evicted_pages > 0
    with pytest.raises(RuntimeError, match="host-evicted"):
        tck.save_stream_state(ev, 0, str(tmp_path / "ev.npz"))
    assert os.path.exists(full)
