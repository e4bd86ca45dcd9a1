"""Session and stream checkpoints (port of ``stc_tpu/utils/checkpoint.py``).

A whole session (stream KV state, counters, draft history, vision and
pruner state, host-tier chunks) or one stream slot of it round-trips
through one ``.npz`` file.  A stream saved from one session restores into
any free slot of another built with the same configs: stream migration.

The file layout is stc_tpu's, so a file crosses between the two packages
in both directions:

- the state's arrays are ``leaf_<i>`` in the order ``jax.tree.flatten``
  gives stc_tpu's state dict: keys sorted, each NamedTuple's fields in
  declaration order, Python ints as int64 scalars, an empty vision state
  (a session without vision) no leaves at all (_session_leaves,
  _stream_leaves write that order down);
- bfloat16 arrays are stored as numpy's two-byte void type (``|V2``, what
  numpy makes of a JAX bfloat16 array) holding the bf16 bits, and read
  back by reinterpreting those bits, never by converting values;
- host-tier chunks are ``host_k_<i>`` / ``host_v_<i>`` (L, B, Hkv, E, S,
  Dp) with scales ``host_ks_<i>`` / ``host_vs_<i>`` (L, B, Hkv, E, D), the
  layout of both packages' host stores.

The port writes its files uncompressed (np.savez; stc_tpu compresses):
a slot's page store is mostly unwritten pages, and zlib over them costs
seconds a stream.  np.load reads stored and compressed members alike, so
each package loads the other's files.
"""

from __future__ import annotations

import numpy as np
import torch

from stc_tpu_torch.kvcache.host_tier import HostBlockStore

_FMT = 3  # stc_tpu's format number: the leaf set and order below

_BF16 = np.dtype("V2")


def _to_np(x) -> np.ndarray:
    """A leaf as the numpy array stc_tpu would save."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16)
    return x.numpy()


def _from_np(arr: np.ndarray) -> torch.Tensor:
    """A saved array as a CPU tensor: bf16 bits reinterpreted."""
    if arr.dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A saved array as a tensor of like's dtype on like's device (as
    stc_tpu converts a leaf to its session's dtype); a bf16 leaf only
    into a bf16 tensor."""
    t = _from_np(arr)
    if t.dtype == torch.bfloat16 and like.dtype != torch.bfloat16:
        raise ValueError(f"a bfloat16 leaf for a {like.dtype} tensor")
    return t.to(device=like.device, dtype=like.dtype)


def _session_leaves(session) -> list:
    """The session's state leaves in stc_tpu's order: chunk_idx,
    evicted_pages, init_len, kvs (StreamKV fields), pstate, qa_hist,
    qa_hist_len, ragged, slot_chunk, stream_blocks, total_blocks,
    vstate."""
    B = session.batch
    return ([int(getattr(session, "chunk_idx", 0)),
             int(session._evicted_pages), int(session._init_len)]
            + list(session.kvs) + list(getattr(session, "_pstate", ()))
            + [np.asarray(session._qa_hist, np.int32),
               np.asarray(session._qa_hist_len, np.int32),
               int(session._ragged),
               np.asarray(getattr(session, "_slot_chunk",
                                  np.zeros(B, np.int64)), np.int64),
               np.asarray(session._stream_blocks, np.int64),
               int(session._total_blocks)]
            + list(getattr(session, "_vstate", ())))


def _check_fmt(data, what: str) -> None:
    fmt = int(data["fmt"]) if "fmt" in data else 1
    if fmt != _FMT:
        raise ValueError(f"{what} format v{fmt} != current v{_FMT}: saved "
                         "with another leaf layout; re-save it")


def _check_shape(i: int, arr: np.ndarray, old) -> None:
    shape = tuple(old.shape) if isinstance(old, torch.Tensor) else \
        np.shape(old)
    if arr.shape != shape:
        raise ValueError(f"leaf {i}: saved {arr.shape} vs session {shape}: "
                         "configs must match")


def save_session_state(session, path: str):
    """The whole session state (host-tier chunks included) to `path`."""
    arrs = {f"leaf_{i}": _to_np(x)
            for i, x in enumerate(_session_leaves(session))}
    arrs["fmt"] = np.asarray(_FMT)
    hs = session.host_store
    if hs.total_pages:
        for i, (hk, hv) in enumerate(zip(hs.k_chunks, hs.v_chunks)):
            hs._ready(i)  # this chunk's copy from the card has ended
            arrs[f"host_k_{i}"], arrs[f"host_v_{i}"] = _to_np(hk), _to_np(hv)
        for i, (ks, vs) in enumerate(zip(hs.k_scales, hs.v_scales)):
            arrs[f"host_ks_{i}"] = _to_np(ks)
            arrs[f"host_vs_{i}"] = _to_np(vs)
    np.savez(path, **arrs)
    return path


def load_session_state(session, path: str):
    """Restore save_session_state's file (the port's or stc_tpu's) into a
    session built with the same configs; every leaf's shape is checked.
    The host store and the prefetch table start afresh from the file."""
    data = np.load(path, allow_pickle=False)
    _check_fmt(data, "checkpoint")
    leaves = _session_leaves(session)
    for i, old in enumerate(leaves):
        _check_shape(i, data[f"leaf_{i}"], old)
    vals = [data[f"leaf_{i}"] for i in range(len(leaves))]
    n_kv, n_p = len(session.kvs), len(getattr(session, "_pstate", ()))
    for cur, arr in zip(session.kvs, vals[3:3 + n_kv]):
        cur.copy_(_to_torch(arr, cur))
    k = 3 + n_kv
    if hasattr(session, "_vstate"):
        p, v = session._pstate, session._vstate
        session._pstate = type(p)(*(_to_torch(a, c) for a, c in
                                    zip(vals[k:k + n_p], p)))
        session._vstate = type(v)(*(_to_torch(a, c) for a, c in
                                    zip(vals[k + n_p + 6:], v)))
        session._slot_chunk = np.asarray(vals[k + n_p + 3], np.int64).copy()
    session.chunk_idx = int(vals[0])
    session._evicted_pages = int(vals[1])
    session._init_len = int(vals[2])
    (qa_hist, qa_hist_len, ragged, _, stream_blocks,
     total) = vals[k + n_p:k + n_p + 6]
    session._qa_hist = np.asarray(qa_hist, np.int32).copy()
    session._qa_hist_len = np.asarray(qa_hist_len, np.int32).copy()
    session._ragged = bool(int(ragged))
    session._stream_blocks = np.asarray(stream_blocks, np.int64).copy()
    session._total_blocks = int(total)
    session.host_store = HostBlockStore()
    session.hp_reset()
    i = 0
    while f"host_k_{i}" in data:
        names = ("k", "v") + (("ks", "vs") if f"host_ks_{i}" in data
                              else ())
        session.host_store.append(*(_from_np(data[f"host_{n}_{i}"])
                                    for n in names))
        i += 1
    return session


# ---------------------------------------------------------------------------
# One stream slot: migration between serving sessions
# ---------------------------------------------------------------------------

def _stream_leaves(session, slot: int) -> list:
    """One slot's state in stc_tpu's order: kvs (StreamKV fields, the
    slot's row of each layer), then on a VLM session the pruner and cacher
    state (VisionPipeline.extract_stream; a CLIP backbone's cacher blob
    lists its leaves by sorted name, clip.ClipStreamBlob, as stc_tpu's
    dict flattens)."""
    if session._evicted_pages:
        raise RuntimeError(
            "per-stream checkpoints with host-evicted pages are not "
            "supported: the host tier's pages are shared by every stream "
            "(as for reset_streams)")
    leaves = [x[:, slot] for x in session.kvs]
    vision = getattr(session, "vision", None)
    if vision is not None:
        v, p = vision.extract_stream(session._vstate, session._pstate, slot)
        leaves += list(p) + list(v)
    return leaves


def save_stream_state(session, slot: int, path: str):
    """Checkpoint one stream slot of a serving session, to restore it into
    any free slot of a session built with the same configs.  Its counters,
    cacher-schedule count and draft history go along; the shared init
    prompt does not (both sessions encode it)."""
    arrs = {f"leaf_{i}": _to_np(x)
            for i, x in enumerate(_stream_leaves(session, slot))}
    arrs["fmt"] = np.asarray(_FMT)
    arrs["blocks"] = np.asarray(
        int(session._stream_blocks[slot]) if session._ragged
        else session._total_blocks)
    arrs["init_len"] = np.asarray(session._init_len)
    arrs["slot_chunk"] = np.asarray(
        int(getattr(session, "_slot_chunk", np.zeros(session.batch))[slot]))
    arrs["qa_hist"] = np.asarray(session._qa_hist[slot])
    arrs["qa_hist_len"] = np.asarray(int(session._qa_hist_len[slot]))
    np.savez(path, **arrs)
    return path


def load_stream_state(session, slot: int, path: str):
    """Restore save_stream_state's file (the port's or stc_tpu's) into
    `slot` (typically one that ServingEngine.retire / admit recycled); the
    other slots' streams are untouched.  On a VLM session the stream
    brings its own cacher-schedule count."""
    data = np.load(path, allow_pickle=False)
    _check_fmt(data, "stream blob")
    if int(data["init_len"]) != session._init_len:
        raise ValueError(
            "init prompt length mismatch: the stream was encoded with "
            f"n_init={int(data['init_len'])}, this session has "
            f"{session._init_len} (init prompts must match)")
    leaves = _stream_leaves(session, slot)
    n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
    if n_saved != len(leaves):
        raise ValueError(f"stream blob has {n_saved} leaves, the session "
                         f"expects {len(leaves)} (VLM and bare sessions' "
                         "streams do not interchange)")
    vals = []
    for i, old in enumerate(leaves):
        _check_shape(i, data[f"leaf_{i}"], old)
        vals.append(data[f"leaf_{i}"])
    hist = np.asarray(data["qa_hist"], np.int32)
    if hist.shape != session._qa_hist[slot].shape:
        raise ValueError(
            f"spec_history_tokens mismatch: blob {hist.shape} vs session "
            f"{session._qa_hist[slot].shape}")
    n_kv = len(session.kvs)
    for cur, arr in zip(session.kvs, vals[:n_kv]):
        cur[:, slot] = _to_torch(arr, cur)
    vision = getattr(session, "vision", None)
    if vision is not None:
        n_p = len(session._pstate)
        p_blob = [_to_torch(a, c) for a, c in
                  zip(vals[n_kv:n_kv + n_p], leaves[n_kv:n_kv + n_p])]
        v_blob = [_to_torch(a, c) for a, c in
                  zip(vals[n_kv + n_p:], leaves[n_kv + n_p:])]
        session._vstate, session._pstate = vision.restore_stream(
            session._vstate, session._pstate, slot, v_blob, p_blob)
        session._slot_chunk[slot] = int(data["slot_chunk"])
    session._qa_hist[slot] = hist
    session._qa_hist_len[slot] = int(data["qa_hist_len"])
    session._ensure_ragged()
    session._stream_blocks[slot] = int(data["blocks"])
    session._total_blocks = int(session._stream_blocks.max())
    return session
