"""On-card smoke run of the PyTorch/CUDA port (stc_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; builds the kernels from stc_tpu_torch/csrc at first use.  Phases,
each of which makes the script exit non-zero when it fails:

  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. every hand-written kernel, through its public wrapper, against its
     plain PyTorch version on the card at main-path shapes, with kernel,
     plain and library (SDPA) times, held to the scaled limits of
     stc_tpu_torch/kernels/agreement.py; then planted faults (a key group
     dropped, a mask one page or one slot off) that those limits must
     reject;
  3. the main path: the LLaVA-OV + ReKV session at llava-ov-0.5b width and
     depth (SigLIP 1152 x 27 layers at 384 px in float32, Qwen2 896 x 24
     layers in bf16, random weights from a seeded torch.Generator): init
     prompt, 16 one-frame chunks, two 8-frame chunks, two questions, four
     more frames, one more question; its kernel launch counts against the
     appends and LM forwards it ran;
  4. a second session (n_local 1200) that crosses the init-fill trigger,
     with its own launch counts;
  5. where the time goes: device time per part of a chunk and a question,
     and the device's busy share of each, measured by issuing the same
     call behind a sleep kernel.

Prints JSON lines; the line before the last holds one entry per kernel
(route, source, the TPU kernel it replaces, launches on the main path,
error, kernel / plain / bound / library times), the last line is
{"ok": true, "device": {...}}.  A fuller record goes to
build/chip_smoke.json.  TF32 is off for matmuls and convolutions, so
every float32 product runs in full float32.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak

RECORD: dict = {"phases": {}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def held(name, got, want) -> dict:
    """got (kernel) against want (plain version), in the terms of
    agreement.py; with return_m both are (o, m) pairs."""
    from stc_tpu_torch.kernels.agreement import disagreement
    if isinstance(want, tuple):
        (o1, m1), (o2, m2) = got, want
        fin = torch.isfinite(m2)
        if not torch.equal(torch.isfinite(m1), fin):
            return {"max_abs_err": float("inf"), "max_rel_err": float("inf"),
                    "rms_rel_err": float("inf"), "agrees": False,
                    "note": f"{name}: row maxima masks differ"}
        a, b = disagreement(o1, o2), disagreement(m1[fin], m2[fin])
        return {k: (a[k] and b[k]) if k == "agrees" else max(a[k], b[k])
                for k in a}
    return disagreement(got, want)


def stream_case(name, Hq, Hkv, D, T, pages, dev, gen, n_local=15000, S=60,
                Nb=1024, n_init=14, exc=480):
    """One stream_attention call of the main path's configuration
    (exc_block_size 480: a 264-page window cover), T new tokens with
    `pages` pages in the store after their write.  Returns the record, the
    wrapper's arguments and the plain version's output."""
    from stc_tpu_torch.config import ReKVConfig
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.ops import stream_attention as sa
    cfg = ReKVConfig(n_init=n_init, n_local=n_local, block_size=S,
                     exc_block_size=exc, topk=64, max_blocks=Nb,
                     max_prompt_tokens=256)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    n_new = T // S
    before = pages - n_new          # pages in the store before this append
    L = torch.tensor([n_init + before * S], dtype=torch.int32, device=dev)
    nb = torch.tensor([before], dtype=torch.int32, device=dev)
    rc = engine.make_rope_cache(L, nb, T, cfg, D, 1e6)
    args = (rnd(1, Hq, T, D), rnd(1, Hq, T, D), rnd(1, Hkv, Nb, S, D),
            rnd(1, Hkv, Nb, S, D), rc.cos_cover, rc.sin_cover,
            rnd(1, Hkv, n_init, D), rnd(1, Hkv, n_init, D),
            rnd(1, Hkv, n_init, D), rc.scalars)
    out = sa.stream_attention(*args, n_local=n_local)
    ref = sa.stream_attention_ref(*args, n_local=n_local)
    torch.cuda.synchronize()
    agree = held(name, out, ref)

    # live keys: stored positions that some query of the call can see
    Lv = int(L.item())
    lo = max(n_init, Lv - n_local + 1)
    hi = min(n_init + pages * S - 1, Lv + T - 1)
    live = max(0, hi - lo + 1)
    init_active = int(rc.scalars[0, 3].item())
    keys = live + n_init + n_init * init_active
    # what the function needs: queries, live pages, init keys/values,
    # output (RoPE angles follow from the affine key positions)
    need = (2 * Hq * T * D * 2 + 2 * Hkv * live * D * 2
            + 3 * Hkv * n_init * D * 2 + Hq * T * D * 2)
    flops = 4 * Hq * T * D * keys
    b_ms, b_by = bound(need, flops, H100_BF16_FLOPS)
    # what this design reads besides: f32 cos and sin rows per live key
    bt_ms, bt_by = bound(need + 2 * live * D * 4, flops, H100_BF16_FLOPS)

    # library yardstick: one SDPA call over the concatenated (rotated) keys,
    # the two query angles packed side by side in a 2D head
    q_rot, q_one, bk, bv, cc, sc, kir, vi, kiw, _ = args
    Lc = cc.shape[1]
    ppt = sa.pages_per_tile(S)
    page = int(rc.start_tile[0]) * ppt + torch.arange(Lc, device=dev) // S
    pg = page.clamp(max=Nb - 1)
    off = torch.arange(Lc, device=dev) % S
    kw_ = bk[0][:, pg, off]
    from stc_tpu_torch.ops.rope import rotate
    kw_ = rotate(kw_[None], cc[:, None], sc[:, None])
    z = torch.zeros_like
    k_all = torch.cat([torch.cat([kir, z(kir)], -1),
                       torch.cat([kw_, z(kw_)], -1),
                       torch.cat([z(kiw), kiw], -1)], dim=2)
    v_all = torch.cat([vi, bv[0][:, pg, off][None], vi], dim=2)
    q2 = torch.cat([q_rot, q_one], -1)
    pos = n_init + (page + int(rc.scalars[0, 4])) * S + off
    qp = Lv + torch.arange(T, device=dev)
    d = qp[:, None] - pos[None, :]
    m_win = (d >= 0) & (d < n_local) & (page < Nb)[None] & (
        (page + int(rc.scalars[0, 4])) < int(rc.scalars[0, 2]))[None]
    di = qp[:, None] - torch.arange(n_init, device=dev)[None]
    m_init = (di >= 0) & (di < n_local)
    m_far = torch.full((T, n_init), bool(init_active), device=dev)
    mask = torch.cat([m_init, m_win, m_far], dim=1)[None, None]
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(
            q2, k_all, v_all, attn_mask=mask, scale=D ** -0.5,
            enable_gqa=True)

    lib_err = held(name, lib(), ref)["max_rel_err"]
    ms = cuda_ms(lambda: sa.stream_attention(*args, n_local=n_local), 20)
    plain_ms = cuda_ms(lambda: sa.stream_attention_ref(*args,
                                                       n_local=n_local), 3, 1)
    lib_ms = cuda_ms(lib, 10)
    rec = dict(case=name, kernel="stream_attention", Hq=Hq, Hkv=Hkv, D=D,
               T=T, pages=pages, window_pages=engine.n_window_pages(cfg),
               init_active=init_active, **agree, kernel_ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_max_rel_err=lib_err, bound_ms=b_ms, bound_by=b_by,
               bound_ms_with_tables=bt_ms, bound_by_with_tables=bt_by,
               live_keys=live)
    return rec, args, dict(n_local=n_local), ref


def decode_case(name, T, start, cursor, n_local, dev, gen, Hq=14, Hkv=2,
                D=64, C=4352, return_m=False):
    """One decode_attention call; returns the record, the wrapper's
    arguments and the plain version's output."""
    from stc_tpu_torch.ops import decode_attention as da
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, k, v = rnd(1, Hq, T, D), rnd(1, Hkv, C, D), rnd(1, Hkv, C, D)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    cu = torch.tensor([cursor], dtype=torch.int32, device=dev)
    args = (q, k, v, st, cu)
    kw = dict(n_local=n_local, return_m=return_m)
    got = da.decode_attention(*args, **kw)
    want = da.decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    agree = held(name, got, want)
    lo = max(0, start - n_local + 1)
    hi = min(start + T, cursor)
    live = max(0, hi - lo)
    bytes_moved = (Hq * T * D * 2 + 2 * Hkv * live * D * 2 + Hq * T * D * 2
                   + (Hq * T * 4 if return_m else 0))
    flops = 4 * Hq * T * D * live
    b_ms, b_by = bound(bytes_moved, flops, H100_BF16_FLOPS)
    slot = torch.arange(C, device=dev)
    qs = start + torch.arange(T, device=dev)
    dist = qs[:, None] - slot[None]
    mask = ((dist >= 0) & (dist < n_local) & (slot < cursor)[None])[None,
                                                                     None]
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = held(name, lib(), want[0] if return_m else want)["max_rel_err"]
    ms = cuda_ms(lambda: da.decode_attention(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: da.decode_attention_ref(*args, **kw), 3, 1)
    lib_ms = cuda_ms(lib, 10)
    rec = dict(case=name, kernel="decode_attention", T=T, start=start,
               cursor=cursor, n_local=n_local, C=C, return_m=return_m,
               **agree, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_max_rel_err=lib_err, bound_ms=b_ms, bound_by=b_by,
               live_slots=live)
    return rec, args, kw, want


def planted_faults(inputs) -> list:
    """Each kernel run on inputs with one planted fault, held against the
    plain version of the true inputs: the limits must reject every one."""
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa

    def scalar(case, col, delta):
        args, kw, ref = inputs[case]
        sc = args[9].clone()
        sc[:, col] += delta
        return sa.stream_attention(*args[:9], sc, **kw), ref

    def decode(case, cursor_delta=0, n_local_delta=0):
        (q, k, v, st, cu), kw, want = inputs[case]
        kw = dict(kw, n_local=kw["n_local"] + n_local_delta)
        return da.decode_attention(q, k, v, st, cu + cursor_delta,
                                   **kw), want

    faults = [
        ("stream: third key group dropped (init_active 1 -> 0)",
         lambda: scalar("stream 300 pages init_active", 3, -1)),
        ("stream: window pages one page late (page_offset + 1)",
         lambda: scalar("stream 100 pages", 4, 1)),
        ("decode: newest slot dropped (cursor - 1)",
         lambda: decode("decode token T=1", cursor_delta=-1)),
        ("decode: window one slot longer (n_local + 1)",
         lambda: decode("decode expired window", n_local_delta=1)),
    ]
    out = []
    for name, run in faults:
        got, want = run()
        rec = {"fault": name, **held(name, got, want)}
        rec["rejected"] = not rec.pop("agrees")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phases 3-4: sessions at llava-ov-0.5b width
# ---------------------------------------------------------------------------

def make_model(dev, seed):
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg
    vision = sg.SiglipConfig(hidden_size=1152, num_layers=27, num_heads=16,
                             intermediate_size=4304, image_size=384,
                             patch_size=14)
    text = qw.Qwen2Config(vocab_size=151936, hidden_size=896, num_layers=24,
                          num_heads=14, num_kv_heads=2, head_dim=64,
                          intermediate_size=4864, rope_base=1000000.0)
    cfg = lo.LlavaOVConfig(vision=vision, text=text)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = lo.LlavaOV(cfg, dtype=torch.bfloat16, vision_dtype=torch.float32,
                       device=dev).init_random_params(gen)
    return model, cfg


def session_cfg(n_local, topk, max_prompt, max_new, exc_frames, max_blocks):
    from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                      SessionConfig)
    return SessionConfig(
        rekv=ReKVConfig(n_init=14, n_local=n_local, block_size=60,
                        exc_block_size=60 * exc_frames, topk=topk,
                        max_blocks=max_blocks, max_prompt_tokens=max_prompt,
                        max_new_tokens=max_new),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.25,
                            cache_interval=2),
        pruner=PrunerConfig(token_per_frame=60),
        encode_chunk_frames=exc_frames)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def patched(wraps):
    """Replace obj.attr by wrap(obj.attr) for each (obj, attr, wrap) while
    the block runs; later entries wrap earlier ones."""
    saved = []
    try:
        for obj, attr, wrap in wraps:
            saved.append((obj, attr, attr in vars(obj), getattr(obj, attr)))
            setattr(obj, attr, wrap(getattr(obj, attr)))
        yield
    finally:
        for obj, attr, own, f in reversed(saved):
            if own:
                setattr(obj, attr, f)
            else:
                delattr(obj, attr)


def segments(fn, targets) -> dict:
    """Device time of fn split by the functions in targets ((obj, attr,
    label), patched for the call with CUDA events around each call), beside
    fn's own device span and host wall time.  torch.profiler is not used:
    its CUPTI tracing crashed the process on the H100 machine it was
    tried on."""
    marks = []

    def timed_call(label):
        def wrap(f):
            def g(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = f(*a, **k)
                e1.record()
                marks.append((label, e0, e1))
                return out
            return g
        return wrap

    with patched([(o, a, timed_call(lb)) for o, a, lb in targets]):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"wall_ms": wall * 1e3, "span_ms": a.elapsed_time(b)}
    for label, e0, e1 in marks:
        out[label + "_ms"] = out.get(label + "_ms", 0.0) + e0.elapsed_time(e1)
        out[label + "_calls"] = out.get(label + "_calls", 0) + 1
    return out


SLEEP_CYCLES = 100_000_000   # ~50 ms at the H100's 1.98 GHz SM clock


def probe(fn, starts, end, nth=1, sleep=False) -> dict:
    """Run fn once and time one stretch of it: from the nth call of any
    (obj, attr) in starts to the return of end's nth call.  The span
    between CUDA events is the device's time from the stretch's first
    launch to its last.  With sleep, a sleep kernel is issued just before
    the stretch: the device reaches the stretch only after the host has
    issued all of it (checked: host_ms < sleep_ms), so it runs it back to
    back and the span is the device's own busy time."""
    st = {"starts": 0, "ends": 0}
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def begin(f):
        def g(*a, **k):
            st["starts"] += 1
            if st["starts"] == nth:
                if sleep:
                    st["es"] = ev()
                    st["es"].record()
                    torch.cuda._sleep(SLEEP_CYCLES)
                st["e0"] = ev()
                st["e0"].record()
                st["t0"] = time.perf_counter()
            return f(*a, **k)
        return g

    def finish(f):
        def g(*a, **k):
            out = f(*a, **k)
            st["ends"] += 1
            if st["ends"] == nth:
                st["e1"] = ev()
                st["e1"].record()
                st["t1"] = time.perf_counter()
            return out
        return g

    torch.cuda.synchronize()
    with patched([(o, a, begin) for o, a in starts]
                 + [(end[0], end[1], finish)]):
        fn()
    torch.cuda.synchronize()
    rec = {"span_ms": st["e0"].elapsed_time(st["e1"]),
           "host_ms": (st["t1"] - st["t0"]) * 1e3}
    if sleep:
        rec["sleep_ms"] = st["es"].elapsed_time(st["e0"])
    return rec


def busy_over(pairs) -> dict:
    """busy() of each (usual, filled) pair, with the medians."""
    rows = [busy(u, f) for u, f in pairs]

    def med(key):
        vals = [r[key] for r in rows if r[key] is not None]
        return float(np.median(vals)) if vals else None

    return {"median_usual_span_ms": med("usual_span_ms"),
            "median_device_ms": med("device_ms"),
            "median_busy_share": med("busy_share"), "layers": rows}


def busy(usual: dict, filled: dict) -> dict:
    """The device's busy share of a stretch: its back-to-back device time
    over its span when issued as usual (None where the sleep did not
    outlast the host's issuing)."""
    ok = filled["host_ms"] < filled["sleep_ms"]
    return {"usual_span_ms": usual["span_ms"],
            "usual_host_ms": usual["host_ms"],
            "device_ms": filled["span_ms"] if ok else None,
            "filled_host_ms": filled["host_ms"],
            "sleep_ms": filled["sleep_ms"],
            "busy_share": filled["span_ms"] / usual["span_ms"] if ok
            else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stc_tpu_torch.kernels import _build
    from stc_tpu_torch.kernels.agreement import MAX_REL, RMS_REL
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in _build.build_log.items()}
    emit({"phase": "build", "card": card, "build_s": build_s,
          "tf32": False})
    RECORD["phases"]["build"] = {"build_s": build_s, "ptxas": regs,
                                 "card": card}

    # ---- phase 2: kernels vs plain, then planted faults ----
    gen = torch.Generator(device=dev).manual_seed(1)
    runs = [
        stream_case("stream empty window", 14, 2, 64, 60, 1, dev, gen),
        stream_case("stream 100 pages", 14, 2, 64, 60, 100, dev, gen),
        stream_case("stream 300 pages init_active", 14, 2, 64, 60, 300, dev,
                    gen),
        stream_case("stream 8-page append", 14, 2, 64, 480, 200, dev, gen),
        stream_case("stream 7B heads", 28, 4, 128, 60, 150, dev, gen),
        decode_case("decode prefill T=256", 256, 3854, 3854 + 256, 15000,
                    dev, gen, return_m=True),
        decode_case("decode token T=1", 1, 4200, 4201, 15000, dev, gen),
        decode_case("decode expired window", 16, 2000, 4352, 64, dev, gen),
    ]
    cases = [r[0] for r in runs]
    for c in cases:
        c["card"] = card
        emit(c)
        if not c["agrees"]:
            raise RuntimeError(f"{c['case']}: kernel disagrees with its "
                               f"plain version {c}")
    faults = planted_faults({r[0]["case"]: r[1:] for r in runs})
    del runs
    emit({"phase": "planted faults", "limits": {"max_rel": MAX_REL,
                                                "rms_rel": RMS_REL},
          "faults": faults})
    missed = [f["fault"] for f in faults if not f["rejected"]]
    if missed:
        raise RuntimeError(f"the limits let these faults pass: {missed}")
    RECORD["phases"]["kernels"] = cases
    RECORD["phases"]["faults"] = faults

    # ---- phase 3: the main path at llava-ov-0.5b width ----
    model, cfg = make_model(dev, seed=0)
    scfg = session_cfg(15000, 64, 256, 16, 8, 1024)
    sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                            device=dev)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(44, 384, 384, 3), dtype=np.uint8)
    n_append = 0
    lm_forwards = 0
    torch.cuda.synchronize()
    sa.launches = da.launches = 0
    sess.encode_init_prompt(list(range(100, 114)))
    chunk_s = []
    for i in range(16):
        _, dt = timed(lambda: sess.encode_video(frames[i:i + 1]))
        chunk_s.append((1, dt))
        n_append += 1
    for j in range(2):
        s0 = 16 + 8 * j
        _, dt = timed(lambda: sess.encode_video(frames[s0:s0 + 8]))
        chunk_s.append((8, dt))
        n_append += 1
    stop = [151645]
    qa_s, answers = [], []

    def ask(q, p):
        out, dt = timed(lambda: sess.question_answering(
            q, p, stop, max_new_tokens=16))
        qa_s.append(dt)
        answers.append(out)
        return len(out)

    lm_forwards += 2 + ask(list(range(200, 212)), list(range(300, 320)))
    lm_forwards += 2 + ask(list(range(400, 409)), list(range(500, 530)))
    for i in range(32, 36):
        sess.encode_video(frames[i:i + 1])
        n_append += 1
    lm_forwards += 2 + ask(list(range(600, 616)), list(range(700, 710)))
    torch.cuda.synchronize()
    launches = {"stream_attention": sa.launches,
                "decode_attention": da.launches}
    want = {"stream_attention": 24 * n_append,
            "decode_attention": 24 * lm_forwards}
    if launches != want:
        raise RuntimeError(f"main path launch counts {launches} != "
                           f"expected {want}")
    nb = int(sess.kvs.num_blocks[0, 0].item())
    if nb != 36 or sess._total_blocks != 36:
        raise RuntimeError(f"num_blocks {nb} != 36 frames sent")
    for a in answers:
        if not a or not all(0 <= t < cfg.text.vocab_size for t in a):
            raise RuntimeError(f"bad answer {a}")
    # steady one-frame chunks (skip the first two: allocator warm-up)
    one = [dt for n, dt in chunk_s[2:16]]
    eight = [dt for n, dt in chunk_s if n == 8]
    p3 = {"phase": "session llava-ov-0.5b", "card": card,
          "frames": nb, "answers": answers,
          "appends": n_append, "lm_forwards": lm_forwards,
          "launches": launches, "expected": want,
          "ingest_fps_1frame_chunks": len(one) / sum(one),
          "ingest_fps_8frame_chunks": 8 * len(eight) / sum(eight),
          "qa_latency_s_mean": float(np.mean(qa_s)),
          "qa_latency_s_p50": float(np.median(qa_s)),
          "qa_latency_s": qa_s,
          "answer_tokens": [len(a) for a in answers],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(p3)
    RECORD["phases"]["session"] = p3

    # ---- phase 4: crossing the init-fill trigger ----
    scfg2 = session_cfg(1200, 8, 128, 32, 1, 64)
    sess2 = lo.build_session(model, scfg2, state_dtype=torch.bfloat16,
                             device=dev)
    if scfg2.rekv.decode_cap > scfg2.rekv.n_local:
        raise RuntimeError("phase 4 must keep decode_cap <= n_local")
    torch.cuda.synchronize()
    sa.launches = da.launches = 0
    sess2.encode_init_prompt(list(range(100, 114)))
    active = []
    for i in range(24):
        L = int(sess2.kvs.length[0, 0].item())
        active.append(L + 60 > scfg2.rekv.n_local)
        sess2.encode_video(frames[i:i + 1])
    if not (all(active[-4:]) and not any(active[:4])):
        raise RuntimeError(f"init_active pattern {active}")
    out = sess2.question_answering(list(range(200, 210)),
                                   list(range(300, 315)), stop,
                                   max_new_tokens=32)
    torch.cuda.synchronize()
    launches2 = {"stream_attention": sa.launches,
                 "decode_attention": da.launches}
    want2 = {"stream_attention": 24 * 24,
             "decode_attention": 24 * (2 + len(out))}
    if launches2 != want2:
        raise RuntimeError(f"init-fill launch counts {launches2} != "
                           f"expected {want2}")
    # the third key group on the session's own state
    kv0 = type(sess2.kvs)(*(x[0] for x in sess2.kvs))
    from stc_tpu_torch.kvcache import engine
    T = 60
    rc = engine.make_rope_cache(kv0.length, kv0.num_blocks, T, scfg2.rekv,
                                64, 1e6, kv0.page_offset)
    q = torch.randn((1, 14, T, 64), generator=gen, device=dev).bfloat16()
    args = (q, q.flip(2).contiguous(), kv0.block_k, kv0.block_v,
            rc.cos_cover, rc.sin_cover, kv0.init_k, kv0.init_v, kv0.init_k,
            rc.scalars)
    state_check = held("init-fill state",
                       sa.stream_attention(*args, n_local=1200),
                       sa.stream_attention_ref(*args, n_local=1200))
    p4 = {"phase": "session init-fill", "card": card,
          "init_active": active, "answer": out,
          "kernel_vs_plain_on_session_state": state_check,
          "launches": launches2, "expected": want2}
    emit(p4)
    RECORD["phases"]["init_fill"] = p4
    if not state_check["agrees"] or int(rc.scalars[0, 3]) != 1:
        raise RuntimeError(f"init-fill state check failed {state_check}")

    # ---- phase 5: where the time goes (not the main path's counts) ----
    vis, lm = sess.vision, sess.lm
    kern = [(sa, "_launch", "stream_attention_kernel"),
            (da, "_launch", "decode_attention_kernel")]
    chunk_targets = [(vis, "full", "vision_full"),
                     (vis, "cached", "vision_cached"),
                     (lm, "encode_step", "lm_append")] + kern
    qa = (list(range(800, 812)), list(range(900, 920)), stop)

    def question():
        sess.question_answering(*qa, max_new_tokens=16)

    p5 = {"phase": "time split", "card": card,
          "chunk_full": segments(lambda: sess.encode_video(frames[36:37]),
                                 chunk_targets),
          "chunk_cached": segments(lambda: sess.encode_video(
              frames[37:38]), chunk_targets),
          "question": segments(question,
                               [(lm, "qa_retrieve_step", "retrieval_forward"),
                                (lm, "decode_step", "decode_step")] + kern)}
    # busy shares of single layers (at a quarter, half and three quarters
    # of each layer loop), each issued as usual and then behind a sleep.  A
    # whole chunk or decode step issues more launches than the driver
    # queues ahead (its host time behind a sleep exceeds the sleep), so the
    # stretch is one layer.
    n_v, n_t = cfg.vision.num_layers, cfg.text.num_layers
    lm_layer = ([(lm, "_qkv")], (lm, "_finish_layer"))
    nxt = iter(range(10 ** 6))

    def chunk():
        i = 36 + next(nxt) % 8
        sess.encode_video(frames[i:i + 1])

    pairs = {k: [] for k in ("vision_layer_full", "vision_layer_cached",
                             "lm_append_layer", "retrieval_layer",
                             "prompt_prefill_layer", "token_step_layer")}
    for frac in (1, 2, 3):
        # chunk_idx alternates the full and cached paths (interval 2), so
        # the vision probes run in the order full, cached, full, cached
        vl = model.vision.layers[n_v * frac // 4]
        vf, vc = ([(vl, "full")], (vl, "full")), ([(vl, "cached")],
                                                  (vl, "cached"))
        u = [probe(chunk, *vf), probe(chunk, *vc)]
        f = [probe(chunk, *vf, sleep=True), probe(chunk, *vc, sleep=True)]
        pairs["vision_layer_full"].append((u[0], f[0]))
        pairs["vision_layer_cached"].append((u[1], f[1]))
        li = n_t * frac // 4 + 1          # the nth _qkv call of a run
        for name, fn, nth in (("lm_append_layer", chunk, li),
                              ("retrieval_layer", question, li),
                              ("prompt_prefill_layer", question, n_t + li),
                              ("token_step_layer", question, 3 * n_t + li)):
            pairs[name].append((probe(fn, *lm_layer, nth),
                                probe(fn, *lm_layer, nth, sleep=True)))
    p5["busy"] = {k: busy_over(v) for k, v in pairs.items()}
    emit(p5)
    RECORD["phases"]["time_split"] = p5

    # ---- the kernels line, then the device line ----
    def entry(name, source, replaces, main_case):
        rows = [c for c in cases if c["kernel"] == name]
        m = next(c for c in rows if c["case"] == main_case)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in rows),
                "max_rel_err": max(c["max_rel_err"] for c in rows),
                "rms_rel_err": max(c["rms_rel_err"] for c in rows),
                "ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], "case": main_case}

    kernels = [
        entry("stream_attention", "stc_tpu_torch/csrc/stream_attention.cu",
              "stc_tpu/ops/stream_attention.py:307",
              "stream 300 pages init_active"),
        entry("decode_attention", "stc_tpu_torch/csrc/decode_attention.cu",
              "stc_tpu/ops/decode_attention.py:143", "decode token T=1"),
    ]
    RECORD["kernels"] = kernels
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
