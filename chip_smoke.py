"""On-card smoke run of the PyTorch/CUDA port (stc_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; builds the kernels from stc_tpu_torch/csrc at first use.  Phases,
each of which makes the script exit non-zero when it fails:

  1. the card (nvidia-smi name, power limit and maximum SM clock) and the
     kernel build, with each kernel's registers and spills from ptxas; the
     bf16 (tensor-core) instances of stream_attention, decode_attention
     and decode_score must spill nothing and hold HMMA instructions in
     their SASS (cuobjdump -sass);
  2. every hand-written kernel, through its public wrapper, against its
     plain PyTorch version on the card at main-path shapes, with kernel,
     plain and library (SDPA) device times (calls issued behind a sleep
     kernel) and the wrapper's host time a call, held to the scaled limits of
     stc_tpu_torch/kernels/agreement.py: stream_attention on bf16, int8
     and int4 pages (the quantized ones also timed against the bf16-page
     kernel on the same cover), decode_attention and decode_score (at
     0.5b and 7B heads; decode_score's float32 instance timed beside, and
     its bf16 tile built and timed with each part switched off in turn);
     stream_attention and decode_attention also over four streams in one
     call, each at its own position, with page offsets of 0, 56 and 112
     pages (0.5b heads on bf16 pages, 7B heads on int8 pages), and
     decode_attention at the speculative decode's verify shape (5 queries
     at each of four streams' own cursors), and stream_attention with a
     page_keep mask (window compression: half of every older page dropped)
     on an 8-page append over the 264-page window, at 0.5b heads on bf16
     pages and 7B heads on int8 pages, its library SDPA with the same
     boolean mask; and the CLIP backbones' shapes: stream_attention's
     one-frame append over the full window on bf16 pages at Vicuna's heads
     (32/32/128, G = 1) with 257-token pages (Video-LLaVA) and 64-token
     pages (Flash-VStream) and at LongVA's 28/4 heads with 144-token
     pages, decode_attention at 32/32/128 (a token step and a 256-token
     prefill);
     each bound counts bytes, products and exponentials at the data
     sheet's clock; then
     planted faults (a key group dropped, a mask one page or one slot off,
     the neighbouring page's scales, the int4 nibble planes swapped, every
     stream reading stream 0's scalars or cursors, one stream's page
     offset one page off, each query of a verify call seeing the draft
     after it, each page reading its neighbour's keep row; at 257-token
     pages a key group dropped and the window one page off) that those
     limits must reject;
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
     call behind a sleep kernel;
  6. the session at llava-ov-7b width (Qwen2 3584 x 28 layers, 28/4 heads
     of 128, the same SigLIP) on an int8 page store: 40 eight-frame chunks,
     past the full 264-page window (the last 8 chunks stream at it) and the
     init-fill crossing (asserted where each happens), two questions; its
     launch counts (every append launches the int8 kernel), then
     stream_attention, decode_attention and decode_score against their
     plain versions on the session's own state;
  7. the same model and stream on an int4 page store, one question;
  8. bench.py's 7b mode on the port, at int8 and int8_g128 weights: a
     fresh seeded model of phase 6's widths with SigLIP in bf16, its
     prompt logits and one decode step on bf16 weights, then the session
     (which quantizes the LM at build) streams phase 6's 40 chunks on bf16
     pages (max_blocks 768) and answers its two questions; each quantized
     product against its bf16 one on the same recorded input (cosine >
     0.999, the head's top-1 agreement > 0.9), the whole model's prompt
     logits against bf16's (reported), the decode step's device time
     against bf16's, the LM's weight bytes;
  9. the HF loader: phase 3's model with its head tied to the embedding
     written as a 2-shard bf16 HF checkpoint (this script's own writer),
     loaded through MODEL_REGISTRY["llava_ov_7b"] onto the card: every
     tensor bit-equal to its source, phase 3's first question answered
     with the same ids; the directory is removed;
 10. the host tier at llava-ov-7b width (phase 8's widths: bf16 SigLIP,
     bf16 weights and state): max_blocks 320 (a 264-page window), 480
     frames in 8-frame chunks, three evictions of 56 pages to pinned host
     memory; questions cold, warm and on external blocks 0-3, against an
     all-device session (max_blocks 512): (a) exact host pages, answers
     and every layer's blocks equal, host pages bit-equal; (b) the default
     int8 host tier on (a)'s replayed features, its bytes and answers;
     (c) int8 device pages against an all-device int8 session, answers
     equal; each with at most 2 rounds cold and 1 warm, eviction stalls,
     link rates, staged bytes and QA times;
 11. ragged multi-stream at llava-ov-0.5b width in float32: four slots
     ticking every 1st, 2nd, 3rd and 1st tick (mixed cacher ticks), slot
     2 recycled after tick 12, per-stream, shared and external-block
     questions, against a batch-1 session per stream: integer state
     exact, pages within the agreement limits, answers and blocks equal
     unless the batch-1 run shows a near-tie (counted and printed);
 12. continuous-batching serving at llava-ov-0.5b width in bf16 (bf16
     SigLIP): a ServingEngine over a 4-slot session, four ragged streams of
     4-frame chunks asking every 4th chunk (encode-only, answer-only and
     both ticks), a retired slot re-admitted, one stream migrated through
     a stream checkpoint into a second engine; the traffic with greedy
     decode, with speculative decode (K = 4) and through the session's
     own calls: greedy equal to the session's calls and to the migrated
     stream's answers, speculative equal to greedy but at near-ties (each
     printed); frames/s, tick and QA times, tokens a verify round, launch
     counts, the stream file's bytes and save / restore times.  Phase 8's
     int8-weight session also asks three questions with speculation off
     and on (QA p50, acceptance, rounds);
 13. the ablation paths and YUV ingest at llava-ov-0.5b width (phase 3's
     model, bf16 LM and pages, float32 SigLIP): (a) window_kv_compression
     = 'select_top_half', 48 frames in 8-frame chunks, every append through
     stream_attention with page_keep (launches = appends x layers), the
     masked kernel against its plain version on the session's own state at
     a middle layer with the keep rows held where the score gap at the cut
     exceeds twice the outputs' difference, three questions, ingest
     frames/s beside phase 3's; (b) every retrieved_kv_compression
     strategy on one 80-frame stream (decode_attention launches, QA p50);
     (c) the aks, dpc_knn and l2norm scorers through layerwise QA, each
     layer's blocks equal to select_blocks recomputed on the host from the
     logits and rep keys the device produced; (d) the cacher with
     sim_source='value' and k_proxy_rank=64 against 'key' (vision ms of an
     8-frame cached chunk); (e) 16 frames through ingest_format='yuv420',
     answers equal to an RGB session fed the numpy reconstruction of the
     same planes, H2D bytes a frame, and stream_encode's prefetcher
     against synchronous staging (frames/s);
 14. the CLIP backbones at the widths and session configs of their
     modules' defaults (bf16 LM and pages, float32 CLIP tower, random
     weights from a seeded torch.Generator), each freed before the next:
     (a) LongVA-7B (CLIP-L/14-336, Qwen2 3584 x 28, 28/4 heads), 80
     one-frame chunks alternating full and MLP-skip (skip ratio 0.8); (b)
     Video-LLaVA-7B (CLIP-L/14 at 224 px, 257 tokens a frame with CLS,
     Vicuna 4096 x 32, 32/32 heads), 48 frames in 8-frame chunks (one
     append a frame); (c) Flash-VStream-7B (CLIP-L/14-336 compressed to 64
     tokens, Vicuna), 96 one-frame chunks; each past its window and its
     init-fill crossing, two questions of up to 16 tokens; launches =
     appends x layers and LM forwards x layers, both kernels against their
     plain versions on the session's own state at a middle layer, (a)'s
     cache_stats equal to what its recomputed rows give; frames/s (full
     and cached chunks apart), QA p50, page-store and weight bytes;
 15. the eval harnesses at llava-ov-7b width (bf16 LM, float32 SigLIP,
     SessionConfig() with n_init set to the adapter's init prompt, random
     weights, a hash tokenizer defined here): four .npy videos at 360 x
     640 (16-96 frames at run_eval's 0.5 frames/s) through run_eval's
     offline ("mlvu"), VideoMME and RVS ("rvs_ego") protocols, four
     StreamingBench and four OVO-Bench questions, open-ended answers at 32
     tokens; gates: no error row or None response, row counts,
     stream_attention launches = appends x layers and decode_attention
     launches on each protocol, three rows equal to direct
     question_answering calls, a video alone in a new session equal to
     its rows after the others (the 20-frame video), a world-2 merge
     (mlvu's 16- and 40-frame videos) equal to the world-1 rows, a bare
     StreamingSession with the FrameEncoder equal to the VLMSession
     (answers and blocks, the 20-frame video),
     both kernels against their plain versions on the session's state;
     estimate_chunk_flops of 1-frame
     (full, cached) and 8-frame chunks against their device times
     (TFLOP/s, tower and LM apart); then batched eval (stream_batch 4)
     at llava-ov-0.5b width in float32 against the sequential solver,
     rows equal or parted only at a vision near-tie;
 16. the parallel layouts at llava-ov-7b width (bf16 Qwen2 3584 x 28,
     float32 SigLIP, weights drawn per tensor from a seed and sliced by
     parallel/sharding.init_random), two streams, two 8-frame chunks
     (the second crosses init-fill), two questions of 8 greedy tokens and one
     over fixed blocks: an unsharded reference, an NCCL world-1 session on
     its model (NCCL's collectives on card tensors, answers equal), then
     (a) tp 2, (b) dp 2 x tp 2, (c) pp 2 and (d) sp 2 as gloo ranks
     started on this one card (every collective staged through host
     memory; ranks time-sliced: no scaling figure); gates, with limits
     fixed from bf16 rounding (PAR_G1): layer 0's retrieval scores and
     the fixed-block question's first-token logits near the reference's,
     answers equal to the reference's or departing only at its near-ties,
     blocks departing only at its near-ties (pp bit-equal), launches per
     rank, collective counts per layer and pass, both kernels on each
     rank's state at its heads (and an sp rank's query offset);
 17. the command-line entry points (stc_tpu_torch/cli) at llava-ov-7b
     width: the public llava-onevision-qwen2-7b-ov widths with the LM's
     depth cut to 4 layers, written as a 2-shard bf16 HF checkpoint with a
     byte-level BPE tokenizer.json written here (Qwen2's specials at
     151643-151645), an MLVU annotation over two .npy videos (16 and 40
     frames at 360 x 640, two questions each); `python -m
     stc_tpu_torch.cli.run_eval` as a subprocess, with stream_demo (16
     frames) and serve_demo (8 ticks, --spec 4 --migrate) at
     llava-ov-0.5b width as subprocesses beside it, then run_eval's main
     in-process with the launch counts from 0, run_eval over a session
     loaded from the same directory, and --stream_batch 2; gates: every
     subprocess exits 0, no error row, the three runs' rows equal, the
     tokenizer's decode of its encode equal to the NFC text, its init
     prompt as long as the session's n_init, launches = appends x layers
     and LM forwards x layers.

    python3 chip_smoke.py --planted-faults

builds the kernels, runs phase 16's reference and then each planted
fault of a straight port in its layout (an even split of the fused
q|k|v axis, unreduced retrieval logits, the logits' tp blocks gathered
in reverse, pruning before the sp gather); it exits non-zero unless the
limits on numbers reject every one.

Prints JSON lines; the line before the last holds one entry per kernel
(route, source, the TPU kernel it replaces, launches on its path, error,
kernel / plain / bound / library times, design), the last line is
{"ok": true, "device": {...}}.  A fuller record goes to
build/chip_smoke.json.  TF32 is off for matmuls and convolutions, so
every float32 product runs in full float32.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import unicodedata

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
# The data sheet's dense bf16 peak, 989 TFLOP/s, is 132 SMs x 4096 flops a
# clock at its 1830 MHz boost clock.  The exponentials (MUFU.EX2, 16 a
# clock per SM on compute capability 9.0) are rated at that same clock, so
# both terms of a bound assume one clock: one exponential takes as long as
# 4096 / 16 = 256 flops.
H100_SMS = 132
H100_CLOCK_HZ = 1.83e9
H100_BF16_FLOPS = H100_SMS * 4096 * H100_CLOCK_HZ
H100_EXP_PER_S = H100_SMS * 16 * H100_CLOCK_HZ
SLEEP_CYCLES = 100_000_000   # ~50 ms at the H100's 1.98 GHz SM clock

DESIGN = "mma.sync bf16 / fma f32"

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


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Device ms per call of fn: reps calls issued behind a sleep kernel, so
    the device runs them back to back however long the host takes to issue
    them (checked: the issuing ends before the sleep does)."""
    return cuda_times(fn, reps, warm)[0]


def cuda_times(fn, reps: int, warm: int = 2) -> tuple:
    """(device ms, host ms) per call of fn, as cuda_ms measures them; the
    host ms is the time to issue one call.  Where the issuing outlasts the
    sleep, the sleep is made four times longer, once."""
    for _ in range(warm):
        fn()
    for cycles in (SLEEP_CYCLES, 4 * SLEEP_CYCLES):
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        torch.cuda._sleep(cycles)
        e[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e[2].record()
        torch.cuda.synchronize()
        if host_ms < e[0].elapsed_time(e[1]):
            return e[1].elapsed_time(e[2]) / reps, host_ms / reps
    raise RuntimeError(f"issuing {reps} calls took {host_ms} ms, longer "
                       f"than the sleep kernel before them")


def bound(bytes_moved: float, flops: float, exps: float):
    """The least ms for the work, and what bounds it: the bytes over the
    memory rate, the bf16 products over the tensor cores' peak, the
    exponentials over the special-function units' rate.  Terms that tie
    are all named, joined by '=' (D = 64 attention: 4 D = 256 flops an
    exponential ties its products and exponentials)."""
    t = {"bytes": bytes_moved / H100_BYTES_PER_S * 1e3,
         "operations": flops / H100_BF16_FLOPS * 1e3,
         "exp": exps / H100_EXP_PER_S * 1e3}
    top = max(t.values())
    return top, "=".join(k for k, v in t.items() if v >= top * (1 - 1e-9))


# ---------------------------------------------------------------------------
# phase 1: what the compiler made of the kernels
# ---------------------------------------------------------------------------

def ptxas_functions(log: str) -> dict:
    """{kernel function: {registers, spill_stores, spill_loads}} from an
    nvcc -Xptxas -v log."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_hmma(path) -> dict:
    """{kernel function: number of HMMA (tensor-core) instructions} in the
    SASS of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def tensor_core_check(paths: dict, logs: dict) -> dict:
    """Every bf16 instance (the *_attention_tc and decode_score_tc kernels)
    of stream_attention, decode_attention and decode_score: HMMA in its
    SASS and no spill; the float32 (FMA) instances and stream_attention's
    bf16 pre-pass (stream_cover, no products) are listed beside them, each
    with its registers."""
    rows = {}
    for name in ("stream_attention", "decode_attention", "decode_score"):
        hmma, regs = sass_hmma(paths[name]), ptxas_functions(logs[name])
        for fn, r in regs.items():
            if "combine" in fn:
                continue
            rows[fn] = dict(r, hmma=hmma.get(fn), tensor_cores=bool(
                re.search(r"(attention|score)_tc", fn)))
    bad = [fn for fn, r in rows.items() if r["tensor_cores"] and (
        not r["hmma"] or r.get("spill_stores") or r.get("spill_loads"))]
    score_tc = [fn for fn, r in rows.items()
                if "score_tc" in fn and r["tensor_cores"]]
    if not any(r["tensor_cores"] for r in rows.values()) or bad or \
            len(score_tc) != 4:
        raise RuntimeError(f"tensor-core instances missing, without HMMA "
                           f"or with spills: {bad} {rows}")
    return rows


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


PAGE_BYTES = {None: 2.0, "int8": 1.0, "int4": 0.5}  # per page element


def half_keep(states, n_new, Nb, S, dev, gen):
    """window_kv_compression's page_keep for stream_case: every page
    written before this append keeps a random half of its S rows (as
    select_top_half leaves it), the new pages and the unwritten slots keep
    all."""
    B = len(states)
    keep = torch.ones((B, Nb, S), dtype=torch.bool, device=dev)
    for b, (nb, off) in enumerate(states):
        old = nb - off
        order = torch.rand((old, S), generator=gen, device=dev).argsort(-1)
        keep[b, :old].scatter_(1, order[:, S // 2:], False)
    return keep


def stream_case(name, Hq, Hkv, D, T, pages, dev, gen, n_local=15000, S=60,
                Nb=1024, n_init=14, exc=480, quant=None, states=None,
                keep=False, rope_base=1e6, q_part=None):
    """One stream_attention call of the main path's configuration
    (exc_block_size 480: a 264-page window cover), T new tokens with
    `pages` pages in the store after their write.  With states, a call
    over B = len(states) streams, each at its own (pages before the
    append, page_offset): every stream's L, start_tile, total, init_active
    and offset differ.  With quant ('int8' or 'int4') the store is
    quantized by the engine's own quantizer from float pages whose
    magnitudes differ from page to page (gain 4 ** (page % 3 - 1)), so a
    page read with another page's scales shows.  With keep, the call reads
    a page_keep mask that drops half of every older page (half_keep), and
    the library is SDPA with the same boolean mask (on dequantized bf16
    pages where quantized).  Returns the record, the wrapper's arguments
    and keywords, and the plain version's output.  rope_base: the model's
    (Qwen2's 1e6 by default, Vicuna's 1e4).  q_part: (offset, n): an sp
    rank's queries, n of the append's T tokens from token offset on, the
    offset carried in the kernel's scalars (L + offset)."""
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
    states = states or [(pages - n_new, 0)]
    B = len(states)
    nb = torch.tensor([s[0] for s in states], dtype=torch.int32, device=dev)
    off = torch.tensor([s[1] for s in states], dtype=torch.int32,
                       device=dev)
    if int((nb + n_new - off).max()) > Nb:
        raise RuntimeError(f"{name}: states {states} outgrow {Nb} pages")
    rc = engine.make_rope_cache(n_init + nb * S, nb, T, cfg, D, rope_base,
                                off)
    scalars, Tq = rc.scalars, T
    if q_part is not None:
        scalars, Tq = rc.scalars.clone(), q_part[1]
        scalars[:, 0] += q_part[0]
    kw = dict(n_local=n_local)
    if quant is None:
        bk, bv = rnd(B, Hkv, Nb, S, D), rnd(B, Hkv, Nb, S, D)
    else:
        gain = 4.0 ** (torch.arange(Nb, device=dev) % 3 - 1)
        qfn = (engine._quantize_page_int4 if quant == "int4"
               else engine._quantize_page)
        (bk, ks), (bv, vs) = (
            qfn(torch.randn((B, Hkv, Nb, S, D), generator=gen, device=dev)
                * gain[:, None, None]) for _ in range(2))
        kw.update(k_scales=ks, v_scales=vs)
    if keep:
        kw["page_keep"] = half_keep(states, n_new, Nb, S, dev, gen)
    args = (rnd(B, Hq, Tq, D), rnd(B, Hq, Tq, D), bk, bv, rc.cos_cover,
            rc.sin_cover, rnd(B, Hkv, n_init, D), rnd(B, Hkv, n_init, D),
            rnd(B, Hkv, n_init, D), scalars)
    out = sa.stream_attention(*args, **kw)
    ref = sa.stream_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    agree = held(name, out, ref)

    # what this run's data needs: the (query, key) pairs the masks let
    # through, and the live window keys (seen by some query) and their
    # pages, stream by stream
    pairs = live = live_pages = 0
    for b in range(B):
        page, _, _, mask = stream_mask(args, b, n_local, Nb, S,
                                       kw.get("page_keep"))
        m_win = mask[:, n_init:n_init + page.numel()]
        pairs += int(mask.sum())
        seen = m_win.any(dim=0)
        live += int(seen.sum())
        live_pages += int(page[seen].unique().numel())
    init_active = rc.scalars[:, 3].tolist()
    # queries, live pages (and their scales), init keys/values, output
    # (RoPE angles follow from the affine key positions)
    need = (B * (2 * Hq * Tq * D * 2 + 3 * Hkv * n_init * D * 2
                 + Hq * Tq * D * 2)
            + 2 * Hkv * live * D * PAGE_BYTES[quant]
            + (2 * Hkv * live_pages * D * 4 if quant else 0)
            + (live_pages * S if keep else 0))   # the keep bytes
    flops, exps = 4 * Hq * D * pairs, Hq * pairs
    b_ms, b_by = bound(need, flops, exps)
    # what this design reads besides: f32 cos and sin rows per live key
    bt_ms, bt_by = bound(need + 2 * live * D * 4, flops, exps)

    ms, host_ms = cuda_times(lambda: sa.stream_attention(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: sa.stream_attention_ref(*args, **kw), 3, 1)
    # this design's bf16 scratch of rotated, dequantized cover keys and
    # values: written by the pre-pass and read back at least once
    Lc = rc.cos_cover.shape[1]
    scratch = 2 * B * Hkv * Lc * D * 2
    rec = dict(case=name, kernel="stream_attention_page_keep" if keep else
               "stream_attention" + (f"_{quant}" if quant else ""),
        Hq=Hq, Hkv=Hkv, D=D, T=T, pages=pages,
        window_pages=engine.n_window_pages(cfg),
        init_active=init_active[0] if B == 1 else init_active,
        **agree, kernel_ms=ms, host_ms=host_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bound_ms_with_tables=bt_ms,
        bound_by_with_tables=bt_by, live_keys=live,
        visible_pairs=pairs, exponentials=exps,
        cover_scratch_mb=scratch / 1e6,
        cover_scratch_hbm_ms=2 * scratch / H100_BYTES_PER_S * 1e3)
    if B > 1:
        rec.update(batch=B, states=states, max_blocks=Nb,
                   scalars=rc.scalars.tolist())
    if q_part is not None:
        rec.update(q_offset=q_part[0], q_tokens=q_part[1])
    if keep:
        rec["kept_window_keys"] = live
    if quant is None or keep:
        largs = list(args)
        if quant:  # SDPA over the same cover dequantized to bf16 pages
            largs[2:4] = (engine._dequant_pages(x, s, bf) for x, s in (
                (bk, kw["k_scales"]), (bv, kw["v_scales"])))
        lib = sdpa_stream(largs, n_local, Nb, S, kw.get("page_keep"))
        rec.update(library_ms=cuda_ms(lib, 10),
                   library_max_rel_err=held(name, lib(), ref)["max_rel_err"])
    else:
        # no PyTorch call computes it: time the 1a kernel instead on the
        # same cover dequantized to bf16 pages, in turns with this one
        fargs = list(args)
        fargs[2:4] = (engine._dequant_pages(x, s, bf) for x, s in (
            (bk, kw["k_scales"]), (bv, kw["v_scales"])))
        f_ms = cuda_ms(lambda: sa.stream_attention(*fargs, n_local=n_local),
                       20)
        q_ms = cuda_ms(lambda: sa.stream_attention(*args, **kw), 20)
        rec.update(library_ms=None, kernel_ms=(ms + q_ms) / 2,
                   kernel_ms_runs=[ms, q_ms], bf16_pages_ms=f_ms)
    return rec, args, kw, ref


def stream_mask(args, b, n_local, Nb, S, keep=None):
    """The visible keys of stream b of a stream_attention call, as the
    plain version masks them (with keep, its page_keep): the cover's local
    pages, their slot offsets, and the (T, n_init + Lc + n_init) mask over
    [init-local | cover | init-far]."""
    from stc_tpu_torch.ops import stream_attention as sa
    q_rot, cc, kir, scalars = args[0], args[4], args[6], args[9]
    dev, T, n_init, Lc = q_rot.device, q_rot.shape[2], kir.shape[2], \
        cc.shape[1]
    Lv, start_tile, total, init_active, offset = (int(x) for x in
                                                  scalars[b])
    page = start_tile * sa.pages_per_tile(S) + torch.arange(
        Lc, device=dev) // S
    off = torch.arange(Lc, device=dev) % S
    pos = n_init + (page + offset) * S + off
    qp = Lv + torch.arange(T, device=dev)
    d = qp[:, None] - pos[None, :]
    m_win = (d >= 0) & (d < n_local) & (page < Nb)[None] & (
        (page + offset) < total)[None]
    if keep is not None:
        m_win = m_win & keep[b, page.clamp(max=Nb - 1), off][None]
    di = qp[:, None] - torch.arange(n_init, device=dev)[None]
    m_init = (di >= 0) & (di < n_local)
    m_far = torch.full((T, n_init), bool(init_active), device=dev)
    return page, page.clamp(max=Nb - 1), off, torch.cat(
        [m_init, m_win, m_far], dim=1)


def sdpa_stream(args, n_local, Nb, S, keep=None):
    """Library yardstick of a 1a call: one SDPA over the concatenated
    (rotated) keys of every stream, the two query angles packed side by
    side in a 2D head, with the call's boolean mask (keep: its
    page_keep)."""
    from stc_tpu_torch.ops.rope import rotate
    q_rot, q_one, bk, bv, cc, sc, kir, vi, kiw, scalars = args
    D = q_rot.shape[-1]
    z = torch.zeros_like
    ks, vs, masks = [], [], []
    for b in range(q_rot.shape[0]):
        _, pg, off, mask = stream_mask(args, b, n_local, Nb, S, keep)
        kw_ = rotate(bk[b][:, pg, off][None], cc[b:b + 1, None],
                     sc[b:b + 1, None])
        ks.append(torch.cat([torch.cat([kir[b:b + 1], z(kir[b:b + 1])], -1),
                             torch.cat([kw_, z(kw_)], -1),
                             torch.cat([z(kiw[b:b + 1]), kiw[b:b + 1]], -1)],
                            dim=2))
        vs.append(torch.cat([vi[b:b + 1], bv[b][:, pg, off][None],
                             vi[b:b + 1]], dim=2))
        masks.append(mask[None, None])
    k_all, v_all, mask = torch.cat(ks), torch.cat(vs), torch.cat(masks)
    q2 = torch.cat([q_rot, q_one], -1)
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(
            q2, k_all, v_all, attn_mask=mask, scale=D ** -0.5,
            enable_gqa=True)
    return lib


def decode_case(name, T, start, cursor, n_local, dev, gen, Hq=14, Hkv=2,
                D=64, C=4352, return_m=False):
    """One decode_attention call; start and cursor are ints (one stream)
    or per-stream lists (B = their length).  Returns the record, the
    wrapper's arguments and the plain version's output."""
    from stc_tpu_torch.ops import decode_attention as da
    bf = torch.bfloat16
    starts = [start] if isinstance(start, int) else list(start)
    cursors = [cursor] if isinstance(cursor, int) else list(cursor)
    B = len(starts)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, k, v = rnd(B, Hq, T, D), rnd(B, Hkv, C, D), rnd(B, Hkv, C, D)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    cu = torch.tensor(cursors, dtype=torch.int32, device=dev)
    args = (q, k, v, st, cu)
    kw = dict(n_local=n_local, return_m=return_m)
    got = da.decode_attention(*args, **kw)
    want = da.decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    agree = held(name, got, want)
    mask = torch.stack([decode_mask(a, T, c, n_local, C, dev)
                        for a, c in zip(starts, cursors)])
    pairs, live = int(mask.sum()), int(mask.any(dim=1).sum())
    bytes_moved = (B * Hq * T * D * 2 + 2 * Hkv * live * D * 2
                   + B * Hq * T * D * 2 + (B * Hq * T * 4 if return_m else 0))
    flops, exps = 4 * Hq * D * pairs, Hq * pairs
    b_ms, b_by = bound(bytes_moved, flops, exps)
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None], enable_gqa=True)

    lib_err = held(name, lib(), want[0] if return_m else want)["max_rel_err"]
    ms, host_ms = cuda_times(lambda: da.decode_attention(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: da.decode_attention_ref(*args, **kw), 3, 1)
    lib_ms = cuda_ms(lib, 10)
    rec = dict(case=name, kernel="decode_attention", T=T, start=start,
               cursor=cursor, n_local=n_local, C=C, return_m=return_m,
               **agree, kernel_ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               library_ms=lib_ms,
               library_max_rel_err=lib_err, bound_ms=b_ms, bound_by=b_by,
               live_slots=live, visible_pairs=pairs, exponentials=exps)
    if B > 1:
        rec["batch"] = B
    return rec, args, kw, want


def decode_mask(start, T, cursor, n_local, C, dev):
    """(T, C) visible slots of one stream's decode call: query slot start
    + t sees slot j when 0 <= start + t - j < n_local and j < cursor."""
    slot = torch.arange(C, device=dev)
    dist = start + torch.arange(T, device=dev)[:, None] - slot[None]
    return (dist >= 0) & (dist < n_local) & (slot < cursor)[None]


# decode_score_tc built with parts switched off (STC_SCORE_DROP in
# csrc/decode_score.cu): the ex2, the products, a query tile's whole step,
# the walk
SCORE_PARTS = {"no_exp": 1, "no_products": 2, "no_step": 3, "no_walk": 4}


def score_parts(args, n_local, paths) -> dict:
    """Device ms of the bf16 decode_score on args, built with each part of
    its tile switched off in turn: what its time is made of.  The variants'
    outputs are wrong by design and not kept."""
    q, k, m, st, cu = args
    B, Hq, T, D = q.shape
    Hkv, C = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, C), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, m, st, cu, out)]
    res = {}
    for part, path in paths.items():
        fn = ctypes.CDLL(str(path)).stc_decode_score
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, part=part):
            rc = fn(*ptrs, B, Hq, Hkv, T, D, C, n_local, 1, stream)
            if rc != 0:
                raise RuntimeError(f"decode_score {part}: cudaError {rc}")
        res[part] = cuda_ms(call, 20)
    return res


def score_case(name, T, start, cursor, n_local, dev, gen, Hq=14, Hkv=2,
               D=64, C=4352, parts=None):
    """One decode_score call, with the row maxima of decode_attention on
    the same inputs, on bf16 (the tensor-core instance) and, held and timed
    beside it, the same inputs in float32 (the FMA instance); with parts
    (score_parts' variant libraries), the bf16 tile's time split too.
    Returns the record, the bf16 call's arguments and the plain version's
    output.  No single PyTorch call computes it."""
    from stc_tpu_torch.ops import decode_attention as da
    bf = torch.bfloat16
    q = torch.randn((1, Hq, T, D), generator=gen, device=dev).to(bf)
    k = torch.randn((1, Hkv, C, D), generator=gen, device=dev).to(bf)
    v = torch.randn((1, Hkv, C, D), generator=gen, device=dev).to(bf)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    cu = torch.tensor([cursor], dtype=torch.int32, device=dev)
    kw = dict(n_local=n_local)
    runs = {}
    for dt in (bf, torch.float32):
        qd, kd = q.to(dt), k.to(dt)
        _, m = da.decode_attention(qd, kd, v.to(dt), st, cu,
                                   return_m=True, **kw)
        args = (qd, kd, m, st, cu)
        got = da.decode_score(*args, **kw)
        want = da.decode_score_ref(*args, **kw)
        torch.cuda.synchronize()
        runs[dt] = args, want, held(name, got, want)
    args, want, agree = runs[bf]
    mask = decode_mask(start, T, cursor, n_local, C, dev)
    pairs, live = int(mask.sum()), int(mask.any(dim=0).sum())
    # queries, live keys, row maxima in; the (Hq, C) f32 masses out
    bytes_moved = (Hq * T * D * 2 + Hkv * live * D * 2 + Hq * T * 4
                   + Hq * C * 4)
    flops, exps = 2 * Hq * D * pairs, Hq * pairs
    b_ms, b_by = bound(bytes_moved, flops, exps)
    ms, host_ms = cuda_times(lambda: da.decode_score(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: da.decode_score_ref(*args, **kw), 3, 1)
    f_args, _, f_agree = runs[torch.float32]
    f32_ms = cuda_ms(lambda: da.decode_score(*f_args, **kw), 5)
    rec = dict(case=name, kernel="decode_score", Hq=Hq, Hkv=Hkv, D=D, T=T,
               start=start, cursor=cursor, n_local=n_local, C=C, **agree,
               kernel_ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               live_slots=live, visible_pairs=pairs, exponentials=exps,
               f32_ms=f32_ms, f32_max_rel_err=f_agree["max_rel_err"],
               f32_rms_rel_err=f_agree["rms_rel_err"],
               f32_agrees=f_agree["agrees"])
    if parts:
        rec["parts_ms"] = score_parts(args, n_local, parts)
    return rec, args, kw, want


def nibbles_swapped(p):
    return ((p & 0x0F) << 4) | (p >> 4)


# the phase-2 cases of four streams at their own positions (phases 10-11's
# shapes): per stream (pages before the append, page_offset), offsets of
# 0, 56 and 112 pages as after host-tier evictions of 56 pages
B4_STREAM = "stream B=4 0.5b heads, 1-frame appends, offsets 0/0/56/112"
B4_STREAM_INT8 = ("stream int8 B=4 7B heads (28/4/128), 8-page appends, "
                  "offsets 0/0/56/112")
B4_DECODE = "decode B=4 token step, own cursors"
# the speculative decode's verify forward: K + 1 = 5 queries (tok0 and 4
# drafts) at each stream's own cursor, causally masked; the rows past the
# cursor (an earlier round's rejected drafts, random here) lie ahead of
# every query
VERIFY_DECODE = "decode verify T=5, B=4, own cursors"
VERIFY_STARTS = [3854, 3901, 4017, 4203]
B4_STATES_05B = [(10, 0), (250, 0), (330, 56), (400, 112)]
# window_kv_compression's masked kernel: an 8-page append over the full
# 264-page window, half of every older page dropped
KEEP_05B = ("stream page_keep 8-page append (T 480), 264 pages, half of "
            "every older page dropped")
KEEP_7B_INT8 = ("stream int8 page_keep 7B heads (28/4/128), 8-page append, "
                "264 pages, half of every older page dropped")
B4_STATES_7B = [(20, 0), (290, 0), (340, 56), (400, 112)]
# the CLIP backbones' shapes (phase 14): one-frame appends over the full
# window at Vicuna's heads (32/32/128, G = 1) on 257-token pages
# (Video-LLaVA: 40 window pages, one a cover tile) and 64-token pages
# (Flash-VStream: 64 pages, 8 a tile), and LongVA's 28/4 heads on
# 144-token pages (64 pages, 2 a tile); decode_attention at Vicuna's heads
# over Video-LLaVA's decode cache
VL_STREAM = ("stream Vicuna heads (32/32/128) 257-token pages, 1-frame "
             "append, 48 pages (40-page window)")
LV_STREAM = ("stream LongVA heads (28/4/128) 144-token pages, 1-frame "
             "append, 80 pages (64-page window)")
FV_STREAM = ("stream Vicuna heads (32/32/128) 64-token pages, 1-frame "
             "append, 96 pages (64-page window)")
TP2_STREAM = ("stream 8-page append, a tp 2 rank's 7B heads (14/2/128), "
              "264 pages")
TP4_STREAM = ("stream 8-page append, a tp 4 rank's 7B heads (7/1/128), "
              "264 pages")
SP_STREAM = ("stream sp 2 rank 1: 4 of an 8-page append's pages at query "
             "offset 240, 7B heads (28/4/128), 264 pages")
TP2_DECODE_TOKEN = "decode token T=1, a tp 2 rank's 7B heads (14/2/128)"
TP4_DECODE_TOKEN = "decode token T=1, a tp 4 rank's 7B heads (7/1/128)"
TP2_DECODE_PREFILL = "decode prefill T=256, a tp 2 rank's heads (14/2/128)"
TP4_DECODE_PREFILL = "decode prefill T=256, a tp 4 rank's heads (7/1/128)"
VL_DECODE_PREFILL = "decode prefill T=256 Vicuna heads (32/32/128)"
VL_DECODE_TOKEN = "decode token T=1 Vicuna heads (32/32/128)"


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

    def neighbour_scales(case):
        args, kw, ref = inputs[case]
        kw = dict(kw, k_scales=kw["k_scales"].roll(1, dims=2).contiguous(),
                  v_scales=kw["v_scales"].roll(1, dims=2).contiguous())
        return sa.stream_attention(*args, **kw), ref

    def swapped_planes(case):
        args, kw, ref = inputs[case]
        a = list(args)
        a[2], a[3] = nibbles_swapped(a[2]), nibbles_swapped(a[3])
        return sa.stream_attention(*a, **kw), ref

    def score_window(case):
        args, kw, ref = inputs[case]
        return da.decode_score(*args, n_local=kw["n_local"] + 1), ref

    def decode(case, cursor_delta=0, n_local_delta=0, start_delta=0):
        (q, k, v, st, cu), kw, want = inputs[case]
        kw = dict(kw, n_local=kw["n_local"] + n_local_delta)
        return da.decode_attention(q, k, v, st + start_delta,
                                   cu + cursor_delta, **kw), want

    def stream0_scalars(case):
        args, kw, ref = inputs[case]
        sc = args[9][:1].expand_as(args[9]).contiguous()
        return sa.stream_attention(*args[:9], sc, **kw), ref

    def stream0_cursors(case):
        (q, k, v, st, cu), kw, want = inputs[case]
        return da.decode_attention(q, k, v, st[:1].expand_as(st).contiguous(),
                                   cu[:1].expand_as(cu).contiguous(),
                                   **kw), want

    def neighbour_keep(case):
        args, kw, ref = inputs[case]
        kw = dict(kw, page_keep=kw["page_keep"].roll(1, dims=1).contiguous())
        return sa.stream_attention(*args, **kw), ref

    def offset_one_page(case, b):
        args, kw, ref = inputs[case]
        sc = args[9].clone()
        sc[b, 4] += 1
        return sa.stream_attention(*args[:9], sc, **kw), ref

    faults = [
        ("stream: third key group dropped (init_active 1 -> 0)",
         lambda: scalar("stream 300 pages init_active", 3, -1)),
        ("stream: window pages one page late (page_offset + 1)",
         lambda: scalar("stream 100 pages", 4, 1)),
        ("decode: newest slot dropped (cursor - 1)",
         lambda: decode("decode token T=1", cursor_delta=-1)),
        ("decode: window one slot longer (n_local + 1)",
         lambda: decode("decode expired window", n_local_delta=1)),
        ("stream int8: the scale rows of the neighbouring page",
         lambda: neighbour_scales("stream int8 300 pages init_active")),
        ("stream int4: the nibble planes swapped",
         lambda: swapped_planes("stream int4 300 pages init_active")),
        ("decode_score: window one slot longer (n_local + 1)",
         lambda: score_window("decode_score expired window (n_local 64)")),
        ("stream B=4: every stream reads stream 0's scalars",
         lambda: stream0_scalars(B4_STREAM)),
        ("stream int8 B=4: stream 3's page_offset one page off",
         lambda: offset_one_page(B4_STREAM_INT8, 3)),
        ("decode B=4: every stream reads stream 0's start and cursor",
         lambda: stream0_cursors(B4_DECODE)),
        ("decode verify: each query sees the next draft (start + 1)",
         lambda: decode(VERIFY_DECODE, start_delta=1)),
        ("stream page_keep: each page reads its neighbour's keep row",
         lambda: neighbour_keep(KEEP_05B)),
        ("stream 257-token pages: third key group dropped (init_active "
         "1 -> 0)", lambda: scalar(VL_STREAM, 3, -1)),
        ("stream 257-token pages: window pages one page late "
         "(page_offset + 1)", lambda: scalar(VL_STREAM, 4, 1)),
    ]
    out = []
    for name, run in faults:
        got, want = run()
        rec = {"fault": name, **held(name, got, want)}
        rec["rejected"] = not rec.pop("agrees")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 13: the ablation paths and YUV ingest at llava-ov-0.5b width
# ---------------------------------------------------------------------------

ABL_STOP = [151645]
ABL_QUESTIONS = [(list(range(200, 212)), list(range(300, 316))),
                 (list(range(400, 409)), list(range(500, 516))),
                 (list(range(600, 612)), list(range(700, 716)))]
ABL_COMPRESSIONS = ("filter_tokens_simple", "filter_tokens_percentile",
                    "filter_tokens_magnitude",
                    "filter_tokens_euclidean_distance",
                    "filter_tokens_inverse_cosine", "filter_tokens_top_half",
                    "filter_tokens_random")
ABL_SCORERS = ("aks", "dpc_knn", "l2norm")


def with_rekv(sess, **kw):
    """The live session with its ReKV settings replaced (the retrieval-time
    ablations are read per question; the stream state stays)."""
    sess.rekv = dataclasses.replace(sess.rekv, **kw)
    sess.scfg = dataclasses.replace(sess.scfg, rekv=sess.rekv)


def yuv_reconstruction(packed, h, w):
    """numpy reconstruction of packed 4:2:0 planes: nearest 2x2 chroma and
    the BT.601 full-range matrix in float32, clipped to [0, 255]."""
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


def keep_rule(got, ref, S):
    """The keep rows select_top_half would take from the kernel's and the
    plain version's outputs (B, Hq, T, D) of one append: per page the
    ceil(S/2) tokens of largest head-and-dim mean.  With d the largest
    difference of the two packages' scores, a token whose plain score lies
    more than 2 d from the page's cut (the midpoint of the k-th and
    (k+1)-th plain scores) is held: it must be kept by both or by neither;
    the tokens within 2 d of the cut are near-ties and are counted.  A
    page whose gap at the cut exceeds 2 d is held whole."""
    from stc_tpu_torch.ops.topk import topk_lowest
    k = -(-S // 2)
    sg, sr = (o.float().mean(dim=(1, 3)).reshape(-1, S) for o in (got, ref))
    diff = float((sg - sr).abs().max())
    srt = sr.sort(dim=-1, descending=True).values
    gap = srt[:, k - 1] - srt[:, k]
    cut = (srt[:, k - 1] + srt[:, k]) / 2
    rows = [torch.zeros_like(x, dtype=torch.bool).scatter_(
        1, topk_lowest(x, k)[1], True) for x in (sg, sr)]
    same = rows[0] == rows[1]
    held = (sr - cut[:, None]).abs() > 2 * diff
    held_pages = gap > 2 * diff
    return {"pages": int(sg.shape[0]), "tokens": int(sg.numel()),
            "held_tokens": int(held.sum()),
            "rows_equal_where_held": bool(same[held].all()),
            "near_tie_pairs": int((~held).sum()),
            "near_tie_pairs_differing": int((~same).sum()),
            "held_pages": int(held_pages.sum()),
            "rows_equal_all": bool(same.all()), "max_score_diff": diff}


def ablation_phase(card, dev, gen, ingest_fps_phase3) -> dict:
    """Phase 13 at llava-ov-0.5b width (phase 3's model): (a) window
    compression, (b) retrieved-KV compression, (c) the host-side block
    scorers through layerwise QA, (d) the cacher's variants, (e) YUV 4:2:0
    ingest and the frame prefetcher.  Each path's launch counts are read
    from 0 around it."""
    from stc_tpu_torch import native
    from stc_tpu_torch.compress.scoring import select_blocks
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.kvcache.state import layer
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.ops import stream_attention as sa
    from stc_tpu_torch.runtime.pipeline import stream_encode
    t_phase = time.perf_counter()
    model, cfg = make_model(dev, seed=0)
    tc = cfg.text
    L, V, G = tc.num_layers, tc.vocab_size, tc.num_heads // tc.num_kv_heads
    hw = cfg.vision.image_size
    frames = np.random.default_rng(13).integers(
        0, 256, size=(48, hw, hw, 3), dtype=np.uint8)
    base = session_cfg(15000, 64, 256, 16, 8, 1024)
    S = base.rekv.block_size
    out = {"phase": "ablations llava-ov-0.5b", "card": card}

    def build(scfg):
        return lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                                device=dev)

    def qa(sess, questions):
        answers, secs = [], []
        for q, p in questions:
            a, dt = timed(lambda: sess.question_answering(
                q, p, ABL_STOP, max_new_tokens=16))
            if not a or not all(0 <= t < V for t in a):
                raise RuntimeError(f"phase 13: bad answer {a}")
            answers.append(a)
            secs.append(dt)
        return answers, secs

    def want_counts(appends, answers, masked=0):
        return {"stream_attention": {"float": L * appends, "int8": 0,
                                     "int4": 0},
                "decode_attention": L * sum(2 + len(a) for a in answers),
                "decode_score": 0, "stream_attention_page_keep": masked}

    def check(counts, want, where):
        if counts != want:
            raise RuntimeError(f"phase 13 {where}: launch counts {counts} "
                               f"!= expected {want}")

    # (a) window compression: every append through the masked kernel
    sess = build(dataclasses.replace(base, rekv=dataclasses.replace(
        base.rekv, window_kv_compression="select_top_half")))
    reset_counts()
    sess.encode_init_prompt(list(range(100, 114)))
    chunk_s = [timed(lambda: sess.encode_video(frames[8 * c:8 * c + 8]))[1]
               for c in range(6)]
    answers, secs = qa(sess, ABL_QUESTIONS)
    counts = read_counts()
    check(counts, want_counts(6, answers, masked=6 * L), "(a)")
    kept = sess.kvs.page_keep[:, 0, :48].sum(-1)
    if not bool((kept == -(-S // 2)).all()):
        raise RuntimeError(f"(a): keep rows hold {kept.unique().tolist()}")
    kv = layer(sess.kvs, L // 2)
    T = 8 * S
    rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, sess.rekv,
                                tc.head_dim, tc.rope_base, kv.page_offset)
    q = torch.randn((1, tc.num_heads, T, tc.head_dim), generator=gen,
                    device=dev).bfloat16()
    args = (q, q.flip(2).contiguous(), kv.block_k, kv.block_v,
            rc.cos_cover, rc.sin_cover, kv.init_k, kv.init_v, kv.init_k,
            rc.scalars)
    kw = dict(n_local=sess.rekv.n_local, page_keep=kv.page_keep)
    got, ref = sa.stream_attention(*args, **kw), sa.stream_attention_ref(
        *args, **kw)
    state = held("(a) session state", got, ref)
    rule = keep_rule(got, ref, S)
    if not state["agrees"] or not rule["rows_equal_where_held"]:
        raise RuntimeError(f"(a): masked kernel on the session's state "
                           f"{state} {rule}")
    out["a_window_compression"] = {
        "frames": 48, "appends": 6, "answers": answers,
        "launches": counts, "kernel_vs_plain_layer": L // 2,
        "kernel_vs_plain": state, "keep_rows": rule,
        "ingest_fps_8frame_chunks": 8 * 5 / sum(chunk_s[1:]),
        "ingest_fps_8frame_chunks_phase3": ingest_fps_phase3,
        "qa_p50_s": p50(secs), "qa_s": secs}
    del sess, kv, args, kw, got, ref

    # (b) retrieved-KV compression and (c) the block scorers, on one
    # uncompressed stream of 80 frames (more blocks than topk 64)
    sess = build(base)
    sess.encode_init_prompt(list(range(100, 114)))
    for c in range(10):
        sess.encode_video(frames[(8 * c) % 48:(8 * c) % 48 + 8])
    nb = sess._total_blocks
    calls = {"n": 0}
    inner = engine.compress_retrieved

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)

    rec_b = {}
    engine.compress_retrieved = counted
    try:
        for strat in ABL_COMPRESSIONS:
            with_rekv(sess, retrieved_kv_compression=strat)
            calls["n"] = 0
            reset_counts()
            answers, secs = qa(sess, ABL_QUESTIONS[:2])
            counts = read_counts()
            check(counts, want_counts(0, answers), f"(b) {strat}")
            if calls["n"] != L * 2:
                raise RuntimeError(f"(b) {strat}: {calls['n']} "
                                   f"compressions, not {L * 2}")
            rec_b[strat] = {"answers": answers, "qa_p50_s": p50(secs),
                            "decode_attention": counts["decode_attention"]}
    finally:
        engine.compress_retrieved = inner
    with_rekv(sess, retrieved_kv_compression="none")
    reset_counts()
    answers, secs = qa(sess, ABL_QUESTIONS[:2])
    check(read_counts(), want_counts(0, answers), "(b) none")
    rec_b["none"] = {"answers": answers, "qa_p50_s": p50(secs)}
    out["b_retrieved_compression"] = rec_b

    rec_c, logged = {}, []
    lm = sess.lm
    inner_logits = lm.qa_layer_logits

    def spy(i, rekv, kv_l, h, n_tok):
        res = inner_logits(i, rekv, kv_l, h, n_tok)
        logged.append((res[3][0, :nb].float().cpu().numpy(),
                       res[5][0].float().cpu().numpy().reshape(-1),
                       kv_l.block_rep[0, :nb].float().cpu().numpy()))
        return res

    lm.qa_layer_logits = spy
    try:
        for scorer in ABL_SCORERS:
            with_rekv(sess, retrieval_scorer=scorer)
            reset_counts()
            answers, secs = qa(sess, ABL_QUESTIONS[:2])
            counts = read_counts()
            check(counts, want_counts(0, answers), f"(c) {scorer}")
            picks, last = sess.last_retrieved_indices, logged[-L:]
            for li, (lg, qm, reps) in enumerate(last):
                reps_flat = np.repeat(reps, G, axis=1).reshape(nb, -1)
                want = select_blocks(scorer, lg, reps_flat, qm,
                                     sess.rekv.topk, sess.rekv.chunk_size)
                if picks[li] != want:
                    raise RuntimeError(f"(c) {scorer} layer {li}: device "
                                       f"picked {picks[li]}, host {want}")
            rec_c[scorer] = {"answers": answers, "qa_p50_s": p50(secs),
                             "blocks_layer0": picks[0],
                             "blocks_per_layer": [len(x) for x in picks],
                             "decode_attention": counts["decode_attention"]}
    finally:
        del lm.qa_layer_logits
    with_rekv(sess, retrieval_scorer="mean_dot")
    rec_c["mean_dot_qa_p50_s"] = rec_b["none"]["qa_p50_s"]
    out["c_block_scorers"] = rec_c
    del sess

    # (d) the cacher's variants: one 8-frame cached chunk's vision
    rec_d = {}
    feats = {}
    for name, ck in (("key", {}), ("value", {"sim_source": "value"}),
                     ("k_proxy_64", {"k_proxy_rank": 64})):
        vis = lo.LlavaOVVision(model, dataclasses.replace(
            base, cacher=dataclasses.replace(base.cacher, **ck)))
        px = [vis.device_preprocess(torch.as_tensor(vis.preprocess(
            frames[8 * i:8 * i + 8])).to(dev)) for i in (0, 1)]
        vstate, pstate = vis.init_state()
        _, vstate, pstate = vis.full(px[0], vstate, pstate)
        ms = sorted(timed(lambda: vis.cached(px[1], vstate, pstate))[1]
                    for _ in range(4))
        full_ms = timed(lambda: vis.full(px[1], vstate, pstate))[1]
        feats[name] = vis.cached(px[1], vstate, pstate)[0].float()
        if not bool(torch.isfinite(feats[name]).all()):
            raise RuntimeError(f"(d) {name}: features not finite")
        rec_d[name] = {"cached_ms_per_8frame_chunk": 1e3 * ms[1],
                       "cached_ms_runs": [1e3 * x for x in ms],
                       "full_ms_per_8frame_chunk": 1e3 * full_ms}
    for name in ("value", "k_proxy_64"):
        rec_d[name]["max_abs_diff_vs_key"] = float(
            (feats[name] - feats["key"]).abs().max())
    out["d_cacher_variants"] = rec_d
    del feats, px

    # (e) YUV 4:2:0 ingest against an RGB session fed the numpy
    # reconstruction of the same planes; the prefetcher against
    # synchronous staging
    one = session_cfg(15000, 64, 256, 16, 1, 1024)
    sy = build(dataclasses.replace(one, ingest_format="yuv420"))
    sr = build(one)
    sy.vision.src_hw = (hw, hw)
    packed = native.rgb_to_yuv420(frames[:16])
    recon = yuv_reconstruction(packed, hw, hw)
    unpack = sy.vision._pre._yuv_to_rgb(torch.as_tensor(packed).to(dev))
    pix_diff = float((unpack.cpu() - torch.from_numpy(recon)).abs().max())
    for s_ in (sy, sr):
        s_.encode_init_prompt(list(range(100, 114)))
    reset_counts()
    _, sync_s = timed(lambda: sy.encode_video(frames[:16]))
    answers, secs = qa(sy, ABL_QUESTIONS[:2])
    counts = read_counts()
    check(counts, want_counts(16, answers), "(e)")
    sr.encode_video(recon)
    want_answers, _ = qa(sr, ABL_QUESTIONS[:2])
    if answers != want_answers or pix_diff > 1e-3:
        raise RuntimeError(f"(e): yuv answers {answers} != rgb on the "
                           f"reconstruction {want_answers} (pixels "
                           f"{pix_diff})")
    bytes_pre, pre_s = timed(lambda: stream_encode(sy, frames[16:32],
                                                   overlap=True))
    _, sync2_s = timed(lambda: sy.encode_video(frames[32:48]))
    out["e_yuv420"] = {
        "frames": 16, "answers": answers, "answers_equal_rgb": True,
        "unpack_max_abs_diff": pix_diff, "launches": counts,
        "h2d_bytes_per_frame": packed.nbytes / 16,
        "h2d_bytes_per_frame_rgb": frames[:16].nbytes / 16,
        "prefetch_h2d_bytes_per_frame": bytes_pre / 16,
        "fps_sync_staging": [16 / sync_s, 16 / sync2_s],
        "fps_prefetch": 16 / pre_s, "qa_p50_s": p50(secs)}
    del sy, sr, model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phases 3-4 (llava-ov-0.5b width) and 6-7 (llava-ov-7b width): sessions
# ---------------------------------------------------------------------------

# Qwen2 widths of the public llava-onevision-qwen2-0.5b-ov and -7b-ov configs
QWEN2_05B = dict(vocab_size=151936, hidden_size=896, num_layers=24,
                 num_heads=14, num_kv_heads=2, head_dim=64,
                 intermediate_size=4864, rope_base=1000000.0)
QWEN2_7B = dict(vocab_size=152064, hidden_size=3584, num_layers=28,
                num_heads=28, num_kv_heads=4, head_dim=128,
                intermediate_size=18944, rope_base=1000000.0)


def make_model(dev, seed, text=QWEN2_05B, vision_dtype=torch.float32,
               dtype=torch.bfloat16):
    """SigLIP 1152 x 27 at 384 px in vision_dtype and the Qwen2 of `text`
    in dtype, random weights from a seeded torch.Generator."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg
    vision = sg.SiglipConfig(hidden_size=1152, num_layers=27, num_heads=16,
                             intermediate_size=4304, image_size=384,
                             patch_size=14)
    cfg = lo.LlavaOVConfig(vision=vision, text=qw.Qwen2Config(**text))
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = lo.LlavaOV(cfg, dtype=dtype, vision_dtype=vision_dtype,
                       device=dev).init_random_params(gen)
    return model, cfg


def session_cfg(n_local, topk, max_prompt, max_new, exc_frames, max_blocks,
                kv_quant="none", weights_quant="none", host_kv_quant="int8",
                max_rep_blocks=0):
    from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                      SessionConfig)
    return SessionConfig(
        rekv=ReKVConfig(n_init=14, n_local=n_local, block_size=60,
                        exc_block_size=60 * exc_frames, topk=topk,
                        max_blocks=max_blocks, max_prompt_tokens=max_prompt,
                        max_new_tokens=max_new, kv_quant=kv_quant,
                        host_kv_quant=host_kv_quant,
                        max_rep_blocks=max_rep_blocks),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.25,
                            cache_interval=2),
        pruner=PrunerConfig(token_per_frame=60),
        encode_chunk_frames=exc_frames, weights_quant=weights_quant)


def reset_counts() -> None:
    """Every kernel launch count to 0."""
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa
    torch.cuda.synchronize()
    da.launches = da.score_launches = 0
    sa.masked_launches = 0
    for k in sa.launches:
        sa.launches[k] = 0


def read_counts() -> dict:
    from stc_tpu_torch.cli import launch_counts
    torch.cuda.synchronize()
    return launch_counts()


def stream_phase(model, cfg, scfg, name, n_chunks, questions, card, dev,
                 gen, after=None) -> dict:
    """Phases 6-8: the pixel session of scfg (8-frame chunks) at the
    model's width, n_chunks chunks (past the full window and the init-fill
    crossing, asserted where each happens), then the questions.  Checks the
    launch counts (every append launches the kernel of the store's page
    kind), then holds stream_attention, decode_attention and decode_score
    against their plain versions on the session's own state.  Building the
    session quantizes the model's LM in place when scfg.weights_quant is
    set.  after(sess), if given, runs once the launch counts are checked;
    its result is the record's "after"."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.kvcache.state import layer
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import siglip as sg
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa
    t_phase = time.perf_counter()
    quant = scfg.rekv.kv_quant
    page_kind = "float" if quant == "none" else quant
    rekv, tc = scfg.rekv, cfg.text
    sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                            device=dev)
    W, T = engine.n_window_pages(rekv), rekv.exc_block_size
    n_layers = tc.num_layers
    rng = np.random.default_rng(6)
    reset_counts()
    sess.encode_init_prompt(list(range(100, 114)))
    chunk_s, init_active, window = [], [], []
    for _ in range(n_chunks):
        frames = rng.integers(0, 256, size=(8, 384, 384, 3), dtype=np.uint8)
        L = int(sess.kvs.length[0, 0].item())
        init_active.append(L + T > rekv.n_local)
        _, dt = timed(lambda: sess.encode_video(frames))
        chunk_s.append(dt)
        window.append(min(int(sess.kvs.num_blocks[0, 0].item()), W))
    # where each turns on, from the config alone: the init-fill crossing
    # L + T > n_local, and the window's W pages all written
    k_init = next(k for k in range(n_chunks)
                  if rekv.n_init + k * T + T > rekv.n_local)
    k_full = next(k for k in range(n_chunks) if 8 * (k + 1) >= W)
    if init_active != [k >= k_init for k in range(n_chunks)] or \
            window[k_full] != W or window[k_full - 1] >= W or \
            k_full >= n_chunks - 1:
        raise RuntimeError(f"{name}: init_active {init_active}, window "
                           f"pages {window}; expected init_active from "
                           f"chunk {k_init}, {W} pages from chunk {k_full}")
    stop = [151645]
    qa_s, answers, lm_forwards = [], [], 0
    captured = {}

    def capture(f):
        def g(*a, **k):
            captured["dkvs"] = f(*a, **k)
            return captured["dkvs"]
        return g

    for q_ids, p_ids in questions:
        with patched([(sess.lm, "init_decode_state", capture)]):
            out, dt = timed(lambda: sess.question_answering(
                q_ids, p_ids, stop, max_new_tokens=16))
        qa_s.append(dt)
        answers.append(out)
        lm_forwards += 2 + len(out)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_app = n_chunks
    want = {"stream_attention": {k: (n_layers * n_app if k == page_kind
                                      else 0) for k in sa.launches},
            "decode_attention": n_layers * lm_forwards, "decode_score": 0,
            "stream_attention_page_keep": 0}
    if counts != want:
        raise RuntimeError(f"{name} session launch counts {counts} != "
                           f"expected {want}")
    for a in answers:
        if not a or not all(0 <= t < tc.vocab_size for t in a):
            raise RuntimeError(f"bad answer {a}")
    extra = {} if after is None else {"after": after(sess)}

    # the kernels on the session's own state, a middle layer: the next
    # append over the full window, and the decode cache of the last question
    li = n_layers // 2
    kv = layer(sess.kvs, li)
    rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, rekv,
                                tc.head_dim, tc.rope_base, kv.page_offset)
    q = torch.randn((1, tc.num_heads, T, tc.head_dim), generator=gen,
                    device=dev).bfloat16()
    args = (q, q.flip(2).contiguous(), kv.block_k, kv.block_v, rc.cos_cover,
            rc.sin_cover, kv.init_k, kv.init_v, kv.init_k, rc.scalars)
    kw = dict(n_local=rekv.n_local)
    if quant != "none":
        kw.update(k_scales=kv.block_k_scale, v_scales=kv.block_v_scale)
    stream_check = held(f"{name} session state",
                        sa.stream_attention(*args, **kw),
                        sa.stream_attention_ref(*args, **kw))
    dkv = layer(captured["dkvs"], li)
    Tq = 16
    qd = torch.randn((1, tc.num_heads, Tq, tc.head_dim), generator=gen,
                     device=dev).bfloat16()
    start = (dkv.cursor - Tq).to(torch.int32)
    dargs = (qd, dkv.k, dkv.v, start, dkv.cursor)
    got = da.decode_attention(*dargs, n_local=rekv.n_local, return_m=True)
    decode_check = held(f"{name} decode cache attention", got,
                        da.decode_attention_ref(*dargs, n_local=rekv.n_local,
                                                return_m=True))
    sargs = (qd, dkv.k, got[1], start, dkv.cursor)
    score_check = held(f"{name} decode cache",
                       da.decode_score(*sargs, n_local=rekv.n_local),
                       da.decode_score_ref(*sargs, n_local=rekv.n_local))
    # where the time of a full-window chunk goes (after the counted run):
    # one chunk on each vision path
    targets = [
        (sess.vision, "full", "vision_full"),
        (sess.vision, "cached", "vision_cached"),
        (sg, "_attn_full", "siglip_attention_full_path"),
        (sg, "_f32_mm", "siglip_f32_attention_products"),
        (sess.lm, "encode_step", "lm_append"),
        (sa, "_launch", "stream_attention_kernel")]
    split = [segments(lambda: sess.encode_video(rng.integers(
        0, 256, size=(8, 384, 384, 3), dtype=np.uint8)), targets)
        for _ in range(2)]
    for sp in split:
        sp["path"] = "cached" if "vision_cached_ms" in sp else "full"
        sp["stream_attention_share"] = (sp["stream_attention_kernel_ms"]
                                        / sp["span_ms"])
    store = sum(x.numel() * x.element_size() for x in (
        sess.kvs.block_k, sess.kvs.block_v, sess.kvs.block_k_scale,
        sess.kvs.block_v_scale))
    bf16_store = 2 * n_layers * tc.num_kv_heads * rekv.max_blocks * \
        rekv.block_size * tc.head_dim * 2
    steady = chunk_s[2:]
    full = [dt for k, dt in enumerate(chunk_s) if window[k] == W]
    full_fps = [8 / dt for dt in full]
    rec = {"phase": f"session llava-ov-7b {name}", "card": card,
           "frames": 8 * n_chunks, "chunks": n_chunks,
           "first_init_active_chunk": k_init, "first_full_window_chunk":
           k_full, "window_pages": W, "answers": answers,
           "lm_forwards": lm_forwards, "launches": counts,
           "expected": want,
           "ingest_fps_8frame_chunks": 8 * len(steady) / sum(steady),
           "ingest_fps_full_window": 8 * len(full) / sum(full),
           "full_window_chunks": len(full),
           "ingest_fps_full_window_chunks_min_p50_max": [
               min(full_fps), float(np.median(full_fps)), max(full_fps)],
           "chunk_s": chunk_s,
           "qa_latency_s_p50": float(np.median(qa_s)), "qa_latency_s": qa_s,
           "answer_tokens": [len(a) for a in answers],
           "peak_mem_gb": peak_gb, "store_gb": store / 2 ** 30,
           "bf16_store_gb": bf16_store / 2 ** 30,
           "store_over_bf16": store / bf16_store,
           "kernel_vs_plain_on_session_state": stream_check,
           "init_active_on_state": int(rc.scalars[0, 3]),
           "decode_attention_vs_plain_on_decode_cache": decode_check,
           "decode_score_vs_plain_on_decode_cache": score_check,
           "time_split_full_window_chunk": split, **extra}
    del sess, captured, args, kw, dargs, got, sargs
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    if not all(c["agrees"] for c in (stream_check, decode_check,
                                      score_check)) or \
            rec["init_active_on_state"] != 1:
        raise RuntimeError(f"{name} session state checks failed {rec}")
    return rec


def lm_bytes(lm) -> int:
    """The bytes of the LM's weights: parameters and (int8) buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(lm.parameters()) + list(lm.buffers()))


def decode_step_ms(lm, step) -> dict:
    """A 1-token decode step (`step` runs one): its span issued as usual
    (median of 3), and its device time as the sum of parts each issued
    behind a sleep kernel, since a whole 7B step issues more launches than
    the CUDA launch queue holds: one LM layer (probe(); the median of
    the layers at a quarter, half and three quarters of the depth) times
    the layer count, plus the head (cuda_ms)."""
    step()
    span = []
    for _ in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b))
    L = lm.cfg.num_layers
    layers = [probe(step, [(lm, "_qkv")], (lm, "_finish_layer"),
                    L * f // 4 + 1, sleep=True) for f in (1, 2, 3)]
    ok = [r["span_ms"] for r in layers if r["host_ms"] < r["sleep_ms"]]
    x = torch.randn((1, 1, lm.cfg.hidden_size), device=lm.device,
                    dtype=lm.dtype)
    head = cuda_ms(lambda: lm._lm_head(x), reps=5)
    layer = float(np.median(ok)) if ok else None
    return {"span_ms": float(np.median(span)), "span_ms_all": span,
            "layer_device_ms": layer, "head_device_ms": head,
            "device_ms": L * layer + head if layer else None,
            "layers": layers}


def cosine(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(a @ b / (a.norm() * b.norm()))


def weights_phase(wq, questions, card, dev, gen, after=None) -> dict:
    """Phase 8: bench.py's 7b mode on the port.  A fresh seeded llava-ov-7b
    width model with the tower in bf16: its prompt logits (256 tokens) and
    one decode step on bf16 weights, recording every LM matmul's input and
    output and the prompt's embedding rows on the way; then the session of
    bench.py's settings (weights_quant=wq quantizes the LM at build; bf16
    pages and state, max_blocks 768) streams phase 6's 40 chunks and
    answers phase 6's questions; then the same on int8 weights.  after:
    stream_phase's hook on that session.

    tests/test_quant.py's criteria (cosine > 0.999, top-1 agreement > 0.9)
    are held per quantized product: each recorded matmul replayed on its
    recorded bf16 input through the int8 weights against its bf16 output
    (the head's top-1 over the prompt's positions), and the embedding rows.
    The whole model's prompt logits against bf16's are reported beside
    them, not held: on random weights each layer amplifies the products'
    differences, and the port's int8 products are stc_tpu's (PERF.md
    §6)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, cfg = make_model(dev, seed=8, text=QWEN2_7B,
                            vision_dtype=torch.bfloat16)
    lm = model.text
    scfg = session_cfg(15000, 64, 256, 16, 8, 768, weights_quant=wq)
    rekv = scfg.rekv
    T = rekv.max_prompt_tokens
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.text.vocab_size, size=(1, T))).to(dev)
    n, one = (torch.tensor([k], dtype=torch.int32, device=dev)
              for k in (T, 1))

    def prompt():
        """Prompt logits (T, V) float32 from a fresh decode cache, and a
        1-token decode step after it."""
        dkvs = lm.init_decode_state(rekv, 1, torch.bfloat16)
        logits, dkvs = lm.decode_step(rekv, dkvs, lm.embed_tokens(ids), n)
        tok = lm.embed_tokens(ids[:, -1:])
        step = decode_step_ms(lm, lambda: lm.decode_step(rekv, dkvs, tok,
                                                         one))
        return logits[0].float(), step

    products = []

    def record(f):
        def g(h, mod, name):
            out = f(h, mod, name)
            if len(products) < 4 * cfg.text.num_layers + 1:  # the prompt
                products.append((h, mod, name, out))
            return out
        return g

    rows = lm.embed_tokens(ids)
    with patched([(lm, "_mm", record)]):
        want, bf16_step = prompt()
    bf16_bytes = lm_bytes(lm)
    rec = stream_phase(model, cfg, scfg,
                       f"{wq} weights, bf16 vision, bf16 pages", 40,
                       questions, card, dev, gen, after=after)
    if lm.int8_group != scfg.weights_quant_group:
        raise RuntimeError(f"{wq}: the session did not quantize the LM")
    per = {"embed": cosine(lm.embed_tokens(ids), rows)}
    for h, mod, name, out in products:
        c = cosine(lm._mm(h, mod, name), out)
        per[name] = min(per.get(name, 1.0), c)
        if name == "lm_head":
            head_top1 = float((lm._mm(h, mod, name).argmax(-1)
                               == out.argmax(-1)).float().mean())
    del products, rows
    got, q_step = prompt()
    q_bytes = lm_bytes(lm)
    rec.update({
        "weights_quant": wq, "vision_dtype": "bfloat16",
        "lm_weight_bytes_bf16": bf16_bytes, "lm_weight_bytes": q_bytes,
        "lm_weight_bytes_over_bf16": q_bytes / bf16_bytes,
        "prompt_tokens": T,
        "product_cosine_min": per, "head_top1_agreement": head_top1,
        "logits_cosine": cosine(got, want),
        "top1_agreement": float((want.argmax(-1) == got.argmax(-1))
                                .float().mean()),
        "decode_step_bf16": bf16_step, "decode_step": q_step,
        "decode_step_device_over_bf16":
            q_step["device_ms"] / bf16_step["device_ms"]
            if q_step["device_ms"] and bf16_step["device_ms"] else None,
        "decode_layer_device_over_bf16":
            q_step["layer_device_ms"] / bf16_step["layer_device_ms"]
            if q_step["layer_device_ms"] and bf16_step["layer_device_ms"]
            else None,
        "head_device_over_bf16":
            q_step["head_device_ms"] / bf16_step["head_device_ms"],
        "decode_step_span_over_bf16":
            q_step["span_ms"] / bf16_step["span_ms"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "seconds": time.perf_counter() - t_phase})
    del model, lm, want, got
    torch.cuda.empty_cache()
    if not (min(per.values()) > 0.999 and head_top1 > 0.9):
        raise RuntimeError(f"{wq}: quantized products cosine {per}, head "
                           f"top-1 agreement {head_top1}")
    return rec


def loader_phase(card, dev) -> dict:
    """Phase 9: phase 3's llava-ov-0.5b model with its head tied to the
    embedding (tower weights rounded to bf16 values) written as a 2-shard
    bf16 HF checkpoint in the 'model.language_model.*' layout, loaded
    through MODEL_REGISTRY["llava_ov_7b"] onto the card: every tensor
    bit-equal to its source, and phase 3's first question (after the init
    prompt and two 8-frame chunks) answered with the same ids."""
    from stc_tpu_torch.models import MODEL_REGISTRY
    from stc_tpu_torch.models import llava_onevision as lo
    t_phase = time.perf_counter()
    model, cfg = make_model(dev, seed=0)
    tie_head_and_round_vision(model)
    scfg = session_cfg(15000, 64, 256, 16, 8, 1024)
    frames = np.random.default_rng(0).integers(0, 256, size=(16, 384, 384, 3),
                                               dtype=np.uint8)
    path = tempfile.mkdtemp(prefix="stc_tpu_torch_ckpt_")
    try:
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(model, path, n_shards=2)
        write_s = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(path)
                        if f.endswith(".safetensors"))
        (sess, lcfg), load_s = timed(lambda: MODEL_REGISTRY["llava_ov_7b"](
            path, scfg=scfg, dtype=torch.bfloat16,
            vision_dtype=torch.float32, device=dev))
    finally:
        shutil.rmtree(path)
    src, got = model.state_dict(), sess.model.state_dict()
    differ = [k for k in src if k not in got or got[k].dtype != src[k].dtype
              or not torch.equal(got[k], src[k])]
    answers = []
    for s in (lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                               device=dev), sess):
        s.encode_init_prompt(list(range(100, 114)))
        for i in (0, 8):
            s.encode_video(frames[i:i + 8])
        answers.append(s.question_answering(
            list(range(200, 212)), list(range(300, 320)), [151645],
            max_new_tokens=16))
    rec = {"phase": "loader llava-ov-0.5b", "card": card,
           "checkpoint_bytes": nbytes, "shards": shards,
           "write_s": write_s, "load_s": load_s,
           "tensors": len(src), "tensors_differ": differ,
           "config_equal": lcfg == dataclasses.replace(
               cfg, text=dataclasses.replace(cfg.text,
                                             tie_embeddings=True)),
           "answers": answers, "path_removed": not os.path.exists(path),
           "seconds": time.perf_counter() - t_phase}
    del model, sess, src, got
    torch.cuda.empty_cache()
    if differ or not rec["config_equal"] or answers[0] != answers[1] or \
            not answers[0]:
        raise RuntimeError(f"loader phase failed {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 10 (llava-ov-7b width): the host tier; phase 11 (llava-ov-0.5b
# width): ragged multi-stream sessions with slot churn
# ---------------------------------------------------------------------------

HOST_QUESTIONS = [(list(range(200, 212)), list(range(300, 316))),
                  (list(range(400, 409)), list(range(500, 516)))]
HOST_EXT_PAGES = [0, 1, 2, 3]     # evicted by the first eviction


def p50(xs):
    return float(np.median(xs)) if xs else None


def host_tier_phase(card, dev) -> dict:
    """Phase 10: cell E's widths (Qwen2 3584 x 28, bf16 SigLIP, bf16
    weights and state), max_blocks 320 (a 264-page window, evictions of
    56 pages), max_rep_blocks 512, 60 eight-frame chunks: three evictions,
    168 host pages.  Reference: an all-device session (max_blocks 512) on
    the same frames.  Settings:
      (a) host_kv_quant none, pixels: answer ids and every layer's
          retrieved blocks equal to the reference's, host pages bit-equal
          to the reference's pages at the same absolute indices;
      (b) host_kv_quant int8 (the default), (a)'s pruned features
          replayed: host bytes 0.533x of (a)'s, answers reported;
      (c) int8 device pages with the host tier against an all-device
          int8-page session, features replayed: answers equal.
    Every setting: host pages served, at most 2 rounds cold and 1 warm,
    its launch counts from 0."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.ops import stream_attention as sa
    t_phase = time.perf_counter()
    model, cfg = make_model(dev, seed=10, text=QWEN2_7B,
                            vision_dtype=torch.bfloat16)
    L = cfg.text.num_layers
    stop, n_chunks = [151645], 60

    def frames(i):
        return np.random.default_rng(1000 + i).integers(
            0, 256, size=(8, 384, 384, 3), dtype=np.uint8)

    def build(max_blocks, host="none", kv_quant="none"):
        scfg = session_cfg(15000, 64, 256, 16, 8, max_blocks,
                           kv_quant=kv_quant, host_kv_quant=host,
                           max_rep_blocks=512)
        sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                                device=dev)
        sess.encode_init_prompt(list(range(100, 114)))
        return sess

    def stream(sess, feats=None, record=None):
        """60 chunks (pixels, or replayed features); per chunk seconds and
        resident pages after it, and each eviction's stall (the host
        clock around the eviction call, synchronized both sides)."""
        stalls, chunk_s, resident = [], [], []

        def evict_timed(f):
            def g(E):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f(E)
                torch.cuda.synchronize()
                stalls.append(time.perf_counter() - t0)
            return g

        def rec(f):
            def g(rekv, kvs, embeds, **kw):
                if record is not None and not kw.get("is_init"):
                    record.append(embeds.clone())
                return f(rekv, kvs, embeds, **kw)
            return g

        with patched([(sess, "_evict", evict_timed),
                      (sess.lm, "encode_step", rec)]):
            for i in range(n_chunks):
                x = frames(i) if feats is None else feats[i]
                fn = sess.encode_video if feats is None else \
                    sess.encode_video_features
                _, dt = timed(lambda: fn(x))
                chunk_s.append(dt)
                resident.append(sess._total_blocks - sess._evicted_pages)
        return chunk_s, resident, stalls

    def ask_all(sess):
        """Each question cold then warm, then the external-index question
        at pages 0-3: answers, rounds, staged bytes, times, blocks, and the
        H2D copies (bytes, device ms)."""
        copies, out = [], []

        def h2d_timed(f):
            def g(buf):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                y = f(buf)
                e1.record()
                copies.append((buf.numel() * buf.element_size(), e0, e1))
                return y
            return g

        asks = [(q, p, None, "cold") for q, p in HOST_QUESTIONS
                ] + [(q, p, None, "warm") for q, p in HOST_QUESTIONS] + [
            (HOST_QUESTIONS[0][0], HOST_QUESTIONS[0][1], HOST_EXT_PAGES,
             "external")]
        with patched([(sess, "_h2d", h2d_timed)]):
            for q, p, ext, kind in asks:
                h0 = sess.staged_bytes
                f0 = sess.host_store.fetch_count
                ans, dt = timed(lambda: sess.question_answering(
                    q, p, stop, max_new_tokens=16, retrieved_indices=ext))
                out.append(dict(kind=kind, answer=ans, s=dt,
                                rounds=sess.qa_rounds,
                                repair_layers=sess.repair_layers,
                                staged_bytes=sess.staged_bytes - h0,
                                fetched=sess.host_store.fetch_count - f0,
                                indices=sess.last_retrieved_indices))
        torch.cuda.synchronize()
        links = [(b, e0.elapsed_time(e1)) for b, e0, e1 in copies]
        return out, links

    def forwards(asks):
        """LM forwards of these questions: the retrieval forward of every
        round, then prefill and the decoded tokens once."""
        return sum(a["rounds"] + 1 + len(a["answer"]) for a in asks)

    def summary(sess, name, chunk_s, resident, stalls, asks, links, counts,
                kind):
        hs = sess.host_store
        W = sess._window_pages
        full = [dt for dt, r in zip(chunk_s, resident) if r >= W]
        ms = hs.transfer_ms()
        cb = [sum(t.numel() * t.element_size() for t in
                  ([hs.k_chunks[c], hs.v_chunks[c]]
                   + ([hs.k_scales[c], hs.v_scales[c]] if hs.quantized
                      else []))) for c in range(len(ms))]
        want = {"stream_attention": {k: (L * n_chunks if k == kind else 0)
                                     for k in sa.launches},
                "decode_attention": L * forwards(asks), "decode_score": 0,
                "stream_attention_page_keep": 0}
        cold = [a for a in asks if a["kind"] != "warm"]
        return {
            "setting": name, "evictions": len(stalls),
            "evicted_pages": sess._evicted_pages,
            "host_pages": hs.total_pages, "host_bytes": hs.nbytes(),
            "fetch_count": hs.fetch_count,
            "rounds": {a["kind"] + str(i % 2): a["rounds"]
                       for i, a in enumerate(asks)},
            "repair_layers": [a["repair_layers"] for a in asks],
            "answers": [a["answer"] for a in asks],
            "eviction_stall_ms": [1e3 * x for x in stalls],
            "d2h_ms": ms, "d2h_bytes": cb,
            "d2h_gb_s": [b / m / 1e6 for b, m in zip(cb, ms)],
            "h2d_gb_s": (sum(b for b, _ in links)
                         / sum(m for _, m in links) / 1e6 if links
                         else None),
            "h2d_copies": len(links),
            "staged_bytes_cold": [a["staged_bytes"] for a in cold],
            "qa_s_cold_p50": p50([a["s"] for a in asks
                                  if a["kind"] == "cold"]),
            "qa_s_warm_p50": p50([a["s"] for a in asks
                                  if a["kind"] == "warm"]),
            "qa_s": [a["s"] for a in asks],
            "ingest_fps_full_window": 8 * len(full) / sum(full),
            "launches": counts, "expected": want,
            "launches_ok": counts == want}

    def protocol_ok(rec, asks):
        return (rec["fetch_count"] > 0 and rec["evictions"] == 3
                and rec["host_pages"] == 168
                and all(a["rounds"] <= 2 for a in asks
                        if a["kind"] == "cold")
                and all(a["rounds"] == 1 for a in asks
                        if a["kind"] == "warm")
                and rec["launches_ok"])

    # (a) and its all-device reference, on pixels
    torch.cuda.reset_peak_memory_stats()
    feats = []
    sess = build(320)
    reset_counts()
    a_stream = stream(sess, record=feats)
    a_asks, a_links = ask_all(sess)
    a_counts = read_counts()
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    ref = build(512)
    reset_counts()
    r_stream = stream(ref)
    r_asks, _ = ask_all(ref)
    r_counts = read_counts()
    rec_a = summary(sess, "a: host_kv_quant none", *a_stream, a_asks,
                    a_links, a_counts, "float")
    rec_a["peak_gib"] = peak_a
    rec_r = summary(ref, "reference: all-device, max_blocks 512",
                    *r_stream, r_asks, [], r_counts, "float")
    rec_a["answers_equal_reference"] = all(
        a["answer"] == r["answer"] for a, r in zip(a_asks, r_asks))
    rec_a["indices_equal_reference"] = all(
        a["indices"] == r["indices"] for a, r in zip(a_asks, r_asks))
    E = sess.host_store.pages_per_chunk
    rec_a["host_pages_bit_equal_reference"] = all(
        torch.equal(hc.to(dev), rx[:, :, :, c * E:(c + 1) * E])
        for chunks, rx in ((sess.host_store.k_chunks, ref.kvs.block_k),
                           (sess.host_store.v_chunks, ref.kvs.block_v))
        for c, hc in enumerate(chunks))
    ok_a = (protocol_ok(rec_a, a_asks) and rec_r["launches_ok"]
            and rec_a["answers_equal_reference"]
            and rec_a["indices_equal_reference"]
            and rec_a["host_pages_bit_equal_reference"])
    a_bytes = sess.host_store.nbytes()
    del sess, ref
    torch.cuda.empty_cache()

    # (b) host_kv_quant int8, replayed features
    sess = build(320, host="int8")
    reset_counts()
    b_stream = stream(sess, feats=feats)
    b_asks, b_links = ask_all(sess)
    rec_b = summary(sess, "b: host_kv_quant int8", *b_stream, b_asks,
                    b_links, read_counts(), "float")
    rec_b["host_bytes_over_a"] = sess.host_store.nbytes() / a_bytes
    rec_b["answers_equal_reference"] = [
        b["answer"] == r["answer"] for b, r in zip(b_asks, r_asks)]
    ok_b = (protocol_ok(rec_b, b_asks)
            and abs(rec_b["host_bytes_over_a"] - (1 + 4 / 60) / 2) < 1e-3)
    del sess
    torch.cuda.empty_cache()

    # (c) int8 device pages: host tier against all-device
    sess, ref = build(320, kv_quant="int8"), build(512, kv_quant="int8")
    reset_counts()
    c_stream = stream(sess, feats=feats)
    c_asks, c_links = ask_all(sess)
    c_counts = read_counts()
    stream(ref, feats=feats)
    rc_asks, _ = ask_all(ref)
    rec_c = summary(sess, "c: int8 device pages", *c_stream, c_asks,
                    c_links, c_counts, "int8")
    rec_c["answers_equal_reference"] = all(
        a["answer"] == r["answer"] for a, r in zip(c_asks, rc_asks))
    rec_c["indices_equal_reference"] = all(
        a["indices"] == r["indices"] for a, r in zip(c_asks, rc_asks))
    rec_c["reference_answers"] = [r["answer"] for r in rc_asks]
    ok_c = (protocol_ok(rec_c, c_asks) and rec_c["answers_equal_reference"]
            and rec_c["indices_equal_reference"])
    del sess, ref, feats, model
    torch.cuda.empty_cache()
    rec = {"phase": "host tier llava-ov-7b", "card": card,
           "frames": 8 * n_chunks, "max_blocks": 320,
           "window_pages": 264, "evict_pages": E,
           "settings": [rec_a, rec_b, rec_c], "reference": rec_r,
           "seconds": time.perf_counter() - t_phase}
    if not (ok_a and ok_b and ok_c):
        raise RuntimeError(f"host tier phase failed (a {ok_a}, b {ok_b}, "
                           f"c {ok_c}) {rec}")
    return rec


# an f32 near-tie: two compared values closer than this share of the
# largest (the port's f32 tolerance for deep computations, DEEP_TOL of the
# CPU tests); batch-4 and batch-1 f32 products differ by ~1e-6 of a value
TIE_REL = 1e-4


class VisionLog:
    """What the vision path selected, call by call: each cached layer's
    key similarities (one record per layer and stream) and each pruner
    call's channel variances and order, combined token scores and keeps.
    Used to find where a batch-4 slot and its batch-1 twin first part."""

    def __init__(self):
        self.sims, self.prunes = [], []

    @contextlib.contextmanager
    def capture(self):
        from stc_tpu_torch.compress import pruner as pr
        from stc_tpu_torch.models import llava_onevision as lo
        from stc_tpu_torch.models import siglip as sg
        from stc_tpu_torch.ops.topk import topk_lowest

        def sims(f):
            def g(k, ref_k, *rest):
                out = f(k, ref_k, *rest)
                self.sims.append(out.detach().clone())
                return out
            return g

        def prune(f):
            def g(features, state, keep_per_frame, channel_keep_ratio):
                out = f(features, state, keep_per_frame=keep_per_frame,
                        channel_keep_ratio=channel_keep_ratio)
                # stc_prune's own steps, to keep its intermediate scores
                B, F_, Tin, C = features.shape
                k_ch = int(C * channel_keep_ratio)
                flat = features.to(torch.float32).reshape(B, F_ * Tin, C)
                var = flat.var(dim=1, unbiased=False)
                ch = topk_lowest(-var, k_ch)[1]
                sel = torch.gather(flat, 2, ch[:, None, :].expand(
                    B, F_ * Tin, k_ch))
                mem = (state.mean_sum + sel.mean(dim=1)) / (
                    state.count + 1)[:, None].to(torch.float32)
                fn = pr._l2norm(sel.reshape(B, F_, Tin, k_ch))
                comb = (pr._gaussian_similarity(
                    fn, pr._l2norm(mem)[:, None, None, :])
                    + pr._gaussian_similarity(
                        fn, fn.mean(dim=2, keepdim=True)))
                self.prunes.append(dict(var=var, ch=ch, comb=comb,
                                        keep=out[1]))
                return out
            return g

        with patched([(sg, "key_similarity", sims),
                      (lo, "stc_prune", prune)]):
            yield


def first_parting(steps, U, K):
    """steps: for one stream, frame by frame, (sims_b4, sims_b1, prune_b4,
    prune_b1) -- the cached layers' similarities of that frame (lists,
    empty on the full path) and the pruner records, each already this
    stream's.  Returns None when every selection agrees, else where the
    two runs first select differently and whether the batch-1 run's own
    scores put the disagreeing items within TIE_REL of the cut (a near-
    tie) or not (a fault)."""
    def cut(vals, chosen, other, n):
        # the n-th smallest value is the cut; the items only one run chose
        # must lie within TIE_REL of it
        v = vals.reshape(-1)
        c = v.sort().values[n - 1]
        diff = set(chosen.reshape(-1).tolist()) ^ set(
            other.reshape(-1).tolist())
        gap = max(float((v[i] - c).abs()) for i in diff)
        lim = TIE_REL * float(v.abs().max())
        return gap, lim

    from stc_tpu_torch.ops.topk import topk_lowest
    for f, (s4, s1, p4, p1) in enumerate(steps):
        for l, (a, b) in enumerate(zip(s4, s1)):
            u4 = topk_lowest(-a.reshape(-1), U)[1]
            u1 = topk_lowest(-b.reshape(-1), U)[1]
            if set(u4.tolist()) != set(u1.tolist()):
                gap, lim = cut(b, u1, u4, U)
                return {"frame": f, "where": f"cacher layer {l}",
                        "gap": gap, "limit": lim, "tie": gap <= lim}
        if not torch.equal(p4["ch"], p1["ch"]):
            j = int((p4["ch"] != p1["ch"]).nonzero()[0, 0])
            v = p1["var"]
            a, b = int(p4["ch"][j]), int(p1["ch"][j])
            gap = float((v[a] - v[b]).abs())
            lim = TIE_REL * float(v.abs().max())
            return {"frame": f, "where": f"pruner channel order, rank {j}",
                    "gap": gap, "limit": lim, "tie": gap <= lim}
        if not torch.equal(p4["keep"], p1["keep"]):
            gap, lim = cut(p1["comb"], p1["keep"], p4["keep"], K)
            return {"frame": f, "where": "pruner keeps", "gap": gap,
                    "limit": lim, "tie": gap <= lim}
    return None


def multistream_phase(card, dev) -> dict:
    """Phase 11: llava-ov-0.5b width (Qwen2 896 x 24) with the LM and state
    in float32 (TF32 off), float32 SigLIP, B = 4 slots of one-frame chunks,
    cacher on (interval 2), pruner 60.  Slots tick every 1st, 2nd, 3rd
    and 1st tick, so their cacher parities disagree (mixed ticks); after
    tick 12 slot 2 is recycled for a new stream.  Then per-stream questions
    (question_answering_batch), a shared one (all_streams) and one on
    external blocks.  Reference: a batch-1 session per stream, the new
    stream in a fresh one.

    Batch-4 and batch-1 f32 products differ by ~1e-6 of a value, and the
    vision path selects (the cacher's tokens, the pruner's channel order,
    whose running memory is kept per rank, and its keeps), so a near-tie
    there sends a stream down another path from that frame on.  Each
    stream's selections are compared frame by frame: where they first
    part, the batch-1 run's own scores must put the disagreeing items
    within TIE_REL of the cut (a near-tie: counted, printed, and the
    stream's later pages and answers reported, not held), else the phase
    fails.  Held: integer state exact; each stream's pages before its
    first near-tie within the agreement limits; for streams with none,
    answer ids and every layer's blocks equal, or the batch-1 run's top
    two logits (or topk-th and next block scores) within TIE_REL of the
    largest at the first difference."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.models import llava_onevision as lo
    t_phase = time.perf_counter()
    model, cfg = make_model(dev, seed=11, dtype=torch.float32)
    L = cfg.text.num_layers
    scfg = session_cfg(15000, 64, 64, 16, 1, 256)
    U = max(1, int(cfg.vision.num_tokens * scfg.cacher.update_token_ratio))
    K = scfg.pruner.token_per_frame
    B, rates, n_ticks, reset_tick = 4, [1, 2, 3, 1], 24, 12
    stop = [151645]

    def frame(stream_id, i):
        return np.random.default_rng(5000 + 100 * stream_id + i).integers(
            0, 256, size=(384, 384, 3), dtype=np.uint8)

    def build(batch):
        sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                device=dev, batch=batch)
        sess.encode_init_prompt(list(range(100, 114)))
        return sess

    sess = build(B)
    slot_stream = [0, 1, 2, 3]
    fed = {s: 0 for s in range(5)}          # frames fed per stream id
    schedule = []                           # (tick, stream id) fed
    tick_s, mixed = [], []
    steps4 = {s: [] for s in range(5)}      # per stream: (sims, prune)
    reset_counts()
    for t in range(n_ticks):
        if t == reset_tick:
            sess.reset_streams([2])
            slot_stream[2] = 4
        act = [t % r == 0 for r in rates]
        cached = sess._slot_chunk % 2 != 0
        ticking = cached[np.asarray(act)]
        mix = bool(ticking.any() and not ticking.all())
        mixed.append(mix)
        batch = np.zeros((B, 1, 384, 384, 3), np.uint8)
        for b in range(B):
            if act[b]:
                sid = slot_stream[b]
                batch[b, 0] = frame(sid, fed[sid])
                fed[sid] += 1
                schedule.append((t, sid))
        log = VisionLog()
        with log.capture():
            _, dt = timed(lambda: sess.encode_video(batch, active=act))
        tick_s.append((dt, sum(act)))
        # each active slot's own records: the path it took this tick
        # (mixed ticks run the full path first, then the cached one)
        for b in range(B):
            if not act[b]:
                continue
            on_cached = bool(cached[b]) and bool(ticking.any())
            sims = ([log.sims[i * B + b] for i in range(len(log.sims) // B)]
                    if on_cached else [])
            pr_rec = log.prunes[-1] if on_cached or not mix else \
                log.prunes[0]
            steps4[slot_stream[b]].append(
                (sims, {k: v[b] for k, v in pr_rec.items()}))
    qs = [list(range(200, 212)), list(range(220, 229)),
          list(range(240, 256)), list(range(260, 266))]
    ps = [list(range(300, 316)), list(range(320, 330)),
          list(range(340, 344)), list(range(360, 380))]
    shared = (list(range(400, 409)), list(range(500, 516)))
    ext = [0, 1, 2]
    qa = []
    ans, dt = timed(lambda: sess.question_answering_batch(
        qs, ps, stop, max_new_tokens=16))
    qa.append(("batch", ans, sess.last_retrieved_indices, dt))
    ans, dt = timed(lambda: sess.question_answering(
        *shared, stop, max_new_tokens=16, all_streams=True))
    qa.append(("shared", ans, sess.last_retrieved_indices, dt))
    ans, dt = timed(lambda: sess.question_answering(
        *shared, stop, max_new_tokens=16, retrieved_indices=ext,
        all_streams=True))
    qa.append(("external", ans, sess.last_retrieved_indices, dt))
    counts = read_counts()
    want = {"stream_attention": {"float": L * n_ticks, "int8": 0,
                                 "int4": 0},
            "decode_attention": L * sum(2 + max(len(a) for a in ans_)
                                        for _, ans_, _, _ in qa),
            "decode_score": 0,
            "stream_attention_page_keep": 0}

    # the batch-1 reference sessions, one per stream in its slot at the end
    solos, solo_s, parting = {}, [], {}
    for sid in slot_stream:
        solo = build(1)
        steps = []
        for t, s_ in schedule:
            if s_ == sid:
                f = frame(sid, solo._total_blocks)
                log = VisionLog()
                with log.capture():
                    _, dt = timed(lambda: solo.encode_video(f[None]))
                solo_s.append(dt)
                steps.append((log.sims, {k: v[0] for k, v in
                                         log.prunes[0].items()}))
        solos[sid] = solo
        parting[sid] = first_parting(
            [(a[0], b[0], a[1], b[1]) for a, b in zip(steps4[sid], steps)],
            U, K)

    ints, pages = {}, {}
    for b, sid in enumerate(slot_stream):
        solo = solos[sid]
        ints[b] = {
            "num_blocks": (sess.kvs.num_blocks[:, b].tolist(),
                           solo.kvs.num_blocks[:, 0].tolist()),
            "length": (sess.kvs.length[:, b].tolist(),
                       solo.kvs.length[:, 0].tolist()),
            "page_offset": (sess.kvs.page_offset[:, b].tolist(),
                            solo.kvs.page_offset[:, 0].tolist()),
            "stream_blocks": (int(sess._stream_blocks[b]),
                              solo._total_blocks),
            "slot_chunk": (int(sess._slot_chunk[b]),
                           int(solo._slot_chunk[0]))}
        n = int(solo.kvs.num_blocks[0, 0])
        if parting[sid] is not None:
            n = parting[sid]["frame"]   # pages before the near-tie
        pages[b] = {"pages_held": n, **({nm: held(
            f"slot {b} {nm}", getattr(sess.kvs, nm)[:, b, :, :n],
            getattr(solo.kvs, nm)[:, 0, :, :n])
            for nm in ("block_k", "block_v")} if n else {})}
    ints_ok = all(x == y for d in ints.values() for x, y in d.values())
    pages_ok = all(r["agrees"] for d in pages.values()
                   for k, r in d.items() if k != "pages_held")
    vision_ok = all(p is None or p["tie"] for p in parting.values())

    def solo_qa(sid, kind, b):
        solo = solos[sid]
        if kind == "batch":
            q, p, e = qs[b], ps[b], None
        else:
            (q, p), e = shared, (ext if kind == "external" else None)
        return (lambda: solo.question_answering(
            q, p, stop, max_new_tokens=16, retrieved_indices=e)), solo

    def near_tie(run, solo, got_idx, got_ans, want_ans, prompt_len):
        """Rerun the batch-1 question capturing its block scores and
        logits: is the first difference a near-tie?"""
        scores, logits = [], []

        def cap_scores(f):
            def g(kv, q, rekv, q_valid=None):
                lg, valid, _ = engine.score_block_logits(kv, q, rekv,
                                                         q_valid)
                scores.append(torch.where(valid, lg, float("-inf"))[0])
                return f(kv, q, rekv, q_valid)
            return g

        def cap_logits(f):
            def g(*a, **k):
                out = f(*a, **k)
                logits.append(out[0])
                return out
            return g

        with patched([(engine, "score_blocks", cap_scores),
                      (solo.lm, "decode_step", cap_logits)]):
            run()
        for l, (g, w) in enumerate(zip(got_idx,
                                       solo.last_retrieved_indices)):
            if g != w:
                s = scores[l].sort(descending=True).values
                k = scfg.rekv.topk
                gap = float(s[k - 1] - s[k])
                lim = TIE_REL * float(s[s.isfinite()].abs().max())
                return {"where": f"layer {l} blocks", "gap": gap,
                        "limit": lim, "tie": gap <= lim}
        i = next(i for i, (x, y) in enumerate(zip(got_ans + [-1],
                                                  want_ans + [-2]))
                 if x != y)
        # decode_step call 0 is the prompt prefill (its last valid row
        # chose token 0), call i > 0 the token step that chose token i
        lg = logits[i]
        row = lg[0, -1] if i else lg[0, prompt_len - 1]
        top = row.topk(2).values
        gap = float(top[0] - top[1])
        lim = TIE_REL * float(row.abs().max())
        return {"where": f"token {i}", "gap": gap, "limit": lim,
                "tie": gap <= lim}

    compare, ties, fails = [], [], []
    for kind, ans, idx, _ in qa:
        for b, sid in enumerate(slot_stream):
            run, solo = solo_qa(sid, kind, b)
            solo_ans = run()
            got_idx = [layer_idx[b] for layer_idx in idx]
            same = ans[b] == solo_ans and \
                got_idx == solo.last_retrieved_indices
            entry = {"question": kind, "slot": b, "stream": sid,
                     "answer": ans[b], "batch1_answer": solo_ans,
                     "equal": same}
            if not same and parting[sid] is not None:
                entry["after_vision_near_tie"] = parting[sid]
            elif not same:
                plen = len(ps[b] if kind == "batch" else shared[1])
                entry["near_tie"] = near_tie(run, solo, got_idx, ans[b],
                                             solo_ans, plen)
                (ties if entry["near_tie"]["tie"] else fails).append(entry)
            compare.append(entry)
    steady = [(dt, n) for dt, n in tick_s[2:]]
    mixed_t = [dt for (dt, _), m in zip(tick_s[2:], mixed[2:]) if m]
    uniform_t = [dt for (dt, _), m in zip(tick_s[2:], mixed[2:]) if not m]
    vision_ties = {sid: p for sid, p in parting.items() if p is not None}
    rec = {"phase": "multi-stream llava-ov-0.5b", "card": card,
           "batch": B, "rates": rates, "ticks": n_ticks,
           "reset_after_tick": reset_tick, "mixed_ticks": sum(mixed),
           "frames_fed": dict(fed), "integer_state": ints,
           "integer_state_exact": ints_ok, "pages": pages,
           "pages_agree": pages_ok, "vision_partings": vision_ties,
           "compare": compare, "answers_equal": sum(e["equal"]
                                                    for e in compare),
           "answers_compared": len(compare),
           "near_ties": len(ties) + len(vision_ties),
           "failures": len(fails), "launches": counts, "expected": want,
           "ingest_fps_b4": (sum(n for _, n in steady)
                             / sum(dt for dt, _ in steady)),
           "ingest_fps_b1": len(solo_s) / sum(solo_s),
           "tick_ms_mixed_p50": 1e3 * p50(mixed_t) if mixed_t else None,
           "tick_ms_uniform_p50": (1e3 * p50(uniform_t) if uniform_t
                                   else None),
           "qa_s": [dt for *_, dt in qa],
           "seconds": time.perf_counter() - t_phase}
    for sid, p in vision_ties.items():
        print(f"near-tie: stream {sid} vision {p}", flush=True)
    for e in ties:
        print(f"near-tie: {e['question']} slot {e['slot']} "
              f"{e['near_tie']}", flush=True)
    del sess, solos, model
    torch.cuda.empty_cache()
    if not (ints_ok and pages_ok and vision_ok and not fails
            and counts == want and sum(mixed) > 0):
        raise RuntimeError(f"multi-stream phase failed {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 12 (llava-ov-0.5b width): continuous-batching serving, speculative
# decode and stream migration; and phase 8's 7B session with speculation
# ---------------------------------------------------------------------------

SPEC_K = 4          # draft tokens a verify round (T = K + 1 queries)
SPEC_HISTORY = 64   # draft-history tokens per stream


def spec_departure(sess, questions, prompts, b, got, want) -> dict:
    """Where stream b's speculative answer `got` first departs from the
    greedy answer `want`, both over sess's current state for these
    per-stream questions and prompts: greedy's top-2 logit gap there, and
    the largest logit difference between T = 1 forwards (greedy's steps)
    and T = K + 1 forwards (verify rounds) over the rows of the common
    prefix up to that position.  cuBLAS may pick another GEMM algorithm at
    M = B than at M = B (K + 1), so a near-tie (gap <= 2 x that
    difference) may flip; anything else is a fault."""
    from stc_tpu_torch.ops.topk import topk_lowest
    lm, rc = sess.lm, sess.rekv
    i = next(j for j, (x, y) in enumerate(zip(got + [-1], want + [-2]))
             if x != y)
    q_ids, q_len = sess._pad_ids(questions)
    p_ids, p_len = sess._pad_ids(prompts)
    q_ids, q_len, p_ids, p_len = (sess._ids(x) for x in (q_ids, q_len,
                                                         p_ids, p_len))
    B, dev = q_ids.shape[0], q_ids.device
    rows = torch.arange(B, device=dev)

    def prefilled():
        d = lm.init_decode_state(rc, B, sess.kvs.init_k.dtype)
        d, _, _ = lm.qa_retrieve_step(rc, sess.kvs, d,
                                      lm.embed_tokens(q_ids), n_tokens=q_len)
        lg, d = lm.decode_step(rc, d, lm.embed_tokens(p_ids), p_len)
        return lg[rows, p_len.long() - 1][b].float(), d

    def tokens(ids):
        return torch.tensor(ids, device=dev)[None].expand(B, -1)

    first, d = prefilled()
    one, wide = [first], [first]      # position 0: the prefill's row
    for t in want[:i]:
        lg, d = lm.decode_step(rc, d, lm.embed_tokens(tokens([t])),
                               torch.ones((B,), dtype=torch.int32,
                                          device=dev))
        one.append(lg[b, 0].float())
    _, d = prefilled()
    for s0 in range(0, i, SPEC_K + 1):
        chunk = want[s0:s0 + SPEC_K + 1]
        start = d.cursor.clone()
        lg, d = lm.decode_step(rc, d, lm.embed_tokens(tokens(
            chunk + [0] * (SPEC_K + 1 - len(chunk)))), torch.full(
            (B,), SPEC_K + 1, dtype=torch.int32, device=dev))
        wide += [lg[b, t].float() for t in range(len(chunk))]
        d.cursor.copy_(start + len(chunk))
    diff = max(float((x - y).abs().max()) for x, y in zip(one, wide))
    top = topk_lowest(one[i], 2)[0]
    gap = float(top[0] - top[1])
    return {"position": i, "top2_gap": gap, "t1_vs_wide_logit_diff": diff,
            "near_tie": gap <= 2 * diff}


def spec_counters(lm) -> tuple:
    return lm.spec_rounds, lm.spec_stream_rounds, lm.spec_tokens


def spec_rates(lm, before, qa_calls) -> dict:
    """lookahead_decode's counters since `before`: verify rounds, live
    streams summed over them, tokens committed; tokens a stream commits
    per verify round, and rounds per QA call."""
    r, sr, tok = (a - b for a, b in zip(spec_counters(lm), before))
    return {"verify_rounds": r, "stream_rounds": sr, "tokens": tok,
            "tokens_per_verify_round": tok / sr if sr else None,
            "rounds_per_qa_call": r / qa_calls if qa_calls else None}


def spec_session_questions(sess, questions, stop) -> dict:
    """The questions asked on sess with speculation off and then on
    (K = SPEC_K, a SPEC_HISTORY-token history), each QA timed: answers
    equal or parted at a near-tie (spec_departure), QA p50 both ways,
    tokens committed per verify round and rounds per answer.  The session
    is left with speculation off."""
    lm = sess.lm
    runs = {}
    for draft in (0, SPEC_K):
        sess.set_spec_decode(draft, SPEC_HISTORY if draft else None)
        before = spec_counters(lm)
        answers, qa_s = [], []
        for q, p in questions:
            out, dt = timed(lambda: sess.question_answering(
                q, p, stop, max_new_tokens=16))
            answers.append(out)
            qa_s.append(dt)
        runs[draft] = {"answers": answers, "qa_s": qa_s,
                       "qa_p50_s": p50(qa_s)}
        if draft:
            runs[draft]["spec"] = spec_rates(lm, before, len(questions))
    sess.set_spec_decode(0)
    departures = [{"question": n, **spec_departure(sess, [q], [p], 0, got,
                                                   want)}
                  for n, ((q, p), want, got) in enumerate(zip(
                      questions, runs[0]["answers"],
                      runs[SPEC_K]["answers"])) if got != want]
    for d in departures:
        print(f"spec departure (7B, question {d['question']}): {d}",
              flush=True)
    return {"greedy": runs[0], "speculative": runs[SPEC_K],
            "departures": departures,
            "ok": all(d["near_tie"] for d in departures)}


# the serving traffic: stream -> (4-frame chunks, first tick, tick rate,
# ticks from its last chunk to its last question); stream 4 takes stream
# 2's slot once stream 2 retires
SERVE_STREAMS = {0: (16, 0, 1, 1), 1: (12, 2, 1, 2), 2: (8, 0, 2, None),
                 3: (10, 6, 1, 2), 4: (8, 18, 1, 1)}
SERVE_SLOT = {0: 0, 1: 1, 2: 2, 3: 3, 4: 2}
SERVE_RETIRE = (15, 2)          # after this tick, stream 2 retires
SERVE_MIGRATE = (8, 1)          # after this tick, stream 1 is saved
SERVE_FRAMES = 4


def serving_traffic() -> list:
    """Tick by tick, the [(stream, chunk index)] fed and the [(stream,
    question index)] asked.  Each stream asks after every 4th of its own
    chunks (stream 2, which ticks every other tick, on its next tick) and
    a last question after its last chunk; stream 4 starts at tick 18, so
    ticks 16, 17 and 26 only answer, and ticks without a question only
    encode."""
    feed, asks = {}, {}
    for sid, (n, t0, rate, last) in SERVE_STREAMS.items():
        q = 0
        for k in range(n):
            t = t0 + k * rate
            feed.setdefault(t, []).append((sid, k))
            if (k + 1) % 4 == 0:
                asks.setdefault(t + rate - 1, []).append((sid, q))
                q += 1
        if last:
            asks.setdefault(t + last, []).append((sid, q))
    return [(feed.get(t, []), asks.get(t, []))
            for t in range(max(list(feed) + list(asks)) + 1)]


def serve_question(sid, q):
    """Stream sid's question q: 12 question and 16 prompt tokens, so every
    QA of the traffic pads to one bucket."""
    base = 2000 + 300 * sid + 40 * q
    return list(range(base, base + 12)), list(range(base + 12, base + 28))


def serving_phase(card, dev) -> dict:
    """Phase 12: a ServingEngine over a 4-slot VLMSession at llava-ov-0.5b
    width (Qwen2 896 x 24, 14/2 heads of 64; SigLIP 1152 x 27 at 384 px;
    bf16 weights, vision, pages and state), n_local 15000, block 60, topk
    64, exc 480, max_blocks 512, cacher 0.25 / interval 2, pruner 60, 256
    prompt tokens, 16 new tokens.  Streams of 64, 48, 32 and 40 frames in
    4-frame chunks (serving_traffic); stream 2 retires after tick 15 and a
    fifth 32-frame stream is admitted into its slot.  The same traffic
    goes through (a) the engine, (b) the engine with speculative decode
    (K = 4, ngram 3, a 64-token history) and (c) one session driven tick
    by tick with encode_video(active=) and question_answering_batch
    (asked=).  In (a), stream 1 is saved after tick 8 (save_stream_state)
    and restored into a free slot of a second engine of the same configs,
    which answers its later questions beside (a).

    Gates: (a) equals (c) id for id (the same kernels at the same shapes);
    the migrated stream answers as it does unmigrated; (b) equals (a) but
    where a departure is a near-tie (spec_departure, on (b)'s state right
    after the tick), each departure printed; each run's launch counts are
    the layer count times its LM forwards, none zero."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.runtime.serving import ServingEngine
    from stc_tpu_torch.utils.checkpoint import (load_stream_state,
                                                save_stream_state)
    t_phase = time.perf_counter()
    model, cfg = make_model(dev, seed=12, vision_dtype=torch.bfloat16)
    lm, L = model.text, cfg.text.num_layers
    scfg = session_cfg(15000, 64, 256, 16, 8, 512)
    stop, B, M = [151645], 4, 16
    traffic = serving_traffic()
    mig_slot = 2

    def frames(sid, k):
        return np.random.default_rng(12000 + 100 * sid + k).integers(
            0, 256, size=(SERVE_FRAMES, 384, 384, 3), dtype=np.uint8)

    def build():
        sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                                device=dev, batch=B)
        sess.encode_init_prompt(list(range(100, 114)))
        return sess

    def migrate(sess):
        """Stream 1's slot to a file, restored into a second engine's
        freed slot; the file's bytes and the save and restore times."""
        d = tempfile.mkdtemp(prefix="stc_tpu_torch_stream_")
        path = os.path.join(d, "stream.npz")
        try:
            _, save_s = timed(lambda: save_stream_state(
                sess, SERVE_SLOT[SERVE_MIGRATE[1]], path))
            nbytes = os.path.getsize(path)
            sess2 = build()
            eng2 = ServingEngine(sess2, stop, max_new_tokens=M)
            eng2.retire(mig_slot)
            slot = eng2.admit()
            _, load_s = timed(lambda: load_stream_state(sess2, slot, path))
        finally:
            shutil.rmtree(d)
        return {"engine": eng2, "slot": slot, "npz_bytes": nbytes,
                "save_ms": 1e3 * save_s, "restore_ms": 1e3 * load_s}

    calls = {"encode_step": 0, "_qa_forward": 0, "decode_step": 0}

    def counting(name):
        def wrap(f):
            def g(*a, **k):
                # an init-prompt append launches no stream_attention
                calls[name] += not k.get("is_init", False)
                return f(*a, **k)
            return g
        return wrap

    def recording(last):
        """Keep the questions and prompts of a session's QA call."""
        def wrap(f):
            def g(*a, **k):
                i = 2 if f.__name__ == "serve" else 0
                last["qp"] = (a[i], a[i + 1])
                return f(*a, **k)
            return g
        return wrap

    def run(kind, check=None):
        """The traffic through kind 'greedy' (a), 'spec' (b) or
        'reference' (c).  check(sess, questions, prompts, slot, key,
        tokens), if given, runs after each tick on each answer, outside
        the tick's time.  Returns (record, answers by (stream, question),
        migrated answers)."""
        sess = build()
        if kind == "spec":
            sess.set_spec_decode(SPEC_K, SPEC_HISTORY)
        eng = None if kind == "reference" else ServingEngine(
            sess, stop, max_new_tokens=M)
        answers, mig_answers, ticks, mig, last = {}, {}, [], {}, {}
        for c in calls:
            calls[c] = 0
        before = spec_counters(lm)
        reset_counts()
        with patched([(lm, c, counting(c)) for c in calls]
                     + [(sess, f, recording(last)) for f in (
                         "serve", "question_answering_batch")]):
            for t, (feed, asks) in enumerate(traffic):
                t0 = time.perf_counter()
                if eng is None:
                    reference_tick(sess, feed, asks, frames, stop, M,
                                   answers)
                    done = []
                else:
                    done = engine_tick(eng, feed, asks, frames, answers)
                torch.cuda.synchronize()
                ticks.append({"tick": t, "kind": ("both" if feed and asks
                                                  else "encode" if feed
                                                  else "qa"),
                              "active": len(feed), "asked": len(asks),
                              "s": time.perf_counter() - t0})
                if mig:   # the migrated stream's tick, not timed
                    engine_tick(mig["engine"], [
                        f for f in feed if f[0] == SERVE_MIGRATE[1]], [
                        a for a in asks if a[0] == SERVE_MIGRATE[1]],
                        frames, mig_answers, {SERVE_MIGRATE[1]: mig["slot"]})
                for key, tok in done:
                    if check:
                        check(sess, *last["qp"], SERVE_SLOT[key[0]], key,
                              tok)
                if t == SERVE_RETIRE[0]:
                    slot = SERVE_SLOT[SERVE_RETIRE[1]]
                    if eng is None:
                        sess.reset_streams([slot])
                    else:
                        eng.retire(slot)
                        if eng.admit() != slot:
                            raise RuntimeError("admitted into another slot")
                if t == SERVE_MIGRATE[0] and kind == "greedy":
                    mig = migrate(sess)
        counts = read_counts()
        want = {"stream_attention": {"float": L * calls["encode_step"],
                                     "int8": 0, "int4": 0},
                "decode_attention": L * (calls["_qa_forward"]
                                         + calls["decode_step"]),
                "decode_score": 0,
                "stream_attention_page_keep": 0}
        by_kind = {k: [tk["s"] for tk in ticks if tk["kind"] == k]
                   for k in ("encode", "qa", "both")}
        frames_in = SERVE_FRAMES * sum(tk["active"] for tk in ticks)
        enc = [tk for tk in ticks if tk["kind"] == "encode"]
        rec = {"launches": counts, "expected": want,
               "launches_ok": counts == want and all(
                   calls[c] for c in ("encode_step", "_qa_forward")),
               "lm_calls": dict(calls), "ticks": ticks,
               "active_frames": frames_in,
               # the ingest rate: frames over the ticks that only encode
               "frames_per_s_encode_only": SERVE_FRAMES * sum(
                   tk["active"] for tk in enc) / sum(tk["s"] for tk in enc),
               # every frame over every tick that encodes, the QA of the
               # ticks that also answer included
               "frames_per_s_encode_ticks_qa_included": frames_in / sum(
                   tk["s"] for tk in ticks if tk["active"]),
               "tick_ms_p50": {k: 1e3 * p50(v) if v else None
                               for k, v in by_kind.items()},
               "answers": {f"{s}.{q}": a for (s, q), a in
                           sorted(answers.items())}}
        if kind == "spec":
            rec["spec"] = spec_rates(lm, before, sum(
                1 for tk in ticks if tk["asked"]))
        if eng is not None:
            rec["stats"] = dataclasses.asdict(eng.stats)
            rec["route_decisions"] = eng.route_decisions
        if mig:
            rec["migration"] = {k: v for k, v in mig.items()
                                if k != "engine"}
        return rec, answers, mig_answers

    rec_a, ans_a, mig_answers = run("greedy")
    torch.cuda.empty_cache()
    rec_c, ans_c, _ = run("reference")
    torch.cuda.empty_cache()
    departures = []

    def check(sess, questions, prompts, slot, key, tok):
        if tok != ans_a[key]:
            d = {"stream": key[0], "question": key[1], "got": tok,
                 "greedy": ans_a[key], **spec_departure(
                     sess, questions, prompts, slot, tok, ans_a[key])}
            print(f"spec departure (phase 12): {d}", flush=True)
            departures.append(d)

    rec_b, ans_b, _ = run("spec", check)
    torch.cuda.empty_cache()
    migrated = {f"{s}.{q}": (a, ans_a[(s, q)])
                for (s, q), a in sorted(mig_answers.items())}
    rec = {"phase": "serving llava-ov-0.5b", "card": card,
           "ticks": len(traffic), "questions": len(ans_a),
           "a_greedy": rec_a, "b_speculative": rec_b, "c_reference": rec_c,
           "a_equals_c": ans_a == ans_c,
           "migrated_answers": migrated,
           "migrated_equal": bool(migrated) and all(
               x == y for x, y in migrated.values()),
           "spec_departures": departures,
           "spec_equal": sum(ans_b[k] == ans_a[k] for k in ans_a),
           "qa_tick_ms_p50_spec_off_on": [rec_a["tick_ms_p50"]["qa"],
                                          rec_b["tick_ms_p50"]["qa"]],
           "both_tick_ms_p50_spec_off_on": [rec_a["tick_ms_p50"]["both"],
                                            rec_b["tick_ms_p50"]["both"]],
           "seconds": time.perf_counter() - t_phase}
    del model, lm
    torch.cuda.empty_cache()
    if not (rec["a_equals_c"] and rec["migrated_equal"]
            and len(ans_b) == len(ans_a)
            and all(d["near_tie"] for d in departures)
            and all(r["launches_ok"] for r in (rec_a, rec_b, rec_c))):
        raise RuntimeError(f"serving phase failed {rec}")
    return rec


def engine_tick(eng, feed, asks, frames, answers, slots=None) -> list:
    """Submit one tick's chunks and questions to the engine and step it
    once; answers[(stream, question)] gets each answer.  slots: stream ->
    slot where it differs from SERVE_SLOT.  Returns [(key, tokens)]."""
    slot = {**SERVE_SLOT, **(slots or {})}
    rids = {}
    for sid, k in feed:
        eng.submit_chunk(slot[sid], frames(sid, k))
    for sid, q in asks:
        rids[eng.submit_question(slot[sid], *serve_question(sid, q))] = \
            (sid, q)
    done = []
    if eng.pending:
        for rid, r in eng.step().items():
            answers[rids[rid]] = r["tokens"]
            done.append((rids[rid], r["tokens"]))
    if eng.pending:
        raise RuntimeError("a tick left work queued")
    return done


def reference_tick(sess, feed, asks, frames, stop, M, answers) -> None:
    """The same tick on the session itself: a ragged encode_video of the
    fed slots, then question_answering_batch of the asking ones."""
    B = sess.batch
    if feed:
        batch = np.zeros((B, SERVE_FRAMES, 384, 384, 3), np.uint8)
        active = [False] * B
        for sid, k in feed:
            batch[SERVE_SLOT[sid]] = frames(sid, k)
            active[SERVE_SLOT[sid]] = True
        sess.encode_video(batch, active=active)
    if asks:
        qs, ps, asked = [[0]] * B, [[0]] * B, [False] * B
        for sid, q in asks:
            b = SERVE_SLOT[sid]
            qs[b], ps[b] = serve_question(sid, q)
            asked[b] = True
        out = sess.question_answering_batch(qs, ps, stop, max_new_tokens=M,
                                            asked=asked)
        for sid, q in asks:
            answers[(sid, q)] = out[SERVE_SLOT[sid]]


# ---------------------------------------------------------------------------
# phase 9: an HF checkpoint written here, read back through the loader
# ---------------------------------------------------------------------------

def write_safetensors(path: str, tensors: dict) -> int:
    """A .safetensors file without the safetensors package: 8-byte
    little-endian header length, the JSON header (padded to 8 bytes), the
    raw little-endian bytes, one tensor at a time; the dtype names are the
    port's reader's.  Returns the file's bytes."""
    from stc_tpu_torch.models.convert import SAFETENSORS_DTYPES
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for t in tensors.values():
            t = t.detach().contiguous().cpu().reshape(-1)
            f.write(t.view(torch.uint8).numpy().tobytes())
    return 8 + len(h) + off


def hf_state(model) -> dict:
    """The port's LlavaOV as an HF LLaVA-OneVision state dict in the
    'model.language_model.*' layout ((out, in) matrices, q/k/v and gate/up
    apart, the patch conv (C, 3, P, P)); no lm_head (the head is tied)."""
    out = {}
    t, tc = model.text, model.cfg.text
    pre = "model.language_model."
    q_end = tc.num_heads * tc.head_dim
    k_end = q_end + tc.num_kv_heads * tc.head_dim
    F_ = tc.intermediate_size
    out[pre + "embed_tokens.weight"] = t.embed
    out[pre + "norm.weight"] = t.norm_f
    for i, lp in enumerate(t.layers):
        p = f"{pre}layers.{i}."
        out[p + "input_layernorm.weight"] = lp.ln1
        out[p + "post_attention_layernorm.weight"] = lp.ln2
        for n, (a, b) in {"q": (0, q_end), "k": (q_end, k_end),
                          "v": (k_end, None)}.items():
            out[p + f"self_attn.{n}_proj.weight"] = lp.wqkv[:, a:b].t()
            out[p + f"self_attn.{n}_proj.bias"] = lp.bqkv[a:b]
        out[p + "self_attn.o_proj.weight"] = lp.wo.t()
        out[p + "mlp.gate_proj.weight"] = lp.w_gateup[:, :F_].t()
        out[p + "mlp.up_proj.weight"] = lp.w_gateup[:, F_:].t()
        out[p + "mlp.down_proj.weight"] = lp.w_down.t()
    v, vc = model.vision, model.cfg.vision
    pre = "model.vision_tower.vision_model."
    P = vc.patch_size
    out[pre + "embeddings.patch_embedding.weight"] = v.patch_w.t().reshape(
        vc.hidden_size, 3, P, P)
    out[pre + "embeddings.patch_embedding.bias"] = v.patch_b
    out[pre + "embeddings.position_embedding.weight"] = v.pos_embed
    out[pre + "post_layernorm.weight"] = v.post_ln_w
    out[pre + "post_layernorm.bias"] = v.post_ln_b
    names = {"ln1_w": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
             "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
             "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
             "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
             "wo": "self_attn.out_proj.weight",
             "bo": "self_attn.out_proj.bias",
             "ln2_w": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
             "fc1": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
             "fc2": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias"}
    for i, lp in enumerate(v.layers):
        for name, key in names.items():
            w = getattr(lp, name)
            out[f"{pre}encoder.layers.{i}.{key}"] = w.t() if w.dim() == 2 \
                else w
    pj = model.projector
    pre = "model.multi_modal_projector."
    out[pre + "linear_1.weight"] = pj.w1.t()
    out[pre + "linear_1.bias"] = pj.b1
    out[pre + "linear_2.weight"] = pj.w2.t()
    out[pre + "linear_2.bias"] = pj.b2
    return out


@torch.no_grad()
def tie_head_and_round_vision(model) -> None:
    """lm_head <- embed^T, and the tower's and projector's float32 weights
    rounded to bf16 values, so that a bf16 checkpoint holds them exactly."""
    model.text.lm_head.copy_(model.text.embed.t())
    for mod in (model.vision, model.projector):
        for prm in mod.parameters():
            prm.copy_(prm.to(torch.bfloat16))


def write_hf_checkpoint(model, path: str, n_shards: int = 2) -> int:
    """model as a bf16 HF LLaVA-OneVision checkpoint directory: config.json
    and n_shards .safetensors shards of about equal bytes.  Returns the
    shards' bytes."""
    state = {k: v.to(torch.bfloat16) for k, v in hf_state(model).items()}
    total = sum(v.numel() * 2 for v in state.values())
    shards, cur, size = [], {}, 0
    for k, v in state.items():
        cur[k] = v
        size += v.numel() * 2
        if size >= total * (len(shards) + 1) / n_shards and \
                len(shards) < n_shards - 1:
            shards.append(cur)
            cur = {}
    shards.append(cur)
    nbytes = sum(write_safetensors(
        os.path.join(path, f"model-{i + 1:05d}-of-{n_shards:05d}"
                     ".safetensors"), sh) for i, sh in enumerate(shards))
    tc, vc = model.cfg.text, model.cfg.vision
    config = {
        "model_type": "llava_onevision",
        "text_config": {
            "model_type": "qwen2", "vocab_size": tc.vocab_size,
            "hidden_size": tc.hidden_size,
            "num_hidden_layers": tc.num_layers,
            "num_attention_heads": tc.num_heads,
            "num_key_value_heads": tc.num_kv_heads,
            "intermediate_size": tc.intermediate_size,
            "rope_theta": tc.rope_base, "rms_norm_eps": tc.rms_eps,
            "tie_word_embeddings": True, "torch_dtype": "bfloat16"},
        "vision_config": {
            "model_type": "siglip_vision_model",
            "hidden_size": vc.hidden_size,
            "num_hidden_layers": vc.num_layers,
            "num_attention_heads": vc.num_heads,
            "intermediate_size": vc.intermediate_size,
            "image_size": vc.image_size, "patch_size": vc.patch_size},
        "vision_feature_layer": -1,
        "vision_feature_select_strategy": "full"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    return nbytes


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


# ---------------------------------------------------------------------------
# phase 14: the CLIP backbones (LongVA, Video-LLaVA, Flash-VStream) at 7B
# width
# ---------------------------------------------------------------------------

# (case, module, frames, frames a chunk, stop ids); widths and session
# configs are the modules' defaults
CLIP_BACKBONES = (("a", "longva", 80, 1, [151645]),
                  ("b", "video_llava", 48, 8, [2]),
                  ("c", "flash_vstream", 96, 1, [2]))
CLIP_QUESTIONS = [(list(range(200, 212)), list(range(300, 316))),
                  (list(range(400, 409)), list(range(500, 516)))]


def clip_backbone_run(case, mod_name, n_frames, chunk, stop, card,
                      dev) -> dict:
    """One CLIP backbone at its published widths and default session config
    (bf16 LM and pages, float32 tower, random weights from a seeded
    torch.Generator): the init prompt, n_frames frames in chunks of
    `chunk`, two questions of up to 16 greedy tokens.  Gates: launches
    (stream_attention = appends x layers, decode_attention = LM forwards x
    layers), both kernels against their plain versions on the session's
    own state at a middle layer, the window filled and the init-fill
    crossed where the config puts them, and on the cacher's path
    cache_stats equal to what the recomputed rows of every cached chunk
    give."""
    import importlib
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.kvcache.state import layer
    from stc_tpu_torch.models import clip as cl
    from stc_tpu_torch.models.longva import ClipVLM
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa
    t_phase = time.perf_counter()
    mod = importlib.import_module(f"stc_tpu_torch.models.{mod_name}")
    cfg_cls = {"longva": "LongVAConfig", "video_llava": "VideoLlavaConfig",
               "flash_vstream": "FlashVStreamConfig"}[mod_name]
    cfg = getattr(mod, cfg_cls)()
    scfg = mod.default_session_config(cfg)
    rekv, tc, vc = scfg.rekv, cfg.text, cfg.vision
    gen = torch.Generator(device=dev).manual_seed(14)
    torch.cuda.reset_peak_memory_stats()
    model = ClipVLM(cfg, dtype=torch.bfloat16, vision_dtype=torch.float32,
                    device=dev)
    model.init_random_params(gen)
    sess = mod.build_session(model, scfg, state_dtype=torch.bfloat16,
                             device=dev)
    S, T = rekv.block_size, rekv.exc_block_size
    W, ppt = engine.n_window_pages(rekv), sa.pages_per_tile(S)
    n_layers, Tv = tc.num_layers, vc.num_tokens
    frames = np.random.default_rng(14).integers(
        0, 256, size=(n_frames, vc.image_size, vc.image_size, 3),
        dtype=np.uint8)
    reset_counts()
    sess.encode_init_prompt(list(range(100, 100 + rekv.n_init)))
    chunks, init_active = [], []
    rows_skipped = rows_processed = 0
    for i in range(0, n_frames, chunk):
        L = int(sess.kvs.length[0, 0].item())
        path = ("cached" if scfg.cacher.enabled
                and sess._slot_chunk[0] % scfg.cacher.cache_interval
                else "full")
        model.vision.last_rows = []
        _, dt = timed(lambda: sess.encode_video(frames[i:i + chunk]))
        # every append of the chunk (one a frame)
        init_active += [L + (f + 1) * T > rekv.n_local
                        for f in range(chunk)]
        chunks.append((path, chunk, dt))
        rows_processed += chunk * Tv
        rows_skipped += sum(r.shape[0] * (Tv - r.shape[1])
                            for r in model.vision.last_rows
                            if r is not None)
    n_pages = int(sess.kvs.num_blocks[0, 0].item())
    qa_s, answers, lm_forwards = [], [], 0
    captured = {}

    def capture(f):
        def g(*a, **k):
            captured["dkvs"] = f(*a, **k)
            return captured["dkvs"]
        return g

    for q_ids, p_ids in CLIP_QUESTIONS:
        with patched([(sess.lm, "init_decode_state", capture)]):
            out, dt = timed(lambda: sess.question_answering(
                q_ids, p_ids, stop, max_new_tokens=16))
        qa_s.append(dt)
        answers.append(out)
        lm_forwards += 2 + len(out)
    counts = read_counts()
    want = {"stream_attention": {"float": n_layers * n_frames, "int8": 0,
                                 "int4": 0},
            "decode_attention": n_layers * lm_forwards, "decode_score": 0,
            "stream_attention_page_keep": 0}
    if counts != want:
        raise RuntimeError(f"phase 14 ({case}) launch counts {counts} != "
                           f"expected {want}")
    for a in answers:
        if not a or not all(0 <= t < tc.vocab_size for t in a):
            raise RuntimeError(f"phase 14 ({case}): bad answer {a}")
    k_init = next(k for k in range(n_frames)
                  if rekv.n_init + (k + 1) * T > rekv.n_local)
    if n_pages != n_frames or init_active != [
            k >= k_init for k in range(n_frames)] or n_frames <= W:
        raise RuntimeError(f"phase 14 ({case}): {n_pages} pages for "
                           f"{n_frames} frames, init_active {init_active}; "
                           f"expected from frame {k_init}, past {W} pages")
    stats = cl.cache_stats(sess._vstate)
    stats_want = {"total_tokens_processed": rows_processed,
                  "total_tokens_skipped": rows_skipped,
                  "actual_skip_ratio": rows_skipped / rows_processed}
    if stats != stats_want or (scfg.cacher.enabled) != (rows_skipped > 0):
        raise RuntimeError(f"phase 14 ({case}): cache_stats {stats} != "
                           f"the recomputed rows' {stats_want}")

    # both kernels on the session's own state, a middle layer: the next
    # one-frame append over the full window (a cover of W / ppt + 1 tiles),
    # and the last question's decode cache
    li = n_layers // 2
    kv = layer(sess.kvs, li)
    rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, rekv,
                                tc.head_dim, tc.rope_base, kv.page_offset)
    q = torch.randn((1, tc.num_heads, T, tc.head_dim), generator=gen,
                    device=dev).bfloat16()
    args = (q, q.flip(2).contiguous(), kv.block_k, kv.block_v, rc.cos_cover,
            rc.sin_cover, kv.init_k, kv.init_v, kv.init_k, rc.scalars)
    stream_check = held(f"phase 14 ({case}) session state",
                        sa.stream_attention(*args, n_local=rekv.n_local),
                        sa.stream_attention_ref(*args, n_local=rekv.n_local))
    dkv = layer(captured["dkvs"], li)
    Tq = 16
    qd = torch.randn((1, tc.num_heads, Tq, tc.head_dim), generator=gen,
                     device=dev).bfloat16()
    start = (dkv.cursor - Tq).to(torch.int32)
    dargs = (qd, dkv.k, dkv.v, start, dkv.cursor)
    decode_check = held(
        f"phase 14 ({case}) decode cache",
        da.decode_attention(*dargs, n_local=rekv.n_local, return_m=True),
        da.decode_attention_ref(*dargs, n_local=rekv.n_local,
                                return_m=True))
    if not (stream_check["agrees"] and decode_check["agrees"]) or \
            int(rc.scalars[0, 3]) != 1 or \
            int(rc.cos_cover.shape[1]) != (W + ppt) * S:
        raise RuntimeError(f"phase 14 ({case}) state checks failed "
                           f"{stream_check} {decode_check}")

    # where a chunk's time goes (after the counted run): the next chunk on
    # each of the backbone's vision paths (LongVA: full, then cached)
    targets = [(sess.vision, "full", "vision_full"),
               (sess.vision, "cached", "vision_cached"),
               (cl.ClipLayer, "attn", "clip_attention"),
               (cl.ClipLayer, "mlp", "clip_mlp"),
               (cl, "residual_similarity", "cacher_similarity"),
               (cl, "recompute_rows", "cacher_selection"),
               (sess.model.projector, "forward", "projector"),
               (sess.lm, "encode_step", "lm_append"),
               (sa, "_launch", "stream_attention_kernel")]
    split = [segments(lambda: sess.encode_video(frames[:chunk]), targets)
             for _ in range(2 if scfg.cacher.enabled else 1)]
    for sp in split:
        sp["path"] = "cached" if "vision_cached_ms" in sp else "full"

    def fps(kind):
        xs = [(n, dt) for p, n, dt in chunks[2:] if kind in (None, p)]
        return sum(n for n, _ in xs) / sum(dt for _, dt in xs) if xs \
            else None

    store = sum(x.numel() * x.element_size() for x in (
        sess.kvs.block_k, sess.kvs.block_v))
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    rec = {"phase": f"clip backbone ({case}) {mod_name}", "card": card,
           "widths": {"vision": dataclasses.asdict(vc),
                      "text": dataclasses.asdict(tc)},
           "session": {"n_local": rekv.n_local, "block_size": S,
                       "topk": rekv.topk, "max_blocks": rekv.max_blocks,
                       "chunk_frames": chunk, "window_pages": W,
                       "pages_per_tile": ppt,
                       "cover_keys": int(rc.cos_cover.shape[1]),
                       "cacher": scfg.cacher.strategy,
                       "skip_ratio": scfg.cacher.update_token_ratio},
           "frames": n_frames, "pages": n_pages,
           "first_init_active_frame": k_init,
           "answers": answers, "answer_tokens": [len(a) for a in answers],
           "lm_forwards": lm_forwards, "launches": counts,
           "expected": want, "cache_stats": stats,
           "frames_per_s": fps(None),
           "frames_per_s_full_chunks": fps("full"),
           "frames_per_s_cached_chunks": fps("cached"),
           "chunk_s": [dt for _, _, dt in chunks],
           "qa_latency_s_p50": p50(qa_s), "qa_latency_s": qa_s,
           "page_store_gb": store / 2 ** 30,
           "weight_gb": weights / 2 ** 30,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kernel_vs_plain_on_session_state": stream_check,
           "decode_attention_vs_plain_on_decode_cache": decode_check,
           "time_split": split}
    del sess, model, captured, args, dargs, kv, dkv
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def clip_backbones_phase(card, dev) -> dict:
    """Phase 14: (a) LongVA-7B, (b) Video-LLaVA-7B, (c) Flash-VStream-7B,
    each model freed before the next."""
    t_phase = time.perf_counter()
    out = {}
    for case, *rest in CLIP_BACKBONES:
        rec = clip_backbone_run(case, *rest, card, dev)
        emit(rec)
        out[case] = rec
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 15: the eval harnesses at llava-ov-7b width; batched eval at 0.5b
# ---------------------------------------------------------------------------

class HashTok:
    """Deterministic text -> at most 20 ids in 1..200, ids -> a comma
    string, stop id 0: no tokenizer file (tests/test_eval_batched.py's)."""
    eos_token_id = 0

    def __call__(self, text):
        return [1 + (b % 200) for b in text.encode()][:20] or [9]

    def decode(self, ids, **kw):
        return ",".join(str(int(i)) for i in ids)


# video name -> raw frames (one a second) at 360 x 640: run_eval's 0.5
# frames/s keeps 16, 40, 64 and 96 (none reaches the 250-page window, for
# the script's time: phases 6-8 and 10 cross it at the same width)
EVAL_VIDEOS = {"v16": 32, "v40": 80, "v64": 128, "v96": 192}
# the videos of the world-2 merge, of the bare-session comparison and of
# the new-session rerun (the short ones, for the script's time)
EVAL_WORLD2 = ("v16", "v40")
EVAL_SHORT = "v40"
EVAL_HW = (360, 640)
EVAL_MC_NEW, EVAL_OPEN_NEW = 16, 32


def mc(q, choices, answer):
    return {"question": q, "choices": choices, "answer": answer}


def oe(q, answer, end_time=None):
    row = {"question": q, "answer": answer}
    if end_time is not None:
        row["end_time"] = end_time
    return row


def eval_annotations(paths) -> dict:
    """The phase's annotations in the benchmarks' schemas: 14 questions
    over run_eval's protocols, 4 StreamingBench and 4 OVO-Bench ones."""
    def sample(name, convs):
        return {"video_id": name, "video_path": paths[name],
                "duration": EVAL_VIDEOS[name], "conversations": convs}

    offline = [
        sample("v16", [mc("what does the person pick up first",
                          ["a cup", "a phone", "a book"], "a phone"),
                       oe("describe the room", "a kitchen")]),
        sample("v40", [mc("where does the walk end",
                          ["a door", "a car", "a bench", "a shop"],
                          "a bench")]),
        sample("v64", [mc("which tool is used",
                          ["a knife", "a saw", "a drill", "a brush",
                           "a pen"], "a saw"),
                       oe("what happens after the cut", "it falls")]),
        sample("v96", [mc("what color is the bag",
                          ["red", "blue", "green", "black"], "green")]),
    ]
    videomme = [
        sample("v16", [mc("what is on the table",
                          ["fruit", "a laptop", "keys", "a lamp"],
                          "keys")]),
        sample("v40", [mc("what does the dog do",
                          ["sleeps", "runs", "barks", "eats"], "runs")]),
    ]
    stream = [
        sample("v64", [oe("what is being held now", "a cup", 40),
                       oe("what was just put down", "a plate")]),
        sample("v96", [oe("who entered", "a child", 100),
                       oe("what is on screen at the end", "a menu")]),
    ]
    sb = [{"video_path": paths["v40"], "questions": [
        {"time_stamp": "00:00:30", "question": "what moved last",
         "options": ["A. a car", "B. a bird", "C. a cat"], "answer": "B",
         "task_type": "Object Perception"},
        {"time_stamp": "00:01:10", "question": "what is the weather",
         "options": ["A. rain", "B. sun", "C. snow", "D. fog"],
         "answer": "A", "task_type": "Attribute Perception"}]},
        {"video_path": paths["v64"], "questions": [
            {"time_stamp": "00:00:50", "question": "what was said",
             "options": ["A. hello", "B. stop", "C. thanks"],
             "answer": "C", "task_type": "Text-Rich Understanding"},
            {"time_stamp": "00:02:00", "question": "where are they",
             "options": ["A. park", "B. office", "C. shop", "D. road"],
             "answer": "D", "task_type": "Spatial Understanding"}]}]
    ovo = {
        "backward": [{"id": "v16", "video": "v16.mp4", "task": "EPM",
                      "question": "what was picked up",
                      "options": ["a cup", "a phone", "a book"], "gt": 1,
                      "realtime": 30}],
        "realtime": [{"id": "v40", "video": "v40.mp4", "task": "OCR",
                      "question": "what does the sign say",
                      "options": ["open", "closed", "exit", "sale"],
                      "gt": 2, "realtime": 60}],
        "forward": [{"id": "v64", "video": "v64.mp4", "task": "REC",
                     "activity": "jump rope",
                     "test_info": [{"count": 3, "realtime": 40},
                                   {"count": 7, "realtime": 80}]}],
    }
    return {"mlvu": offline, "videomme": videomme, "rvs_ego": stream,
            "streamingbench": sb, "ovobench": ovo}


def write_eval_videos(d, names, hw, seed) -> dict:
    """Random uint8 videos (one frame a second) as .npy under d: name ->
    path."""
    rng = np.random.default_rng(seed)
    paths = {}
    for name, n in names.items():
        h, w = hw[name] if isinstance(hw, dict) else hw
        paths[name] = os.path.join(d, f"{name}.npy")
        np.save(paths[name], rng.integers(0, 256, size=(n, h, w, 3),
                                          dtype=np.uint8))
    return paths


def make_timed_adapter(session, tok):
    """A SessionAdapter that records, under the protocol named in
    `protocol`, each encode (frames, seconds) and each question (decode
    budget, seconds), host clock around work ending in a synchronize."""
    from stc_tpu_torch.runtime.adapter import SessionAdapter
    from stc_tpu_torch.utils.metrics import Timer, device_sync
    sync = device_sync(session.device)

    class TimedAdapter(SessionAdapter):
        protocol = None

        def encode_video(self, frames, active=None):
            with Timer(sync) as t:
                super().encode_video(frames, active)
            n = (len(frames) if active is None
                 else int(np.shape(frames)[1]) * int(np.sum(active)))
            self.log.append((self.protocol, "encode", n, t.seconds))

        def question_answering(self, input_text, max_new_tokens=128):
            with Timer(sync) as t:
                out = super().question_answering(input_text, max_new_tokens)
            self.log.append((self.protocol, "qa", max_new_tokens,
                             t.seconds))
            return out

    ad = TimedAdapter(session, tok, stop_token_ids=[0])
    ad.log = []
    return ad


def count_appends(sess):
    """Patch sess.lm.encode_step to count video appends (is_init False)
    into the returned dict's "n"."""
    box = {"n": 0}

    def wrap(f):
        def g(*a, **k):
            if not k.get("is_init", False):
                box["n"] += 1
            return f(*a, **k)
        return g

    return box, patched([(sess.lm, "encode_step", wrap)])


def row_key(r):
    return (r.get("video_id"), r.get("question"))


def eval_protocols(ad, sess, anno, paths, work) -> dict:
    """Each protocol once on `ad`, its launches counted from 0 just before
    it: {protocol: record}; the rows / outputs under "out"."""
    from stc_tpu_torch.eval.ovobench import OVOBenchEval
    from stc_tpu_torch.eval.runner import run_eval
    from stc_tpu_torch.eval.streamingbench import StreamingBenchEval
    from stc_tpu_torch.eval.solvers import load_video_frames
    L = sess.lm.cfg.num_layers

    def sb_loader(path, t0, t1, fps):
        v = np.load(path, mmap_mode="r")
        return np.ascontiguousarray(v[t0:t1:max(1, round(1 / fps))])

    def ovo_loader(ref, t, fps):
        v = np.load(paths[ref.split(".")[0].split("_")[0]], mmap_mode="r")
        return np.ascontiguousarray(v[:int(t):max(1, round(1 / fps))])

    recs = {}
    for name in ("mlvu", "videomme", "rvs_ego", "streamingbench",
                 "ovobench"):
        ad.protocol = name
        a_path = os.path.join(work, f"{name}.json")
        with open(a_path, "w") as f:
            json.dump(anno[name], f)
        box, patch = count_appends(sess)
        reset_counts()
        t0 = time.perf_counter()
        with patch:
            if name == "streamingbench":
                data = json.loads(json.dumps(anno[name]))
                out = StreamingBenchEval(
                    ad, "port", sample_fps=0.5, frame_loader=sb_loader).run(
                        data, os.path.join(work, "sb_out.json"))
                answers = [q["port"] for e in out for q in e["questions"]]
                n_samples = len(answers)
                bad = [a for a in answers if not isinstance(a, str)]
            elif name == "ovobench":
                out = OVOBenchEval(ad, sample_fps=0.5,
                                   frame_loader=ovo_loader).eval(
                    anno[name], os.path.join(work, "ovo_out.json"))
                answers = ([r["response"] for g in ("backward", "realtime")
                            for r in out[g]]
                           + [i["response"] for r in out["forward"]
                              for i in r["test_info"]])
                n_samples = len(answers)
                bad = [a for a in answers if a is None]
            else:
                out, _ = run_eval(name, ad, os.path.join(work, name),
                                  anno_path=a_path, rank=0, world=1,
                                  frame_loader=load_video_frames)
                n_samples = len(anno[name])
                want_rows = sum(len(s["conversations"]) for s in anno[name])
                bad = [r for r in out if "error" in r]
                if len(out) != want_rows:
                    bad.append(f"{len(out)} rows for {want_rows} questions")
            wall = time.perf_counter() - t0
        counts = read_counts()
        frames = sum(n for p, k, n, _ in ad.log if p == name
                     and k == "encode")
        want_qs = (sum(len(s["conversations"]) for s in anno[name])
                   if name not in ("streamingbench", "ovobench")
                   else n_samples)
        qs = [(n, s) for p, k, n, s in ad.log if p == name and k == "qa"]
        recs[name] = {
            "out": out, "samples": n_samples, "questions": len(qs),
            "frames": frames, "appends": box["n"], "launches": counts,
            "seconds": wall, "seconds_per_sample": wall / n_samples,
            "qa_p50_s_mc": p50([s for n, s in qs if n == EVAL_MC_NEW]),
            "qa_p50_s_open": p50([s for n, s in qs if n != EVAL_MC_NEW]),
            "bad": bad}
        ok = (not bad and len(qs) == want_qs and box["n"] == frames > 0
              and counts["stream_attention"] == {
                  "float": L * box["n"], "int8": 0, "int4": 0}
              and counts["decode_attention"] > 0
              and counts["stream_attention_page_keep"] == 0)
        if not ok:
            raise RuntimeError(
                f"phase 15 {name}: {bad[:3]} ({len(bad)} bad), {len(qs)} "
                f"questions of {want_qs}, {box['n']} appends for {frames} "
                f"frames, launches {counts}")
    return recs


def session_kernel_checks(sess, gen, label) -> dict:
    """Both kernels against their plain versions on the session's own
    state at a middle layer: the next one-frame append, and the decode
    cache of a question asked now."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.kvcache.state import layer
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa
    rekv, tc, dev = sess.rekv, sess.lm.cfg, sess.device
    captured = {}

    def capture(f):
        def g(*a, **k):
            captured["dkvs"] = f(*a, **k)
            return captured["dkvs"]
        return g

    with patched([(sess.lm, "init_decode_state", capture)]):
        sess.question_answering(list(range(30, 42)), list(range(50, 66)),
                                [0], max_new_tokens=4)
    li = tc.num_layers // 2
    kv = layer(sess.kvs, li)
    T = rekv.block_size
    rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, rekv,
                                tc.head_dim, tc.rope_base, kv.page_offset)
    q = torch.randn((1, tc.num_heads, T, tc.head_dim), generator=gen,
                    device=dev).bfloat16()
    args = (q, q.flip(2).contiguous(), kv.block_k, kv.block_v, rc.cos_cover,
            rc.sin_cover, kv.init_k, kv.init_v, kv.init_k, rc.scalars)
    stream_check = held(f"{label} session state",
                        sa.stream_attention(*args, n_local=rekv.n_local),
                        sa.stream_attention_ref(*args, n_local=rekv.n_local))
    dkv = layer(captured["dkvs"], li)
    Tq = 16
    qd = torch.randn((1, tc.num_heads, Tq, tc.head_dim), generator=gen,
                     device=dev).bfloat16()
    dargs = (qd, dkv.k, dkv.v, (dkv.cursor - Tq).to(torch.int32),
             dkv.cursor)
    decode_check = held(
        f"{label} decode cache",
        da.decode_attention(*dargs, n_local=rekv.n_local, return_m=True),
        da.decode_attention_ref(*dargs, n_local=rekv.n_local,
                                return_m=True))
    if not (stream_check["agrees"] and decode_check["agrees"]):
        raise RuntimeError(f"{label} kernel checks failed {stream_check} "
                           f"{decode_check}")
    return {"stream_attention": stream_check,
            "decode_attention": decode_check}


def chunk_flops(sess, n_chunks) -> list:
    """For the session's next n_chunks chunks (each on the path its chunk
    count gives): estimate_chunk_flops of that chunk, the vision part's
    FLOPs (tower, projector, pooling, pruner) apart, then the chunk run
    and its device time split (CUDA events), and TFLOP/s achieved."""
    from stc_tpu_torch.utils.metrics import estimate_flops
    vis, lm = sess.vision, sess.lm
    n = sess.scfg.encode_chunk_frames
    hw = vis.cfg.vision.image_size
    frames = np.random.default_rng(15).integers(
        0, 256, size=(n * n_chunks,) + EVAL_HW + (3,), dtype=np.uint8)
    out = []
    for i in range(n_chunks):
        cached = bool(sess._slot_chunk[0] % sess.scfg.cacher.cache_interval)
        total = sess.estimate_chunk_flops(cached=cached)
        px = vis.device_preprocess(torch.zeros(
            (n, hw, hw, 3), dtype=torch.uint8, device=sess.device))
        path = vis.cached if cached else vis.full
        vision = estimate_flops(lambda: path(px, sess._vstate,
                                             sess._pstate))
        split = segments(lambda: sess.encode_video(frames[i * n:(i + 1) * n]),
                         [(vis, "full", "vision"), (vis, "cached", "vision"),
                          (lm, "encode_step", "lm_append")])
        ms = split["span_ms"]
        out.append({
            "frames": n, "path": "cached" if cached else "full",
            "flops": total, "vision_flops": vision,
            "lm_flops": total - vision, "device_ms": ms,
            "vision_ms": split.get("vision_ms"),
            "lm_ms": split.get("lm_append_ms"), "wall_ms": split["wall_ms"],
            "tflops_per_s": total / ms / 1e9,
            "vision_tflops_per_s": vision / split["vision_ms"] / 1e9,
            "lm_tflops_per_s": (total - vision) / split["lm_append_ms"]
            / 1e9,
            "share_of_bf16_peak": total / (ms / 1e3) / H100_BF16_FLOPS})
    return out


def log_chunks(sess):
    """Patch sess._encode_chunk_pixels and sess.clear_cache to record, per
    chunk, the group (clear_cache count), the active mask, the cacher mask
    and that chunk's VisionLog records; returns (records, a context that
    applies the patches and the VisionLog capture)."""
    records, log, group = [], VisionLog(), {"g": -1}

    def wrap_chunk(f):
        def g(pixels, n_frames, active=None):
            cached = sess._slot_chunk % sess.scfg.cacher.cache_interval != 0
            s0, p0 = len(log.sims), len(log.prunes)
            out = f(pixels, n_frames, active)
            act = (np.ones(sess.batch, bool) if active is None
                   else np.asarray(active, bool))
            records.append((group["g"], act, cached, log.sims[s0:],
                            log.prunes[p0:]))
            return out
        return g

    def wrap_clear(f):
        def g(*a, **k):
            group["g"] += 1
            return f(*a, **k)
        return g

    @contextlib.contextmanager
    def ctx():
        with log.capture(), patched([(sess, "_encode_chunk_pixels",
                                      wrap_chunk),
                                     (sess, "clear_cache", wrap_clear)]):
            yield

    return records, ctx()


def stream_steps(records, B, per_group) -> dict:
    """Each video's frame-by-frame (cached layers' similarities, pruner
    record) from log_chunks records: video index = group * per_group +
    slot."""
    steps = {}
    for g, act, cached, sims, prunes in records:
        ticking = cached[act]
        mix = bool(ticking.any() and not ticking.all())
        for b in range(B):
            if not act[b]:
                continue
            on_cached = bool(cached[b]) and bool(ticking.any())
            s = ([sims[i * B + b] for i in range(len(sims) // B)]
                 if on_cached else [])
            pr = prunes[-1] if on_cached or not mix else prunes[0]
            steps.setdefault(g * per_group + b, []).append(
                (s, {k: v[b] for k, v in pr.items()}))
    return steps


def batched_eval_part(card, dev) -> dict:
    """(d): run_eval(stream_batch=4) over five videos of unequal length
    (one at a second resolution) at llava-ov-0.5b width in float32 (phase
    11's model and session), against the sequential solver.  Rows must be
    equal; where a video's rows part, the first frame where its vision
    selections part must be a near-tie of the sequential run's own scores
    (first_parting), else the phase fails."""
    from stc_tpu_torch.eval.runner import run_eval
    from stc_tpu_torch.eval.solvers import BaseVQA, load_video_frames
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.runtime.adapter import ChatTemplate
    t_part = time.perf_counter()
    tok = HashTok()
    n_init = len(tok(ChatTemplate.init_prompt))
    model, cfg = make_model(dev, seed=11, dtype=torch.float32)
    base = session_cfg(15000, 64, 64, EVAL_OPEN_NEW, 1, 256)
    scfg = dataclasses.replace(base, rekv=dataclasses.replace(
        base.rekv, n_init=n_init))
    U = max(1, int(cfg.vision.num_tokens * scfg.cacher.update_token_ratio))
    K = scfg.pruner.token_per_frame
    names = {"b0": 12, "b1": 18, "b2": 8, "b3": 14, "b4": 6}
    hw = {k: EVAL_HW for k in names}
    hw["b2"] = (240, 320)
    work = tempfile.mkdtemp(prefix="stc_eval_b_")
    try:
        paths = write_eval_videos(work, names, hw, seed=16)
        anno = [{"video_id": k, "video_path": paths[k], "conversations": [
            mc(f"question {i} about {k}", ["a", "b", "c", "d"][:3 + i % 2],
               "b"), oe(f"open question {i}", "x")][:1 + i % 2]}
            for i, k in enumerate(names)]
        a_path = os.path.join(work, "anno.json")
        with open(a_path, "w") as f:
            json.dump(anno, f)
        runs = {}
        for batch in (1, 4):
            sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                    device=dev, batch=batch)
            ad = make_timed_adapter(sess, tok)
            records, ctx = log_chunks(sess)
            with ctx, patched([(BaseVQA, "open_max_new",
                                lambda _: EVAL_OPEN_NEW)]):
                rows, _ = run_eval("mlvu", ad, os.path.join(work, str(batch)),
                                   anno_path=a_path, rank=0, world=1,
                                   frame_loader=load_video_frames,
                                   stream_batch=batch)
            enc = [(n, s) for _, k, n, s in ad.log if k == "encode"]
            runs[batch] = {"rows": rows, "steps": stream_steps(
                records, batch, batch),
                "fps": sum(n for n, _ in enc) / sum(s for _, s in enc)}
            del sess, ad
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seq, bat = runs[1]["rows"], runs[4]["rows"]
    errors = [r for r in seq + bat if "error" in r]
    parted, failures = {}, []
    for i, s in enumerate(anno):
        vid = s["video_id"]
        a = [r for r in bat if r["video_id"] == vid]
        b = [r for r in seq if r["video_id"] == vid]
        if a == b:
            continue
        part = first_parting(
            [(x[0], y[0], x[1], y[1]) for x, y in zip(
                runs[4]["steps"][i], runs[1]["steps"][i])], U, K)
        parted[vid] = part
        if part is None or not part["tie"]:
            failures.append(vid)
    equal_rows = sum(x == y for x, y in zip(bat, seq))
    rec = {"model": "llava-ov-0.5b widths, float32", "stream_batch": 4,
           "videos": {k: (names[k] // 2,) + hw[k] for k in names},
           "rows": len(bat), "equal_rows": equal_rows,
           "rows_equal": bat == seq, "partings": parted,
           "frames_per_s_batch4": runs[4]["fps"],
           "frames_per_s_batch1": runs[1]["fps"],
           "seconds": time.perf_counter() - t_part}
    for vid, p in parted.items():
        print(f"near-tie: batched eval video {vid} {p}", flush=True)
    del model
    torch.cuda.empty_cache()
    if errors or failures or len(bat) != len(seq) or \
            len(bat) != sum(len(s["conversations"]) for s in anno):
        raise RuntimeError(f"phase 15 (d) batched eval failed: errors "
                           f"{errors[:3]}, partings away from a near-tie "
                           f"{failures} {rec}")
    return rec


def eval_phase(card, dev) -> dict:
    """Phase 15: the eval harnesses at llava-ov-7b width (bf16 LM, float32
    SigLIP, SessionConfig() but n_init = the adapter's init prompt, random
    weights), HashTok, .npy videos at 360 x 640:
    (a)-(b) run_eval offline ("mlvu", five videos), "videomme" (two),
    "rvs_ego" (two, end_time cuts), StreamingBenchEval and OVOBenchEval
    (four questions each); (c) gates: no error row or None response, row
    counts, launches = appends x layers by protocol, decode launches on
    every protocol, three rows equal to direct question_answering calls
    in a cleared session, a video alone in a new session equal to its rows
    after the others, a world-2 merge (mlvu's v16 and v40) equal to the
    world-1 rows, a bare StreamingSession with the FrameEncoder equal to
    the VLMSession (answer ids and blocks) on a 20-frame video, both
    kernels against their plain versions on the session's state; (d)
    batched eval at 0.5b width; (e) chunk FLOPs and device times."""
    from stc_tpu_torch.config import SessionConfig
    from stc_tpu_torch.eval import solvers
    from stc_tpu_torch.eval.runner import merge_and_score, run_eval
    from stc_tpu_torch.eval.solvers import OfflineVQA, load_video_frames
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.runtime.adapter import ChatTemplate
    from stc_tpu_torch.runtime.session import StreamingSession
    t_phase = time.perf_counter()
    tok = HashTok()
    n_init = len(tok(ChatTemplate.init_prompt))
    base = SessionConfig()
    scfg = dataclasses.replace(base, rekv=dataclasses.replace(
        base.rekv, n_init=n_init))
    print(f"phase 15: BaseVQA.open_max_new lowered from "
          f"{solvers.BaseVQA.open_max_new} to {EVAL_OPEN_NEW} "
          f"(multiple-choice keeps {solvers.BaseVQA.mc_max_new})",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(15)
    torch.cuda.reset_peak_memory_stats()
    model, cfg = make_model(dev, seed=15, text=QWEN2_7B)
    work = tempfile.mkdtemp(prefix="stc_eval_")
    out = {"phase": "eval llava-ov-7b", "card": card,
           "open_max_new": EVAL_OPEN_NEW, "mc_max_new": EVAL_MC_NEW,
           "n_init": n_init}
    try:
        t0 = time.perf_counter()
        paths = write_eval_videos(work, EVAL_VIDEOS, EVAL_HW, seed=15)
        out["write_videos_s"] = time.perf_counter() - t0
        anno = eval_annotations(paths)
        with patched([(solvers.BaseVQA, "open_max_new",
                       lambda _: EVAL_OPEN_NEW)]):
            sess = lo.build_session(model, scfg,
                                    state_dtype=torch.bfloat16, device=dev)
            ad = make_timed_adapter(sess, tok)
            recs = eval_protocols(ad, sess, anno, paths, work)
            mlvu = recs["mlvu"]["out"]

            # three rows against direct calls in a freshly cleared session
            solver = OfflineVQA(ad)
            direct = []
            for s in anno["mlvu"][:2]:
                frames = load_video_frames(s["video_path"], 0.5)
                for qa in s["conversations"][:2]:
                    if len(direct) == 3:
                        break
                    is_mc = "choices" in qa
                    prompt = (solver.format_mcqa_prompt(qa["question"],
                                                        qa["choices"])
                              if is_mc else
                              solver.format_openqa_prompt(qa["question"]))
                    sess.clear_cache()
                    sess.encode_init_prompt(tok(ChatTemplate.init_prompt))
                    sess.encode_video(frames)
                    ids = sess.question_answering(
                        tok(qa["question"]), tok(prompt), [0],
                        max_new_tokens=EVAL_MC_NEW if is_mc
                        else EVAL_OPEN_NEW)
                    row = next(r for r in mlvu if row_key(r) == (
                        s["video_id"], qa["question"]))
                    direct.append({"video": s["video_id"],
                                   "row": row["pred_answer"],
                                   "direct": tok.decode(ids)})

            # the world-2 merge, rank 0 then rank 1, over two of the mlvu
            # videos (its depth cut to keep the script's time)
            w2 = [s for s in anno["mlvu"] if s["video_id"] in EVAL_WORLD2]
            a_path = os.path.join(work, "mlvu_world2.json")
            with open(a_path, "w") as f:
                json.dump(w2, f)
            wdir = os.path.join(work, "world2")
            ad.protocol = "world2"
            for rank in (0, 1):
                run_eval("mlvu", ad, wdir, anno_path=a_path, rank=rank,
                         world=2, frame_loader=load_video_frames)
            merged = merge_and_score(wdir, "mlvu")
            with open(os.path.join(wdir, "merged_score.json")) as f:
                merged_rows = json.load(f)["rows"]
            kv_gb = max(r["kv_memory_gb"] for r in recs["videomme"]["out"])

            # the bare session with the FrameEncoder against the VLMSession
            frames_short = load_video_frames(paths[EVAL_SHORT], 0.5)
            questions = [(tok("what is on the left"),
                          tok(ad.get_prompt("what is on the left"))),
                         (tok("which object moves"),
                          tok(ad.get_prompt("which object moves", mc=True)))]

            def bare_vs_vlm(s):
                s.clear_cache()
                s.encode_init_prompt(tok(ChatTemplate.init_prompt))
                for i in range(len(frames_short)):
                    s.encode_video(frames_short[i:i + 1])
                res = []
                for q, p in questions:
                    ids = s.question_answering(q, p, [0],
                                               max_new_tokens=EVAL_MC_NEW)
                    res.append((ids, s.last_retrieved_indices))
                return res

            vlm_res = bare_vs_vlm(sess)
            checks = session_kernel_checks(sess, gen, "phase 15")
            flops1 = chunk_flops(sess, 3)
            logs = ad.log
            del ad, sess
            torch.cuda.empty_cache()
            bare = StreamingSession(
                model.text, scfg, state_dtype=torch.bfloat16,
                frame_encoder=lo.FrameEncoder(model, scfg, device=dev))
            bare_res = bare_vs_vlm(bare)
            del bare
            torch.cuda.empty_cache()

            # one video alone in a newly built session
            alone = [s for s in anno["mlvu"] if s["video_id"] == EVAL_SHORT]
            al_path = os.path.join(work, "alone.json")
            with open(al_path, "w") as f:
                json.dump(alone, f)
            sess2 = lo.build_session(model, scfg,
                                     state_dtype=torch.bfloat16, device=dev)
            alone_rows, _ = run_eval(
                "mlvu", make_timed_adapter(sess2, tok),
                os.path.join(work, "alone"), anno_path=al_path, rank=0,
                world=1, frame_loader=load_video_frames)
            del sess2
            torch.cuda.empty_cache()

            # an 8-frame chunk (exc_block_size 480): FLOPs and device time
            scfg8 = dataclasses.replace(
                scfg, encode_chunk_frames=8, rekv=dataclasses.replace(
                    scfg.rekv, exc_block_size=8 * scfg.rekv.block_size))
            sess8 = lo.build_session(model, scfg8,
                                     state_dtype=torch.bfloat16, device=dev)
            sess8.encode_init_prompt(tok(ChatTemplate.init_prompt))
            sess8.encode_video(np.random.default_rng(8).integers(
                0, 256, size=(32,) + EVAL_HW + (3,), dtype=np.uint8))
            flops8 = chunk_flops(sess8, 2)
            del sess8
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out["d_batched"] = batched_eval_part(card, dev)

    enc = [(n, s) for _, k, n, s in logs if k == "encode"]
    short = [r for r in mlvu if r["video_id"] == EVAL_SHORT]
    mlvu_w2 = [r for r in mlvu if r["video_id"] in EVAL_WORLD2]
    gates = {
        "direct_qa_equal": all(d["row"] == d["direct"] for d in direct)
        and len(direct) == 3,
        "alone_equal_after_others": alone_rows == short and bool(short),
        "world2_merge_equal": sorted(merged_rows, key=row_key) == sorted(
            mlvu_w2, key=row_key) and merged["n_rows"] == len(mlvu_w2)
        and bool(mlvu_w2),
        "bare_frame_encoder_equal_vlm": bare_res == vlm_res,
    }
    out.update({
        "protocols": {k: {kk: vv for kk, vv in r.items()
                          if kk not in ("out", "bad")}
                      for k, r in recs.items()},
        "launches": {k: r["launches"] for k, r in recs.items()},
        "ingest_frames_per_s": sum(n for n, _ in enc) / sum(
            s for _, s in enc),
        "frames_encoded": sum(n for n, _ in enc),
        "kv_memory_gb": kv_gb,
        "kv_memory_gb_note": "SessionAdapter.calc_memory_usage, as stc_tpu "
                             "computes it: pages x max_blocks x bytes a "
                             "page",
        "direct_qa": direct,
        "bare_vs_vlm": [{"answer": a, "blocks_layer0": b[0]}
                        for a, b in vlm_res],
        "merge_score": merged["score"], "gates": gates,
        "kernel_vs_plain_on_session_state": checks,
        "chunk_flops_1frame": flops1, "chunk_flops_8frame": flops8,
        "peak_mem_gb": peak,
        "mlvu_answers": [r["pred_answer"] for r in mlvu]})
    out["seconds"] = time.perf_counter() - t_phase
    if not all(gates.values()):
        raise RuntimeError(f"phase 15 gates failed {gates} {direct}")
    return out


# --------------------------------------------------------------------------
# phase 16: parallel layouts at llava-ov-7b width
# --------------------------------------------------------------------------

PAR_SEED = 16
PAR_B = 2                  # streams
PAR_CHUNKS = 2             # 8-frame chunks: the second crosses init-fill
PAR_N_LOCAL = 900          # tokens: 14 + 480 fit, 14 + 960 do not
PAR_QUESTIONS = [(list(range(200, 212)), list(range(300, 316))),
                 (list(range(400, 409)), list(range(500, 516)))]
PAR_NEW = 8                # greedy tokens a question
PAR_STOP = [151645]
# The gates' limits.  U = 2^-8 is the largest relative change one
# rounding to bf16 makes; A, of a block's retrieval score, is the
# reference's sum over heads and dims of |q_mean| |rep key| (the score's
# terms in absolute value), so U A is the score's change if each term
# moved by one rounding, all one way.
#  - pruner: at most PAR_G0 of the reference's kept tokens (stream, frame,
#    token) are not kept by the layout (a layout's pooled features differ
#    from the reference's by float32 rounding; only a near-tie of the
#    pruner's scores may part a pick);
#  - layer 0's retrieval scores: |layout - reference| <= PAR_G1 * A for
#    every block of every question and stream, PAR_G1 = U: the layer's
#    q_mean and rep keys differ from the reference's by less than one
#    rounding of each term in all;
#  - the first-token logits of a question asked over fixed blocks (the
#    first topk, so no retrieval can part them): rms(layout - reference)
#    <= PAR_G2 * rms(reference) for every stream, PAR_G2 = 1/4 >= 56 U,
#    one rounding added to the residual stream by each of 56 sublayers;
#  - a retrieved block's departure is a near-tie when the reference's cut
#    gap (its k-th minus (k+1)-th score) is at most PAR_G1 (A_k + A_k+1);
#  - an answer's first departure is a near-tie when the reference's top-2
#    gap there is at most two bf16 ulps of its top logit, or when that
#    question's retrieval for that stream parted at a near-tie.
# A planted fault of a straight port (python3 chip_smoke.py
# --planted-faults) must fail one of the first three.
U = 2.0 ** -8
PAR_G0 = 2.0 ** -7
PAR_G1 = U
PAR_G2 = 2.0 ** -2
# layout -> (its name, its ranks)
PAR_LAYOUTS = {"a": ("tp 2", 2), "b": ("dp 2 x tp 2", 4),
               "c": ("pp 2", 2), "d": ("sp 2 x tp 1", 2)}
# planted fault -> the layout it is planted in
PAR_FAULTS = {"even_wqkv": "a", "unreduced_retrieval": "a",
              "lm_head_order": "a", "prune_before_gather": "d"}


def par_mesh(layout):
    from stc_tpu_torch.parallel import mesh as pm
    return {"a": lambda: pm.make_mesh(dp=1, tp=2),
            "b": lambda: pm.make_mesh(dp=2, tp=2),
            "c": lambda: pm.make_pp_mesh(pp=2, tp=1),
            "d": lambda: pm.make_mesh(dp=1, tp=1, sp=2),
            "nccl": lambda: pm.make_mesh(dp=1, tp=1)}[layout]()


def par_model(dev, mesh=None):
    """llava-ov-7b widths (bf16 Qwen2 3584 x 28, float32 SigLIP 1152 x 27
    at 384 px), built on the meta device, sharded onto `mesh`, allocated
    on the card and filled by sharding.init_random from PAR_SEED: every
    layout holds slices of the reference's very weights, drawn tensor by
    tensor on the card."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg
    from stc_tpu_torch.parallel import sharding
    vision = sg.SiglipConfig(hidden_size=1152, num_layers=27, num_heads=16,
                             intermediate_size=4304, image_size=384,
                             patch_size=14)
    cfg = lo.LlavaOVConfig(vision=vision, text=qw.Qwen2Config(**QWEN2_7B))
    model = lo.LlavaOV(cfg, dtype=torch.bfloat16,
                       vision_dtype=torch.float32, device="meta")
    if mesh is not None:
        sharding.shard_module(model, mesh)
    model.to_empty(device=dev)
    return sharding.init_random(model, PAR_SEED), cfg


def par_scfg():
    return session_cfg(PAR_N_LOCAL, 8, 128, 16, 8, 64)


def par_frames():
    rng = np.random.default_rng(PAR_SEED)
    return rng.integers(0, 256, size=(PAR_B, 8 * PAR_CHUNKS, 384, 384, 3),
                        dtype=np.uint8)


def par_fault(name) -> list:
    """The patches (for `patched`) that plant one fault of a straight
    port: the fused q|k|v output axis split evenly ("even_wqkv"), the
    retrieval logits left unreduced over tp ("unreduced_retrieval"), the
    tp blocks of the logits gathered in reverse ("lm_head_order"), each
    sp rank pruning its own frames before the gather
    ("prune_before_gather")."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.parallel import sharding

    def even_wqkv(f):
        def g(cfg):
            return {**f(cfg), **{k: sharding.COL for k in (
                "wqkv", "bqkv", "wqkv_q", "wqkv_s", "wqkv_gs")}}
        return g

    def unreduced(f):
        def g(kv, q, cfg, q_valid=None, tp=None):
            return f(kv, q, cfg, q_valid, None)
        return g

    def reversed_blocks(f):
        def g(self, h):
            x = f(self, h)
            return x if self.tp is None else torch.cat(
                x.chunk(self.tp.size, dim=-1)[::-1], dim=-1)
        return g

    def prune_first(f):
        def g(self, feats, pstate, sp=None):
            flat, idx, pstate = f(self, feats, pstate)
            if sp is None:
                return flat, idx, pstate
            return (sp.all_gather(flat, dim=1, site="sp.pooled"),
                    sp.all_gather(idx, dim=1, site="sp.kept"), pstate)
        return g

    return {"even_wqkv": [(sharding, "qwen2_param_specs", even_wqkv)],
            "unreduced_retrieval": [(engine, "score_block_logits",
                                     unreduced)],
            "lm_head_order": [(qw.Qwen2, "_lm_head", reversed_blocks)],
            "prune_before_gather": [(lo.LlavaOVVision, "_post",
                                     prune_first)]}[name]


def par_drive(sess) -> dict:
    """The phase's stream on `sess`: init prompt, PAR_CHUNKS 8-frame chunks
    of PAR_B streams (device ms each), the two questions for every stream
    (device ms each), then the fixed-block question.  Records each
    question's logit top-2 gaps and top logits a greedy step and its
    retrieval scores and their terms' sums A a layer, the pruner's kept
    tokens a chunk, the fixed-block question's first-token logits, and
    the decode state it built (for the kernel checks)."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    frames = par_frames()
    rc = sess.rekv
    sess.encode_init_prompt(list(range(100, 114)))
    chunk_ms, init_active, kept = [], [], []

    def post(f):
        def g(self, *a, **k):
            out = f(self, *a, **k)
            kept.append(out[1].cpu())
            return out
        return g

    with patched([(lo.LlavaOVVision, "_post", post)]):
        for c in range(PAR_CHUNKS):
            L = int(sess.kvs.length[0, 0])
            init_active.append(L + rc.exc_block_size > rc.n_local)
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            sess.encode_video(frames[:, 8 * c:8 * c + 8])
            e1.record()
            torch.cuda.synchronize()
            chunk_ms.append(e0.elapsed_time(e1))
    gaps, cuts, terms, first, dec = [], [], [], [], {"fixed": False}

    def top2(f):
        def g(logits):
            x = logits.float()
            v = x.topk(2, dim=-1).values
            gaps[-1].append(((v[..., 0] - v[..., 1]).tolist(),
                             v[..., 0].tolist()))
            if dec["fixed"] and not first:
                first.append(x.cpu())
            return f(logits)
        return g

    def scores(f):
        def g(*a, **k):
            out = f(*a, **k)
            rep, qm = a[0].block_rep.float(), out[2].abs()
            B, Hkv, D = qm.shape[0], rep.shape[2], qm.shape[-1]
            qs = qm.reshape(B, Hkv, -1, D).sum(dim=2)
            cuts[-1].append(out[0].float().cpu())
            terms[-1].append(torch.einsum("bnhd,bhd->bn", rep.abs(),
                                          qs).cpu())
            return out
        return g

    def decode_state(f):
        def g(*a, **k):
            dec["dkvs"] = f(*a, **k)
            return dec["dkvs"]
        return g

    answers, blocks, qa_ms = [], [], []
    with patched([(qw, "top2_lowest", top2),
                  (engine, "score_block_logits", scores)]):
        for q, p in PAR_QUESTIONS:
            for x in (gaps, cuts, terms):
                x.append([])
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            answers.append(sess.question_answering(
                q, p, PAR_STOP, max_new_tokens=PAR_NEW, all_streams=True))
            e1.record()
            torch.cuda.synchronize()
            qa_ms.append(e0.elapsed_time(e1))
            blocks.append(sess.last_retrieved_indices)
        for x in (gaps, cuts, terms):
            x.append([])
        dec["fixed"] = True
        with patched([(sess.lm, "init_decode_state", decode_state)]):
            fixed = sess.question_answering(
                list(range(30, 42)), list(range(50, 66)), PAR_STOP,
                max_new_tokens=4, retrieved_indices=list(range(rc.topk)),
                all_streams=True)
    gaps.pop()
    if cuts.pop() or terms.pop():
        raise RuntimeError("the fixed-block question scored blocks")
    return {"answers": answers, "blocks": blocks, "chunk_ms": chunk_ms,
            "qa_ms": qa_ms, "init_active": init_active, "gaps": gaps,
            "cuts": cuts, "terms": terms, "kept": torch.stack(kept, 1),
            "fixed_answer": fixed, "fixed_logits": first[0],
            "dkvs": dec["dkvs"]}


def par_merge(ranks, key) -> list:
    """A layout's per-layer records `key` [question][layer] (B, ...),
    merged from its ranks' own (their layers under pp, their streams
    under dp)."""
    r0 = ranks[0]
    nq = len(r0[key])
    n = len(r0[key][0])
    L = n * len({r["coord"].get("pp", 0) for r in ranks})
    out = [[None] * L for _ in range(nq)]
    for r in ranks:
        l0 = r["coord"].get("pp", 0) * n
        for qi in range(nq):
            for l, s in enumerate(r[key][qi]):
                b0 = r["coord"].get("dp", 0) * s.shape[0]
                if out[qi][l0 + l] is None:
                    out[qi][l0 + l] = torch.zeros((PAR_B,) + s.shape[1:])
                out[qi][l0 + l][b0:b0 + s.shape[0]] = s
    return out


def par_rows(ranks, key) -> torch.Tensor:
    """Per-stream rows `key` (B_local, ...) merged over dp."""
    r0 = ranks[0][key]
    out = torch.zeros((PAR_B,) + r0.shape[1:])
    for r in ranks:
        b0 = r["coord"].get("dp", 0) * r[key].shape[0]
        out[b0:b0 + r[key].shape[0]] = r[key]
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def kept_mask(idx, width) -> torch.Tensor:
    """(..., keep) kept token indices -> (..., width) bool."""
    m = torch.zeros(idx.shape[:-1] + (width,), dtype=torch.bool)
    return m.scatter_(-1, idx.long(), True)


def par_numerics(kept, cuts, fixed, ref) -> dict:
    """The limits on numbers (see PAR_G0): the pruner's kept tokens
    (`kept` merged) against PAR_G0, layer 0's retrieval scores (`cuts`
    merged) against PAR_G1 * A, and the fixed-block question's
    first-token logits (`fixed` merged) against PAR_G2."""
    nb = ref["nb"]
    w = int(max(kept.max(), ref["kept"].max())) + 1
    want_k = kept_mask(ref["kept"], w)
    g0 = float((want_k & ~kept_mask(kept, w)).sum()) / float(want_k.sum())
    g1 = max(float(((cuts[qi][0][:, :nb] - ref["cuts"][qi][0][:, :nb]).abs()
                    / (PAR_G1 * ref["terms"][qi][0][:, :nb])).max())
             for qi in range(len(PAR_QUESTIONS)))
    want = ref["fixed_logits"]
    g2 = [float((fixed[b] - want[b]).pow(2).mean().sqrt()
                / want[b].pow(2).mean().sqrt()) for b in range(PAR_B)]
    return {"kept_tokens_parted": g0, "kept_tokens_limit": PAR_G0,
            "layer0_score_err_over_limit": g1,
            "fixed_logits_rms_rel": g2, "fixed_logits_limit": PAR_G2,
            "ok": g0 <= PAR_G0 and g1 <= 1.0 and max(g2) <= PAR_G2}


def par_departures(run, ref) -> dict:
    """Where a layout's answers and blocks part from the reference's, and
    whether each is a near-tie of the reference (see PAR_G1)."""
    topk, nb = ref["topk"], ref["nb"]
    out = {"answers": [], "blocks": []}
    for qi, (got, want) in enumerate(zip(run["blocks"], ref["blocks"])):
        for l, (gl, wl) in enumerate(zip(got, want)):
            for b, (g, w) in enumerate(zip(gl, wl)):
                if g == w:
                    continue
                s = ref["cuts"][qi][l][b, :nb]
                a = ref["terms"][qi][l][b, :nb]
                order = s.argsort(descending=True, stable=True)
                gap = float(s[order[topk - 1]] - s[order[topk]])
                lim = PAR_G1 * float(a[order[topk - 1]] + a[order[topk]])
                out["blocks"].append({"question": qi, "layer": l,
                                      "stream": b, "cut_gap": gap,
                                      "limit": lim, "near_tie": gap <= lim})
    for qi, (got, want) in enumerate(zip(run["answers"], ref["answers"])):
        for b, (g, w) in enumerate(zip(got, want)):
            if g == w:
                continue
            i = next(j for j, (x, y) in enumerate(zip(g + [-1], w + [-2]))
                     if x != y)
            # step i's logits: the prefill's row (i == 0) or decode step i's
            gap, top = (x[b] for x in ref["gaps"][qi][i])
            lim = 2 * bf16_ulp(top)
            out["answers"].append({
                "question": qi, "stream": b, "position": i,
                "top2_gap": gap, "limit": lim, "near_tie": gap <= lim,
                "after_block_near_tie": any(
                    x["near_tie"] for x in out["blocks"]
                    if (x["question"], x["stream"]) == (qi, b))})
    out["ok"] = (all(d["near_tie"] or d["after_block_near_tie"]
                     for d in out["answers"])
                 and all(d["near_tie"] for d in out["blocks"]))
    return out


def par_kernel_checks(sess, dkvs, gen, sp_offset=None) -> dict:
    """stream_attention and decode_attention against their plain versions
    on this rank's own state at a middle layer, at the rank's heads: the
    next 8-frame append of stream 0 (with sp_offset, this rank's half of
    its queries, offset in the kernel's scalars), and the decode cache
    `dkvs` of the fixed-block question."""
    from stc_tpu_torch.kvcache import engine
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa
    rekv, tc, dev = sess.rekv, sess.lm.cfg, sess.device
    li = tc.num_layers // 2
    kv = type(sess.kvs)(*(x[li, :1] for x in sess.kvs))
    T = rekv.exc_block_size
    rc = engine.make_rope_cache(kv.length, kv.num_blocks, T, rekv,
                                tc.head_dim, tc.rope_base, kv.page_offset)
    scal, Tq = rc.scalars, T
    if sp_offset is not None:
        scal, Tq = rc.scalars.clone(), T // 2
        scal[:, 0] += sp_offset
    q = torch.randn((1, tc.num_heads, Tq, tc.head_dim), generator=gen,
                    device=dev).bfloat16()
    args = (q, q.flip(2).contiguous(), kv.block_k, kv.block_v, rc.cos_cover,
            rc.sin_cover, kv.init_k, kv.init_v, kv.init_k, scal)
    stream = held("session state", sa.stream_attention(
        *args, n_local=rekv.n_local), sa.stream_attention_ref(
        *args, n_local=rekv.n_local))
    dkv = type(dkvs)(*(x[li, :1] for x in dkvs))
    Tq = 16
    qd = torch.randn((1, tc.num_heads, Tq, tc.head_dim), generator=gen,
                     device=dev).bfloat16()
    dargs = (qd, dkv.k, dkv.v, (dkv.cursor - Tq).to(torch.int32),
             dkv.cursor)
    decode = held("decode cache", da.decode_attention(
        *dargs, n_local=rekv.n_local, return_m=True),
        da.decode_attention_ref(*dargs, n_local=rekv.n_local, return_m=True))
    return {"heads": [tc.num_heads, tc.num_kv_heads, tc.head_dim],
            "q_offset": sp_offset, "stream_attention": stream,
            "decode_attention": decode,
            "agrees": stream["agrees"] and decode["agrees"]}


def par_rank(rank, world, layout, fault=None, device="cuda:0") -> dict:
    """One rank of a phase-16 layout (with a planted fault when `fault`
    names one): its model shard, its session, the phase's stream, its
    launch and collective counts, and its kernel checks.  Every rank runs
    on `device` (the one card)."""
    from stc_tpu_torch.models import llava_onevision as lo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with patched([] if fault is None else par_fault(fault)):
        t0 = time.perf_counter()
        mesh = par_mesh(layout)
        model, cfg = par_model(dev, mesh)
        sess = lo.build_session(model, par_scfg(),
                                state_dtype=torch.bfloat16, device=dev,
                                batch=PAR_B, mesh=mesh)
        build_s = time.perf_counter() - t0
        reset_counts()
        mesh.reset_stats()
        t1 = time.perf_counter()
        run = par_drive(sess)
        wall_s = time.perf_counter() - t1
        launches = read_counts()
        comm = mesh.stats_summary()
        gen = torch.Generator(device=dev).manual_seed(rank)
        checks = par_kernel_checks(
            sess, run.pop("dkvs"), gen, None if layout != "d" else
            mesh.coord["sp"] * sess.rekv.exc_block_size // 2)
    calls = {k: v["calls"] for k, v in comm.items()}
    mine = [a[sess._b0:sess._b0 + sess.batch]
            for a in run["answers"] + [run["fixed_answer"]]]
    tokens = sum(len(x) for a in mine[:-1] for x in a)
    steps = [max(len(x) for x in a) for a in mine]  # greedy loop steps
    return dict(rank=rank, coord=mesh.coord, layout=layout, fault=fault,
                **run, launches=launches, layers=sess.lm.cfg.num_layers,
                lm_forwards=sum(2 + s for s in steps), decode_steps=steps,
                tokens=tokens, comm=comm, calls=calls, checks=checks,
                build_s=build_s, wall_s=wall_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                device_ms_per_chunk=float(np.mean(run["chunk_ms"])),
                device_ms_per_token=sum(run["qa_ms"]) / max(tokens, 1))


def par_gates(layout, r) -> list:
    """The counts a rank of `layout` must show over par_drive: launches,
    and collectives per layer and per pass (names axis.op.site of
    Mesh.stats).  Every question (the fixed-block one too) makes a
    retrieval forward, a prefill and its greedy steps; the fixed-block
    one scores no blocks."""
    L = r["layers"]
    appends, fwd = PAR_CHUNKS, r["lm_forwards"]
    nq = len(PAR_QUESTIONS)
    passes = 1 + appends + fwd          # init append + appends + QA passes
    want = {"stream_attention": appends * L,
            "decode_attention": fwd * L}
    got = {"stream_attention": r["launches"]["stream_attention"]["float"],
           "decode_attention": r["launches"]["decode_attention"]}
    c = r["calls"]
    if layout in ("a", "b"):
        for site in ("qwen2.attn_out", "qwen2.mlp_out"):
            want[f"tp.all_reduce.{site}"] = passes * L
        want["tp.all_reduce.engine.retrieval_logits"] = nq * L
        want["tp.all_gather.qwen2.lm_head"] = fwd - (nq + 1)
    if layout == "b":
        want["dp.all_gather.dp.streams"] = 4 * (nq + 1)
    if layout == "c":
        s = r["coord"]["pp"]
        want["pp.send.pp.hop" if s == 0 else "pp.recv.pp.hop"] = passes
        want["pp.broadcast.pp.out"] = fwd - (nq + 1)
    if layout == "d":
        want["sp.all_gather.sp.kv"] = appends * L
        want["sp.all_gather.sp.pooled"] = PAR_CHUNKS
    for k in want:
        if k not in got:
            got[k] = c.get(k, 0)
    return [{"count": k, "got": got[k], "want": v} for k, v in want.items()
            if got[k] != v]


def par_launches(p16, kernel) -> dict:
    """Phase 16's launches of `kernel`, rank by rank of each layout."""
    out = {}
    for key, lay in p16["layouts"].items():
        for r in lay["per_rank"]:
            n = r["launches"][kernel]
            out[f"phase 16 ({key}) rank {r['rank']}"] = (
                n["float"] if isinstance(n, dict) else n)
    return out


def par_reference(dev) -> tuple:
    """The unsharded reference session's run (with nb, the streams'
    blocks, and topk), its model and session config."""
    from stc_tpu_torch.models import llava_onevision as lo
    scfg = par_scfg()
    model, _ = par_model(dev)
    sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                            device=dev, batch=PAR_B)
    reset_counts()
    t0 = time.perf_counter()
    ref = par_drive(sess)
    ref["wall_s"] = time.perf_counter() - t0
    ref.pop("dkvs")
    if ref["init_active"] != [False] * (PAR_CHUNKS - 1) + [True]:
        raise RuntimeError(f"init-fill pattern {ref['init_active']}")
    ref.update(nb=sess._total_blocks, topk=scfg.rekv.topk)
    return ref, model, scfg


def par_layout(key, ref, fault=None) -> tuple:
    """Layout `key` as gloo ranks on this card (with a planted fault when
    `fault` names one), judged against the reference: (its record, the
    failures of its ranks)."""
    from stc_tpu_torch.parallel import dryrun
    name, world = PAR_LAYOUTS[key]
    t0 = time.perf_counter()
    ranks = dryrun.launch(world, "chip_smoke:par_rank", (key, fault),
                          backend="gloo", timeout=600)
    lay = {"name": name, "ranks": world, "backend": "gloo", "fault": fault,
           "launch_s": time.perf_counter() - t0, "per_rank": []}
    num = par_numerics(par_rows(ranks, "kept"), par_merge(ranks, "cuts"),
                       par_rows(ranks, "fixed_logits"), ref)
    lay["numerics"] = num
    failures = []
    for r in ranks:
        dep = par_departures(r, ref)
        if key == "c" and not (r["answers"] == ref["answers"]
                               and r["blocks"] == ref["blocks"]):
            # the stages run the reference's arithmetic: no departure
            dep["ok"] = False
        bad = par_gates(key, r)
        lay["per_rank"].append({
            "rank": r["rank"], "coord": r["coord"],
            "answers_equal": r["answers"] == ref["answers"],
            "blocks_equal": r["blocks"] == ref["blocks"],
            "departures": dep, "count_failures": bad,
            "launches": r["launches"], "lm_forwards": r["lm_forwards"],
            "checks": r["checks"], "calls": r["calls"],
            "comm_ms": sum(v["ms"] for v in r["comm"].values()),
            "comm_bytes": sum(v["bytes"] for v in r["comm"].values()),
            "staged_bytes": sum(v["staged_bytes"]
                                for v in r["comm"].values()),
            "comm": r["comm"],
            "device_ms_per_chunk": r["device_ms_per_chunk"],
            "device_ms_per_token": r["device_ms_per_token"],
            "chunk_ms": r["chunk_ms"], "qa_ms": r["qa_ms"],
            "wall_s": r["wall_s"], "build_s": r["build_s"],
            "peak_mem_gb": r["peak_mem_gb"]})
        if not (num["ok"] and dep["ok"]) or bad or \
                not r["checks"]["agrees"]:
            failures.append({
                "layout": key, "rank": r["rank"], "numerics_ok": num["ok"],
                "answer_departures_unexplained": [
                    d for d in dep["answers"] if not (
                        d["near_tie"] or d["after_block_near_tie"])],
                "block_departures_not_near_tie": [
                    d for d in dep["blocks"] if not d["near_tie"]],
                "count_failures": bad,
                "kernel_checks_agree": r["checks"]["agrees"]})
    return lay, failures


def parallel_phase(card, dev) -> dict:
    """Phase 16 (see the module docstring): the reference, the NCCL
    world-1 session, then layouts (a)-(d) as gloo ranks on this card."""
    import torch.distributed as dist
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.parallel import dryrun
    from stc_tpu_torch.parallel import mesh as pm
    t_phase = time.perf_counter()
    ref, model, scfg = par_reference(dev)
    # NCCL, world 1: explicit collectives on card tensors, then layout
    # (a)'s code at tp 1 (every axis of size 1) on the reference's model
    pm.init_parallel("nccl", 0, 1, f"tcp://localhost:{dryrun.free_port()}")
    try:
        mesh = par_mesh("nccl")
        x = torch.arange(4, dtype=torch.float32, device=dev)
        y, g = x.clone(), [torch.empty_like(x)]
        dist.all_reduce(y)
        dist.all_gather(g, x)
        dist.broadcast(y, 0)
        ok = torch.equal(y, x) and torch.equal(g[0], x)
        nccl_sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                                     device=dev, batch=PAR_B, mesh=mesh)
        nccl = par_drive(nccl_sess)
        nccl_rec = {"collectives_ok": ok, "backend": dist.get_backend(),
                    "answers_equal": nccl["answers"] == ref["answers"],
                    "blocks_equal": nccl["blocks"] == ref["blocks"],
                    "comm": mesh.stats_summary()}
        del nccl_sess, nccl
    finally:
        dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()
    if not (nccl_rec["collectives_ok"] and nccl_rec["answers_equal"]):
        raise RuntimeError(f"NCCL world-1 session failed {nccl_rec}")
    out = {"phase": "parallel layouts", "card": card,
           "ranks_note": ("ranks are processes time-sliced on one H100, "
                          "backend gloo (collectives staged through host "
                          "memory): no scaling figure"),
           "limits": {"kept_tokens_parted": PAR_G0,
                      "layer0_scores": f"{PAR_G1} * A",
                      "fixed_logits_rms_rel": PAR_G2,
                      "answer_near_tie": "2 bf16 ulps of the top logit"},
           "reference": {"answers": ref["answers"],
                         "chunk_ms": ref["chunk_ms"], "qa_ms": ref["qa_ms"],
                         "wall_s": ref["wall_s"],
                         "init_active": ref["init_active"]},
           "nccl_world1": nccl_rec, "layouts": {}}
    failures = []
    for key in PAR_LAYOUTS:
        lay, bad = par_layout(key, ref)
        out["layouts"][key] = lay
        failures += bad
    out["seconds"] = time.perf_counter() - t_phase
    if failures:
        RECORD["phases"]["parallel"] = out
        raise RuntimeError(f"phase 16 failed: {failures}")
    return out


def par_planted_faults(card, dev) -> dict:
    """python3 chip_smoke.py --planted-faults: the phase-16 reference, then
    each planted fault (PAR_FAULTS) in its layout; each must fail the
    limits on numbers (par_numerics).  Raises if one passes."""
    t0 = time.perf_counter()
    ref, model, _ = par_reference(dev)
    del model
    torch.cuda.empty_cache()
    out = {"phase": "planted faults", "card": card, "faults": {}}
    passed = []
    for fault, key in PAR_FAULTS.items():
        lay, bad = par_layout(key, ref, fault)
        num = lay["numerics"]
        out["faults"][fault] = {
            "layout": lay["name"], "numerics": num,
            "answers_equal": [r["answers_equal"] for r in lay["per_rank"]],
            "count_failures": lay["per_rank"][0]["count_failures"],
            "rejected_by_numerics": not num["ok"],
            "rejected": bool(bad), "launch_s": lay["launch_s"]}
        emit({"phase": f"planted fault {fault}", "card": card,
              **out["faults"][fault]})
        if num["ok"]:
            passed.append(fault)
    out["seconds"] = time.perf_counter() - t0
    if passed:
        raise RuntimeError(f"planted faults not rejected: {passed}")
    return out


# --------------------------------------------------------------------------
# phase 17: the command-line entry points at llava-ov-7b width
# --------------------------------------------------------------------------

CLI_LAYERS = 4            # of llava-ov-7b's 28: the checkpoint's depth cut
CLI_VIDEOS = {"c16": 16, "c40": 40}     # raw frames at 360 x 640
QWEN2_SPECIAL_IDS = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                     "<|im_end|>": 151645}
CLI_CORPUS = [
    "<|im_start|>system \nYou are a helpful assistant.<|im_end|>"
    "<|im_start|>user ",
    "\nWhat does the person pick up first?<|im_end|><|im_start|>assistant\n",
    "Question: which tool is used\nOptions:\n(A) a knife\n(B) a saw\n"
    "Only give the best option.<|im_end|><|im_start|>assistant\n"
    "Best option: (",
    "It's 12 o'clock, THEY'LL see x² and Ⅻ   twice\t\tthen\r\n stop  ",
    "café 漢字 😀<|im_end|><|im_end|>",
]
CLI_DEMOS = {"stream_demo": ["--size", "0.5b", "--frames", "16",
                              "--question_every", "8"],
             "serve_demo": ["--size", "0.5b", "--ticks", "8", "--spec", "4",
                            "--migrate"]}
CLI_QUESTIONS = {
    "c16": [("what does the person pick up first",
             ["a cup", "a phone", "a book"], "a phone"),
            ("which hand is used", ["left", "right"], "right")],
    "c40": [("where does the walk end",
             ["a door", "a car", "a bench", "a shop"], "a bench"),
            ("what color is the bag", ["red", "blue", "green"], "green")],
}


def write_byte_level_tokenizer(path, corpus, n_merges=200) -> int:
    """A Qwen2-style tokenizer.json and tokenizer_config.json in `path`,
    written without the tokenizers library: GPT-2's 256 byte symbols at
    ids 0-255, up to n_merges byte-level BPE merges counted from `corpus`
    (the most frequent adjacent pair over its pre-tokenized words, the
    lowest pair on a tie), then tokens `<t{id}>` that no merge makes up
    to id 151642 (so that a random model's answers decode to text),
    Qwen2's special tokens at 151643-151645, NFC and Qwen2's Split +
    ByteLevel pre-tokenizer; eos_token <|im_end|>.  Returns the number of
    merges."""
    from stc_tpu_torch.runtime import tokenizer as tk
    words = {}
    for text in corpus:
        for part in re.split("|".join(map(re.escape, QWEN2_SPECIAL_IDS)),
                             text):
            for w in tk._split_isolated(unicodedata.normalize("NFC", part),
                                        tk._qwen2_match):
                w = tuple(tk.BYTE_CHAR[b] for b in w.encode())
                words[w] = words.get(w, 0) + 1
    vocab = {tk.BYTE_CHAR[b]: b for b in range(256)}
    merges = []
    for _ in range(n_merges):
        pairs = {}
        for w, n in words.items():
            for p in zip(w, w[1:]):
                pairs[p] = pairs.get(p, 0) + n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(" ".join(best))
        vocab.setdefault(best[0] + best[1], len(vocab))
        new = {}
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + n
        words = new
    for i in range(len(vocab), min(QWEN2_SPECIAL_IDS.values())):
        vocab[f"<t{i}>"] = i
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for t, i in QWEN2_SPECIAL_IDS.items()],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": tk.QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges}}
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<|im_end|>",
                   "clean_up_tokenization_spaces": False}, f)
    return len(merges)


def cli_annotation(paths) -> list:
    return [{"video_id": name, "video_path": paths[name],
             "duration": CLI_VIDEOS[name],
             "conversations": [mc(q, c, a) for q, c, a in qs]}
            for name, qs in CLI_QUESTIONS.items()]


def cli_counters():
    """A context that counts, at class level, the LM's video appends,
    retrieval forwards and decode_step forwards (prompt prefills, tokens
    and verify rounds), the tokenizer's seconds, and the sessions' QA
    calls, into the dict it yields."""
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.runtime.tokenizer import Tokenizer
    box = {"appends": 0, "retrievals": 0, "decode_steps": 0,
           "tokenizer_s": 0.0, "tokenizer_calls": 0}

    def count(key, pred=lambda k: True):
        def wrap(f):
            def g(*a, **k):
                if pred(k):
                    box[key] += 1
                return f(*a, **k)
            return g
        return wrap

    def clock(f):
        def g(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                box["tokenizer_s"] += time.perf_counter() - t0
                box["tokenizer_calls"] += 1
        return g

    @contextlib.contextmanager
    def ctx():
        with patched([
                (qw.Qwen2, "encode_step",
                 count("appends", lambda k: not k.get("is_init", False))),
                (qw.Qwen2, "qa_retrieve_step", count("retrievals")),
                (qw.Qwen2, "decode_step", count("decode_steps")),
                (Tokenizer, "encode", clock), (Tokenizer, "decode", clock)]):
            yield box

    return ctx()


def cli_phase(card, dev) -> dict:
    """Phase 17: the eval CLI, its tokenizer and the demos.  A llava-ov-7b
    checkpoint (Qwen2 3584 wide, 28/4 heads of 128, vocab 152064; SigLIP
    1152 x 27 at 384 px; depth cut to CLI_LAYERS layers) written as 2 bf16
    shards with the script's own tokenizer.json, an MLVU annotation over
    two .npy videos; then (1) `python -m stc_tpu_torch.cli.run_eval` as a
    subprocess (the two demos at 0.5b width run beside it as subprocesses:
    stream_demo over 16 frames, serve_demo for 8 ticks with --spec 4
    --migrate), (2) its main() in-process with the launch counts from 0,
    (3) run_eval over a session loaded here from the same directory, (4)
    --stream_batch 2.  Gates: every subprocess exits 0, no error row, (1)
    = (2) = (3), the tokenizer's decode of its encode = the NFC text over
    CLI_CORPUS and the init prompt's length = the session's n_init,
    launches = appends x layers and LM forwards x layers."""
    from stc_tpu_torch.cli import run_eval as cli
    from stc_tpu_torch.eval.runner import run_eval
    from stc_tpu_torch.models import MODEL_REGISTRY
    from stc_tpu_torch.runtime.adapter import ChatTemplate, SessionAdapter
    from stc_tpu_torch.runtime.tokenizer import load_tokenizer
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    work = tempfile.mkdtemp(prefix="stc_cli_")
    out = {"phase": "cli llava-ov-7b", "card": card,
           "layers": CLI_LAYERS, "seconds_by_step": {}}
    step = {"t": time.perf_counter()}

    def lap(name):
        now = time.perf_counter()
        out["seconds_by_step"][name] = now - step["t"]
        step["t"] = now

    demos = []
    try:
        ckpt = os.path.join(work, "ckpt")
        os.makedirs(ckpt)
        model, cfg = make_model(dev, seed=17, text=dict(
            QWEN2_7B, num_layers=CLI_LAYERS))
        tie_head_and_round_vision(model)
        out["checkpoint_bytes"] = write_hf_checkpoint(model, ckpt)
        del model
        torch.cuda.empty_cache()
        out["tokenizer_merges"] = write_byte_level_tokenizer(ckpt,
                                                             CLI_CORPUS)
        paths = write_eval_videos(work, CLI_VIDEOS, EVAL_HW, seed=17)
        anno = cli_annotation(paths)
        a_path = os.path.join(work, "anno.json")
        with open(a_path, "w") as f:
            json.dump(anno, f)
        lap("write")

        def argv(save, *extra):
            return ["--dataset", "mlvu", "--model_path", ckpt,
                    "--anno_path", a_path, "--save_dir",
                    os.path.join(work, save)] + list(extra)

        def rows(save):
            with open(os.path.join(work, save, "results_rank0.json")) as f:
                return json.load(f)

        # (1) the CLI as a subprocess, the demos beside it
        for name, args in CLI_DEMOS.items():
            cmd = [sys.executable, "-m", f"stc_tpu_torch.cli.{name}"] + args
            demos.append((name, cmd, subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        cmd = [sys.executable, "-m", "stc_tpu_torch.cli.run_eval"] + argv(
            "sub")
        t0 = time.perf_counter()
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600)
        out["subprocess_s"] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"phase 17: {' '.join(cmd)} exited "
                               f"{res.returncode}: {res.stderr[-3000:]}")
        out["subprocess_printed"] = json.loads(
            res.stdout.strip().splitlines()[-1])
        out["demos"] = {}
        for name, cmd, proc in demos:
            text, _ = proc.communicate(timeout=600)
            lines = text.strip().splitlines()
            out["demos"][name] = {"returncode": proc.returncode,
                                  "last_lines": lines[-3:]}
            if proc.returncode != 0:
                raise RuntimeError(f"phase 17: {' '.join(cmd)} exited "
                                   f"{proc.returncode}: {text[-3000:]}")
        demos = []
        lap("subprocesses")

        # (2) main() in-process, its launches counted from 0
        with cli_counters() as box:
            reset_counts()
            t0 = time.perf_counter()
            printed = cli.main(argv("main"))
            wall = time.perf_counter() - t0
            launches = read_counts()
        L, n_q = CLI_LAYERS, sum(len(s["conversations"]) for s in anno)
        forwards = box["retrievals"] + box["decode_steps"]
        want = {"stream_attention": {"float": L * box["appends"], "int8": 0,
                                     "int4": 0},
                "decode_attention": L * forwards, "decode_score": 0,
                "stream_attention_page_keep": 0}
        out.update({"launches": launches, "expected": want,
                    "appends": box["appends"], "lm_forwards": forwards,
                    "main_s": wall, "seconds_per_sample": wall / len(anno),
                    "tokenizer_ms_per_question":
                    box["tokenizer_s"] * 1e3 / n_q,
                    "tokenizer_calls": box["tokenizer_calls"],
                    "score": printed["score"]})
        lap("main")

        # (3) run_eval over a session loaded here; the tokenizer's gates
        tok = load_tokenizer(ckpt)
        args = cli.parse_args(argv("direct"))
        n_init = len(tok(ChatTemplate.init_prompt))
        sess, _ = MODEL_REGISTRY["llava_ov_7b"](
            ckpt, cli.session_config(args, n_init), device=dev,
            dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
        ad = SessionAdapter(sess, tok)
        direct, _ = run_eval("mlvu", ad, os.path.join(work, "direct"),
                             anno_path=a_path, rank=0, world=1)
        round_trip = [tok.decode(tok(t)) == unicodedata.normalize("NFC", t)
                      for t in CLI_CORPUS]
        out["n_init"] = {"init_prompt_ids": ad.init_prompt_len,
                         "session": sess.rekv.n_init}
        del sess
        torch.cuda.empty_cache()
        lap("direct")

        # (4) --stream_batch 2
        cli.main(argv("batch2", "--stream_batch", "2"))
        batched = rows("batch2")
        lap("stream_batch")
        sub, main_rows = rows("sub"), rows("main")
    finally:
        for _, _, proc in demos:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    bad = [r for r in sub + main_rows + direct + batched if "error" in r]
    out["rows"] = len(main_rows)
    out["batched_equal_rows"] = sum(a == b for a, b in zip(batched,
                                                            main_rows))
    out["answers"] = [r["pred_answer"] for r in main_rows]
    gates = {
        "no_error_row": not bad and len(main_rows) == n_q,
        "subprocess_rows_equal_main": sub == main_rows,
        "direct_rows_equal_main": direct == main_rows,
        "batched_rows": len(batched) == n_q,
        "decode_of_encode_is_nfc_text": all(round_trip),
        "init_prompt_is_n_init": len(set(out["n_init"].values())) == 1,
        "launches": launches == want and box["appends"] > 0
        and forwards > 0,
    }
    out["gates"] = gates
    out["seconds"] = time.perf_counter() - t_phase
    if not all(gates.values()):
        raise RuntimeError(f"phase 17 gates failed {gates}: launches "
                           f"{launches} expected {want}; errors {bad[:3]}")
    return out


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
    t_script = time.perf_counter()
    faults_only = sys.argv[1:] == ["--planted-faults"]
    if sys.argv[1:] and not faults_only:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    clock_mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rates = {"sm_clock_max_mhz": clock_mhz, "sms": sms,
             "bound_clock_mhz": H100_CLOCK_HZ / 1e6,
             "exp_per_s": H100_EXP_PER_S, "bytes_per_s": H100_BYTES_PER_S,
             "bf16_flops": H100_BF16_FLOPS}

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    if faults_only:
        pf = par_planted_faults(card, dev)
        emit({**{k: v for k, v in pf.items() if k != "faults"},
              "build_s": build_s,
              "rejected_by_numerics": {
                  k: v["rejected_by_numerics"]
                  for k, v in pf["faults"].items()},
              "script_seconds": time.perf_counter() - t_script})
        print(card, flush=True)
        return 0
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in _build.build_log.items()}
    tcore = tensor_core_check(paths, _build.build_log)
    t1 = time.perf_counter()
    parts = _build.build_all({
        p: ("decode_score", (f"STC_SCORE_DROP={i}",))
        for p, i in SCORE_PARTS.items()})
    parts_build_s = time.perf_counter() - t1
    emit({"phase": "build", "card": card, "rates": rates,
          "build_s": build_s, "parts_build_s": parts_build_s,
          "tf32": False, "instances": tcore,
          "seconds": time.perf_counter() - t0})
    RECORD["phases"]["build"] = {"build_s": build_s, "ptxas": regs,
                                 "instances": tcore, "card": card,
                                 "rates": rates,
                                 "seconds": time.perf_counter() - t0}

    # ---- phase 2: kernels vs plain, then planted faults ----
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    runs = [
        stream_case("stream empty window", 14, 2, 64, 60, 1, dev, gen),
        stream_case("stream 100 pages", 14, 2, 64, 60, 100, dev, gen),
        stream_case("stream 300 pages init_active", 14, 2, 64, 60, 300, dev,
                    gen),
        stream_case("stream 8-page append", 14, 2, 64, 480, 200, dev, gen),
        stream_case("stream 7B heads", 28, 4, 128, 60, 150, dev, gen),
        stream_case("stream 8-page append 7B heads (28/4/128), 264 pages",
                    28, 4, 128, 480, 264, dev, gen),
        stream_case("stream int8 300 pages init_active", 14, 2, 64, 60, 300,
                    dev, gen, quant="int8"),
        stream_case("stream int4 300 pages init_active", 14, 2, 64, 60, 300,
                    dev, gen, quant="int4"),
        stream_case("stream int8 8-page append (T 480), 264 pages", 14, 2,
                    64, 480, 264, dev, gen, quant="int8"),
        stream_case("stream int8 7B heads (28/4/128), 264 pages", 28, 4, 128,
                    480, 264, dev, gen, quant="int8"),
        stream_case("stream int4 7B heads (28/4/128), 264 pages", 28, 4, 128,
                    480, 264, dev, gen, quant="int4"),
        stream_case(B4_STREAM, 14, 2, 64, 60, 0, dev, gen, Nb=320, exc=60,
                    states=B4_STATES_05B),
        stream_case(B4_STREAM_INT8, 28, 4, 128, 480, 0, dev, gen, Nb=320,
                    quant="int8", states=B4_STATES_7B),
        stream_case(KEEP_05B, 14, 2, 64, 480, 264, dev, gen, keep=True),
        stream_case(KEEP_7B_INT8, 28, 4, 128, 480, 264, dev, gen,
                    quant="int8", keep=True),
        decode_case("decode prefill T=256", 256, 3854, 3854 + 256, 15000,
                    dev, gen, return_m=True),
        decode_case("decode token T=1", 1, 4200, 4201, 15000, dev, gen),
        decode_case("decode expired window", 16, 2000, 4352, 64, dev, gen),
        decode_case("decode prefill T=256 7B heads (28/4/128)", 256, 3854,
                    3854 + 256, 15000, dev, gen, Hq=28, Hkv=4, D=128,
                    return_m=True),
        decode_case("decode token T=1 7B heads (28/4/128)", 1, 4200, 4201,
                    15000, dev, gen, Hq=28, Hkv=4, D=128),
        decode_case(B4_DECODE, 1, [900, 1500, 3000, 4200],
                    [901, 1501, 3001, 4201], 15000, dev, gen),
        decode_case("decode B=4 prefill T=64, own cursors, n_local 1024",
                    64, [100, 900, 2500, 4288], [164, 964, 2564, 4352], 1024,
                    dev, gen),
        decode_case(VERIFY_DECODE, 5, VERIFY_STARTS,
                    [s + 5 for s in VERIFY_STARTS], 15000, dev, gen),
        stream_case(VL_STREAM, 32, 32, 128, 257, 48, dev, gen, n_local=8000,
                    S=257, Nb=128, exc=257, rope_base=1e4),
        stream_case(LV_STREAM, 28, 4, 128, 144, 80, dev, gen, n_local=8000,
                    S=144, Nb=512, exc=144),
        stream_case(FV_STREAM, 32, 32, 128, 64, 96, dev, gen, n_local=4000,
                    S=64, Nb=256, exc=64, rope_base=1e4),
        decode_case(VL_DECODE_PREFILL, 256, 2070, 2070 + 256, 8000, dev, gen,
                    Hq=32, Hkv=32, D=128, C=2816, return_m=True),
        decode_case(VL_DECODE_TOKEN, 1, 2400, 2401, 8000, dev, gen, Hq=32,
                    Hkv=32, D=128, C=2816),
        stream_case(TP2_STREAM, 14, 2, 128, 480, 264, dev, gen),
        stream_case(TP4_STREAM, 7, 1, 128, 480, 264, dev, gen),
        stream_case(SP_STREAM, 28, 4, 128, 480, 264, dev, gen,
                    q_part=(240, 240)),
        decode_case(TP2_DECODE_TOKEN, 1, 4200, 4201, 15000, dev, gen,
                    Hq=14, Hkv=2, D=128),
        decode_case(TP4_DECODE_TOKEN, 1, 4200, 4201, 15000, dev, gen, Hq=7,
                    Hkv=1, D=128),
        decode_case(TP2_DECODE_PREFILL, 256, 3854, 3854 + 256, 15000, dev,
                    gen, Hq=14, Hkv=2, D=128, return_m=True),
        decode_case(TP4_DECODE_PREFILL, 256, 3854, 3854 + 256, 15000, dev,
                    gen, Hq=7, Hkv=1, D=128, return_m=True),
        score_case("decode_score prefill T=256 at slot 3854", 256, 3854,
                   3854 + 256, 15000, dev, gen, parts=parts),
        score_case("decode_score expired window (n_local 64)", 16, 2000,
                   4352, 64, dev, gen),
        score_case("decode_score prefill T=256 at slot 3854 7B heads "
                   "(28/4/128)", 256, 3854, 3854 + 256, 15000, dev, gen,
                   Hq=28, Hkv=4, D=128, parts=parts),
    ]
    cases = [r[0] for r in runs]
    for c in cases:
        c["card"] = card
        c["sm_clock_max_mhz"] = clock_mhz
        emit(c)
        if not c["agrees"] or not c.get("f32_agrees", True):
            raise RuntimeError(f"{c['case']}: kernel disagrees with its "
                               f"plain version {c}")
    faults = planted_faults({r[0]["case"]: r[1:] for r in runs})
    del runs
    emit({"phase": "planted faults", "limits": {"max_rel": MAX_REL,
                                                "rms_rel": RMS_REL},
          "faults": faults, "seconds": time.perf_counter() - t_phase})
    missed = [f["fault"] for f in faults if not f["rejected"]]
    if missed:
        raise RuntimeError(f"the limits let these faults pass: {missed}")
    RECORD["phases"]["kernels"] = cases
    RECORD["phases"]["faults"] = faults

    # ---- phase 3: the main path at llava-ov-0.5b width ----
    t_phase = time.perf_counter()
    model, cfg = make_model(dev, seed=0)
    scfg = session_cfg(15000, 64, 256, 16, 8, 1024)
    sess = lo.build_session(model, scfg, state_dtype=torch.bfloat16,
                            device=dev)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(44, 384, 384, 3), dtype=np.uint8)
    n_append = 0
    lm_forwards = 0
    reset_counts()
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
    launches = read_counts()
    want = {"stream_attention": {"float": 24 * n_append, "int8": 0,
                                 "int4": 0},
            "decode_attention": 24 * lm_forwards, "decode_score": 0,
            "stream_attention_page_keep": 0}
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
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "seconds": time.perf_counter() - t_phase}
    emit(p3)
    RECORD["phases"]["session"] = p3

    # ---- phase 4: crossing the init-fill trigger ----
    t_phase = time.perf_counter()
    scfg2 = session_cfg(1200, 8, 128, 32, 1, 64)
    sess2 = lo.build_session(model, scfg2, state_dtype=torch.bfloat16,
                             device=dev)
    if scfg2.rekv.decode_cap > scfg2.rekv.n_local:
        raise RuntimeError("phase 4 must keep decode_cap <= n_local")
    reset_counts()
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
    launches2 = read_counts()
    want2 = {"stream_attention": {"float": 24 * 24, "int8": 0, "int4": 0},
             "decode_attention": 24 * (2 + len(out)), "decode_score": 0,
             "stream_attention_page_keep": 0}
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
          "launches": launches2, "expected": want2,
          "seconds": time.perf_counter() - t_phase}
    emit(p4)
    RECORD["phases"]["init_fill"] = p4
    if not state_check["agrees"] or int(rc.scalars[0, 3]) != 1:
        raise RuntimeError(f"init-fill state check failed {state_check}")

    # ---- phase 5: where the time goes (not the main path's counts) ----
    t_phase = time.perf_counter()
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
    p5["seconds"] = time.perf_counter() - t_phase
    emit(p5)
    RECORD["phases"]["time_split"] = p5
    # free the 0.5b model before the 7B one (closures above hold it too)
    del sess, sess2, model, vis, lm, kv0, args, kern, chunk_targets, \
        lm_layer, vl, vf, vc
    torch.cuda.empty_cache()

    # ---- phases 6-7: llava-ov-7b width on int8 and int4 page stores ----
    model7, cfg7 = make_model(dev, seed=7, text=QWEN2_7B)
    two_questions = [(list(range(200, 212)), list(range(300, 316))),
                     (list(range(400, 409)), list(range(500, 516)))]
    torch.cuda.reset_peak_memory_stats()
    p6 = stream_phase(model7, cfg7,
                      session_cfg(15000, 64, 256, 16, 8, 1024,
                                  kv_quant="int8"), "int8 pages", 40,
                      two_questions, card, dev, gen)
    emit(p6)
    RECORD["phases"]["session_7b_int8"] = p6
    torch.cuda.reset_peak_memory_stats()
    p7 = stream_phase(model7, cfg7,
                      session_cfg(15000, 64, 256, 16, 8, 1024,
                                  kv_quant="int4"), "int4 pages", 40,
                      two_questions[:1], card, dev, gen)
    emit(p7)
    RECORD["phases"]["session_7b_int4"] = p7
    del model7
    torch.cuda.empty_cache()

    # ---- phase 8: bench.py's 7b mode: int8 weights, bf16 vision; on
    # int8 (cell E1) three questions with speculation off and on ----
    three_questions = two_questions + [(list(range(600, 612)),
                                        list(range(700, 716)))]
    for wq in ("int8", "int8_g128"):
        p8 = weights_phase(wq, two_questions, card, dev, gen, after=(
            (lambda s: spec_session_questions(s, three_questions, [151645]))
            if wq == "int8" else None))
        emit(p8)
        RECORD["phases"][f"session_7b_{wq}_weights"] = p8
        if "after" in p8 and not p8["after"]["ok"]:
            raise RuntimeError(f"7B speculative answers part from greedy "
                               f"away from a near-tie {p8['after']}")
        if "after" in p8:
            spec7 = p8["after"]

    # ---- phase 9: the HF loader at llava-ov-0.5b width ----
    p9 = loader_phase(card, dev)
    emit(p9)
    RECORD["phases"]["loader"] = p9

    # ---- phase 10: the host tier at llava-ov-7b width ----
    p10 = host_tier_phase(card, dev)
    emit(p10)
    RECORD["phases"]["host_tier"] = p10

    # ---- phase 11: ragged multi-stream at llava-ov-0.5b width ----
    p11 = multistream_phase(card, dev)
    emit(p11)
    RECORD["phases"]["multi_stream"] = p11

    # ---- phase 12: serving, speculative decode, migration (0.5b) ----
    p12 = serving_phase(card, dev)
    emit({k: v for k, v in p12.items() if k not in (
        "a_greedy", "b_speculative", "c_reference")})
    RECORD["phases"]["serving"] = p12
    a12, b12 = p12["a_greedy"], p12["b_speculative"]
    emit({"phase": "serving summary", "card": card,
          "seconds": p12["seconds"],
          "frames_per_s_encode_only": a12["frames_per_s_encode_only"],
          "frames_per_s_encode_ticks_qa_included": a12[
              "frames_per_s_encode_ticks_qa_included"],
          "tick_ms_p50_spec_off": a12["tick_ms_p50"],
          "tick_ms_p50_spec_on": b12["tick_ms_p50"],
          "spec": b12["spec"], "stats": a12["stats"],
          "decode_attention_launches": {
              "a": a12["launches"]["decode_attention"],
              "b": b12["launches"]["decode_attention"]},
          "migration": a12["migration"],
          "spec_7b": {"qa_p50_s_off_on": [spec7["greedy"]["qa_p50_s"],
                                          spec7["speculative"]["qa_p50_s"]],
                      "spec": spec7["speculative"]["spec"],
                      "departures": len(spec7["departures"])}})

    # ---- phase 13: the ablation paths and YUV ingest (0.5b) ----
    p13 = ablation_phase(card, dev, gen, p3["ingest_fps_8frame_chunks"])
    emit(p13)
    RECORD["phases"]["ablations"] = p13

    # ---- phase 14: the CLIP backbones at 7B width ----
    p14 = clip_backbones_phase(card, dev)
    RECORD["phases"]["clip_backbones"] = p14
    emit({"phase": "clip backbones summary", "card": card,
          "seconds": p14["seconds"],
          **{k: {"frames_per_s": r["frames_per_s"],
                 "frames_per_s_full_cached": [
                     r["frames_per_s_full_chunks"],
                     r["frames_per_s_cached_chunks"]],
                 "qa_latency_s_p50": r["qa_latency_s_p50"],
                 "page_store_gb": r["page_store_gb"],
                 "weight_gb": r["weight_gb"],
                 "cache_stats": r["cache_stats"],
                 "time_split": r["time_split"], "seconds": r["seconds"]}
             for k, r in p14.items() if k != "seconds"}})

    # ---- phase 15: the eval harnesses at llava-ov-7b width ----
    p15 = eval_phase(card, dev)
    RECORD["phases"]["eval"] = p15
    emit({k: v for k, v in p15.items() if k not in (
        "chunk_flops_1frame", "chunk_flops_8frame")})
    emit({"phase": "eval chunk flops", "card": card,
          "bf16_peak_flops": H100_BF16_FLOPS,
          "one_frame": p15["chunk_flops_1frame"],
          "eight_frame": p15["chunk_flops_8frame"]})
    emit({"phase": "eval summary", "card": card,
          "seconds": p15["seconds"],
          "ingest_frames_per_s": p15["ingest_frames_per_s"],
          "qa_p50_s": {k: [r["qa_p50_s_mc"], r["qa_p50_s_open"]]
                       for k, r in p15["protocols"].items()},
          "seconds_per_sample": {k: r["seconds_per_sample"]
                                 for k, r in p15["protocols"].items()},
          "kv_memory_gb": p15["kv_memory_gb"], "gates": p15["gates"],
          "batched_equal_rows": [p15["d_batched"]["equal_rows"],
                                 p15["d_batched"]["rows"]],
          "tflops_per_s": {
              f"{c['frames']}-frame {c['path']}": c["tflops_per_s"]
              for c in p15["chunk_flops_1frame"][:2]
              + p15["chunk_flops_8frame"]}})

    # ---- phase 16: parallel layouts at llava-ov-7b width ----
    p16 = parallel_phase(card, dev)
    RECORD["phases"]["parallel"] = p16
    emit({k: v for k, v in p16.items() if k != "layouts"})
    for key, lay in p16["layouts"].items():
        emit({"phase": f"parallel layout ({key})", "card": card,
              **{k: v for k, v in lay.items() if k != "per_rank"},
              "per_rank": [{k: v for k, v in r.items() if k not in (
                  "comm", "calls", "chunk_ms", "qa_ms")}
                  for r in lay["per_rank"]]})
    emit({"phase": "parallel summary", "card": card,
          "seconds": p16["seconds"], "note": p16["ranks_note"],
          "nccl_world1": {k: v for k, v in p16["nccl_world1"].items()
                          if k != "comm"},
          **{key: {"answers_equal": [r["answers_equal"]
                                     for r in lay["per_rank"]],
                   "blocks_equal": [r["blocks_equal"]
                                    for r in lay["per_rank"]],
                   "device_ms_per_chunk": [r["device_ms_per_chunk"]
                                           for r in lay["per_rank"]],
                   "device_ms_per_token": [r["device_ms_per_token"]
                                           for r in lay["per_rank"]],
                   "comm_ms": [r["comm_ms"] for r in lay["per_rank"]],
                   "comm_bytes": [r["comm_bytes"] for r in lay["per_rank"]],
                   "wall_s": [r["wall_s"] for r in lay["per_rank"]]}
             for key, lay in p16["layouts"].items()}})

    # ---- phase 17: the command-line entry points at llava-ov-7b width ----
    p17 = cli_phase(card, dev)
    RECORD["phases"]["cli"] = p17
    emit(p17)

    # ---- the kernels line, then the device line ----
    def bound_by(c):
        """bound_by as one word; terms that tie are listed beside it."""
        terms = c["bound_by"].split("=")
        return {"bound_by": terms[0],
                **({"bound_ties": terms} if len(terms) > 1 else {})}

    def times(c):
        return {"case": c["case"], "ms": c["kernel_ms"],
                "host_ms": c["host_ms"], "plain_ms": c["plain_ms"],
                "library_ms": c["library_ms"], "bound_ms": c["bound_ms"],
                **bound_by(c),
                **({"f32_ms": c["f32_ms"]} if "f32_ms" in c else {})}

    def entry(name, source, replaces, main_case, n_launches, path,
              also=(), by_path=None):
        rows = [c for c in cases if c["kernel"] == name]
        m = next(c for c in rows if c["case"] == main_case)
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n_launches,
             "launches_on": path,
             "max_abs_err": max(c["max_abs_err"] for c in rows),
             "max_rel_err": max(c["max_rel_err"] for c in rows),
             "rms_rel_err": max(c["rms_rel_err"] for c in rows),
             "ms": m["kernel_ms"], "host_ms": m["host_ms"],
             "plain_ms": m["plain_ms"],
             "bound_ms": m["bound_ms"], **bound_by(m),
             "library_ms": m["library_ms"], "case": main_case,
             "design": DESIGN}
        for k in ("bf16_pages_ms", "f32_ms"):
            if k in m:
                e[k] = m[k]
        if by_path:
            e["launches_by_path"] = by_path
        if also:
            e["also"] = [times(c) for c in rows if c["case"] in also]
        return e

    sa_src, sa_tpu = ("stc_tpu_torch/csrc/stream_attention.cu",
                      "stc_tpu/ops/stream_attention.py:307")
    da_src = "stc_tpu_torch/csrc/decode_attention.cu"
    set_a, set_c = p10["settings"][0], p10["settings"][2]
    kernels = [
        entry("stream_attention", sa_src, sa_tpu,
              "stream 300 pages init_active",
              launches["stream_attention"]["float"], "phase 3",
              also=("stream 8-page append",
                    "stream 8-page append 7B heads (28/4/128), 264 pages",
                    B4_STREAM, VL_STREAM, LV_STREAM, FV_STREAM, TP2_STREAM,
                    TP4_STREAM, SP_STREAM),
              by_path={"phase 3": launches["stream_attention"]["float"],
                       "phase 10 (a)":
                       set_a["launches"]["stream_attention"]["float"],
                       "phase 11": p11["launches"]["stream_attention"][
                           "float"],
                       "phase 12 (a)": a12["launches"]["stream_attention"][
                           "float"],
                       **{f"phase 14 ({k})": r["launches"][
                           "stream_attention"]["float"]
                          for k, r in p14.items() if k != "seconds"},
                       **{f"phase 15 ({k})": c["stream_attention"]["float"]
                          for k, c in p15["launches"].items()},
                       **par_launches(p16, "stream_attention"),
                       "phase 17 (cli main)": p17["launches"][
                           "stream_attention"]["float"]}),
        entry("stream_attention_int8", sa_src, sa_tpu,
              "stream int8 7B heads (28/4/128), 264 pages",
              p6["launches"]["stream_attention"]["int8"], "phase 6",
              also=(B4_STREAM_INT8,),
              by_path={"phase 6": p6["launches"]["stream_attention"]["int8"],
                       "phase 10 (c)":
                       set_c["launches"]["stream_attention"]["int8"]}),
        entry("stream_attention_page_keep", sa_src, sa_tpu, KEEP_05B,
              p13["a_window_compression"]["launches"][
                  "stream_attention_page_keep"], "phase 13 (a)",
              also=(KEEP_7B_INT8,)),
        entry("stream_attention_int4", sa_src, sa_tpu,
              "stream int4 7B heads (28/4/128), 264 pages",
              p7["launches"]["stream_attention"]["int4"], "phase 7"),
        entry("decode_attention", da_src,
              "stc_tpu/ops/decode_attention.py:143", "decode token T=1",
              launches["decode_attention"], "phase 3",
              also=("decode prefill T=256",
                    "decode prefill T=256 7B heads (28/4/128)",
                    "decode token T=1 7B heads (28/4/128)", B4_DECODE,
                    VERIFY_DECODE, VL_DECODE_PREFILL, VL_DECODE_TOKEN,
                    TP2_DECODE_TOKEN, TP4_DECODE_TOKEN, TP2_DECODE_PREFILL,
                    TP4_DECODE_PREFILL),
              by_path={"phase 3": launches["decode_attention"],
                       "phase 10 (a)": set_a["launches"]["decode_attention"],
                       "phase 11": p11["launches"]["decode_attention"],
                       "phase 12 (a)": a12["launches"]["decode_attention"],
                       "phase 12 (b)": b12["launches"]["decode_attention"],
                       **{f"phase 14 ({k})": r["launches"][
                           "decode_attention"]
                          for k, r in p14.items() if k != "seconds"},
                       **{f"phase 15 ({k})": c["decode_attention"]
                          for k, c in p15["launches"].items()},
                       **par_launches(p16, "decode_attention"),
                       "phase 17 (cli main)": p17["launches"][
                           "decode_attention"]}),
        entry("decode_score", "stc_tpu_torch/csrc/decode_score.cu",
              "stc_tpu/ops/decode_attention.py:244",
              "decode_score prefill T=256 at slot 3854", 0,
              "no session path calls it",
              also=("decode_score prefill T=256 at slot 3854 7B heads "
                    "(28/4/128)",)),
    ]
    RECORD["kernels"] = kernels
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    emit({"phase": "timing", "card": card,
          "phase_seconds": {k: v["seconds"] for k, v in
                            RECORD["phases"].items() if "seconds" in v},
          "script_seconds": time.perf_counter() - t_script})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
