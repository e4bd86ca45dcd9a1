"""Streaming session demo + smoke of the port (the counterpart of
``scripts/stream_demo.py``): synthesizes a video stream, runs the full STC
pipeline (cacher + pruner + ReKV), asks questions mid-stream, prints live
throughput/latency metrics.

Runs with random weights from a seeded torch.Generator (no checkpoint
needed), on the card unless given ``--device cpu`` (float32 there, bfloat16
on the card):

  python -m stc_tpu_torch.cli.stream_demo --frames 32 --size tiny
  python -m stc_tpu_torch.cli.stream_demo --frames 64 --size 0.5b  # real shapes
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build(size: str, device: torch.device):
    """(session, tokens a frame, frame side) of the demo's model: `size`
    'tiny' or '0.5b' (llava-ov-0.5b's widths), seed 0."""
    from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                      SessionConfig)
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.models import siglip as sg

    if size == "tiny":
        cfg = lo.LlavaOVConfig.tiny()
        rekv = ReKVConfig(n_init=4, n_local=256, block_size=3,
                          exc_block_size=3, topk=4, max_blocks=128,
                          max_prompt_tokens=32, max_new_tokens=8)
        tpf, hw = 3, 56
    else:
        cfg = lo.LlavaOVConfig(
            vision=sg.SiglipConfig(),
            text=qw.Qwen2Config(vocab_size=151936, hidden_size=896,
                                num_layers=24, num_heads=14, num_kv_heads=2,
                                head_dim=64, intermediate_size=4864,
                                rope_base=1e6))
        rekv = ReKVConfig(n_init=14, n_local=15000, block_size=60,
                          exc_block_size=60, topk=64, max_blocks=1024,
                          max_prompt_tokens=256, max_new_tokens=32)
        tpf, hw = 60, 384
    scfg = SessionConfig(rekv=rekv, cacher=CacherConfig(),
                         pruner=PrunerConfig(token_per_frame=tpf))
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = lo.LlavaOV(cfg, dtype=dtype, vision_dtype=dtype, device=device)
    model.init_random_params(torch.Generator(device=device).manual_seed(0))
    sess = lo.build_session(model, scfg, state_dtype=dtype, device=device)
    return sess, tpf, hw


def main(argv=None) -> dict:
    """Runs the demo; returns its summary, answers and host-tier pages."""
    from stc_tpu_torch.cli import launch_counts
    from stc_tpu_torch.device import resolve_device
    from stc_tpu_torch.utils.metrics import StreamingStats, device_sync

    ap = argparse.ArgumentParser(prog="python -m stc_tpu_torch.cli.stream_demo")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", choices=["tiny", "0.5b"], default="tiny")
    ap.add_argument("--question_every", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a card only 'cpu' runs")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sess, tpf, hw = build(args.size, device)
    rekv = sess.rekv
    sync = device_sync(device)
    stats = StreamingStats()

    sess.encode_init_prompt(list(range(rekv.n_init)))
    rng = np.random.default_rng(0)
    print(f"streaming {args.frames} frames ({args.size} shapes, "
          f"{tpf} tokens/frame after pruning)...")
    answers = []
    for i in range(args.frames):
        frame = rng.integers(0, 256, (1, hw, hw, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        sess.encode_video(frame)
        if i % 8 == 7 and sync:  # periodic hard sync for honest numbers
            sync()
        stats.record_frame(time.perf_counter() - t0, tokens=tpf)

        if (i + 1) % args.question_every == 0:
            t0 = time.perf_counter()
            ans = sess.question_answering(
                [5, 6, 7], [5, 6, 7, 8], stop_token_ids=[0],
                max_new_tokens=rekv.max_new_tokens)
            stats.record_qa(time.perf_counter() - t0)
            answers.append(ans)
            print(f"  t={i + 1:4d}f  QA -> {len(ans)} tokens "
                  f"({stats.qa_times[-1] * 1e3:.0f} ms)")

    s = stats.summary(sess.kv_memory_bytes())
    pages = sess.host_store.total_pages
    if device.type == "cuda":
        sync()
        print(json.dumps({"kernel_launches": launch_counts()}))
    print(f"done: {s['fps']:.1f} fps | p50 {s['frame_p50_ms']:.1f} ms | "
          f"p95 {s['frame_p95_ms']:.1f} ms | {s['questions']} questions | "
          f"KV {s['kv_memory_gb'] * 1024:.1f} MB | "
          f"host tier: {pages} pages", flush=True)
    return {"summary": s, "answers": answers, "host_pages": pages}


if __name__ == "__main__":
    main(sys.argv[1:])
