"""Continuous-batching serving demo + smoke of the port (the counterpart of
``scripts/serve_demo.py``): multiplexes N logical streams (each its own
synthetic feature stream and question traffic) onto one batched session
through the ServingEngine, with mid-run stream churn (retire/admit) and an
optional slot migration through a stream checkpoint file.  Prints per-tick
and aggregate stats (fused-tick ratio, answers, churn).

Runs with random weights from a seeded torch.Generator (no checkpoint
needed), on the card unless given ``--device cpu``:

  python -m stc_tpu_torch.cli.serve_demo --slots 4 --ticks 24 --size tiny \\
      --device cpu
  python -m stc_tpu_torch.cli.serve_demo --slots 4 --ticks 24 --size 0.5b \\
      --spec 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def build(size: str, spec: int, slots: int, device: torch.device):
    """(session, question vocab) of the demo's Qwen2: `size` 'tiny'
    (float32) or '0.5b' (llava-ov-0.5b's LM, bfloat16), seed 0, `slots`
    streams, speculative decode with `spec` draft tokens."""
    from stc_tpu_torch.config import ReKVConfig, SessionConfig
    from stc_tpu_torch.models import qwen2 as qw
    from stc_tpu_torch.runtime.session import StreamingSession

    if size == "tiny":
        mcfg = qw.Qwen2Config.tiny()
        rekv = ReKVConfig(n_init=4, n_local=128, block_size=8,
                          exc_block_size=8, topk=4, max_blocks=256,
                          max_prompt_tokens=16, max_new_tokens=8,
                          spec_decode_draft=spec,
                          spec_history_tokens=256 if spec else 0)
        q_vocab = mcfg.vocab_size
    else:
        mcfg = qw.Qwen2Config(vocab_size=151936, hidden_size=896,
                              num_layers=24, num_heads=14, num_kv_heads=2,
                              head_dim=64, intermediate_size=4864,
                              rope_base=1e6)
        rekv = ReKVConfig(n_init=14, n_local=15000, block_size=60,
                          exc_block_size=60, topk=64, max_blocks=1024,
                          max_prompt_tokens=64, max_new_tokens=16,
                          spec_decode_draft=spec,
                          spec_history_tokens=512 if spec else 0)
        q_vocab = 1000
    dtype = torch.float32 if size == "tiny" else torch.bfloat16
    lm = qw.Qwen2(mcfg, dtype=dtype, device=device)
    lm.init_random_params(torch.Generator(device=device).manual_seed(0))
    sess = StreamingSession(lm, SessionConfig(rekv=rekv), batch=slots,
                            state_dtype=dtype)
    return sess, q_vocab


def main(argv=None) -> dict:
    """Runs the demo; returns the answers ({request id: {slot, tokens}})
    and the engine's stats."""
    from stc_tpu_torch.cli import launch_counts
    from stc_tpu_torch.device import resolve_device
    from stc_tpu_torch.runtime.serving import ServingEngine
    from stc_tpu_torch.utils.checkpoint import (load_stream_state,
                                                save_stream_state)
    from stc_tpu_torch.utils.metrics import device_sync

    ap = argparse.ArgumentParser(prog="python -m stc_tpu_torch.cli.serve_demo")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--size", choices=["tiny", "0.5b"], default="tiny")
    ap.add_argument("--spec", type=int, default=0,
                    help="spec_decode_draft (0 = plain greedy)")
    ap.add_argument("--churn_at", type=int, default=None,
                    help="tick at which stream 1 ends and a new one is "
                    "admitted into its slot (default: ticks//2)")
    ap.add_argument("--migrate", action="store_true",
                    help="also checkpoint stream 0 and restore it into the "
                    "recycled slot (save_stream_state round trip)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a card only 'cpu' runs")
    args = ap.parse_args(argv)
    churn_at = args.churn_at if args.churn_at is not None else args.ticks // 2
    device = resolve_device(args.device)
    sess, q_vocab = build(args.size, args.spec, args.slots, device)
    rekv, hidden = sess.rekv, sess.mcfg.hidden_size
    sess.encode_init_prompt(list(range(rekv.n_init)))
    eng = ServingEngine(sess, stop_token_ids=[0],
                        max_new_tokens=rekv.max_new_tokens)

    rng = np.random.default_rng(0)

    def chunk():
        return rng.normal(size=(rekv.block_size, hidden)
                          ).astype(np.float32) * 0.02

    def question(slot, tick):
        n = 4 + (slot + tick) % 5
        return (list(rng.integers(1, q_vocab, size=n)),
                list(rng.integers(1, q_vocab, size=n + 2)))

    print(f"serving {args.slots} streams, {args.ticks} ticks, "
          f"spec_decode_draft={args.spec}, churn at tick {churn_at}")
    answers = {}
    with tempfile.TemporaryDirectory(prefix="stc_serve_") as work:
        t0 = time.perf_counter()
        for tick in range(args.ticks):
            # per-slot arrival pattern: slot s ticks every s+1 steps
            for s in range(args.slots):
                if eng.is_free(s):
                    continue
                if tick % (s + 1) == 0:
                    eng.submit_chunk(s, chunk())
                if (tick + s) % 5 == 4:
                    q, p = question(s, tick)
                    eng.submit_question(s, q, p)
            if tick == churn_at and args.slots > 1:
                blob = None
                if args.migrate:
                    blob = os.path.join(work, "stream0.npz")
                    save_stream_state(sess, 0, blob)
                eng.retire(1)
                slot = eng.admit()
                if blob is not None:
                    load_stream_state(sess, slot, blob)
                    print(f"  tick {tick}: stream 1 retired; stream 0 cloned "
                          f"into slot {slot} via {blob}")
                else:
                    print(f"  tick {tick}: stream 1 retired; fresh stream "
                          f"admitted into slot {slot}")
            res = eng.step()
            answers.update(res)
            for rid, r in res.items():
                print(f"  tick {tick}: slot {r['slot']} answered rid={rid} "
                      f"({len(r['tokens'])} tokens)")
        answers.update(eng.run())  # drain
        sync = device_sync(device)
        if sync:
            sync()
        dt = time.perf_counter() - t0
    st = eng.stats
    if device.type == "cuda":
        print(json.dumps({"kernel_launches": launch_counts()}))
    print(f"done in {dt:.1f}s: {st.ticks} ticks ({st.fused_ticks} fused), "
          f"{st.encode_chunks} chunks, {st.answers} answers, "
          f"{st.streams_retired} retired / {st.streams_admitted} admitted")
    print(f"per-slot chunks {st.slot_chunks} answers {st.slot_answers}")
    if eng.route_decisions:
        print(f"serve routing settled: {eng.route_decisions}")
    if not (st.answers >= len(answers) and st.encode_chunks > 0):
        raise RuntimeError(f"serving stats {st} for {len(answers)} answers")
    sys.stdout.flush()
    return {"answers": answers, "stats": dataclasses.asdict(st)}


if __name__ == "__main__":
    main(sys.argv[1:])
