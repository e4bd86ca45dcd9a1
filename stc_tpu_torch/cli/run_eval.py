"""Offline / streaming VQA evaluation CLI of the port: the counterpart of
``scripts/run_eval.py``, with the same arguments and ``--device``.

One process evaluates one data shard (``--rank`` / ``--world``, else the
``RANK`` / ``WORLD_SIZE`` environment variables; ``eval_offline.sh``
starts one process per shard), writes ``results_rank<r>.json`` under
``--save_dir``, and rank 0 then merges the rank files it finds into
``merged_score.json`` and prints the score as one JSON line.  Rank 0
merges as soon as its own shard ends, as ``scripts/run_eval.py`` does, so
it can miss the rows of a shard still running; ``eval_offline.sh`` merges
again once every shard has ended.

The tokenizer is the checkpoint's ``tokenizer.json``, read by
``runtime/tokenizer.py``.  For ``llava_ov_7b`` the knobs build the
``SessionConfig`` with ``stc_tpu``'s ``SessionConfig.from_env`` defaults
and derived fields, and ``n_init`` is the tokenizer's length of the chat
template's init prompt.  The CLIP backbones take their modules'
``default_session_config``, and a knob given for one of them raises.  On
the card the LM runs in bfloat16; ``--device cpu`` runs float32.

  python -m stc_tpu_torch.cli.run_eval --dataset mlvu --model llava_ov_7b \\
      --model_path /ckpts/llava-onevision-qwen2-7b-ov-hf \\
      --save_dir results/mlvu --sample_fps 0.5 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

# the knobs of the LLaVA-OV session config
KNOBS = ("n_local", "retrieve_size", "retrieve_chunk_size", "cache_strategy",
         "update_token_ratio", "token_per_frame", "prune_strategy", "ingest",
         "spec_decode")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m stc_tpu_torch.cli.run_eval",
        description="Evaluate a streaming session on a VQA dataset shard.")
    p.add_argument("--dataset", required=True)
    p.add_argument("--model", default="llava_ov_7b")
    p.add_argument("--model_path", default=None)
    p.add_argument("--save_dir", default="results/eval")
    p.add_argument("--anno_path", default=None)
    p.add_argument("--sample_fps", type=float, default=0.5)
    p.add_argument("--max_samples", type=int, default=None)
    # ReKV knobs (reference run_distributed.py arg surface)
    p.add_argument("--n_local", type=int, default=None)
    p.add_argument("--retrieve_size", type=int, default=None, help="topk")
    p.add_argument("--retrieve_chunk_size", type=int, default=None)
    p.add_argument("--cache_strategy", default=None,
                   choices=[None, "none", "cacher"])
    p.add_argument("--update_token_ratio", type=float, default=None)
    p.add_argument("--token_per_frame", type=int, default=None)
    p.add_argument("--prune_strategy", default=None,
                   choices=[None, "stc", "none", "full_tokens"])
    p.add_argument("--ingest", default=None, choices=["rgb", "yuv420"],
                   help="pixel ingest format: yuv420 halves the "
                        "host->device bytes/frame (packed 4:2:0 planes; "
                        "device-side chroma upsample)")
    p.add_argument("--spec_decode", type=int, default=None,
                   help="prompt-lookup speculative decode draft length "
                   "(answers are bit-identical to greedy; latency only)")
    p.add_argument("--stream_batch", type=int, default=1,
                   help="videos evaluated CONCURRENTLY per card (one "
                   "batched session, ragged multi-stream; rows identical "
                   "to sequential). Offline-protocol datasets only.")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    return p.parse_args(argv)


def session_config(args, n_init: int):
    """LLaVA-OV's SessionConfig from the knobs: stc_tpu's
    SessionConfig.from_env with the CLI's variables set (its defaults for
    the rest, block_size and exc_block_size derived as it derives them),
    and `n_init` tokens of init prompt."""
    from stc_tpu_torch.config import MODEL_SPECS, SessionConfig

    def pick(value, default):
        return default if value is None else value

    base = SessionConfig()
    cacher = dataclasses.replace(
        base.cacher, strategy=pick(args.cache_strategy, base.cacher.strategy),
        update_token_ratio=pick(args.update_token_ratio,
                                base.cacher.update_token_ratio))
    prune = {"full_tokens": "none"}.get(args.prune_strategy,
                                        args.prune_strategy)
    pruner = dataclasses.replace(
        base.pruner, strategy=pick(prune, base.pruner.strategy),
        token_per_frame=pick(args.token_per_frame,
                             base.pruner.token_per_frame))
    tpf = (pruner.token_per_frame if pruner.enabled
           else MODEL_SPECS[pruner.model_spec].tokens_per_frame)
    rekv = dataclasses.replace(
        base.rekv, n_init=n_init, n_local=pick(args.n_local, base.rekv.n_local),
        topk=pick(args.retrieve_size, base.rekv.topk),
        chunk_size=pick(args.retrieve_chunk_size, base.rekv.chunk_size),
        block_size=tpf, exc_block_size=tpf * base.encode_chunk_frames,
        spec_decode_draft=pick(args.spec_decode, base.rekv.spec_decode_draft))
    return dataclasses.replace(
        base, rekv=rekv, cacher=cacher, pruner=pruner,
        ingest_format=pick(args.ingest, base.ingest_format))


def load_model(args, device: torch.device):
    """The SessionAdapter (session and tokenizer) of the arguments."""
    from stc_tpu_torch.models import MODEL_REGISTRY
    import stc_tpu_torch.models.llava_onevision  # noqa: F401 (register)
    import stc_tpu_torch.models.longva  # noqa: F401
    import stc_tpu_torch.models.video_llava  # noqa: F401
    import stc_tpu_torch.models.flash_vstream  # noqa: F401
    from stc_tpu_torch.runtime.adapter import ChatTemplate, SessionAdapter
    from stc_tpu_torch.runtime.tokenizer import load_tokenizer

    if args.model not in MODEL_REGISTRY:
        raise ValueError(f"--model {args.model}: not one of "
                         f"{sorted(MODEL_REGISTRY)}")
    if args.model_path is None:
        raise ValueError("--model_path: a checkpoint directory is needed")
    tokenizer = load_tokenizer(args.model_path)
    if args.model == "llava_ov_7b":
        scfg = session_config(args, len(tokenizer(ChatTemplate.init_prompt)))
    else:
        given = [k for k in KNOBS if getattr(args, k) is not None]
        if given:
            raise ValueError(
                f"--{given[0]}: {args.model} runs its module's "
                f"default_session_config (stc_tpu's CLI ignores the knobs "
                f"for the CLIP backbones); drop the knob")
        scfg = None
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    session, _ = MODEL_REGISTRY[args.model](
        args.model_path, scfg, dtype=dtype, device=device,
        batch=args.stream_batch)
    return SessionAdapter(session, tokenizer)


def main(argv=None) -> dict:
    """Run one shard; rank 0 returns (and prints) the merged score, the
    other ranks None."""
    from stc_tpu_torch.device import resolve_device
    from stc_tpu_torch.eval.runner import merge_and_score, run_eval

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = load_model(args, device)
    rank = args.rank if args.rank is not None else int(
        os.environ.get("RANK", "0"))
    world = args.world if args.world is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    # the rows carry the sweep's knobs, as stc_tpu's do through the
    # environment variables its CLI sets
    tags = {k: v for k, v in (("retrieve_size", args.retrieve_size),
                              ("chunk_size", args.retrieve_chunk_size))
            if v is not None}
    run_eval(args.dataset, model, args.save_dir, anno_path=args.anno_path,
             sample_fps=args.sample_fps, rank=rank, world=world,
             max_samples=args.max_samples, stream_batch=args.stream_batch,
             tags=tags)
    if rank != 0:
        return None
    out = merge_and_score(args.save_dir, args.dataset)
    out = {k: v for k, v in out.items() if k != "rows"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
