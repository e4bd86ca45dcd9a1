"""Multi-process dry run of the parallel layouts (the port's counterpart
of the JAX package's ``dryrun_multichip``).

    python -m stc_tpu_torch.parallel.dryrun [--world 4] [--device cpu]

``launch`` starts `world` ranks as fresh interpreters (they import torch
and stc_tpu_torch only, on one thread each), joins them into one gloo
process group on a free localhost port and runs a function on every rank;
every join has its own deadline, so a rank that hangs fails the run
instead of stalling it.  ``dryrun_multichip`` runs the list below at tiny
widths with random weights, each layout against an unsharded session
built from the same seed inside each rank.  The ranks run on the card
(every rank on the current CUDA device, collectives over gloo staged
through host memory) unless the caller asks for the CPU:

  - dp x tp: the whole step (SigLIP with the cacher, projector, pooling,
    pruner, LM appends, retrieval QA, decode) through a LLaVA-OV session;
  - dp x tp: the host tier (evictions, two-tier QA) with the aks scorer;
    int4 pages with int8_g16 weights; ragged ingest, a recycled slot and a
    serving tick on the pixel session;
  - dp x sp x tp: sp vision and sp LM appends through the same session;
  - pp x tp: the stage relay session (ingest and QA).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CHILD = ("import sys, torch; torch.set_num_threads(1); "
          "from stc_tpu_torch.parallel import dryrun; "
          "dryrun._rank_main(sys.argv[1])")


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world: int, target: str, args: Sequence = (), *,
           backend: str = "gloo", timeout: float = 300.0,
           env: dict | None = None) -> list:
    """Run `target` ("module:function", called as fn(mesh_rank, world,
    *args) after init_parallel) on `world` fresh ranks in one process
    group of `backend`; returns the ranks' return values in rank order.
    Raises with the failing ranks' error output when a rank fails or
    outlives `timeout` seconds (the others are then stopped)."""
    port = free_port()
    run_env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_", "TPU_", "PJRT_"))}
    run_env["PYTHONPATH"] = ROOT + os.pathsep + run_env.get("PYTHONPATH", "")
    run_env.update(env or {})
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(world):
            spec = dict(target=target, args=tuple(args), rank=r,
                        world=world, backend=backend,
                        init=f"tcp://localhost:{port}",
                        out=os.path.join(tmp, f"{r}.pkl"))
            path = os.path.join(tmp, f"spec{r}.pkl")
            with open(path, "wb") as f:
                pickle.dump(spec, f)
            err = open(os.path.join(tmp, f"{r}.err"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _CHILD, path], cwd=ROOT, env=run_env,
                stdout=err, stderr=subprocess.STDOUT), err))
        deadline = time.monotonic() + timeout
        failed = []
        try:
            for r, (p, _) in enumerate(procs):
                try:
                    rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append((r, "timed out"))
                    break
                if rc != 0:
                    failed.append((r, f"exit code {rc}"))
                    break
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            tails = []
            for r, (_, err) in enumerate(procs):
                err.seek(0)
                tails.append(f"--- rank {r} ---\n{err.read()[-4000:]}")
            raise RuntimeError(f"rank {failed[0][0]} {failed[0][1]}\n"
                               + "\n".join(tails))
        for _, err in procs:
            err.close()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(spec_path: str) -> None:
    import torch.distributed as dist
    from stc_tpu_torch.parallel.mesh import init_parallel
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    init_parallel(spec["backend"], spec["rank"], spec["world"], spec["init"])
    mod, name = spec["target"].split(":")
    fn: Callable = getattr(importlib.import_module(mod), name)
    result = fn(spec["rank"], spec["world"], *spec["args"])
    with open(spec["out"], "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the dry run's cases (tiny widths)
# --------------------------------------------------------------------------

def tiny_model(seed: int, mesh=None, heads=(4, 2), vision_heads: int = 4,
               device="cuda"):
    """A tiny float32 LLaVA-OV on `device` from `seed` (parallel.sharding.
    init_random: every layout holds slices of the same weights), sharded
    onto `mesh` when one is given."""
    import dataclasses
    import torch
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.parallel import sharding
    base = lo.LlavaOVConfig.tiny()
    cfg = lo.LlavaOVConfig(
        vision=dataclasses.replace(base.vision, num_heads=vision_heads),
        text=dataclasses.replace(base.text, num_heads=heads[0],
                                 num_kv_heads=heads[1], vocab_size=128))
    model = lo.LlavaOV(cfg, dtype=torch.float32, device="meta")
    if mesh is not None:
        sharding.shard_module(model, mesh)
    model.to_empty(device=device)
    return sharding.init_random(model, seed, scale=0.1)


def tiny_scfg(**rekv):
    from stc_tpu_torch import config as tc
    kw = dict(n_init=4, n_local=48, block_size=4, exc_block_size=8, topk=4,
              max_blocks=32, max_prompt_tokens=16, max_new_tokens=6)
    kw.update(rekv)
    return tc.SessionConfig(
        rekv=tc.ReKVConfig(**kw),
        cacher=tc.CacherConfig(update_token_ratio=0.5),
        pruner=tc.PrunerConfig(token_per_frame=4), encode_chunk_frames=2)


def drive(sess, frames, questions, *, ragged=None, reset=None,
          serve=False):
    """Init prompt, the frames chunk by chunk (with optional ragged masks
    a chunk and slot resets after a chunk), then each question for every
    stream, then (serve) one serving tick of two frames and a question per
    stream.  Returns (answers, each question's per-layer blocks)."""
    sess.encode_init_prompt([1, 2, 3, 4])
    n = sess.scfg.encode_chunk_frames
    for i, s in enumerate(range(0, frames.shape[1], n)):
        active = None if ragged is None else ragged[i % len(ragged)]
        sess.encode_video(frames[:, s:s + n], active=active)
        if reset is not None and i == reset[0]:
            sess.reset_streams(reset[1])
    answers, blocks = [], []
    for q, p in questions:
        answers.append(sess.question_answering(q, p, [0], max_new_tokens=6,
                                               all_streams=True))
        blocks.append(sess.last_retrieved_indices)
    if serve:
        B = sess.n_streams
        tok, cnt = sess.serve(frames[:, :2], [b % 2 == 0 for b in range(B)],
                              [questions[b % 2][0] for b in range(B)],
                              [questions[b % 2][1] for b in range(B)], [0],
                              max_new_tokens=4)
        answers.append([tok.tolist(), cnt.tolist()])
    return answers, blocks


def _case(name, seed, mesh, B, frames, questions, scfg, *, device,
          heads=(4, 2), **kw):
    import torch
    from stc_tpu_torch.models import llava_onevision as lo
    ref = lo.build_session(tiny_model(seed, heads=heads, device=device),
                           scfg, state_dtype=torch.float32, device=device,
                           batch=B)
    want = drive(ref, frames, questions, **kw)
    # int8 weights are quantized whole, then sharded by the session
    pre = None if scfg.weights_quant != "none" else mesh
    sess = lo.build_session(tiny_model(seed, pre, heads=heads,
                                       device=device), scfg,
                            state_dtype=torch.float32, device=device,
                            batch=B, mesh=mesh)
    got = drive(sess, frames, questions, **kw)
    if got != want:
        raise AssertionError(f"{name}: {got} != {want}")
    return {"case": name, "answers": got[0],
            "evicted_pages": sess._evicted_pages}


def _dryrun_rank(rank: int, world: int, device: str) -> list:
    import numpy as np
    from stc_tpu_torch.parallel.mesh import make_mesh, make_pp_mesh
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 12, 56, 56, 3), dtype=np.uint8)
    qs = [([5, 6, 7], [8, 9]), ([10, 11], [12, 13, 14])]
    tp = 2 if world % 2 == 0 else 1
    out = []
    mesh = make_mesh(dp=world // tp, tp=tp)
    B = world // tp

    def case(*args, **kw):
        out.append(_case(*args, device=device, **kw))

    case("dp x tp step", 1, mesh, B, frames[:B], qs, tiny_scfg())
    case("host tier + aks scorer", 2, mesh, B, frames[:B], qs,
         tiny_scfg(max_blocks=10, n_local=24, retrieval_scorer="aks",
                   host_kv_quant="none"))
    case("int4 pages + int8_g16 weights", 3, mesh, B, frames[:B], qs,
         _with(tiny_scfg(kv_quant="int4"), weights_quant="int8_g16"))
    case("ragged ingest, slot reset, serving tick", 4, mesh, B, frames[:B],
         qs, tiny_scfg(), ragged=[[True] * B, [True] + [False] * (B - 1)],
         reset=(2, [0]), serve=True)
    if world % 4 == 0:
        case("dp x sp x tp: sp vision and sp LM appends", 5,
             make_mesh(dp=world // 4, sp=2, tp=2), world // 4,
             frames[:world // 4], qs, tiny_scfg())
        case("pp x tp session", 6, make_pp_mesh(pp=2, tp=world // 2), 1,
             frames[:1], qs, tiny_scfg())
    return out


def _with(scfg, **kw):
    import dataclasses
    return dataclasses.replace(scfg, **kw)


def dryrun_multichip(world: int = 4, timeout: float = 600.0,
                     device: str = "cuda") -> list:
    """Run the list above on `world` gloo ranks on `device` ("cuda": all
    on the current card; "cpu"); returns rank 0's case records.  Raises
    if any layout parts from its unsharded session."""
    return launch(world, "stc_tpu_torch.parallel.dryrun:_dryrun_rank",
                  (device,), timeout=timeout)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    for rec in dryrun_multichip(a.world, device=a.device):
        print(rec, flush=True)
    print(f"dryrun OK on {a.world} gloo ranks ({a.device})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
