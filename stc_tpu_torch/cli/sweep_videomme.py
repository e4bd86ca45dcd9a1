"""VideoMME retrieve_size x chunk_size sweep of the port (the counterpart
of ``scripts/sweep_videomme.py``).

Runs ``python -m stc_tpu_torch.cli.run_eval`` once per grid point (a fresh
process per combination), merges all rows, and writes the accuracy pivot
(``sweep.json``) and, where matplotlib imports, its heatmap
(``qa_acc.png``) into --save_dir.  Arguments it does not take itself
(``--device``, ``--anno_path``, ...) go to every run_eval as they are.

  python -m stc_tpu_torch.cli.sweep_videomme --model_path /ckpts/llava-ov-7b \\
      --save_dir results/videomme_sweep \\
      --retrieve_sizes 16 32 64 --chunk_sizes 1 2 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m stc_tpu_torch.cli.sweep_videomme")
    p.add_argument("--dataset", default="videomme_subset")
    p.add_argument("--model", default="llava_ov_7b")
    p.add_argument("--model_path", required=True)
    p.add_argument("--save_dir", default="results/videomme_sweep")
    p.add_argument("--retrieve_sizes", type=int, nargs="+",
                   default=[16, 32, 64])
    p.add_argument("--chunk_sizes", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--sample_fps", type=float, default=0.5)
    p.add_argument("--max_samples", type=int, default=None)
    args, passed = p.parse_known_args(argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    all_rows = []
    for rs in args.retrieve_sizes:
        for cs in args.chunk_sizes:
            sub = os.path.join(args.save_dir, f"rs{rs}_cs{cs}")
            cmd = [sys.executable, "-m", "stc_tpu_torch.cli.run_eval",
                   "--dataset", args.dataset, "--model", args.model,
                   "--model_path", args.model_path, "--save_dir", sub,
                   "--retrieve_size", str(rs),
                   "--retrieve_chunk_size", str(cs),
                   "--sample_fps", str(args.sample_fps)] + passed
            if args.max_samples:
                cmd += ["--max_samples", str(args.max_samples)]
            subprocess.run(cmd, check=True, env=env)
            with open(os.path.join(sub, "merged_score.json")) as f:
                all_rows.extend(json.load(f)["rows"])

    from stc_tpu_torch.eval.reports import save_heatmap, videomme_sweep
    pivot = videomme_sweep([r for r in all_rows if "qa_acc" in r])
    out = {"pivot": pivot, "n_rows": len(all_rows)}
    with open(os.path.join(args.save_dir, "sweep.json"), "w") as f:
        json.dump(out, f, indent=1)
    save_heatmap(pivot, os.path.join(args.save_dir, "qa_acc.png"))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
