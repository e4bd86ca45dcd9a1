"""Tiny cells for the CPU tests: the benchmark's real configuration and
traffic files with the widths, depths and lengths cut down, so a whole
run (set-up, window, check) takes seconds on the CPU with the kernels'
plain versions."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


TEXT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
            rope_theta=10000.0)


def config(family: str) -> dict:
    name = "llava-ov-7b" if family == "llava_ov" else "longva-7b"
    cfg = copy.deepcopy(_load("configs", f"{name}.json"))
    cfg["text_config"].update(TEXT)
    cfg["vision_config"].update(hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, run_layers=2,
                                num_attention_heads=4, image_size=56,
                                patch_size=14)
    s = cfg["session"]
    block = 3 if family == "llava_ov" else 4
    s["rekv"].update(n_init=4, n_local=128, block_size=block,
                     exc_block_size=block, topk=4, max_blocks=64,
                     max_new_tokens=8, max_prompt_tokens=64)
    s["pruner"]["token_per_frame"] = block
    return cfg


def spec(family: str = "llava_ov") -> dict:
    """A resolve()-shaped ingest cell."""
    mix = copy.deepcopy(_load("workloads", "ingest_v960.json"))
    # every chunk marked, so a short window on a busy CPU still has chunks
    # to check
    mix.update(frame_hw=[36, 64], video_frames=60, fill_frames=44,
               check_every=1, check_chunks=4, profile_after=2,
               profile_units=3)
    cell = "ov7b-ingest" if family == "llava_ov" else "longva7b-ingest"
    bench = _load("..", "BENCHMARK.json")
    units = dict(ingest_fps="frames/s", chunk_p95_ms="ms",
                 peak_mem_gib="GiB", setup_s="s")
    return dict(cell=dict(name="tiny", chips=1), config=config(family),
                mix=mix, limits=_load("limits", f"{cell}.json"),
                end_to_end=[dict(name=n, unit=u) for n, u in units.items()],
                per_layer=[m for m in bench["per_layer"]
                           if cell in m["workloads"]])
