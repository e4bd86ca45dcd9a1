"""The kimi_vl family (Kimi-VL-A3B: MoonViT, latent attention, experts):
its counts against arithmetic by hand, and its check end to end on the CPU
at a tiny size (the kernels' plain versions, the configuration's bf16):
the program agrees with the float32 reference, the control (float8
linears in the LM, experts included, and in the tower) and four planted
faults do not."""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from stcbench import counts, harness
from stcbench.lms import kimi as lk
from stcbench.reference import kimi_lm as rk

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "stcbench/configs/kimi-vl-a3b.json").read_text())
SEED = 2 ** 31 + 4243


@pytest.mark.parametrize("k", [0, 1, 249, 250, 300])
def test_chunk_work_by_hand(k):
    """A 1-frame append after k pages: the latent op's visible pairs
    counted by enumerating every (query, key) mask of the three groups,
    its bytes, and the pass's routed-expert bytes, those of the experts
    the program's counters say an MoE layer hit (here 37 a layer and
    chunk: 111 over 3 appends)."""
    lm = lk.KimiLM(CFG, None, "cpu", "", "")
    reads = []

    def routing():
        reads.append(1)
        return dict(hits=torch.tensor([0] + [111] * 26), appends=3,
                    tokens=torch.zeros(27, 64, dtype=torch.int64))

    lm.routing = routing
    w = lm.chunk_work(k)
    lm.chunk_work(k + 1)
    assert lm.experts_hit() == 37.0 and len(reads) == 1
    calls = w["ops"]["latent_attention"]
    assert len(calls) == 27
    n_init, n_local, T = 14, 15000, 60
    L = n_init + 60 * k
    q = L + torch.arange(T)[:, None]
    keys = torch.arange(L + T)[None, :]
    dist = q - keys
    window = ((dist >= 0) & (dist < n_local)).sum().item()
    far = T * n_init if L + T > n_local else 0
    pairs = window + far
    live = (L + T) - max(n_init, L - n_local + 1)
    c = calls[0]
    assert c.bf16 == 2 * 16 * (576 + 512) * pairs
    assert c.exps == 16 * pairs
    assert c.bytes == 2 * (2 * T * 16 * 576 + T * 16 * 512 + 2 * 14 * 576
                           + live * 576)
    d = rk.KimiDims(CFG)
    lm_only = lk.lm_pass(d, 60, 37.0)
    experts = lm_only.bytes - lk.lm_pass(d, 60, 0.0).bytes
    assert experts == 26 * 37 * 3 * 2048 * 1408 * 2
    attn = counts.Work()
    for call in calls:
        attn = attn + call
    assert w["lm"].bytes == pytest.approx(lm_only.bytes + attn.bytes)
    assert w["lm"].bf16 == pytest.approx(lm_only.bf16 + attn.bf16)


def test_chunk_work_needs_the_programs_routing():
    lm = lk.KimiLM(CFG, None, "cpu", "", "")
    with pytest.raises(RuntimeError, match="routing counters"):
        lm.chunk_work(0)


def tiny_spec() -> dict:
    """The cell's files cut to a tiny size: hidden 64, 4 heads, latent 32
    + rope 16, 1 dense + 3 MoE layers of 8 experts (top 2, one shared); a
    2-layer MoonViT on 50 x 80 frames padded to 56 x 84 (6 merged tokens,
    3 kept); bf16 as the configuration states."""
    cfg = copy.deepcopy(CFG)
    cfg.update(hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=4,
               num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
               num_experts_per_tok=2, kv_lora_rank=32, qk_rope_head_dim=16,
               qk_nope_head_dim=16, v_head_dim=16, vocab_size=512,
               rope_theta=10000.0)
    cfg["vision_config"].update(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_hw=[56, 84], init_pos_emb_height=8,
        init_pos_emb_width=8)
    s = cfg["session"]
    s["rekv"].update(n_init=4, n_local=128, block_size=3, exc_block_size=3,
                     topk=4, max_blocks=64, max_new_tokens=8,
                     max_prompt_tokens=64)
    s["pruner"]["token_per_frame"] = 3
    mix = json.loads((ROOT / "stcbench/workloads/ingest_v960.json")
                     .read_text())
    mix.update(frame_hw=[50, 80], video_frames=60, fill_frames=44,
               check_every=1, check_chunks=4, profile_after=2,
               profile_units=3)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    units = dict(ingest_fps="frames/s", chunk_p95_ms="ms",
                 peak_mem_gib="GiB", setup_s="s")
    return dict(cell=dict(name="tiny", chips=1), config=cfg, mix=mix,
                limits=dict(TINY_LIMITS),
                end_to_end=[dict(name=n, unit=u) for n, u in units.items()],
                per_layer=[m for m in bench["per_layer"]
                           if "kimivl-ingest" in m["workloads"]])


# The cell's limits come from readings at the cell's size (PERF.md).  At
# this size the bf16 program reads feature_gap 0.006-0.01, memory_gap
# 0.003 (the reference takes the program's channels), page_gap
# 0.006-0.008 and init_gap 0.00785 (the same prompt and weights every
# run); the control 0.07 (page, init) and 1.0 (memory); a RoPE over the
# whole row 0.014 (page, init): these limits lie between, as the cell's
# do.
TINY_LIMITS = dict(feature_gap=0.03, memory_gap=0.1, page_gap=0.011,
                   init_gap=0.011)


def run(spec, control=False, seconds=1.5, trace=False):
    torch.manual_seed(0)
    return harness.run_cell(spec, SEED, seconds, trace, "cpu",
                            time.perf_counter(), control=control)


def test_program_agrees_and_reports_the_cells_metrics():
    r = run(tiny_spec(), trace=True, seconds=3.0)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"vision_ms_per_frame", "append_ms_per_frame",
            "preprocess_ms_per_frame", "mfu.ingest"} <= set(r["metrics"])
    # the CPU's trace has no kernels: the roofline reads nothing there
    assert "latent_attention_roofline" not in r["metrics"]


def test_control_is_not_correct():
    r = run(tiny_spec(), control=True)
    assert r["correct"] is False, r["checks"]
    for k, lim in TINY_LIMITS.items():
        assert r["readings"][k] <= lim, (k, r["readings"])


def plant(monkeypatch, fault):
    from stc_tpu_torch.kvcache import latent
    from stc_tpu_torch.models import deepseek_v3 as ds
    if fault == "bias_sign_flipped":
        route = ds.DeepseekV3.route_tokens

        def flipped(self, lp, x):
            lp.e_bias.neg_()
            try:
                return route(self, lp, x)
            finally:
                lp.e_bias.neg_()
        monkeypatch.setattr(ds.DeepseekV3, "route_tokens", flipped)
    elif fault == "shared_dropped":
        moe = ds.DeepseekV3._moe

        def dropped(self, i, lp, *a):
            lp.s_down.zero_()
            return moe(self, i, lp, *a)
        monkeypatch.setattr(ds.DeepseekV3, "_moe", dropped)
    elif fault == "pruner_memory_short":
        from stc_tpu_torch.models import llava_onevision as lo
        prune = lo.stc_prune

        def short(features, state, *a, **k):
            pruned, idx, new = prune(features, state, *a, **k)
            # each chunk's mean added at three quarters of its weight
            mean = state.mean_sum + 0.75 * (new.mean_sum - state.mean_sum)
            return pruned, idx, new._replace(mean_sum=mean)
        monkeypatch.setattr(lo, "stc_prune", short)
    elif fault == "rope_whole_row":
        rot = latent._rot_tail

        def whole(x, P, cos, sin):
            n = x.shape[-1] // P
            return rot(x, x.shape[-1], torch.cat([cos] * n, -1),
                       torch.cat([sin] * n, -1))
        monkeypatch.setattr(latent, "_rot_tail", whole)


@pytest.mark.parametrize("fault", ["bias_sign_flipped", "shared_dropped",
                                   "rope_whole_row", "pruner_memory_short"])
def test_fault_is_not_correct(monkeypatch, fault):
    plant(monkeypatch, fault)
    r = run(tiny_spec())
    assert r["correct"] is False, r["checks"]


def test_kimi_loads_no_jax_and_its_reference_no_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from stcbench.reference import kimi_lm, moonvit\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "stc_tpu", "stc_tpu_torch"}
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from stcbench.families import kimi_vl\n"
            "from stc_tpu_torch.models import kimi_vl as k\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "stc_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "stc_tpu"}
