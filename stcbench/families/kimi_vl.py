"""Kimi-VL (MoonViT with the STC-Cacher + 2 x 2 merger and projector +
STC-Pruner + a DeepSeek-V3 LM: latent attention and 64 routed + 2 shared
experts): how the benchmark builds the program from a configuration file,
and the matching plain reference of one chunk's vision side.

The configuration file holds the LM's published config at its top level
(every number of the catalog's row), the tower's under ``vision_config``.
The weights reach the program through its own checkpoint converters
(``stc_tpu_torch.models.convert``), one tensor at a time.
"""

from __future__ import annotations

import sys

import torch

from stcbench import counts, weights
from stcbench.families import llava_ov
from stcbench.families.llava_ov import pruner_memory, session_config
from stcbench.lms.kimi import KimiLM
from stcbench.reference import moonvit as rm
from stcbench.reference.precision import fp8

VISION, PROJ = "vision_tower.", "multi_modal_projector."
LM, HEAD = "language_model.model.", "language_model.lm_head.weight"
CHECK_NAMES = ("feature_gap", "memory_gap", "page_gap", "init_gap")
__all__ = ["pruner_memory", "session_config"]


def specs(cfg: dict) -> dict:
    v, dt = cfg["vision_config"], cfg["dtype"]
    C, Fv, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    vt = v["dtype"]
    out = {VISION + "patch_embed.proj.weight": ((C, 3, P, P), vt, "w"),
           VISION + "patch_embed.proj.bias": ((C,), vt, "b"),
           VISION + "patch_embed.pos_emb.weight": (
               (v["init_pos_emb_height"], v["init_pos_emb_width"], C), vt,
               "w"),
           VISION + "encoder.final_layernorm.weight": ((C,), vt, "n"),
           VISION + "encoder.final_layernorm.bias": ((C,), vt, "b")}
    for i in range(v["num_hidden_layers"]):
        b = f"{VISION}encoder.blocks.{i}."
        for n in ("norm0", "norm1"):
            out[b + n + ".weight"] = ((C,), vt, "n")
            out[b + n + ".bias"] = ((C,), vt, "b")
        for n, shape in (("wqkv", (3 * C, C)), ("wo", (C, C)),
                         ("mlp.fc0", (Fv, C)), ("mlp.fc1", (C, Fv))):
            out[b + n + ".weight"] = (shape, vt, "w")
            out[b + n + ".bias"] = ((shape[0],), vt, "b")
    k = v["merge_kernel_size"][0] * v["merge_kernel_size"][1]
    E = cfg["hidden_size"]
    out.update({PROJ + "pre_norm.weight": ((C,), vt, "n"),
                PROJ + "pre_norm.bias": ((C,), vt, "b"),
                PROJ + "linear_1.weight": ((k * C, k * C), vt, "w"),
                PROJ + "linear_1.bias": ((k * C,), vt, "b"),
                PROJ + "linear_2.weight": ((E, k * C), vt, "w"),
                PROJ + "linear_2.bias": ((E,), vt, "b")})
    H, N, Pr = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                cfg["qk_rope_head_dim"])
    R, V, Fd = cfg["kv_lora_rank"], cfg["v_head_dim"], \
        cfg["intermediate_size"]
    Fe, n_exp = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    Fs = Fe * cfg["n_shared_experts"]
    out.update({LM + "embed_tokens.weight": ((cfg["vocab_size"], E), dt,
                                             "w"),
                LM + "norm.weight": ((E,), dt, "n"),
                HEAD: ((cfg["vocab_size"], E), dt, "w")})
    for i in range(cfg["num_hidden_layers"]):
        p = f"{LM}layers.{i}."
        a = p + "self_attn."
        out.update({p + "input_layernorm.weight": ((E,), dt, "n"),
                    p + "post_attention_layernorm.weight": ((E,), dt, "n"),
                    a + "q_proj.weight": ((H * (N + Pr), E), dt, "w"),
                    a + "kv_a_proj_with_mqa.weight": ((R + Pr, E), dt, "w"),
                    a + "kv_a_layernorm.weight": ((R,), dt, "n"),
                    a + "kv_b_proj.weight": ((H * (N + V), R), dt, "w"),
                    a + "o_proj.weight": ((E, H * V), dt, "w")})
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            for n, shape in (("gate_proj", (Fd, E)), ("up_proj", (Fd, E)),
                             ("down_proj", (E, Fd))):
                out[m + n + ".weight"] = (shape, dt, "w")
            continue
        out[m + "gate.weight"] = ((n_exp, E), dt, "w")
        out[m + "gate.e_score_correction_bias"] = ((n_exp,), "float32", "b")
        for e in range(n_exp):
            for n, shape in (("gate_proj", (Fe, E)), ("up_proj", (Fe, E)),
                             ("down_proj", (E, Fe))):
                out[f"{m}experts.{e}.{n}.weight"] = (shape, dt, "w")
        for n, shape in (("gate_proj", (Fs, E)), ("up_proj", (Fs, E)),
                         ("down_proj", (E, Fs))):
            out[f"{m}shared_experts.{n}.weight"] = (shape, dt, "w")
    return out


def model_config(cfg: dict):
    from stc_tpu_torch.models import deepseek_v3 as ds
    from stc_tpu_torch.models import kimi_vl as kv
    from stc_tpu_torch.models import moonvit as mv
    v = cfg["vision_config"]
    vcfg = mv.MoonViTConfig(
        hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"],
        intermediate_size=v["intermediate_size"],
        patch_size=v["patch_size"], image_hw=tuple(v["image_hw"]),
        pos_grid=(v["init_pos_emb_height"], v["init_pos_emb_width"]),
        rope_base=float(v["rope_theta"]),
        layer_norm_eps=v["layer_norm_eps"])
    tcfg = ds.DeepseekV3Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], kv_lora_rank=cfg["kv_lora_rank"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        norm_topk_prob=cfg["norm_topk_prob"],
        rope_base=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"])
    return kv.KimiVLConfig(vision=vcfg, text=tcfg,
                           merge=v["merge_kernel_size"][0])


def build(cfg: dict, seed: int, device):
    """The program's session over this seed's weights."""
    from stc_tpu_torch.models import kimi_vl as kv
    from stc_tpu_torch.models.convert import (convert_deepseek_v3,
                                              convert_kimi_projector,
                                              convert_moonvit)
    model = kv.KimiVL(model_config(cfg), dtype=weights.DTYPES[cfg["dtype"]],
                      vision_dtype=weights.DTYPES[
                          cfg["vision_config"]["dtype"]], device=device)
    state = weights.LazyState(specs(cfg), seed, device)
    convert_moonvit(state, model.vision, prefix=VISION)
    convert_kimi_projector(state, model.projector, prefix=PROJ)
    convert_deepseek_v3(state, model.text, prefix=LM, head=HEAD)
    return kv.build_session(model, session_config(cfg),
                            state_dtype=weights.DTYPES[cfg["dtype"]],
                            device=device)


def vision_work(cfg: dict, cached: bool):
    """The work of one frame through MoonViT (bf16: the cacher's path
    counted as reference/vision.py's SigLIP cacher), the merger and the
    projector."""
    v = cfg["vision_config"]
    C, Fv, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    gh, gw = v["image_hw"][0] // P, v["image_hw"][1] // P
    T, n = gh * gw, v["num_hidden_layers"]
    ratio = cfg["session"]["cacher"]["update_token_ratio"]
    patch = 2 * T * 3 * P * P * C
    if cached:
        U = max(1, min(int(T * ratio), T))
        per = (2 * T * C * C + 2 * 3 * U * C * C + 4 * U * T * C
               + 2 * U * U * C + 4 * U * C * Fv)
    else:
        per = counts.vit_layer(C, Fv, T, T, 4 * T, T)
    k = v["merge_kernel_size"][0] * v["merge_kernel_size"][1]
    E, rows = cfg["hidden_size"], T // k
    proj = 2 * rows * (k * C * k * C + k * C * E)
    by = 2 * (n * (4 * C * C + 2 * C * Fv) + 3 * P * P * C
              + k * C * (k * C + E))
    return counts.Work(bf16=patch + n * per + proj, bytes=by)


def lm(cfg: dict, get, device):
    """The language model: DeepSeek-V3's layout."""
    return KimiLM(cfg, get, device, LM, HEAD)


def instrument(session, run):
    """LLaVA-OV's hooks (the pruner states, the cacher's choices, the kept
    tokens of a checked chunk); the pruner's channels of every chunk, in
    its order (run.pruner_channels, by (video, frame), added to the
    choices the reference follows); the router's choices: those of a
    checked chunk's append (run.hooks.capture['route'], (L, T, k)) and
    those of the init prompt (run.lm.init_route), copies on the device;
    and the program's routing counters, zeroed as the window starts and
    read by run.lm after it."""
    from stc_tpu_torch.ops.topk import topk_lowest
    from stc_tpu_torch.utils import metrics
    llava_ov.instrument(session, run)
    lm, append, init = session.lm, session._append_flat, \
        session.encode_init_prompt
    vis, window, choices = session.vision, run.window, run.choices
    prune = vis._prune
    run.pruner_channels = {}

    def app(*a, **k):
        out = append(*a, **k)
        cap = run.hooks.capture
        if cap is not None and lm.route is not None:
            cap["route"] = lm.route.clone()
        return out

    def enc_init(*a, **k):
        out = init(*a, **k)
        run.lm.init_route = lm.route_init.clone()
        return out

    def prune_(feats, pstate, sp=None):
        # the pruner's channel choice (compress/pruner.stc_prune) on the
        # same features, which it does not return
        E = feats.shape[-1]
        x = feats.to(torch.float32).reshape(vis.batch, -1, E)
        k = int(E * session.scfg.pruner.channel_keep_ratio)
        _, ch = topk_lowest(-x.var(dim=1, unbiased=False), k)
        run.pruner_channels[run.where] = ch[0]
        return prune(feats, pstate, sp)

    def choices_(v, k):
        out = choices(v, k)
        out["channels"] = run.pruner_channels.get((v, k))
        return out

    def window_():
        metrics.reset_moe_counts(lm)
        run.lm.routing = lambda: metrics.moe_counts(lm)
        run.lm.hit = None
        return window()

    session._append_flat = app
    session.encode_init_prompt = enc_init
    vis._prune = prune_
    run.choices = choices_
    run.window = window_


class _Lin:
    """The tower's linears at a harness Precision: float32, or with the
    control's the float8 e4m3 ones (the nearest precision below bf16)."""

    def __init__(self, prec):
        self.control = prec.control

    def __call__(self, x, w):
        if self.control:
            return fp8(x, -1) @ fp8(w, 1).T
        return x @ w.T


class VisionReference(llava_ov.VisionReference):
    """One 1-frame chunk's pruned features from its frames, and the pruner
    memory of a video from its frames, in float32 or at the control's
    precision (LLaVA-OV's, with MoonViT, the merger and the projector)."""

    def __init__(self, cfg: dict, get, prec):
        self.cfg, self.get, self.prec = cfg, get, prec
        self.v = cfg["vision_config"]
        self.lin = _Lin(prec)
        self.tower = rm.Tower(get, VISION, self.v, self.lin)
        s = cfg["session"]
        self.cacher = s["cacher"]
        self.ratio = s["cacher"]["update_token_ratio"]
        self.keep = s["pruner"]["token_per_frame"]
        self.channel_keep = s["pruner"].get("channel_keep_ratio", 0.5)
        self.merge = self.v["merge_kernel_size"][0]
        self.n_sel = int(cfg["hidden_size"] * self.channel_keep)

    def px(self, f):
        return rm.preprocess(f, self.tower.hw)

    def pool(self, h):
        return rm.project(self.get, PROJ, h, self.merge,
                          (self.tower.gh, self.tower.gw), self.lin)

    @torch.no_grad()
    def chunk(self, prev, frame, cached: bool, memory, prog=None):
        prog = prog or {}
        if cached:
            _, refs = self.tower.full(self.px(prev))
            h = self.tower.cached(self.px(frame), refs, self.ratio,
                                  prog.get("sel"))
        else:
            h, _ = self.tower.full(self.px(frame))
        out = rm.prune(self.pool(h), memory[0].float(), memory[1], self.keep,
                       self.channel_keep, prog.get("channels"),
                       prog.get("idx"))
        return out[0]

    @torch.no_grad()
    def replay(self, frames, upto: int, prog=None, own: bool = False,
               batch: int = 4):
        """The pruner memory (mean_sum, count) before each chunk 0..upto
        of one video (llava_ov.VisionReference.replay's, through MoonViT,
        the merger and the projector; prog's "channels", the program's,
        followed at near-ties)."""
        prog = prog or {}
        dev = self.tower.device
        c = self.cacher["cache_interval"]
        step = -(-batch // c) * c
        mem = torch.zeros(self.n_sel, device=dev)
        mem_own = mem.clone()
        out, out_own = {}, {}
        T = self.tower.gh * self.tower.gw
        tally = [0, 0]  # chunks with the program's channels taken, refused
        for k0 in range(0, upto + 1, step):
            ks = list(range(k0, min(upto + 1, k0 + step)))
            px = self.px(torch.as_tensor(frames[ks[0]:ks[-1] + 1],
                                         device=dev))
            full = [i for i, k in enumerate(ks) if not self.cached(k)]
            h = px.new_empty((len(ks), T, self.v["hidden_size"]))
            hf, refs = self.tower.full(px[full], every=True)
            h[full] = hf
            rest = [i for i, k in enumerate(ks) if self.cached(k)]
            if rest:
                row = [full.index(i - ks[i] % c) for i in rest]
                sub = [{n: t[row] for n, t in r.items()} for r in refs]
                sel = [prog.get(ks[i], {}).get("sel") for i in rest]
                given = (torch.cat([x.to(dev) for x in sel], dim=1)
                         if all(x is not None for x in sel) else None)
                h[rest] = self.tower.cached(px[rest], sub, self.ratio, given)
            del refs
            pooled = self.pool(h)
            for i, k in enumerate(ks):
                out[k] = (mem, k)
                out_own[k] = (mem_own, k)
                x = pooled[i:i + 1]
                ch_own, mean_own = rm.chunk_channels(x, self.channel_keep)
                given = prog.get(k, {}).get("channels")
                if given is None:
                    mean = mean_own
                else:
                    ch, mean = rm.chunk_channels(x, self.channel_keep, given)
                    took = torch.equal(ch, given.to(ch))
                    tally[0] += int(took and not torch.equal(ch, ch_own))
                    tally[1] += int(not took)
                mem = mem + mean
                mem_own = mem_own + mean_own
        print(f"stcbench: pruner memory took the program's channels where "
              f"they differ in {tally[0]} of {upto + 1} chunks, refused "
              f"them in {tally[1]}", file=sys.stderr)
        return (out, out_own) if own else out
