"""LLaVA-OneVision (SigLIP + projector + 2x bilinear pooling + STC-Pruner
+ Qwen2): how the benchmark builds the program from a configuration file,
and the matching plain reference of one chunk's vision side.

The weights reach the program through its own checkpoint converters
(``stc_tpu_torch.models.convert``), the path its loaders take, one tensor
at a time from ``weights.LazyState``.
"""

from __future__ import annotations

import torch

from stcbench import counts, weights
from stcbench.lms.qwen2 import Qwen2LM
from stcbench.reference import vision as rv

VISION = "vision_tower.vision_model."
PROJ = ("multi_modal_projector.linear_1.", "multi_modal_projector.linear_2.")
LM, HEAD = "language_model.model.", "language_model.lm_head.weight"
CHECK_NAMES = ("feature_gap", "memory_gap", "page_gap", "init_gap")


def specs(cfg: dict) -> dict:
    v, t = cfg["vision_config"], cfg["text_config"]
    out = weights.vision_specs(dict(v, num_hidden_layers=v["run_layers"]),
                               VISION, "siglip")
    out.update(weights.projector_specs(v["hidden_size"], t["hidden_size"],
                                       v["dtype"], PROJ))
    out.update(weights.qwen2_specs(t, LM, HEAD))
    return out


def session_config(cfg: dict):
    from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                      SessionConfig)
    s = cfg["session"]
    return SessionConfig(rekv=ReKVConfig(**s["rekv"]),
                         cacher=CacherConfig(**s["cacher"]),
                         pruner=PrunerConfig(**s["pruner"]),
                         encode_chunk_frames=s["encode_chunk_frames"])


def qwen2_config(t: dict):
    from stc_tpu_torch.models import qwen2 as qw
    return qw.Qwen2Config(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"],
        num_kv_heads=t["num_key_value_heads"],
        head_dim=t["hidden_size"] // t["num_attention_heads"],
        intermediate_size=t["intermediate_size"],
        rope_base=float(t["rope_theta"]), rms_eps=t["rms_norm_eps"])


def build(cfg: dict, seed: int, device):
    """The program's session over this seed's weights."""
    from stc_tpu_torch.models import llava_onevision as lo
    from stc_tpu_torch.models import siglip as sg
    from stc_tpu_torch.models.convert import (convert_projector,
                                              convert_qwen2, convert_siglip)
    v, t = cfg["vision_config"], cfg["text_config"]
    vcfg = sg.SiglipConfig(
        hidden_size=v["hidden_size"], num_layers=v["run_layers"],
        num_heads=v["num_attention_heads"],
        intermediate_size=v["intermediate_size"],
        image_size=v["image_size"], patch_size=v["patch_size"])
    mcfg = lo.LlavaOVConfig(vision=vcfg, text=qwen2_config(t))
    model = lo.LlavaOV(mcfg, dtype=weights.DTYPES[t["dtype"]],
                       vision_dtype=weights.DTYPES[v["dtype"]],
                       device=device)
    state = weights.LazyState(specs(cfg), seed, device)
    convert_siglip(state, model.vision, prefix=VISION)
    convert_projector(state, model.projector, prefix=PROJ[0][:-len(
        "linear_1.")])
    convert_qwen2(state, model.text, prefix=LM)
    return lo.build_session(model, session_config(cfg),
                            state_dtype=weights.DTYPES[t["dtype"]],
                            device=device)


def vision_work(cfg: dict, cached: bool, frame=counts.siglip_frame):
    """The work of one frame through the tower (frame: its float32
    products) and the projector."""
    v, t = cfg["vision_config"], cfg["text_config"]
    ratio = cfg["session"]["cacher"]["update_token_ratio"]
    rows = (v["image_size"] // v["patch_size"]) ** 2
    return counts.Work(f32=frame(v, cached, ratio),
                       bytes=counts.vit_bytes(v)) + \
        counts.projector(v["hidden_size"], t["hidden_size"], rows)


def lm(cfg: dict, get, device):
    """The language model: Qwen2."""
    return Qwen2LM(cfg, get, device, LM, HEAD)


def instrument(session, run):
    """Hooks on the session's vision pipeline instance for the check: the
    pruner state each chunk leaves (run.pruner_states) and the tokens the
    cacher recomputed in each layer of each cached chunk
    (run.cacher_choices), both by (video, frame) and kept by reference,
    no copy; on a chunk the check reads (run.hooks.capture), the pruner's
    kept tokens."""
    vis, tower = session.vision, session.vision.model.vision
    encode, encode_cached = vis.encode, tower.encode_cached

    def enc(pixels, vstate, pstate, cached):
        out = encode(pixels, vstate, pstate, cached)
        run.pruner_states[run.where] = out[3]
        if run.hooks.capture is not None:
            run.hooks.capture["idx"] = out[1][0]
        return out

    def enc_cached(*a, **k):
        out = encode_cached(*a, **k)
        run.cacher_choices[run.where] = out[1]
        return out

    vis.encode = enc
    tower.encode_cached = enc_cached


def pruner_memory(pstate):
    """(mean_sum, count) of a pruner state of one stream."""
    return pstate.mean_sum[0], int(pstate.count[0])


class VisionReference:
    """One 1-frame chunk's pruned features from its frames, and the pruner
    memory of a video from its frames, in float32 or at the control's
    precision."""

    def __init__(self, cfg: dict, get, prec):
        self.cfg, self.get, self.prec = cfg, get, prec
        self.v = cfg["vision_config"]
        self.tower = rv.Tower(get, VISION, self.v, "siglip", prec)
        s = cfg["session"]
        self.cacher = s["cacher"]
        self.ratio = s["cacher"]["update_token_ratio"]
        self.keep = s["pruner"]["token_per_frame"]
        self.channel_keep = s["pruner"].get("channel_keep_ratio", 0.5)
        self.S = self.v["image_size"]
        self.n_sel = int(cfg["text_config"]["hidden_size"]
                         * self.channel_keep)

    def cached(self, k: int) -> bool:
        c = self.cacher
        return c["strategy"] == "cacher" and k % c["cache_interval"] != 0

    def px(self, f):
        return rv.preprocess(f, self.S, rv.SIGLIP_MEAN, rv.SIGLIP_STD)

    def pool(self, h):
        feats = rv.project(self.get, PROJ, h, self.prec)
        return rv.bilinear_pool(feats, self.S // self.v["patch_size"])

    @torch.no_grad()
    def chunk(self, prev, frame, cached: bool, memory, prog=None):
        """prev/frame: (1, H, W, 3) uint8 on the device (prev: the frame
        of the last full chunk, read when cached); memory: (mean_sum,
        count) before the chunk; prog: the program's choices to follow at
        near-ties (sel, idx, delta), or None.  Returns (T, E)."""
        prog = prog or {}
        if cached:
            _, refs = self.tower.full(self.px(prev))
            h = self.tower.siglip_cached(self.px(frame), refs, self.ratio,
                                         prog.get("sel"))
        else:
            h, _ = self.tower.full(self.px(frame))
        out = rv.prune(self.pool(h), memory[0].float(), memory[1], self.keep,
                       self.channel_keep, prog.get("delta"), prog.get("idx"))
        return out[0]

    @torch.no_grad()
    def replay(self, frames, upto: int, prog=None, own: bool = False,
               batch: int = 8):
        """The pruner memory (mean_sum, count) before each chunk 0..upto
        of one video, from its frames (n, H, W, 3) uint8 on the host,
        every chunk through this side's tower, cacher, projector and
        pooling.  prog: chunk -> the program's choices (sel, delta) to
        follow at near-ties, or None.  With own, the memory that takes
        this side's own channel order as well.  Returns {k: memory} (and
        the own one)."""
        prog = prog or {}
        dev = self.tower.w("embeddings.position_embedding.weight").device
        c = self.cacher["cache_interval"]
        step = -(-batch // c) * c
        mem = torch.zeros(self.n_sel, device=dev)
        mem_own = mem.clone()
        out, out_own = {}, {}
        for k0 in range(0, upto + 1, step):
            ks = list(range(k0, min(upto + 1, k0 + step)))
            px = self.px(torch.as_tensor(frames[ks[0]:ks[-1] + 1],
                                         device=dev))
            full = [i for i, k in enumerate(ks) if not self.cached(k)]
            T = (self.S // self.v["patch_size"]) ** 2
            h = px.new_empty((len(ks), T, self.v["hidden_size"]))
            hf, refs = self.tower.full(px[full], every=True)
            h[full] = hf
            rest = [i for i, k in enumerate(ks) if self.cached(k)]
            if rest:
                # each cached frame against the last full frame before it
                row = [full.index(i - ks[i] % c) for i in rest]
                sub = [{n: t[row] for n, t in r.items()} for r in refs]
                sel = [prog.get(ks[i], {}).get("sel") for i in rest]
                given = (torch.cat([x.to(dev) for x in sel], dim=1)
                         if all(x is not None for x in sel) else None)
                h[rest] = self.tower.siglip_cached(px[rest], sub, self.ratio,
                                                   given)
            del refs
            pooled = self.pool(h)
            for i, k in enumerate(ks):
                out[k] = (mem, k)
                out_own[k] = (mem_own, k)
                _, mean = rv.chunk_channels(pooled[i:i + 1],
                                            self.channel_keep,
                                            prog.get(k, {}).get("delta"))
                mem = mem + mean
                if own:
                    mem_own = mem_own + rv.chunk_channels(
                        pooled[i:i + 1], self.channel_keep)[1]
        return (out, out_own) if own else out
