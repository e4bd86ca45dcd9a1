"""LongVA (CLIP-L/14-336 with the MLP-skip cacher + mlp2x projector + 2x2
average pooling + Qwen2): how the benchmark builds the program from a
configuration file, and the matching plain reference of one chunk's
vision side.  The features are the hidden states after layer
run_layers - 1 (the checkpoint's feature layer -2).
"""

from __future__ import annotations

import torch

from stcbench import counts, weights
from stcbench.families import llava_ov
from stcbench.families.llava_ov import qwen2_config, session_config
from stcbench.lms.qwen2 import Qwen2LM
from stcbench.reference import vision as rv

VISION = "model.vision_tower.vision_tower.vision_model."
PROJ = ("model.mm_projector.0.", "model.mm_projector.2.")
LM, HEAD = "model.", "lm_head.weight"
CHECK_NAMES = ("feature_gap", "page_gap", "init_gap")


def specs(cfg: dict) -> dict:
    v, t = cfg["vision_config"], cfg["text_config"]
    out = weights.vision_specs(dict(v, num_hidden_layers=v["run_layers"]),
                               VISION, "clip")
    out.update(weights.projector_specs(v["hidden_size"], t["hidden_size"],
                                       v["dtype"], PROJ))
    out.update(weights.qwen2_specs(t, LM, HEAD))
    return out


def build(cfg: dict, seed: int, device):
    from stc_tpu_torch.models import clip as cl
    from stc_tpu_torch.models import longva as lv
    from stc_tpu_torch.models.convert import (convert_clip, convert_mlp2x,
                                              convert_qwen2)
    v, t = cfg["vision_config"], cfg["text_config"]
    vcfg = cl.CLIPConfig(
        hidden_size=v["hidden_size"], num_layers=v["run_layers"],
        num_heads=v["num_attention_heads"],
        intermediate_size=v["intermediate_size"],
        image_size=v["image_size"], patch_size=v["patch_size"])
    mcfg = lv.LongVAConfig(vision=vcfg, text=qwen2_config(t),
                           pool_stride=cfg["pool_stride"])
    model = lv.ClipVLM(mcfg, dtype=weights.DTYPES[t["dtype"]],
                       vision_dtype=weights.DTYPES[v["dtype"]],
                       device=device)
    state = weights.LazyState(specs(cfg), seed, device)
    convert_clip(state, model.vision, prefix=VISION)
    convert_mlp2x(state, model.projector, prefix="model.mm_projector.")
    convert_qwen2(state, model.text, prefix=LM)
    return lv.build_session(model, session_config(cfg),
                            state_dtype=weights.DTYPES[t["dtype"]],
                            device=device)


def vision_work(cfg: dict, cached: bool):
    """The work of one frame through the tower and the projector."""
    return llava_ov.vision_work(cfg, cached, counts.clip_frame)


def lm(cfg: dict, get, device):
    """The language model: Qwen2."""
    return Qwen2LM(cfg, get, device, LM, HEAD)


def instrument(session, run):
    """A hook on the tower instance for the check: on a chunk the check
    reads (run.hooks.capture), the tokens the MLP-skip cacher recomputed
    in each layer (the tower's last_rows, kept by reference, no copy) in
    run.cacher_choices by (video, frame).  LongVA has no pruner."""
    tower = session.vision.model.vision
    encode_cached = tower.encode_cached

    def enc_cached(*a, **k):
        out = encode_cached(*a, **k)
        if run.hooks.capture is not None:
            run.cacher_choices[run.where] = list(tower.last_rows)
        return out

    tower.encode_cached = enc_cached


class VisionReference:
    def __init__(self, cfg: dict, get, prec):
        self.cfg, self.get, self.prec = cfg, get, prec
        self.v = cfg["vision_config"]
        self.tower = rv.Tower(get, VISION, self.v, "clip", prec)
        self.skip = cfg["session"]["cacher"]["update_token_ratio"]
        self.n_out = self.v["run_layers"] - 1
        self.stride = cfg["pool_stride"]

    @torch.no_grad()
    def chunk(self, prev, frame, cached: bool, memory=None,
              prog=None) -> torch.Tensor:
        """One 1-frame chunk's pooled features (T, E); LongVA keeps no
        pruner memory.  prog: the program's choices to follow at
        near-ties (sel: the cacher's recomputed tokens of each layer), or
        None."""
        S = self.v["image_size"]

        def px(f):
            return rv.preprocess(f, S, rv.CLIP_MEAN, rv.CLIP_STD)

        if cached:
            _, refs = self.tower.clip_features(px(prev), self.n_out)
            h = self.tower.clip_cached(px(frame), refs, self.skip,
                                       self.n_out, (prog or {}).get("sel"))
        else:
            h, _ = self.tower.clip_features(px(frame), self.n_out)
        feats = rv.project(self.get, PROJ, h[:, 1:], self.prec)
        return rv.avg_pool(feats, S // self.v["patch_size"], self.stride)[0]
