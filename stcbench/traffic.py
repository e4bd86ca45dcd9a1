"""The one traffic generator: everything a cell sends to the program, made
from the seed and the parameters of its mix (``workloads/<traffic>.json``).

Video.  Each video is synthetic RGB at the mix's frame size: a textured
scene (a sum of smooth random octaves, per colour channel) seen through a
window that drifts and zooms a little each frame, with a cut to a new
scene every ``scene_frames`` frames, so consecutive frames share most of
their content as real video does.  Frames are drawn on the device in
batches and brought to the host as uint8.

The init prompt's token ids, and which chunks the check reads
(``marked``, ``pick``), are drawn from the seed too.
"""

from __future__ import annotations

import hashlib
import json
from typing import List

import numpy as np
import torch
import torch.nn.functional as F


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(_torch_seed(seed, "rng", *tags))


def _torch_seed(seed: int, *tags) -> int:
    h = hashlib.sha256(":".join(str(x) for x in (seed,) + tags).encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def scene_lengths(seed: int, video: int, n: int, lo: int, hi: int):
    rng = _rng(seed, 1, video)
    out, total = [], 0
    while total < n:
        k = int(rng.integers(lo, hi + 1))
        out.append(min(k, n - total))
        total += k
    return out


@torch.no_grad()
def render_video(seed: int, video: int, n: int, mix: dict,
                 device) -> np.ndarray:
    """(n, H, W, 3) uint8 frames of video number `video`."""
    H, W = mix["frame_hw"]
    lo, hi = mix["scene_frames"]
    drift_lo, drift_hi = mix["drift_per_frame"]
    zoom = mix["zoom_per_frame"]
    out = np.empty((n, H, W, 3), dtype=np.uint8)
    dev = torch.device(device)
    pos = 0
    for s, length in enumerate(scene_lengths(seed, video, n, lo, hi)):
        rng = _rng(seed, 2, video, s)
        g = torch.Generator(device=dev).manual_seed(
            _torch_seed(seed, "scene", video, s))
        tex = torch.zeros((1, 3, 2 * H, 2 * W), device=dev)
        for octave in range(5):
            h0, w0 = 3 * 2 ** octave, 5 * 2 ** octave
            noise = torch.randn((1, 3, h0, w0), generator=g, device=dev)
            tex += F.interpolate(noise, size=(2 * H, 2 * W),
                                 mode="bicubic", align_corners=False) \
                * 0.6 ** octave
        tex = (tex - tex.mean()) / tex.std() * 48.0 + 128.0
        # the window: a scale, a start and a velocity in texture units
        scale0 = float(rng.uniform(0.55, 0.8))
        dz = float(rng.uniform(-zoom, zoom))
        speed = float(rng.uniform(drift_lo, drift_hi)) / W
        angle = float(rng.uniform(0, 2 * np.pi))
        c0 = rng.uniform(-0.1, 0.1, size=2)
        i = torch.arange(length, device=dev, dtype=torch.float32)
        scale = (scale0 * (1.0 + dz) ** i).clamp(0.4, 0.95)
        margin = 1.0 - scale
        cx = float(c0[0]) + float(speed * np.cos(angle)) * i
        cy = float(c0[1]) + float(speed * np.sin(angle)) * i
        # reflect at the texture's edges
        cx = margin - (cx - margin).remainder(4 * margin).sub(
            2 * margin).abs()
        cy = margin - (cy - margin).remainder(4 * margin).sub(
            2 * margin).abs()
        for b in range(0, length, 64):
            sl = slice(b, min(length, b + 64))
            m = scale[sl].numel()
            theta = torch.zeros((m, 2, 3), device=dev)
            theta[:, 0, 0] = scale[sl]
            theta[:, 1, 1] = scale[sl]
            theta[:, 0, 2] = cx[sl]
            theta[:, 1, 2] = cy[sl]
            grid = F.affine_grid(theta, (m, 3, H, W), align_corners=False)
            img = F.grid_sample(tex.expand(m, -1, -1, -1), grid,
                                mode="bilinear", align_corners=False)
            img = img.clamp(0, 255).round().to(torch.uint8)
            out[pos + b:pos + b + m] = img.permute(0, 2, 3, 1).cpu().numpy()
        pos += length
    return out


def init_prompt(seed: int, n: int, vocab: int) -> List[int]:
    return [int(x) for x in _rng(seed, 3).integers(0, vocab, size=n)]


def marked(seed: int, every: int, *tags) -> bool:
    """Whether the check reads this chunk or question: one in `every`,
    drawn from the seed."""
    h = hashlib.sha256(":".join(str(x) for x in (seed, "mark") + tags)
                       .encode()).digest()
    return int.from_bytes(h[:4], "little") % every == 0


def pick(seed: int, items: list, k: int, *tags) -> list:
    """k of items drawn from the seed, in their order."""
    if len(items) <= k:
        return list(items)
    idx = sorted(_rng(seed, 5, *tags).choice(len(items), size=k,
                                             replace=False).tolist())
    return [items[i] for i in idx]
