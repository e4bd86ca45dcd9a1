"""vision_ms_per_frame: the vision span's time per frame over the
window's unprofiled chunks (layer: vision; CUDA events around the
pipeline's full / cached call)."""

from stcbench.metrics._common import per_frame_ms


def read(rec):
    return per_frame_ms(rec, "vision")
