"""append_ms_per_frame: the append span's time per frame over the window's
unprofiled chunks (layer: LM append; CUDA events around _append_flat)."""

from stcbench.metrics._common import per_frame_ms


def read(rec):
    return per_frame_ms(rec, "append")
