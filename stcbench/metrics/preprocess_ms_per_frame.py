"""preprocess_ms_per_frame: the preprocess span's time per frame over
the window's unprofiled chunks (layer: host pipeline; host clock)."""

from stcbench.metrics._common import per_frame_ms


def read(rec):
    return per_frame_ms(rec, "preprocess")
