"""mfu.ingest: the least time the chip could take for the window's
unprofiled chunks (stcbench/counts.py: per chunk the larger of its
products at their dtype's peak and the bytes it must move), over the
time they took, in %."""

from stcbench.metrics._common import mfu


def read(rec):
    return mfu(rec, "ingest")
