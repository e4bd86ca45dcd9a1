"""stream_attention_roofline: the profiled chunks' stream_attention calls'
least time (stcbench/counts.py) over the device time of the op's kernels
(the cover pre-pass and the combine included), in %."""

from stcbench.metrics._common import roofline


def read(rec):
    if rec["kind"] != "ingest":
        return None
    return roofline(rec, "stream_attention")
