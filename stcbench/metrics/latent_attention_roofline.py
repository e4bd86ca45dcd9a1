"""latent_attention_roofline: the profiled chunks' latent_attention calls'
least time (stcbench/lms/kimi.py) over the device time of the op's kernels
(the combine included), in %."""

from stcbench.metrics._common import roofline


def read(rec):
    return roofline(rec, "latent_attention")
