"""idle_share.ingest: the share of the profiled sub-window in which no kernel
or copy ran on the device, in %."""

from stcbench.metrics._common import idle_share


def read(rec):
    return idle_share(rec, "ingest")
