"""Share of the traced sub-window in which the device runs no kernel and
no copy."""

from port_bench.layer_metrics._split import idle_pct


def read(trace):
    return idle_pct(trace)
