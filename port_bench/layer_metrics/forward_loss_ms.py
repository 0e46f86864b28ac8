"""Device ms a step inside the program's ``step.forward_loss`` range: the
forward of every view and the triplet and local-local losses."""

from port_bench.layer_metrics._split import device_ms


def read(trace):
    return device_ms(trace, ("step.forward_loss",))
