"""Device ms a step inside the program's ``step.backward`` range."""

from port_bench.layer_metrics._split import device_ms


def read(trace):
    return device_ms(trace, ("step.backward",))
