"""Device ms a step of the kernels launched inside the program's
``moco.momentum`` span (``models/moco.py::MoCoBank.momentum_update``): the
key encoder's exponential moving average of the query parameters, copies
left out."""

from port_bench.layer_metrics._split import device_ms

MOMENTUM = "moco.momentum"


def read(trace):
    return device_ms(trace, (MOMENTUM,))
