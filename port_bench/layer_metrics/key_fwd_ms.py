"""Device ms a step of the kernels launched inside the program's
``moco.keys`` span (``models/moco.py::MoCoBank.keys``): the key encoder's
gradient-free train-mode forward and the keys' normalization, copies left
out."""

from port_bench.layer_metrics._split import device_ms

KEYS = "moco.keys"


def read(trace):
    return device_ms(trace, (KEYS,))
