"""Device ms a step, on rank 0, of the kernels launched inside the
program's ``dist.sum_gradients`` span (``parallel/dist.py::sum_gradients``):
the flattening of the parameter gradients, their all-reduce over the
process group and the copies back; an all-reduce's kernel includes the
time it waits for the slowest rank."""

from port_bench.layer_metrics._split import device_ms

SUM_GRADIENTS = "dist.sum_gradients"


def read(trace):
    return device_ms(trace, (SUM_GRADIENTS,))
