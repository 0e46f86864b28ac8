"""Device ms a step, on rank 0, of the kernels launched inside the
program's ``dist.bn_stats`` spans (``models/layers.py``): the all-reduces
of BatchNorm's train-mode statistics in the forward and of their
gradients' sums in the backward, each including the time it waits for
the slowest rank."""

from port_bench.layer_metrics._split import device_ms

BN_STATS = "dist.bn_stats"


def read(trace):
    return device_ms(trace, (BN_STATS,))
