"""Device ms a step (or batch) of the kernels launched inside the
program's ``model.stem`` span: the stem's forward (convolution,
BatchNorm, ReLU, max-pool) in ``models/resnet3d.py`` and
``models/slowfast.py``. Autograd runs the backward outside the span."""

from port_bench.layer_metrics._split import device_ms

STEM = "model.stem"


def read(trace):
    return device_ms(trace, (STEM,))
