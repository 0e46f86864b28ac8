"""Device ms a step of the augmentation: the kernels launched in the
step's host span (``driver.step``, from one batch handed to the epoch to
the next request) outside the step's three ranges, copies left out. That
is ``train/driver.py::_device_batch``'s ``train_augment`` of each view."""

from port_bench.layer_metrics._split import RANGES, device_ms


def read(trace):
    return device_ms(trace, ("driver.step",), exclude=RANGES)
