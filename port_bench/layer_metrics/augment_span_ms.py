"""Device ms a step of the kernels launched inside the program's
``batch.augment`` span (``train/driver.py::_device_batch``'s
``train_augment`` of each view), copies left out: the augmentation read
where it happens, beside ``augment_ms``'s remainder."""

from port_bench.layer_metrics._split import device_ms

AUGMENT = "batch.augment"


def read(trace):
    return device_ms(trace, (AUGMENT,))
