"""Device ms a step (or batch) of the program's host-to-device uploads:
the ``Memcpy HtoD`` copies whose launching op starts inside a span whose
name ends in ``.upload`` (``train/driver.py::_device_batch``'s
``batch.upload``, ``evaluation/embed.py``'s ``embed.upload``)."""

from port_bench.layer_metrics._spans import copy_ms, spans

SUFFIX = ".upload"
COPY = "Memcpy HtoD"


def read(trace):
    return copy_ms(trace, spans(trace, suffix=SUFFIX), COPY)
