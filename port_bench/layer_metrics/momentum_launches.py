"""Kernels and copies a step that the program launches inside its
``moco.momentum`` span (``models/moco.py::MoCoBank.momentum_update``): the
launches the key encoder's moving average costs, one loop over every
parameter tensor. The profiler can link one launch to two nested host
ops; a launch of a given name and duration counts at most as often as the
device timeline holds it."""

from collections import Counter

from port_bench.layer_metrics._spans import spans

MOMENTUM = "moco.momentum"


def read(trace):
    ivs = spans(trace, (MOMENTUM,))
    if not (trace["steps"] and trace["device"] and ivs):
        return None
    linked = Counter((name, us) for start, kernels in trace["ops"]
                     if any(a <= start < b for a, b in ivs)
                     for name, us in kernels)
    ran = Counter((name, e - s) for name, s, e in trace["device"])
    return sum(min(n, ran[key]) for key, n in linked.items()) \
        / trace["steps"]
