"""Share of the card's dense bf16 peak that the embedding pass's forward
FLOPs reach (``port_bench/flops.py``), over the clips embedded outside the
traced sub-window and their seconds."""

from port_bench.layer_metrics._split import mfu


def read(trace):
    return mfu(trace, trace["flops_per_clip"], trace["clips_per_step"])
