"""Share of the card's dense bf16 peak that the training steps' model
FLOPs reach: forward plus twice it for the backward, less the stems' input
gradient (``port_bench/flops.py``), times the clips of a step and the
steps outside the traced sub-window, over their seconds."""

from port_bench.layer_metrics._split import mfu


def read(trace):
    return mfu(trace, trace["flops_per_clip"], trace["clips_per_step"])
