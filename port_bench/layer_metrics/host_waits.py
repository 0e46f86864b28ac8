"""CUDA runtime calls a step (or batch) that block the host until the
card has caught up, counted where their host interval lies inside one of
the program's spans. An exact count: the same in every traced run of a
cell. None for a program that does not mark its waiting spans."""

from port_bench.layer_metrics._spans import calls_inside, spans

SPANS = ("batch.upload", "batch.augment", "step.forward_loss",
         "step.backward", "step.optimizer", "metrics.drain", "model.stem",
         "embed.upload", "embed.forward", "embed.readback")
WAITS = ("batch.upload", "metrics.drain", "embed.upload", "embed.readback")
CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def read(trace):
    if not spans(trace, WAITS):
        return None
    return calls_inside(trace, CALLS, spans(trace, SPANS))
