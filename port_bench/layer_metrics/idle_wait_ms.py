"""Device-idle ms a step (or batch) in the gaps that open while the host
is inside one of the program's spans that wait on the card: the blocking
uploads, the read of the deferred step metrics and the embeddings' copy
back."""

from port_bench.layer_metrics._spans import gap_ms, spans

WAITS = ("batch.upload", "metrics.drain", "embed.upload", "embed.readback")


def read(trace):
    return gap_ms(trace, spans(trace, WAITS))
