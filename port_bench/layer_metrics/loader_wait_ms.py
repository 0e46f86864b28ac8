"""Host ms a step waits in the loader's ``__next__`` (the program's
PrefetchLoader, asked through the benchmark's window), the mean over the
steps outside the traced sub-window."""


def read(trace):
    waits = trace.get("outside_waits_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
