"""Device kernels a profiled request ran (a CUDA graph's replayed kernels
included)."""

from benchmark.yardstick.readers import Reading


def read(r: Reading):
    if not r.trace.kernels:
        return None
    return len(r.trace.kernels) / r.trace.calls
