"""Device ms a served request: the union of the device activities that
began inside the benchmark's ``bench/served_call`` range (copy-in, the
replayed CUDA graph's kernels, copy-out). The profiler links a replayed
graph's kernels to no host operation, so they are taken by time: one
client, nothing else runs on the card."""

from benchmark.yardstick.readers import Reading


def read(r: Reading):
    busy = r.trace.busy_in("bench/served_call")
    if not busy:
        return None
    return busy / r.trace.calls * 1e3
