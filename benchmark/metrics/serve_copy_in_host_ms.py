"""Host ms a served request inside the program's ``stage/serve_copy_in``
range (serving.ServingModel.__call__: the batch check, the settling of the
last replay's stage marks and the copies into the static input
buffers)."""

from benchmark.yardstick.readers import Reading, range_host_ms


def read(r: Reading):
    return range_host_ms(r, "stage/serve_copy_in")
