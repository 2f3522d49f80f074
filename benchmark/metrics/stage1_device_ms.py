"""Device ms a request of the kernels launched inside the ``stage/stage1``
range(s)."""

from benchmark.yardstick.readers import Reading, range_device_ms


def read(r: Reading):
    return range_device_ms(r, "stage/stage1")
