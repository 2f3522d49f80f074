"""Device ms a request of the kernels launched inside the
``stage/backbone_encode`` range(s)."""

from benchmark.yardstick.readers import Reading, range_device_ms


def read(r: Reading):
    return range_device_ms(r, "stage/backbone_encode")
