"""Device ms a request of the kernels launched inside the ``stage/fusion``
range(s), in CoAlign's two-pass cell, whose end-to-end metrics are its own
(``*.two_pass``)."""

from benchmark.yardstick.readers import Reading, range_device_ms


def read(r: Reading):
    return range_device_ms(r, "stage/fusion")
