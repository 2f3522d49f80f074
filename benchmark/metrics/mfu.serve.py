"""The served frames' needed FLOPs (benchmark/flops/<config>.py) over the
window's wall time, as a share (%) of the chips' float32 peak."""

from benchmark.yardstick.readers import Reading, mfu


def read(r: Reading):
    return mfu(r)
