"""The rotated-IoU kernel's share (%) of its roofline in the profiled
stretch: for each launch the larger of its operations over the float32 peak
and its bytes over HBM bandwidth (yardstick/iou.py's iou_ops and iou_bytes
on the NMS inputs that the reference derives for the profiled requests),
summed, over the kernel's device time summed over the same launches. None
when the trace holds another number of launches than the requests made."""

from benchmark.yardstick.iou import iou_bytes, iou_ops
from benchmark.yardstick.readers import PEAK_F32_FLOPS, PEAK_HBM_BYTES, Reading


def read(r: Reading):
    times = r.trace.kernel_us("rotated_iou")
    if not r.iou_cases or len(times) != len(r.iou_cases):
        return None
    bound = sum(max(iou_ops(c, c) / PEAK_F32_FLOPS,
                    iou_bytes(c, c) / PEAK_HBM_BYTES) for c in r.iou_cases)
    return 100.0 * bound / (sum(times) / 1e6)
