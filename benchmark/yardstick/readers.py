"""What a per-layer reader (benchmark/metrics/<metric>.py, a function
``read(reading) -> float | None``) is given, and the arithmetic the readers
share. A reader that finds nothing to read returns None, and the metric is
left out of the result line."""

from __future__ import annotations

from dataclasses import dataclass, field

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates
# at the 700 W power limit): float32 outside the tensor cores, which is the
# configurations' own precision (TF32 off), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


@dataclass
class Reading:
    trace: object                 # yardstick.trace.TraceData
    window: object                # yardstick.cell.Window
    chips: int
    profiled: list                # indices of the profiled requests
    flops: list = field(default_factory=list)   # per completed request
    iou_cases: list = field(default_factory=list)  # per profiled call:
    #                               the (B, K, 4, 2) NMS inputs it launched


def range_device_ms(r: Reading, name: str):
    """Device ms a call of the kernels launched inside range ``name``."""
    got = r.trace.ranges.get(name)
    if not got or got["device_us"] <= 0:
        return None
    return got["device_us"] / r.trace.calls / 1e3


def range_host_ms(r: Reading, name: str):
    got = r.trace.ranges.get(name)
    if not got:
        return None
    return got["host_us"] / r.trace.calls / 1e3


def mfu(r: Reading):
    """The needed FLOPs of the window's completed work over its wall time,
    as a share (%) of the float32 peak of the chips used."""
    if not r.flops or r.window.seconds <= 0:
        return None
    return 100.0 * sum(r.flops) / r.window.seconds / (PEAK_F32_FLOPS
                                                      * r.chips)
