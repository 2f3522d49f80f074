"""Device ms a profiled request of the served graph's ``stage/fusion`` segment:
the mean over the last profiled requests of the program's stage-mark log
(timed CUDA events at the stage boundaries of the replayed graph;
coalign_tpu_torch/utils/profiling.py)."""

from benchmark.yardstick.readers import Reading


def read(r: Reading):
    try:
        from coalign_tpu_torch.utils.profiling import mean_stage_ms
    except ImportError:     # a program without the stage-mark log
        return None
    return mean_stage_ms("stage/fusion", r.trace.calls)
