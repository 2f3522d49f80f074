"""Idle device ms a served request that the program's own host work
causes: over each span of its ``stage/serve_copy_in``,
``stage/serve_replay`` and ``stage/serve_copy_out`` ranges, the span's
length less the union of the device activity inside it, summed. The rest
of ``idle_share`` lies in the client's code or inside the replay."""

from benchmark.yardstick.readers import Reading

RANGES = ("stage/serve_copy_in", "stage/serve_replay",
          "stage/serve_copy_out")


def read(r: Reading):
    spans = [span for name in RANGES
             for span in r.trace.ranges.get(name, {}).get("spans", [])]
    if not spans:
        return None
    acts = sorted((s, s + d) for _, s, d in r.trace.kernels + r.trace.copies)
    idle_us = 0.0
    for a, b in spans:
        busy, end = 0.0, a
        for s, e in acts:
            s, e = max(s, end), min(e, b)
            if e > s:
                busy += e - s
                end = e
        idle_us += (b - a) - busy
    return idle_us / r.trace.calls / 1e3
