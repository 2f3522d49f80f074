"""Host ms a request inside the ``stage/pose_graph`` range (the pose graph
is host-bound: its launches and its host-side set-up)."""

from benchmark.yardstick.readers import Reading, range_host_ms


def read(r: Reading):
    return range_host_ms(r, "stage/pose_graph")
