"""The floating-point operations that pointpillar_coalign_opv2v's requests
need, from the configuration's shapes and the request's own inputs (a
multiply-add counts 2).

Counted: every convolution, transposed convolution and linear layer on
the agents that are real (padded agent slots are left out, whatever the
program computes on them), the warp's bilinear taps and the attention of
the fusion. Not counted: norms, activations, decoding, NMS and the pose
graph, which are elementwise or small. So the count is a floor of the work,
the same whatever implements it, and an mfu from it cannot pass 100% of
the peak by counting too much.
"""

from __future__ import annotations


def _canvas(args: dict) -> tuple:
    r, v = args["lidar_range"], args["voxel_size"]
    return (int(round((r[4] - r[1]) / v[1])), int(round((r[3] - r[0]) / v[0])))


def conv(c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * c_in * c_out * k * k * h_out * w_out


def trunk_scales(args: dict) -> tuple:
    """(the FLOPs of the ResNet trunk on one agent's canvas, each scale's
    (channels, height, width))."""
    bb = args["base_bev_backbone"]
    h, w = _canvas(args)
    c_in = args["pillar_vfe"]["num_filters"][-1]
    total, scales = 0.0, []
    for blocks, stride, c in zip(bb["layer_nums"], bb["layer_strides"],
                                 bb["num_filters"]):
        h, w = h // stride, w // stride
        total += conv(c_in, c, 3, h, w) + conv(c, c, 3, h, w)
        if stride != 1 or c_in != c:
            total += conv(c_in, c, 1, h, w)
        total += (blocks - 1) * 2 * conv(c, c, 3, h, w)
        scales.append((c, h, w))
        c_in = c
    return total, scales


def decode_shrink_heads(args: dict, heads: int) -> float:
    """The deblocks, the shrink header and ``heads`` 1x1 output channels on
    one map."""
    bb = args["base_bev_backbone"]
    _, scales = trunk_scales(args)
    total = 0.0
    for (c, h, w), up, s in zip(scales, bb["num_upsample_filter"],
                                bb["upsample_strides"]):
        total += conv(c, up, int(s), h, w)      # transposed: k*k taps a input
    h, w = scales[0][1] * int(bb["upsample_strides"][0]), \
        scales[0][2] * int(bb["upsample_strides"][0])
    sh = args["shrink_header"]
    c_in = sh["input_dim"]
    for k, d, s in zip(sh["kernal_size"], sh["dim"], sh["stride"]):
        h, w = h // s, w // s
        total += conv(c_in, d, k, h, w) + conv(d, d, 3, h, w)
        c_in = d
    return total + conv(c_in, heads, 1, h, w)


def pillars(args: dict, points: int) -> float:
    """The PFN's linear layer on the agent's points."""
    return 2.0 * 10 * args["pillar_vfe"]["num_filters"][-1] * points


def _heads(args: dict) -> int:
    a = args["anchor_number"]
    return a * (1 + 7 + args["dir_args"]["num_bins"]
                + args.get("uncertainty_dim", 0))


def flagship(args: dict, agent_points: list) -> float:
    """One B = 1 frame of the flagship with one entry of ``agent_points``
    (its point count) for each real agent: pillars and trunk on each, the
    warp and the attention of every scale, then decode, shrink and heads
    once on the fused map."""
    trunk, scales = trunk_scales(args)
    n = len(agent_points)
    fuse = sum(8.0 * c * h * w * (n - 1) + 4.0 * c * h * w * n
               for c, h, w in scales)
    return (sum(pillars(args, p) for p in agent_points) + n * trunk + fuse
            + decode_shrink_heads(args, _heads(args)))


def single(args: dict, agent_points: list) -> float:
    """The single-agent detector on each real agent's frame."""
    trunk, _ = trunk_scales(args)
    return sum(pillars(args, p) + trunk + decode_shrink_heads(args,
                                                              _heads(args))
               for p in agent_points)


def _points(frame: dict) -> list:
    return [len(a["points"]) for a in frame["agents"]]


def request_flops(config: dict, frame: dict, device=None) -> float:
    """A request of the flagship on ``frame`` (a scene of
    yardstick/scenes.py)."""
    return flagship(config["model"]["args"], _points(frame))


def stage1_flops(config: dict, frame: dict) -> float:
    """CoAlign's first pass on ``frame``: the stage-1 detector."""
    return single(config["stage1_model"]["args"], _points(frame))
