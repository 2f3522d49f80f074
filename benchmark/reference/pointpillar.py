"""The plain reference of the PointPillars models the benchmark runs: the
CoAlign flagship (point_pillar_baseline_multiscale with att fusion at every
scale) and CoAlign's stage-1 detector (point_pillar_uncertainty).

Written from the reference implementation's equations (OpenCOOD's
pillar_vfe.py, point_pillar_scatter.py, base_bev_backbone_resnet.py,
resblock.py, downsample_conv.py, att_fuse.py and the multiscale model) as
plain functional PyTorch over a dict of tensors keyed by the reference's
state-dict names. It imports nothing of the program. Departures from the
published model, each the program's documented behaviour as well:
  * the pillar encoder reduces every point of a pillar, with no cap of 32
    points a pillar and no cap on the number of pillars (the traffic holds
    at most 30,000 points an agent, under the 70,000-pillar cap);
  * batch norms in eval mode use their running statistics; calibrate()
    sets those of a seeded model from one batch, as a first training step
    with momentum 1 would.

``lowp`` rounds the operands of every convolution and linear layer to
TF32's 10-bit mantissa: the control of the comparison (what the card
computes with TF32 on, the step below the configuration's float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TRUNK_EPS = 1e-5       # torchvision BasicBlock's norms
BEV_EPS = 1e-3         # the PFN's and the deblocks' norms


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Net:
    """Parameters (name -> tensor), the precision mode and, while
    calibrating, the masks that say which rows are real."""

    def __init__(self, params: dict, lowp: bool = False):
        self.p = params
        self.lowp = lowp
        self.calibrating = False
        # norms whose names start with one of these normalize by the batch's
        # statistics and move their running ones (training)
        self.train_norms = ()

    def _ops(self, *xs):
        return [tf32(x) if self.lowp and x is not None else x for x in xs]

    def conv(self, x, name, stride=1, padding=0, bias=False):
        x, w = self._ops(x, self.p[name + ".weight"])
        return F.conv2d(x, w, self.p[name + ".bias"] if bias else None,
                        stride=stride, padding=padding)

    def conv_t(self, x, name, stride):
        x, w = self._ops(x, self.p[name + ".weight"])
        return F.conv_transpose2d(x, w, stride=stride)

    def linear(self, x, name):
        x, w = self._ops(x, self.p[name + ".weight"])
        return x @ w.t()

    def bn(self, x, name, eps, mask=None, channel_dim=1):
        """Eval-mode batch norm; while calibrating, the running statistics
        are first set to the batch's (mean and biased variance over the
        elements ``mask`` (broadcast over the channels) keeps)."""
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        training = bool(self.train_norms) and name.startswith(self.train_norms)
        if self.calibrating or training:
            dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
            w = (torch.ones_like(x) if mask is None
                 else mask.unsqueeze(channel_dim).to(x.dtype).expand_as(x))
            n = w.sum(dims).clamp(min=1.0)
            mean = (x * w).sum(dims) / n
            var = (w * (x - mean.reshape(shape)) ** 2).sum(dims) / n
            m = 1.0 if self.calibrating else 0.1
            with torch.no_grad():
                for key, v in (("running_mean", mean), ("running_var", var)):
                    run = self.p[f"{name}.{key}"]
                    run.copy_((1 - m) * run + m * v.detach())
            if training:
                return ((x - mean.reshape(shape))
                        / torch.sqrt(var.reshape(shape) + eps)
                        * self.p[name + ".weight"].reshape(shape)
                        + self.p[name + ".bias"].reshape(shape))
        mean = self.p[name + ".running_mean"].reshape(shape)
        var = self.p[name + ".running_var"].reshape(shape)
        return ((x - mean) / torch.sqrt(var + eps)
                * self.p[name + ".weight"].reshape(shape)
                + self.p[name + ".bias"].reshape(shape))


def grid_shape(args: dict) -> tuple:
    r, v = args["lidar_range"], args["voxel_size"]
    return (int(round((r[4] - r[1]) / v[1])), int(round((r[3] - r[0]) / v[0])))


def pillar_canvas(net: Net, points, point_mask, args: dict):
    """points (F, N, 4), point_mask (F, N) -> the (F, 64, ny, nx) canvas:
    each point decorated with its offsets from its pillar's mean and centre
    (ref pillar_vfe.py), a linear layer, batch norm and ReLU, the max over
    each pillar scattered onto a zero canvas (ref
    point_pillar_scatter.py)."""
    r, v = args["lidar_range"], args["voxel_size"]
    ny, nx = grid_shape(args)
    f, n, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    ix = torch.floor((x - r[0]) / x.new_full((), v[0])).long()
    iy = torch.floor((y - r[1]) / y.new_full((), v[1])).long()
    valid = (point_mask & (x >= r[0]) & (x < r[3]) & (y >= r[1]) & (y < r[4])
             & (z >= r[2]) & (z <= r[5]) & (ix >= 0) & (ix < nx)
             & (iy >= 0) & (iy < ny))
    cells = ny * nx
    gid = torch.where(valid, iy * nx + ix + cells * torch.arange(
        f, device=points.device)[:, None], f * cells).reshape(-1)
    centre = torch.stack([ix.to(x.dtype) * v[0] + (v[0] / 2 + r[0]),
                          iy.to(x.dtype) * v[1] + (v[1] / 2 + r[1]),
                          torch.full_like(x, v[2] / 2 + r[2])], -1)
    offset = points[..., :3] - centre
    vf = valid[..., None].to(points.dtype)
    sums = torch.zeros(f * cells + 1, 4, dtype=points.dtype,
                       device=points.device)
    sums.index_add_(0, gid, (torch.cat([offset, torch.ones_like(x)[..., None]],
                                       -1) * vf).reshape(-1, 4))
    per = sums[gid].reshape(f, n, 4)
    mean = per[..., :3] / per[..., 3:].clamp(min=1.0)
    feats = torch.cat([points, offset - mean, offset], -1) * vf
    h = net.linear(feats, "pillar_vfe.pfn_layers.0.linear")
    h = torch.relu(net.bn(h, "pillar_vfe.pfn_layers.0.norm", BEV_EPS,
                          mask=valid, channel_dim=-1)) * vf
    c = h.shape[-1]
    canvas = torch.zeros(f * cells + 1, c, dtype=h.dtype, device=h.device)
    canvas.scatter_reduce_(0, gid[:, None].expand(-1, c), h.reshape(-1, c),
                           "amax", include_self=True)
    return canvas[:-1].reshape(f, ny, nx, c).permute(0, 3, 1, 2)


def trunk(net: Net, x, args: dict, mask=None) -> list:
    """The ResNet trunk (ref resblock.py ResNetModified of torchvision
    BasicBlocks): each stage's output."""
    bb = args["base_bev_backbone"]
    outs, c_in = [], x.shape[1]
    for s, (blocks, stride, c_out) in enumerate(zip(
            bb["layer_nums"], bb["layer_strides"], bb["num_filters"])):
        for i in range(blocks):
            name = f"backbone.resnet.layer{s}.{i}"
            st = stride if i == 0 else 1
            identity = x
            if i == 0 and (st != 1 or c_in != c_out):
                identity = net.bn(net.conv(x, name + ".downsample.0",
                                           stride=st),
                                  name + ".downsample.1", TRUNK_EPS, mask)
            h = torch.relu(net.bn(net.conv(x, name + ".conv1", stride=st,
                                           padding=1),
                                  name + ".bn1", TRUNK_EPS, mask))
            h = net.bn(net.conv(h, name + ".conv2", padding=1), name + ".bn2",
                       TRUNK_EPS, mask)
            x = torch.relu(h + identity)
        c_in = c_out
        outs.append(x)
    return outs


def decode(net: Net, feats: list, args: dict, mask=None):
    """One transposed-conv deblock a scale, concatenated (ref
    base_bev_backbone_resnet.py)."""
    ups = args["base_bev_backbone"]["upsample_strides"]
    return torch.cat([torch.relu(net.bn(
        net.conv_t(f, f"backbone.deblocks.{i}.0", int(s)),
        f"backbone.deblocks.{i}.1", BEV_EPS, mask))
        for i, (f, s) in enumerate(zip(feats, ups))], 1)


def shrink_heads(net: Net, x, args: dict) -> dict:
    """The shrink header (ref downsample_conv.py DoubleConv) and the 1x1
    heads."""
    sh = args["shrink_header"]
    for i, (k, p) in enumerate(zip(sh["kernal_size"], sh["padding"])):
        name = f"shrink_conv.layers.{i}.double_conv"
        x = torch.relu(net.conv(x, name + ".0", padding=p, bias=True))
        x = torch.relu(net.conv(x, name + ".2", padding=1, bias=True))
    out = {}
    for kind in ("cls", "reg", "dir", "unc"):
        if kind + "_head.weight" in net.p:
            out[kind + "_preds"] = net.conv(x, kind + "_head", bias=True)
    return out


def normalized_affines(pairwise, args: dict):
    """(B, L, L, 4, 4) metric T_j<-i -> (B, L, L, 2, 3) affines of an
    align_corners=False grid over the full canvas (ref
    transformation_utils.py normalize_pairwise_tfm)."""
    ny, nx = grid_shape(args)
    d = args["voxel_size"][0]
    t = pairwise
    row0 = torch.stack([t[..., 0, 0], t[..., 0, 1] * ny / nx,
                        t[..., 0, 3] / (d * nx) * 2], -1)
    row1 = torch.stack([t[..., 1, 0] * nx / ny, t[..., 1, 1],
                        t[..., 1, 3] / (d * ny) * 2], -1)
    return torch.stack([row0, row1], -2)


def att_fuse(x, affines, agent_mask):
    """x (B, L, C, H, W): every agent's map warped into the ego's frame
    (bilinear, zeros outside), then per pixel a softmax over the agents of
    the ego's feature dotted with each, scaled by 1/sqrt(C) (ref
    att_fuse.py ScaledDotProductAttention with the ego as the query)."""
    b, l, c, h, w = x.shape
    parts = [x[:, 0]]
    for j in range(1, l):
        grid = F.affine_grid(affines[:, j], [b, c, h, w], align_corners=False)
        parts.append(F.grid_sample(x[:, j], grid, mode="bilinear",
                                   padding_mode="zeros", align_corners=False))
    m = agent_mask[:, :, None, None]
    x = torch.stack(parts, 1) * m[:, :, None].to(x.dtype)
    scores = (x[:, :1] * x).sum(2) / math.sqrt(c)
    scores = scores.masked_fill(~m, float("-inf"))
    att = torch.softmax(scores, dim=1)
    return (att[:, :, None] * x).sum(1)


def flagship_maps(net: Net, batch: dict, args: dict) -> dict:
    """The flagship's head maps of a (B, L) batch: every agent slot's canvas
    through the trunk, each scale fused into the ego's frame, decoded,
    shrunk, the heads."""
    b, l, n, _ = batch["points"].shape
    mask = batch["agent_mask"].reshape(b * l)
    canvas = pillar_canvas(net, batch["points"].reshape(b * l, n, -1),
                           batch["point_mask"].reshape(b * l, n), args)
    feats = trunk(net, canvas, args, mask[:, None, None])
    affines = normalized_affines(batch["pairwise_t_matrix"], args)[:, 0]
    fused = [att_fuse(f.reshape((b, l) + f.shape[1:]), affines,
                      batch["agent_mask"]) for f in feats]
    return shrink_heads(net, decode(net, fused, args), args)


def single_maps(net: Net, batch: dict, args: dict) -> dict:
    """The single-agent detector's head maps of each of the B * L agent
    frames of a batch (padded agents included, as the program runs them)."""
    b, l, n, _ = batch["points"].shape
    mask = batch["agent_mask"].reshape(b * l)[:, None, None]
    canvas = pillar_canvas(net, batch["points"].reshape(b * l, n, -1),
                           batch["point_mask"].reshape(b * l, n), args)
    return shrink_heads(net, decode(net, trunk(net, canvas, args, mask), args,
                                    mask), args)


def param_shapes(args: dict) -> dict:
    """name -> shape of every tensor of the model that ``args`` describe
    (the reference's state-dict names), norms' running statistics
    included."""
    shapes = {}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{k}"] = (c,)

    pf = args["pillar_vfe"]["num_filters"][-1]
    shapes["pillar_vfe.pfn_layers.0.linear.weight"] = (pf, 10)
    bn("pillar_vfe.pfn_layers.0.norm", pf)
    bb = args["base_bev_backbone"]
    c_in = pf
    for s, (blocks, stride, c) in enumerate(zip(
            bb["layer_nums"], bb["layer_strides"], bb["num_filters"])):
        for i in range(blocks):
            name = f"backbone.resnet.layer{s}.{i}"
            shapes[name + ".conv1.weight"] = (c, c_in, 3, 3)
            bn(name + ".bn1", c)
            shapes[name + ".conv2.weight"] = (c, c, 3, 3)
            bn(name + ".bn2", c)
            if i == 0 and (stride != 1 or c_in != c):
                shapes[name + ".downsample.0.weight"] = (c, c_in, 1, 1)
                bn(name + ".downsample.1", c)
            c_in = c
    for i, (c, up, s) in enumerate(zip(bb["num_filters"],
                                       bb["num_upsample_filter"],
                                       bb["upsample_strides"])):
        shapes[f"backbone.deblocks.{i}.0.weight"] = (c, up, int(s), int(s))
        bn(f"backbone.deblocks.{i}.1", up)
    sh = args["shrink_header"]
    c_in = sh["input_dim"]
    for i, (k, d) in enumerate(zip(sh["kernal_size"], sh["dim"])):
        name = f"shrink_conv.layers.{i}.double_conv"
        shapes[name + ".0.weight"] = (d, c_in, k, k)
        shapes[name + ".0.bias"] = (d,)
        shapes[name + ".2.weight"] = (d, d, 3, 3)
        shapes[name + ".2.bias"] = (d,)
        c_in = d
    a = args["anchor_number"]
    heads = {"cls": a, "reg": 7 * a,
             "dir": args["dir_args"]["num_bins"] * a}
    if "uncertainty_dim" in args:
        heads["unc"] = args["uncertainty_dim"] * a
    for kind, c in heads.items():
        shapes[f"{kind}_head.weight"] = (c, c_in, 1, 1)
        shapes[f"{kind}_head.bias"] = (c,)
    return shapes
