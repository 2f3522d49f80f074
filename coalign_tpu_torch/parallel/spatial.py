"""Spatial BEV sharding with halo exchange over torch.distributed.

Port of coalign_tpu/parallel/spatial.py: the BEV map's W axis (the last
axis of an NCHW map) is split across the ranks of a process group, rank r
holding columns [r * W_local, (r + 1) * W_local). Convolutions stay local
after each rank swaps ``kw // 2`` edge columns with its ring neighbours
(halo_exchange, batch_isend_irecv; the grid's two ends see zeros), the
transposed-conv upsampling and the 1x1 heads are local, and the per-scale
fusion all-gathers the maps along W, because a rotation may sample any
column. Where the JAX functions return a jitted shard_map closure and a
NamedSharding, these return a callable, which takes the full-width map
and returns this rank's W slice of each output, and the split
(SpatialSplit: rank, world, W_local); gather_w rebuilds the full map.

Everything here runs the model in eval mode: its batch norms are folded
into per-channel scales and biases (_fold_bn), as the JAX functions fold
flax's. Over gloo, a CUDA tensor's collectives are staged through the
host (gloo's point-to-point ops take CPU tensors only).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.parallel.mesh import Mesh


class SpatialSplit(NamedTuple):
    """This rank's share of the W axis: columns [rank * w_local,
    (rank + 1) * w_local) of a map of width world * w_local."""
    rank: int
    world: int
    w_local: int


def make_spatial_mesh(group=None) -> Mesh:
    """The spatial axis over ``group`` (the default process group unless
    named; rank 0 of 1 without a group)."""
    from coalign_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(group)


def _split(mesh: Mesh, width: int) -> SpatialSplit:
    if width % mesh.world:
        raise ValueError(f"width {width} is not divisible by the "
                         f"{mesh.world} ranks")
    return SpatialSplit(mesh.rank, mesh.world, width // mesh.world)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Pad ``x`` (..., W_local), a rank's slice of the W axis, with
    ``halo`` columns of each ring neighbour: (..., W_local + 2 * halo).
    The first rank's left halo and the last rank's right halo are zeros
    (the grid's boundary), as at world 1 both are."""
    if halo == 0:
        return x
    if halo > x.shape[-1]:
        raise ValueError(f"halo {halo} wider than the slice {x.shape[-1]}")
    rank, world = ((dist.get_rank(group), dist.get_world_size(group))
                   if dist.is_initialized() else (0, 1))
    left = torch.zeros_like(x[..., :halo])
    right = torch.zeros_like(x[..., :halo])
    if world > 1:
        staged = _staged(x, group)
        dev = torch.device("cpu") if staged else x.device
        send_l = x[..., :halo].contiguous().to(dev)   # my left edge -> r-1
        send_r = x[..., -halo:].contiguous().to(dev)
        recv_l, recv_r = torch.empty_like(send_l), torch.empty_like(send_r)
        ops = []
        if rank > 0:
            peer = _peer(group, rank - 1)
            ops += [dist.P2POp(dist.isend, send_l, peer, group),
                    dist.P2POp(dist.irecv, recv_l, peer, group)]
        if rank < world - 1:
            peer = _peer(group, rank + 1)
            ops += [dist.P2POp(dist.isend, send_r, peer, group),
                    dist.P2POp(dist.irecv, recv_r, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if rank > 0:
            left = recv_l.to(x.device)
        if rank < world - 1:
            right = recv_r.to(x.device)
    return torch.cat([left, x, right], dim=-1)


def sharded_conv2d(x: torch.Tensor, weight: torch.Tensor, group=None,
                   stride: int = 1, bias=None) -> torch.Tensor:
    """A W-sharded NCHW conv with torch's symmetric padding (kh // 2,
    kw // 2) across the shards, any stride.

    x (B, Cin, H, W_local), weight (Cout, Cin, kh, kw). With global padding
    p = kw // 2, output column j reads inputs [j*s - p, j*s - p + kw - 1];
    W_local % s == 0 puts every shard's first output at a global input
    offset that is a multiple of s, so after exchanging p halo columns each
    shard's valid-W strided conv is exactly its W_local / s slice of the
    global output. H stays local with the same padding."""
    kh, kw = weight.shape[-2:]
    if stride > 1 and x.shape[-1] % stride:
        raise ValueError(
            f"W_local {x.shape[-1]} not divisible by stride {stride}")
    x = halo_exchange(x, kw // 2, group)
    return F.conv2d(x, weight, bias, stride=stride, padding=(kh // 2, 0))


def gather_w(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full-width map from every rank's W slice ``t`` (..., W_local):
    an all_gather along the last axis."""
    if not dist.is_initialized():
        return t
    staged = _staged(t, mesh.group)
    src = t.contiguous().to("cpu") if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=-1).to(t.device)


def _fold_bn(bn: nn.Module) -> tuple:
    """An eval-mode batch norm as a per-channel (scale, bias), each
    (C, 1, 1)."""
    inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return (inv[:, None, None],
            (bn.bias - bn.running_mean * inv)[:, None, None])


def _fold_trunk(backbone) -> tuple:
    """The port's ResNetBEVBackbone trunk as plain tensors: (blocks,
    strides, stage_ends), each block its conv kernels (OIHW) and folded
    norms."""
    trunk = backbone.resnet
    blocks, strides, stage_ends = [], [], []
    for s in range(trunk.num_stages):
        for block in getattr(trunk, f"layer{s}"):
            blk = {"k0": block.conv1.weight, "bn0": _fold_bn(block.bn1),
                   "k1": block.conv2.weight, "bn1": _fold_bn(block.bn2)}
            if block.downsample is not None:
                blk["k2"] = block.downsample[0].weight
                blk["bn2"] = _fold_bn(block.downsample[1])
            blocks.append(blk)
            strides.append(block.conv1.stride[0])
        stage_ends.append(len(blocks))
    return blocks, strides, stage_ends


def _trunk_local(x, blocks, strides, stage_ends, group) -> tuple:
    """The folded trunk as local convs and halo exchanges; the per-scale
    feature tuple, as backbone.encode returns it."""
    outs = []
    for i, (blk, s) in enumerate(zip(blocks, strides)):
        out = sharded_conv2d(x, blk["k0"], group, s)
        out = torch.relu(out * blk["bn0"][0] + blk["bn0"][1])
        out = sharded_conv2d(out, blk["k1"], group, 1)
        out = out * blk["bn1"][0] + blk["bn1"][1]
        if "k2" in blk:
            idt = sharded_conv2d(x, blk["k2"], group, s)
            idt = idt * blk["bn2"][0] + blk["bn2"][1]
        else:
            idt = x
        x = torch.relu(out + idt)
        if i + 1 in stage_ends:
            outs.append(x)
    return tuple(outs)


def _local_slice(x: torch.Tensor, split: SpatialSplit) -> torch.Tensor:
    if x.shape[-1] != split.world * split.w_local:
        raise ValueError(f"a map of width {x.shape[-1]}, expected "
                         f"{split.world * split.w_local}")
    w0 = split.rank * split.w_local
    return x[..., w0:w0 + split.w_local]


def spatial_resnet_encode_fn(backbone, mesh: Mesh, width: int):
    """W-shard a ResNetBEVBackbone's encode (the flagship's trunk, stride-2
    stage entries and 1x1 downsample projections included) over the mesh.
    Returns (fn, split): fn(x) takes the full (F, C, H, width) canvas and
    returns this rank's W slice of each scale's features, as
    ``backbone.encode`` returns them in eval mode."""
    split = _split(mesh, width)
    blocks, strides, stage_ends = _fold_trunk(backbone)

    @torch.no_grad()
    def fn(x):
        return _trunk_local(_local_slice(x, split), blocks, strides,
                            stage_ends, mesh.group)

    return fn, split


def _warp_cols_from_full(src_full, affine, w0: int, w_local: int):
    """Output columns [w0, w0 + w_local) of the bilinear warp of
    ``src_full`` (N, C, H, W), the all-gathered full-width source, by the
    normalized ``affine`` (N, 2, 3): ops/warp.warp_affine's convention
    (affine_grid + grid_sample, align_corners=False, zeros outside),
    restricted to a column slice. The sample positions are the slice of
    the full-width affine_grid, the same numbers the dense warp samples
    at: the maps depend on them steeply (computed by another formula in
    float32 they moved the full-width flagship's cls maps by 7e-4 on an
    H100)."""
    theta = affine.to(src_full.dtype)
    grid = F.affine_grid(theta, list(src_full.shape), align_corners=False)
    return F.grid_sample(src_full, grid[:, :, w0:w0 + w_local],
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def _att_fuse_local(feats, affines, agent_mask, mesh: Mesh, split):
    """AttFusion (models/fuse/fusion.py) on W slices: all_gather the agents'
    maps along W, warp this rank's output columns of each neighbour from
    the gathered map (the ego passes through unwarped, as in
    warp_agents_to_ego), then the per-pixel ego-query attention, which is
    pointwise. feats (B, L, C, H, W_local)."""
    b, l, c, h, wl = feats.shape
    x = feats
    if l > 1:
        full = gather_w(feats[:, 1:].reshape(b * (l - 1), c, h, wl), mesh)
        neigh = _warp_cols_from_full(full, affines[:, 1:].reshape(
            b * (l - 1), 2, 3), split.rank * wl, wl)
        x = torch.cat([feats[:, :1], neigh.reshape(b, l - 1, c, h, wl)], 1)
    x = x * agent_mask[:, :, None, None, None].to(x.dtype)
    m = agent_mask[:, :, None, None]
    scores = (x[:, :1] * x).sum(dim=2) / math.sqrt(c)
    scores = scores.masked_fill(~m, float("-inf"))
    att = torch.exp(scores - scores.amax(dim=1, keepdim=True))
    att = torch.where(m, att, 0.0)
    att = att / torch.clamp(att.sum(dim=1, keepdim=True), min=1e-9)
    return (att[:, :, None] * x).sum(dim=1)


def _deblock_local(x, deblock):
    """A decode deblock (models/layers.deblock) on a W slice: its
    transposed conv has kernel = stride, so every output pixel reads one
    input pixel and the upsampling needs no halo (a strided downsampling
    deblock, kernel = stride too, needs W_local % stride == 0)."""
    conv, bn = deblock[0], deblock[1]
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, conv.weight, stride=conv.stride)
    else:
        if x.shape[-1] % conv.stride[1]:
            raise ValueError(f"W_local {x.shape[-1]} not divisible by the "
                             f"deblock's stride {conv.stride[1]}")
        y = F.conv2d(x, conv.weight, stride=conv.stride)
    scale, bias = _fold_bn(bn)
    return torch.relu(y * scale + bias)


def spatial_flagship_forward_fn(model, mesh: Mesh):
    """W-shard the flagship's dense-BEV forward over the mesh: trunk encode
    -> per-scale warp and att fusion -> decode deblocks -> shrink header ->
    detection heads. Everything after the (per-agent) pillar scatter runs
    sharded; the cross-shard traffic is the conv halos and the per-scale
    all_gather the rotation warp needs.

    ``model`` is a PointPillarBaselineMultiscale (the CoAlign flagship)
    with att fusion, a ResNet trunk and a stride-1 shrink header, whose
    weights the function reads at build time (call it again after they
    change).
    Returns (fn, split): fn(bev, affine, agent_mask) -> {cls,reg,dir}_preds,
    this rank's W slices of the maps the model gives in eval mode, with
    bev (B*L, C, H, nx) the scattered pillar canvas, affine (B, L, 2, 3)
    the ego row of the normalized pairwise matrix and agent_mask (B, L)."""
    from coalign_tpu_torch.models.fuse.fusion import AttFusion

    split = _split(mesh, model.spec.nx)
    bb = model.backbone
    if not hasattr(bb, "resnet"):
        raise NotImplementedError("the spatial forward runs a ResNet trunk")
    if len(bb.deblocks) != bb.num_levels:
        raise NotImplementedError("the spatial forward has no extra deblock")
    if model.naive_compressor is not None:
        raise NotImplementedError("the spatial forward has no compressor")
    if not all(isinstance(f, AttFusion) for f in model.fusion_net):
        raise NotImplementedError("the spatial forward fuses with att only")
    shrink = []
    if model.shrink_conv is not None:
        for layer in model.shrink_conv.layers:
            for conv in (layer.double_conv[0], layer.double_conv[2]):
                k = conv.kernel_size
                if conv.stride != (1, 1) or conv.padding != (k[0] // 2,
                                                             k[1] // 2):
                    raise NotImplementedError(
                        f"shrink conv {k} with stride {conv.stride} and "
                        f"padding {conv.padding}")
                shrink.append(conv)
    heads = {name: getattr(model, f"{name}_head")
             for name in ("cls", "reg", "dir", "iou", "unc")
             if getattr(model, f"{name}_head") is not None}
    blocks, strides, stage_ends = _fold_trunk(bb)

    @torch.no_grad()
    def fn(bev, affine, agent_mask):
        b, l = agent_mask.shape
        scales = _trunk_local(_local_slice(bev, split), blocks, strides,
                              stage_ends, mesh.group)
        ups = []
        for feat, deb in zip(scales, bb.deblocks):
            fused = _att_fuse_local(feat.reshape((b, l) + feat.shape[1:]),
                                    affine, agent_mask, mesh, split)
            ups.append(_deblock_local(fused, deb))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        for conv in shrink:
            x = torch.relu(sharded_conv2d(x, conv.weight, mesh.group, 1,
                                          conv.bias))
        return {f"{name}_preds": F.conv2d(x, head.weight, head.bias)
                for name, head in heads.items()}

    return fn, split


def make_spatial_infer_fn(model, anchors, postprocess_cfg: dict,
                          mesh: Mesh, device=None):
    """make_infer_fn (inference.py) with the flagship's dense-BEV forward
    W-sharded over the mesh: (batch) -> detections of each frame, on every
    rank. The pillar encoder runs on each rank's whole batch, the rest
    through spatial_flagship_forward_fn; the maps are all-gathered
    (gather_w) before post_process. The weights are read at build time."""
    from coalign_tpu_torch.inference import infer_setup, to_device
    from coalign_tpu_torch.postprocess.decode import post_process

    dev, anchors, kwargs = infer_setup(model, anchors, postprocess_cfg,
                                       device)
    fwd, _ = spatial_flagship_forward_fn(model, mesh)
    max_keep = int(postprocess_cfg.get("max_num", 100))

    @torch.no_grad()
    def infer(batch: dict) -> dict:
        b = to_device(batch, dev)
        bev, affine, _ = model._encode_agents(b)
        maps = fwd(bev, affine[:, 0], b["agent_mask"])
        maps = {k: gather_w(v, mesh) for k, v in maps.items()}
        return post_process(maps["cls_preds"], maps["reg_preds"], anchors,
                            b["transformation_matrix"],
                            dir_preds=maps.get("dir_preds"),
                            max_keep=max_keep, **kwargs)

    return infer


def make_spatial_conv_fn(kernels, mesh: Mesh, width: int):
    """A W-sharded conv stack with ReLU between: kernels (Cout, Cin, kh,
    kw). Returns (fn, split): fn(x) takes the full (B, Cin, H, width) map
    and returns this rank's W slice of the output."""
    split = _split(mesh, width)

    @torch.no_grad()
    def fn(x):
        x = _local_slice(x, split)
        for i, k in enumerate(kernels):
            x = sharded_conv2d(x, k, mesh.group)
            if i < len(kernels) - 1:
                x = torch.relu(x)
        return x

    return fn, split
