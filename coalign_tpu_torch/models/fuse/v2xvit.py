"""V2X-ViT fusion: agent attention and pyramid window attention over the
ego-warped agent maps.

Port of coalign_tpu/models/fuse/v2xvit.py (ref v2xvit_basic.py
V2XTransformer:183, V2XTEncoder:125; hmsa.py HGTCavAttention:7;
base_transformer.py CavAttention:32; mswin.py BaseWindowAttention:19,
PyramidWindowAttention:85; split_attn.py SplitAttn:30). The maps run
channel-last, (B, L, H, W, C), inside the encoder.

As in the JAX package:
  * every agent is of type 0 and no time-delay or velocity prior is fed
    (the reference's wiring, fusion_in_one.py:295-352). So the HGT
    attention reads only the type-0 linears and relation 0; the others
    are kept under the reference's names (``k_linears.{t}`` ...) so that
    its checkpoint loads strictly. With one relation for every pair, the
    relation matrices act on each sender's keys and values once: the
    (B, M, H, W, L, L, d) message tensor of the JAX package is never
    formed;
  * window attention pads H and W up to a multiple of the window, masks
    the padded keys out of the softmax and sets the rows that have no key
    to 0 (the reference needs divisible maps);
  * LayerNorms take torch's eps 1e-5, SplitAttn's ``bn1`` included (it is
    a LayerNorm);
  * the feed-forward GELU is the tanh approximation, flax's ``nn.gelu``;
    the reference's is exact, a difference of the JAX package from the
    reference (its recording still holds at 2e-4).
``fusion_net.encoder.prior_feed`` is never called: the reference's forward
drops the prior channels instead (v2xvit_basic.py:145,163-166). It is kept
so that the reference's checkpoint loads strictly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.ops.warp import warp_agents_to_ego

LN_EPS = 1e-5


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., heads * d) -> (..., heads, d)."""
    return t.reshape(t.shape[:-1] + (heads, -1))


def _agent_softmax(att: torch.Tensor, agent_mask: torch.Tensor):
    """Softmax of (B, M, H, W, L_i, L_j) scores over the senders j, padded
    senders left out."""
    keep = agent_mask[:, None, None, None, None, :]
    return torch.softmax(att.masked_fill(~keep, float("-inf")), dim=-1)


class CavAttention(nn.Module):
    """Per-pixel multi-head attention across agents (base_transformer.py:
    32), for ``use_hetero: false``."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x, agent_mask):
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        att = torch.einsum("bihwmc,bjhwmc->bmhwij", q, k) * self.scale
        out = torch.einsum("bmhwij,bjhwmc->bihwmc",
                           _agent_softmax(att, agent_mask), v)
        return self.to_out(out.flatten(-2))


class HGTCavAttention(nn.Module):
    """Heterogeneous (agent-type aware) attention across agents (hmsa.py:7)
    with every agent of type 0."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 num_types: int = 2):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        inner = heads * dim_head
        for name, (c_in, c_out) in (("k", (dim, inner)), ("q", (dim, inner)),
                                    ("v", (dim, inner)), ("a", (inner, dim))):
            self.add_module(f"{name}_linears", nn.ModuleList(
                [nn.Linear(c_in, c_out) for _ in range(num_types)]))
        shape = (num_types * num_types, heads, dim_head, dim_head)
        self.relation_att = nn.Parameter(torch.zeros(shape))
        self.relation_msg = nn.Parameter(torch.zeros(shape))

    def init_weights(self, generator: torch.Generator):
        """flax's xavier_uniform of the JAX package's relation matrices."""
        fan = self.dim_head * self.heads * self.relation_att.shape[0]
        bound = math.sqrt(6.0 / (2 * fan))
        for p in (self.relation_att, self.relation_msg):
            nn.init.uniform_(p, -bound, bound, generator=generator)

    def forward(self, x, agent_mask):
        q, k, v = (_heads(lin[0](x), self.heads) for lin in
                   (self.q_linears, self.k_linears, self.v_linears))
        # relation 0 (type 0 to type 0) for every pair: W k_j and W v_j
        k = torch.einsum("bjhwmq,mpq->bjhwmp", k, self.relation_att[0])
        v = torch.einsum("bjhwmp,mpq->bjhwmq", v, self.relation_msg[0])
        att = torch.einsum("bihwmp,bjhwmp->bmhwij", q, k) * self.scale
        out = torch.einsum("bmhwij,bjhwmq->bihwmq",
                           _agent_softmax(att, agent_mask), v)
        return self.a_linears[0](out.flatten(-2))


class WindowAttention(nn.Module):
    """Multi-head self-attention inside ws x ws windows of each agent's map,
    with a relative position bias (mswin.py:19 BaseWindowAttention)."""

    def __init__(self, dim: int, heads: int, dim_head: int, window_size: int):
        super().__init__()
        self.heads = heads
        self.ws = window_size
        self.scale = dim_head ** -0.5
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        ws = window_size
        self.pos_embedding = nn.Parameter(torch.zeros(2 * ws - 1, 2 * ws - 1))
        idx = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                         indexing="ij"), -1).reshape(-1, 2)
        # [i, j] = idx_j - idx_i + ws - 1 (mswin.py get_relative_distances)
        self.register_buffer("rel_index",
                             idx[None, :, :] - idx[:, None, :] + ws - 1,
                             persistent=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def init_weights(self, generator: torch.Generator):
        nn.init.normal_(self.pos_embedding, 0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, h, w, _ = x.shape
        ws, heads = self.ws, self.heads
        pad_h, pad_w = (-h) % ws, (-w) % ws
        xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        nh, nw = hp // ws, wp // ws

        def windows(t):   # (b, l, hp, wp, heads*d) -> (b, l, heads, n, K, d)
            t = t.reshape(b, l, nh, ws, nw, ws, heads, -1)
            return t.permute(0, 1, 6, 2, 4, 3, 5, 7).reshape(
                b, l, heads, nh * nw, ws * ws, -1)

        q, k, v = (windows(t) for t in self.to_qkv(xp).chunk(3, dim=-1))
        bias = self.pos_embedding[self.rel_index[..., 0],
                                  self.rel_index[..., 1]]
        dots = q @ k.transpose(-1, -2) * self.scale + bias
        if pad_h or pad_w:
            valid = torch.ones(hp, wp, dtype=torch.bool, device=x.device)
            valid[h:] = False
            valid[:, w:] = False
            keys = valid.reshape(nh, ws, nw, ws).transpose(1, 2).reshape(
                nh * nw, 1, ws * ws)
            dots = dots.masked_fill(~keys, float("-inf"))
            att = torch.softmax(dots, dim=-1)
            att = torch.where(torch.isnan(att), 0.0, att)
        else:
            att = torch.softmax(dots, dim=-1)
        out = (att @ v).reshape(b, l, heads, nh, nw, ws, ws, -1)
        out = out.permute(0, 1, 3, 5, 4, 6, 2, 7).reshape(b, l, hp, wp, -1)
        return self.to_out(out[:, :, :h, :w])


class SplitAttn(nn.Module):
    """Radix-3 split attention over the pyramid's outputs (split_attn.py:
    30); ``bn1`` is a LayerNorm."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.fc1 = nn.Linear(input_dim, input_dim, bias=False)
        self.bn1 = nn.LayerNorm(input_dim, eps=LN_EPS)
        self.fc2 = nn.Linear(input_dim, 3 * input_dim, bias=False)

    def forward(self, window_list):
        sw, mw, bw = window_list
        gap = (sw + mw + bw).mean(dim=(2, 3), keepdim=True)   # (B,L,1,1,C)
        attn = self.fc2(F.relu(self.bn1(self.fc1(gap))))
        attn = torch.softmax(attn.reshape(attn.shape[:4]
                                          + (3, self.input_dim)), dim=4)
        return (sw * attn[..., 0, :] + mw * attn[..., 1, :]
                + bw * attn[..., 2, :])


class PyramidWindowAttention(nn.Module):
    """Window attention at several window sizes, fused by SplitAttn
    (mswin.py:85)."""

    def __init__(self, dim: int, heads, dim_heads, window_sizes):
        super().__init__()
        self.pwmsa = nn.ModuleList([
            WindowAttention(dim, h, dh, ws)
            for h, dh, ws in zip(heads, dim_heads, window_sizes)])
        self.split_attn = SplitAttn(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.split_attn([att(x) for att in self.pwmsa])


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class FeedForward(nn.Module):
    """Linear, tanh-approximated GELU, Linear (``net.0``, ``net.3``; the
    reference's dropouts sit at ``net.2`` and ``net.4``)."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, mlp_dim),
                                 nn.GELU(approximate="tanh"), nn.Identity(),
                                 nn.Linear(mlp_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class V2XViTFusion(nn.Module):
    """The V2X-ViT encoder over the ego-warped agent maps
    (``fusion_net.encoder``, ref fusion_in_one.py:295 and v2xvit_basic.py
    V2XTEncoder); returns the ego's map."""

    def __init__(self, args: dict, dim: int):
        super().__init__()
        enc = args["transformer"]["encoder"]
        cav = enc["cav_att_config"]
        pw = enc["pwindow_att_config"]
        dim = cav.get("dim", dim)
        heads, dim_head = cav.get("heads", 8), cav.get("dim_head", 32)
        att_cls = (HGTCavAttention if cav.get("use_hetero", True)
                   else CavAttention)
        if not pw.get("relative_pos_embedding", True):
            raise NotImplementedError("absolute window position embeddings "
                                      "are not ported yet")
        if pw.get("fusion_method", "split_attn") != "split_attn":
            raise NotImplementedError(
                f"pyramid fusion {pw['fusion_method']!r} is not ported yet")

        def make_pwindow():
            return PyramidWindowAttention(
                dim, pw.get("heads", (16, 8, 4)),
                pw.get("dim_head", (16, 32, 64)),
                pw.get("window_size", (4, 8, 16)))

        def fusion_block():
            # ref v2xvit_basic.py V2XFusionBlock: layers.{b} = [agent
            # attention, pyramid window attention], each pre-normed
            block = nn.Module()
            block.layers = nn.ModuleList([
                nn.ModuleList([PreNorm(dim, att_cls(dim, heads, dim_head)),
                               PreNorm(dim, make_pwindow())])
                for _ in range(enc.get("num_blocks", 1))])
            return block

        mlp_dim = enc.get("feed_forward", {}).get("mlp_dim", 256)
        encoder = nn.Module()
        encoder.prior_feed = nn.Linear(dim + 3, dim)
        encoder.layers = nn.ModuleList([
            nn.ModuleList([fusion_block(),
                           PreNorm(dim, FeedForward(dim, mlp_dim))])
            for _ in range(enc.get("depth", 3))])
        self.fusion_net = nn.ModuleDict({"encoder": encoder})

    def forward(self, features, affines, agent_mask):
        x = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        x = x.permute(0, 1, 3, 4, 2)                          # (B,L,H,W,C)
        for block, feed_forward in self.fusion_net["encoder"].layers:
            for att, pwindow in block.layers:
                x = x + att(x, agent_mask)
                x = x + pwindow(x)
            x = x + feed_forward(x)
        return x[:, 0].permute(0, 3, 1, 2)
