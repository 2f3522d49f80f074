"""The reference of CoAlign's agent-object pose graph.

A frozen copy of coalign_tpu_torch/posegraph/box_align.py (the batched
damped Gauss-Newton solve that replaces the reference's g2o
Levenberg-Marquardt, ref box_align_v2.py box_alignment_relative_sample_np),
run here in float64 on the program's own stage-1 detections: the graph's
clustering and abandon rules are thresholds on box positions, so the step
is held against the program's own input and the detector before it is
compared on its own (PERF.md). ``lowp`` rounds the normal equations'
operands to TF32, the control's precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.pointpillar import tf32


def limit_period(val, offset: float = 0.5, period: float = 2 * math.pi):
    return val - torch.floor(val / val.new_full((), period) + offset) * period


# anchor diagonal squared, converting the regression-target variance to
# metres (ref box_align_v2.py:185-197: w_a = 1.6, l_a = 3.9)
_D_A_SQUARE = 1.6 ** 2 + 3.9 ** 2
CLUSTER_ROUNDS = 8


class BoxAlignConfig(NamedTuple):
    landmark_SE2: bool = True
    adaptive_landmark: bool = False
    normalize_uncertainty: bool = False
    abandon_hard_cases: bool = True
    drop_hard_boxes: bool = True
    use_uncertainty: bool = True
    thres: float = 1.5
    yaw_var_thres: float = 0.2
    iterations: int = 20
    damping: float = 1e-6

    @classmethod
    def from_yaml(cls, args: dict):
        """The yaml's ``box_align.args``."""
        return cls(
            landmark_SE2=args.get("landmark_SE2", True),
            adaptive_landmark=args.get("adaptive_landmark", False),
            normalize_uncertainty=args.get("normalize_uncertainty", False),
            abandon_hard_cases=args.get("abandon_hard_cases", True),
            drop_hard_boxes=args.get("drop_hard_boxes", True),
            use_uncertainty=args.get("use_uncertainty", True),
        )


def _se2_inv_compose(pose_a, pose_b):
    """log(A^-1 B) of SE(2) poses (..., 3) (x, y, theta): B in A's frame."""
    c, s = torch.cos(pose_a[..., 2]), torch.sin(pose_a[..., 2])
    dx = pose_b[..., 0] - pose_a[..., 0]
    dy = pose_b[..., 1] - pose_a[..., 1]
    return torch.stack(
        [c * dx + s * dy, -s * dx + c * dy,
         limit_period(pose_b[..., 2] - pose_a[..., 2], 0.5, 2 * math.pi)],
        dim=-1)


def _cluster_min_label(dist, valid, same_agent, thres,
                       num_iters: int = CLUSTER_ROUNDS):
    """Clusters by ``num_iters`` rounds of min-label propagation.

    dist (..., M, M) world centre distances; valid (..., M); same_agent
    (M, M) bool (boxes of one agent are never adjacent, ref :207-212).
    Returns labels (..., M) int64: after enough rounds, the lowest box index
    of each connected component; a chain longer than ``num_iters`` hops
    splits."""
    m = dist.shape[-1]
    adj = ((dist < thres) & ~same_agent & valid[..., :, None]
           & valid[..., None, :])
    adj = adj | torch.eye(m, dtype=torch.bool, device=dist.device)
    labels = torch.arange(m, device=dist.device).expand(dist.shape[:-1])
    big = torch.full_like(labels, m)
    for _ in range(num_iters):
        labels = torch.where(adj, labels[..., None, :],
                             big[..., None, :]).amin(dim=-1)
    return labels


def _edge_blocks(agents, lms, boxes):
    """Residuals (B, M, 3) of each box against its agent's pose ``agents``
    (B, M, 3) and its landmark ``lms`` (B, M, 3), and their Jacobians
    (B, M, 3, 3) with respect to the agent and to the landmark."""
    c, s = torch.cos(agents[..., 2]), torch.sin(agents[..., 2])
    dx = lms[..., 0] - agents[..., 0]
    dy = lms[..., 1] - agents[..., 1]
    pred = _se2_inv_compose(agents, lms)
    r = pred - boxes
    r = torch.stack([r[..., 0], r[..., 1],
                     limit_period(r[..., 2], 0.5, 2 * math.pi)], dim=-1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    j_agent = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], -1),
        torch.stack([s, -c, -c * dx - s * dy], -1),
        torch.stack([zero, zero, -one], -1)], -2)
    j_landmark = torch.stack([
        torch.stack([c, s, zero], -1),
        torch.stack([-s, c, zero], -1),
        torch.stack([zero, zero, one], -1)], -2)
    return r, j_agent, j_landmark


def _unpack(x, agent_se2, landmark0, free_agent):
    b, l = agent_se2.shape[:2]
    da = x[:, :3 * l].reshape(b, l, 3)
    dl = x[:, 3 * l:].reshape(b, -1, 3)
    return agent_se2 + da * free_agent[..., None], landmark0 + dl


def _gather_rows(t, idx):
    """t (B, S, 3), idx (B, M) or (M,) -> (B, M, 3)."""
    idx = idx.expand(t.shape[0], -1)
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def _jacobian(x, graph):
    """(residuals (B, 3M), dense Jacobian (B, 3M, n_u)): each box's 3x6
    block, scattered into its agent's and its landmark's columns."""
    agents, lms = _unpack(x, graph["agent_se2"], graph["landmark0"],
                          graph["free_agent"])
    agent_of_box, labels = graph["agent_of_box"], graph["labels"]
    r, j_a, j_l = _edge_blocks(_gather_rows(agents, agent_of_box),
                               _gather_rows(lms, labels), graph["boxes"])
    w = graph["sqrt_w"][..., None]                       # (B, M, 3, 1)
    free = graph["free_agent"][:, agent_of_box]          # (B, M)
    j_a = j_a * w * free[..., None, None].to(w.dtype)
    j_l = j_l * w
    b, m = labels.shape
    l = agents.shape[1]
    on_agent = (agent_of_box[:, None] == torch.arange(
        l, device=labels.device)).to(w.dtype)            # (M, L)
    on_landmark = (labels[..., None] == torch.arange(
        m, device=labels.device)).to(w.dtype)            # (B, M, M)
    cols_a = j_a[:, :, :, None, :] * on_agent[None, :, None, :, None]
    cols_l = j_l[:, :, :, None, :] * on_landmark[:, :, None, :, None]
    jac = torch.cat([cols_a.reshape(b, 3 * m, 3 * l),
                     cols_l.reshape(b, 3 * m, 3 * m)], dim=-1)
    return (r * graph["sqrt_w"]).reshape(b, -1), jac


def _build_graph(box_poses, box_mask, uncertainty, noisy_pose, agent_mask,
                 cfg: BoxAlignConfig) -> dict:
    """Everything of the pose graph but its solution: the recentred agent
    poses, world boxes, labels, edge weights and the hard-case decision,
    batched over B."""
    b, l, k, _ = box_poses.shape
    m = l * k
    dev, dtype = box_poses.device, box_poses.dtype
    ego_xy = noisy_pose[:, 0, :2]
    agent_se2 = torch.stack(
        [noisy_pose[..., 0] - ego_xy[:, None, 0],
         noisy_pose[..., 1] - ego_xy[:, None, 1],
         torch.deg2rad(noisy_pose[..., 4])], dim=-1)           # (B, L, 3)

    boxes = box_poses.reshape(b, m, 3)
    valid = (box_mask & agent_mask[..., None]).reshape(b, m)
    agent_of_box = torch.arange(l, device=dev).repeat_interleave(k)
    ap = agent_se2[:, agent_of_box]                            # (B, M, 3)
    c, s = torch.cos(ap[..., 2]), torch.sin(ap[..., 2])
    world = torch.stack(
        [ap[..., 0] + c * boxes[..., 0] - s * boxes[..., 1],
         ap[..., 1] + s * boxes[..., 0] + c * boxes[..., 1],
         ap[..., 2] + boxes[..., 2]], dim=-1)

    if cfg.use_uncertainty:
        cert = torch.exp(-uncertainty.reshape(b, m, 3))
        cert = torch.cat([cert[..., :2] / _D_A_SQUARE, cert[..., 2:]], -1)
        if cfg.normalize_uncertainty:
            cert = torch.sqrt(cert)
    else:
        cert = torch.ones((b, m, 3), dtype=dtype, device=dev)

    d2 = ((world[:, :, None, :2] - world[:, None, :, :2]) ** 2).sum(-1)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    same_agent = agent_of_box[:, None] == agent_of_box[None, :]
    labels = _cluster_min_label(dist, valid, same_agent, cfg.thres)

    idx = torch.arange(m, device=dev)
    is_rep = (labels == idx) & valid
    member = (labels[:, None, :] == idx[None, :, None]) & valid[:, None, :]
    csize = member.sum(-1)
    active_cluster = is_rep & (csize >= 2)

    # "circular yaw variance" in the JAX package's comment; in its code, and
    # here, the plain variance of the raw world yaw
    yaw = world[..., 2]
    count = torch.clamp(csize, min=1).to(dtype)
    yaw_mean = torch.where(member, yaw[:, None, :], 0.0).sum(-1) / count
    yaw_var = torch.where(member, (yaw[:, None, :] - yaw_mean[..., None]) ** 2,
                          0.0).sum(-1) / count
    yaw_varies = yaw_var > cfg.yaw_var_thres

    landmark_num = active_cluster.sum(-1)
    yaw_varies_cnt = (active_cluster & yaw_varies).sum(-1)
    abandoned = ((landmark_num <= 3) | (yaw_varies_cnt >= 0.5 * landmark_num)) \
        & cfg.abandon_hard_cases

    varies_of_box = torch.gather(yaw_varies, 1, labels)
    edge_active = torch.gather(active_cluster, 1, labels) & valid
    if cfg.drop_hard_boxes and not cfg.adaptive_landmark:
        edge_active = edge_active & ~varies_of_box

    edge = edge_active[..., None].to(dtype)
    sqrt_w = torch.sqrt(cert) * edge
    if not cfg.landmark_SE2:
        sqrt_w = torch.cat([sqrt_w[..., :2], torch.zeros_like(
            sqrt_w[..., 2:])], -1)
    elif cfg.adaptive_landmark:
        # yaw-varying clusters fall back to R^2 landmarks with doubled
        # certainty (ref :261-266)
        adapted = torch.sqrt(2 * cert) * edge
        adapted = torch.cat([adapted[..., :2], torch.zeros_like(
            adapted[..., 2:])], -1)
        sqrt_w = torch.where(varies_of_box[..., None], adapted, sqrt_w)

    return {"agent_se2": agent_se2, "ego_xy": ego_xy, "landmark0": world,
            "boxes": boxes, "labels": labels, "agent_of_box": agent_of_box,
            "free_agent": agent_mask & (torch.arange(l, device=dev) > 0),
            "sqrt_w": sqrt_w, "abandoned": abandoned}


def _solve(graph: dict, cfg: BoxAlignConfig,
           lowp: bool = False) -> torch.Tensor:
    """``cfg.iterations`` damped Gauss-Newton steps from the noisy poses ->
    the agents' solved SE(2) poses (B, L, 3), recentred at the ego."""
    b, l = graph["agent_se2"].shape[:2]
    m = graph["labels"].shape[1]
    n_u = (l + m) * 3
    dtype, dev = graph["agent_se2"].dtype, graph["agent_se2"].device
    x = torch.zeros((b, n_u), dtype=dtype, device=dev)
    damping = cfg.damping * torch.eye(n_u, dtype=dtype, device=dev)
    for _ in range(cfg.iterations):
        r, jac = _jacobian(x, graph)
        if lowp:
            jac, r = tf32(jac), tf32(r)
        jt = jac.transpose(1, 2)
        h = torch.matmul(jt, jac) + damping
        g = torch.matmul(jt, r[..., None])
        dx = -torch.linalg.solve_ex(h, g, check_errors=False)[0][..., 0]
        # a diverged or singular solve must not poison the poses
        x = x + torch.where(torch.isfinite(dx), dx, 0.0)
    return _unpack(x, graph["agent_se2"], graph["landmark0"],
                   graph["free_agent"])[0]


def align_xyyaw(box_poses, box_mask, uncertainty, noisy_pose, agent_mask,
                cfg: BoxAlignConfig = BoxAlignConfig(),
                lowp: bool = False) -> dict:
    """The pose graph of each sample, tensors in, on their device and in
    their dtype (noisy_pose's: float32 or float64).

    box_poses (B, L, K, 3) stage-1 boxes (x, y, yaw rad) in each agent's
    frame; box_mask (B, L, K); uncertainty (B, L, K, 3) log sigma^2 of
    (x, y, yaw); noisy_pose (B, L, 6) degrees; agent_mask (B, L).

    Returns refined (B, L, 3) x, y, yaw-degrees (the noisy values for
    padded agents and abandoned samples; the ego's recomputed from its own
    pose), labels (B, L*K) and abandoned (B,)."""
    graph = _build_graph(box_poses, box_mask, uncertainty, noisy_pose,
                         agent_mask, cfg)
    agents = _solve(graph, cfg, lowp)
    ego_xy = graph["ego_xy"]
    refined = torch.stack(
        [agents[..., 0] + ego_xy[:, None, 0],
         agents[..., 1] + ego_xy[:, None, 1],
         torch.rad2deg(limit_period(agents[..., 2], 0.5, 2 * math.pi))],
        dim=-1)
    noisy = torch.stack([noisy_pose[..., 0], noisy_pose[..., 1],
                         noisy_pose[..., 4]], dim=-1)
    use = (~graph["abandoned"][:, None] & agent_mask)[..., None]
    return {"refined": torch.where(use, refined, noisy),
            "labels": graph["labels"], "abandoned": graph["abandoned"]}
