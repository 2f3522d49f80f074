"""Train the stage-1 detector's deblocks, shrink header and heads on the
benchmark's own synthetic scenes, once, on the card, and write them to
the configuration's stage1_weights file (an input that the benchmark hands
to the program and to the reference alike).

    python3 benchmark/train_stage1.py [--out <file>]

The model is the benchmark's plain reference (reference/pointpillar.py),
started from the weights yardstick/pillars.py seeds and calibrates
(weight_seed + 1). The trunk's first two stages, the deblocks, the shrink
header and the heads are trained (their norms on the batch's statistics)
and stored, 3.7 million values in float16; the pillar encoder and the
trunk's last stage (9.2 million) stay seeded and are not stored. With all
of it trained the pose graph kept 66% of held-out frames against 58% (my
chip run, 3,000 steps each), for a file 3.5 times as large. The loss is
plain: a sigmoid focal loss on the anchors' scores, smooth L1 on the box
deltas (the yaw as the sine of its residual), cross-entropy on the
direction bins, and a Gaussian negative log-likelihood
that teaches the log-variance head the deltas' own spread. An anchor is
positive when its centre lies in the inner half of a box's footprint and its
yaw is the nearer of the two to the box's, negative when it lies a metre or
more outside every box. Nothing of the program is imported.

At the end it prints, for held-out noisy frames, how many the pose graph
(reference/posegraph.py, the yaml's box_align args) keeps rather than
abandons, and the share of gt boxes within 1 m of a kept box.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
sys.path.insert(0, REPO)

from benchmark.reference import pointpillar as ref  # noqa: E402
from benchmark.reference.posegraph import (BoxAlignConfig,  # noqa: E402
                                           align_xyyaw)
from benchmark.yardstick import pillars as P  # noqa: E402
from benchmark.yardstick import scenes  # noqa: E402

CONFIG = "pointpillar_coalign_opv2v"
TRAFFIC = "coalign_noisy"
TRAIN_SEED = 424242
EVAL_SEED = 737373
STEPS = 3000
BATCH = 8                  # agent frames a step
FRAMES = 384               # scenes to train on (~1,350 agent frames)
EVAL_FRAMES = 64
TRAINED = ("backbone.resnet.layer0.", "backbone.resnet.layer1.")


def agent_frames(seed: int, n_frames: int, traffic: dict, config: dict):
    """(points (N, 4), local gt boxes) of every agent of ``n_frames``
    frames."""
    rng = config["model"]["args"]["lidar_range"]
    out = []
    for i in range(n_frames):
        f = scenes.make_frame(seed, i, traffic, rng)
        for a, ag in enumerate(f["agents"]):
            out.append((ag["points"], scenes.local_boxes(f, a)))
    return out


def targets(gt: torch.Tensor, anchors: torch.Tensor, dir_offset: float):
    """Per anchor (A = H * W * 2): label (1 positive, 0 negative, -1
    ignored), the matched box and its direction bin."""
    ax, ay = anchors[:, 0], anchors[:, 1]
    dx = ax[:, None] - gt[None, :, 0]
    dy = ay[:, None] - gt[None, :, 1]
    c, s = torch.cos(gt[:, 6]), torch.sin(gt[:, 6])
    lx = dx * c + dy * s                    # anchor centre in the box frame
    ly = -dx * s + dy * c
    inner = (lx.abs() < gt[:, 5] / 4) & (ly.abs() < gt[:, 4] / 4)
    yaw_gap = torch.remainder(anchors[:, 6:7] - gt[None, :, 6], math.pi)
    yaw_gap = torch.minimum(yaw_gap, math.pi - yaw_gap)
    near_yaw = yaw_gap <= math.pi / 4
    pos = inner & near_yaw
    outside = ((lx.abs() > gt[:, 5] / 2 + 1.0)
               | (ly.abs() > gt[:, 4] / 2 + 1.0)).all(1)
    label = torch.full((len(anchors),), -1.0, device=anchors.device)
    label[outside] = 0.0
    label[pos.any(1)] = 1.0
    match = torch.argmax(pos.float() - (lx ** 2 + ly ** 2) * 1e-3, 1)
    box = gt[match]
    rot = torch.remainder(box[:, 6] - dir_offset, 2 * math.pi)
    return label, box, (rot >= math.pi).long()


def loss_of(maps: dict, label, box, dir_bin, anchors):
    cls = ref_rows(maps["cls_preds"], 1)[..., 0]
    reg = ref_rows(maps["reg_preds"], 7)
    dirs = ref_rows(maps["dir_preds"], 2)
    unc = ref_rows(maps["unc_preds"], 3)
    care = label >= 0
    pos = label > 0
    npos = pos.sum().clamp(min=1.0)
    p = torch.sigmoid(cls)
    t = (label > 0).float()
    pt = p * t + (1 - p) * (1 - t)
    focal = (F.binary_cross_entropy_with_logits(cls, t, reduction="none")
             * (0.25 * t + 0.75 * (1 - t)) * (1 - pt) ** 2)
    cls_loss = (focal * care).sum() / npos
    a = anchors.expand_as(box)
    diag = torch.sqrt(a[..., 4] ** 2 + a[..., 5] ** 2)
    tgt = torch.stack([(box[..., 0] - a[..., 0]) / diag,
                       (box[..., 1] - a[..., 1]) / diag,
                       (box[..., 2] - a[..., 2]) / a[..., 3],
                       torch.log(box[..., 3] / a[..., 3]),
                       torch.log(box[..., 4] / a[..., 4]),
                       torch.log(box[..., 5] / a[..., 5])], -1)
    err = torch.cat([reg[..., :6] - tgt,
                     torch.sin(reg[..., 6] - (box[..., 6] - a[..., 6]))[
                         ..., None]], -1)
    reg_loss = (F.smooth_l1_loss(err, torch.zeros_like(err), beta=1 / 9,
                                 reduction="none").sum(-1) * pos).sum() / npos
    dir_loss = (F.cross_entropy(dirs[pos], dir_bin[pos], reduction="sum")
                / npos)
    e = err[..., [0, 1, 6]].detach()
    unc = unc.clamp(-8.0, 8.0)
    nll = 0.5 * (torch.exp(-unc) * e ** 2 + unc)
    unc_loss = (nll.sum(-1) * pos).sum() / npos
    return cls_loss + 2.0 * reg_loss + dir_loss + 0.1 * unc_loss


def ref_rows(x, width):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


def to_batch(items, pad: int, device):
    f = len(items)
    pts = np.zeros((f, pad, 4), np.float32)
    mask = np.zeros((f, pad), bool)
    for i, (p, _) in enumerate(items):
        pts[i, :len(p)] = p
        mask[i, :len(p)] = True
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(mask).to(device))


def evaluate(params, config, traffic, anchor_t, frames: int = 32) -> dict:
    """The pose graph's kept share and the detector's recall on held-out
    noisy frames, through the reference in full float32."""
    rng = config["model"]["args"]["lidar_range"]
    noise = config["noise_setting"]["args"]
    table = scenes.noise_table(EVAL_SEED, frames, config["max_cav"],
                               noise["pos_std"], noise["rot_std"])
    cfg = BoxAlignConfig(**config["box_align"]["args"])
    k = config["stage1_boxes"]
    kept, hits, total = 0, 0, 0
    for i in range(frames):
        frame = scenes.make_frame(EVAL_SEED, i, traffic, rng)
        batch = scenes.assemble(frame, config["max_cav"],
                                traffic["pad_points"], table[i])
        dets = P.reference_stage1(params, batch, config, anchor_t)
        n_l = config["max_cav"]
        poses = torch.zeros(1, n_l, k, 3, dtype=torch.float64)
        mask = torch.zeros(1, n_l, k, dtype=torch.bool)
        unc = torch.zeros(1, n_l, k, 3, dtype=torch.float64)
        for a in range(len(frame["agents"])):
            d = dets[a]["kept"]
            n = len(d["scores"])
            poses[0, a, :n] = d["boxes7"][:, [0, 1, 6]].double()
            mask[0, a, :n] = True
            unc[0, a, :n] = d["uncertainty"].double()
            gt = torch.from_numpy(scenes.local_boxes(frame, a))
            lr = rng
            seen = ((gt[:, 0] > lr[0]) & (gt[:, 0] < lr[3])
                    & (gt[:, 1] > lr[1]) & (gt[:, 1] < lr[4]))
            if n:
                dist = torch.cdist(gt[seen, :2].double(),
                                   d["boxes7"][:, :2].double())
                hits += int((dist.min(1).values < 1.0).sum())
            total += int(seen.sum())
        dev = anchor_t.device
        pose = torch.from_numpy(batch["lidar_pose"]).double()
        out = align_xyyaw(poses.to(dev), mask.to(dev), unc.to(dev),
                          pose.to(dev),
                          torch.from_numpy(batch["agent_mask"]).to(dev), cfg)
        kept += int(not bool(out["abandoned"][0]))
    return {"frames": frames, "kept_share": kept / frames,
            "recall_1m": hits / max(total, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="where to write (default: the config's file)")
    args = ap.parse_args()
    t0 = time.time()
    with open(os.path.join(BENCH_DIR, "configs", CONFIG + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", TRAFFIC + ".json")) as f:
        traffic = json.load(f)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = P.stage1_weights(config, dev, trained=False)
    anchor_t = P.anchors(config, dev)
    before = evaluate(params, config, traffic, anchor_t, 8)
    print(json.dumps({"phase": "seeded", **before}), flush=True)

    data = agent_frames(TRAIN_SEED, FRAMES, traffic, config)
    print(json.dumps({"phase": "data", "agent_frames": len(data),
                      "s": time.time() - t0}), flush=True)
    prefixes = P.STAGE1_TRAINED + TRAINED
    trainable = [k for k in params if k.startswith(prefixes)
                 and not k.endswith(("running_mean", "running_var"))]
    for k in trainable:
        params[k] = params[k].clone().requires_grad_(True)
    opt = torch.optim.Adam([params[k] for k in trainable], lr=2e-3)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, [int(STEPS * 0.7), int(STEPS * 0.9)], 0.1)
    # training may round to TF32; the weights are inputs, not results
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    s1 = config["stage1_model"]["args"]
    flat_anchors = anchor_t.reshape(-1, 7)
    order = np.random.default_rng(TRAIN_SEED).permutation(
        STEPS * BATCH) % len(data)
    net = ref.Net(params)
    net.train_norms = TRAINED + ("backbone.deblocks.",)
    for step in range(STEPS):
        items = [data[j] for j in order[step * BATCH:(step + 1) * BATCH]]
        pts, mask = to_batch(items, traffic["pad_points"], dev)
        canvas = ref.pillar_canvas(net, pts, mask, s1)
        feats = ref.trunk(net, canvas, s1)
        maps = ref.shrink_heads(net, ref.decode(net, feats, s1), s1)
        lab, box, dbin = zip(*(targets(torch.from_numpy(gt).to(dev),
                                       flat_anchors,
                                       s1["dir_args"]["dir_offset"])
                               for _, gt in items))
        loss = loss_of(maps, torch.stack(lab), torch.stack(box),
                       torch.stack(dbin), flat_anchors[None])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_([params[k] for k in trainable], 10.0)
        opt.step()
        sched.step()
        if step % 100 == 0 or step == STEPS - 1:
            print(json.dumps({"phase": "train", "step": step,
                              "loss": float(loss.detach()),
                              "s": time.time() - t0}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.detach() for k, v in params.items()}
    after = evaluate(params, config, traffic, anchor_t, EVAL_FRAMES)
    print(json.dumps({"phase": "trained", **after}), flush=True)
    out = args.out or os.path.join(REPO, config["stage1_weights"])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({k: v.half().cpu() for k, v in params.items()
                if k.startswith(prefixes)}, out)
    print(json.dumps({"phase": "saved", "file": os.path.relpath(out, REPO),
                      "bytes": os.path.getsize(out),
                      "s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
