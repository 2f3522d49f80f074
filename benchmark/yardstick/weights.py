"""Seeded weights, made on the device from the configuration's weight seed
and handed to the program and to the reference alike.

Every convolution and linear kernel comes out of one ``torch.randn`` call
on the device's own generator, scaled to a variance of 1 / fan_in (lecun
normal, the JAX package's default); biases are 0; norms start at scale 1,
shift 0, mean 0, variance 1. calibrate() then sets every norm's running
statistics from one batch of the weight seed's own scene, and shifts the cls
bias so that about ``cls_candidates`` anchors of that scene score above the
threshold: a seeded model then decodes a few hundred candidate boxes a
frame, as a trained one does, instead of none or all.
"""

from __future__ import annotations

import math

import torch


def seeded(shapes: dict, seed: int, device, head_scale: float = 1.0) -> dict:
    """name -> tensor on ``device`` for the ``shapes`` of
    reference.pointpillar.param_shapes. ``head_scale`` multiplies the reg,
    dir and unc heads' kernels, so that seeded boxes keep car-like sizes."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    kernels = [k for k, s in shapes.items()
               if k.endswith(".weight") and len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in kernels),
                       generator=gen, device=device)
    out, at = {}, 0
    for k in kernels:
        s = shapes[k]
        n = math.prod(s)
        # a transposed conv of stride = kernel feeds each output from one
        # tap of every input channel
        if ".deblocks." in k:
            fan_in = s[0]
        else:
            fan_in = math.prod(s[1:])
        scale = 1.0 / math.sqrt(fan_in)
        if k.split("_head")[0] in ("reg", "dir", "unc"):
            scale *= head_scale
        out[k] = flat[at:at + n].reshape(s) * scale
        at += n
    for k, s in shapes.items():
        if k in out:
            continue
        fill = 1.0 if k.endswith(("running_var", ".weight")) else 0.0
        out[k] = torch.full(s, fill, device=device)
    return out


def shift_cls_bias(params: dict, cls_logits: torch.Tensor, threshold: float,
                   candidates: int):
    """Move the cls head's bias so that ``candidates`` of ``cls_logits``
    (the calibration batch's, any shape) lie above logit(threshold)."""
    top = torch.topk(cls_logits.flatten(), candidates).values[-1]
    params["cls_head.bias"] += math.log(threshold / (1 - threshold)) - top
