"""DiscoNet's knowledge-distillation loss.

Port of coalign_tpu/loss/disconet_loss.py (ref opencood/loss/
point_pillar_disconet_loss.py:11-75): the PointPillars detection loss plus
a channelwise KL divergence between the student's fused BEV map and the
frozen early-fusion teacher's.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.loss.point_pillar_loss import build_loss as _build_pp
from coalign_tpu_torch.parallel.distributed import global_mean


def channel_kl(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """KL(softmax(teacher) || softmax(student)), the softmax over the
    channels of NCHW maps (dim 1), averaged over every element as
    KLDivLoss(size_average=True) does (ref kd_loss_feature)."""
    log_s = torch.log_softmax(student, dim=1)
    log_t = torch.log_softmax(teacher, dim=1)
    return global_mean(log_t.exp() * (log_t - log_s))


class DiscoNetLoss:
    """Detection loss plus ``kd_weight`` times channel_kl of the student's
    ``feature`` against the teacher's ``teacher_feature`` (detached); with
    ``decoder_kd`` also of the reg and cls maps against the teacher's."""

    def __init__(self, det_loss, kd_weight: float = 1.0,
                 decoder_kd: bool = False):
        self.det_loss = det_loss
        self.kd_weight = kd_weight
        self.decoder_kd = decoder_kd

    def __call__(self, outputs: dict, labels: dict):
        total, terms = self.det_loss(outputs, labels)
        kd = channel_kl(outputs["feature"],
                        outputs["teacher_feature"].detach())
        if self.decoder_kd:
            for key in ("reg_preds", "cls_preds"):
                kd = kd + channel_kl(outputs[key],
                                     outputs["teacher_" + key].detach())
        total = total + self.kd_weight * kd
        terms = dict(terms)
        terms.update(kd_loss=kd, total_loss=total)
        return total, terms


def build_disconet_loss(args: dict) -> DiscoNetLoss:
    """From the yaml ``loss.args``; ``kd.weight`` (1.0), ``kd.decoder_kd``."""
    kd = args.get("kd", {})
    return DiscoNetLoss(_build_pp(args), kd_weight=kd.get("weight", 1.0),
                        decoder_kd=kd.get("decoder_kd", False))
