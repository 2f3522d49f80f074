"""Uncertainty-aware PointPillars loss: the PointPillars terms plus a
heteroscedastic (KL) regression loss on (x, y) and a von-Mises negative
log-likelihood on the yaw, weighted by the predicted log-variances.

Port of coalign_tpu/loss/uncertainty_loss.py (ref
opencood/loss/point_pillar_uncertainty_loss.py:16, KLLoss:195). The log of
the Bessel function I0 is ``log(i0e(kappa)) + kappa`` with
``torch.special.i0e``, as the JAX package takes it from
``jax.scipy.special.i0e``.

The settings are read from ``loss.args.uncertainty``, as the JAX package
reads them (coalign_tpu/loss/uncertainty_loss.py:98). The reference's yaml
writes them under ``kl`` (pointpillar_uncertainty.yaml), so with that yaml
both packages train with the default weight 1.0, not the yaml's 0.5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from coalign_tpu_torch.loss.point_pillar_loss import (PointPillarLoss,
                                                      PointPillarLossCfg,
                                                      _flat)
from coalign_tpu_torch.loss.point_pillar_loss import build_loss as _build_base
from coalign_tpu_torch.parallel.distributed import global_sum, summing_mesh


class UncertaintyCfg(NamedTuple):
    dim: int = 3
    weight: float = 1.0
    angle_weight: float = 1.0
    xy_loss_type: str = "l2"
    angle_loss_type: str = "von-mise"
    lambda_v: float = 0.001
    s0: float = 1.0
    limit_period: bool = True


def kl_loss_xy(diff, s, kind: str):
    """0.5 * exp(-s) * |diff|^p + 0.5 * s for l2, + s for l1 (ref
    KLLoss.kl_loss_l1/l2)."""
    if kind == "l2":
        return 0.5 * (torch.exp(-s) * diff ** 2 + s)
    if kind != "l1":
        raise ValueError(f"unknown xy_loss_type {kind!r}")
    return 0.5 * torch.exp(-s) * torch.abs(diff) + s


def kl_loss_angular(diff, s, lambda_v: float, s0: float,
                    use_limit_period: bool):
    """von-Mises NLL with kappa = exp(-s) (ref KLLoss.kl_loss_angular:243).
    With ``use_limit_period`` the heading is ambiguous by pi: |cos diff|
    treats diff and diff + pi alike, and carries no gradient."""
    kappa = torch.exp(-s)
    log_i0 = torch.log(torch.special.i0e(kappa)) + kappa
    cos_term = torch.cos(diff)
    if use_limit_period:
        cos_term = torch.abs(cos_term).detach()
    return log_i0 - kappa * cos_term + lambda_v * F.elu(s - s0)


class PointPillarUncertaintyLoss(PointPillarLoss):
    """PointPillarLoss + the KL uncertainty term on (x, y, yaw), reported
    as ``unc_loss``. outputs: the PointPillarLoss maps and unc_preds
    (B, dim*A, H, W), whose channel ``a * dim + u`` is anchor a's
    log-variance u."""

    def __init__(self, cfg: PointPillarLossCfg, unc_cfg: UncertaintyCfg):
        super().__init__(cfg)
        self.unc = unc_cfg

    def __call__(self, outputs: dict, targets: dict, sample_mask=None):
        total, terms = super().__call__(outputs, targets, sample_mask)
        u = self.unc
        # clamp log sigma^2: unbounded confidence drives kappa = exp(-s) to
        # overflow (a NaN loss) once the detector overfits
        sm = torch.clamp(_flat(outputs["unc_preds"], u.dim), -7.0, 7.0)
        reg_p = _flat(outputs["reg_preds"], 7)
        b = reg_p.shape[0]
        reg_t = targets["targets"].reshape(b, -1, 7)
        pos = targets["pos_equal_one"].reshape(b, -1, 1)
        if sample_mask is not None:
            pos = pos * sample_mask.to(pos.dtype)[:, None, None]
        weights = pos / torch.clamp(pos.sum(dim=1, keepdim=True), min=1.0)

        loss_xy = kl_loss_xy(reg_p[..., :2] - reg_t[..., :2], sm[..., :2],
                             u.xy_loss_type)
        theta_diff = reg_p[..., 6:7] - reg_t[..., 6:7]
        if u.angle_loss_type == "von-mise":
            loss_a = kl_loss_angular(theta_diff, sm[..., 2:3], u.lambda_v,
                                     u.s0, u.limit_period)
        else:
            loss_a = kl_loss_xy(theta_diff, sm[..., 2:3], "l2")
        # the whole batch's B under a data-parallel step's global sums
        mesh = summing_mesh()
        n = b if mesh is None else b * mesh.world
        unc_loss = global_sum((torch.cat([loss_xy, u.angle_weight * loss_a],
                                         dim=-1) * weights).sum()) \
            * u.weight / n
        total = total + unc_loss
        terms["unc_loss"] = unc_loss
        terms["total_loss"] = total
        return total, terms


def build_uncertainty_loss(loss_args: dict) -> PointPillarUncertaintyLoss:
    """From the yaml ``loss.args`` subtree; the uncertainty settings under
    ``uncertainty`` (module docstring)."""
    ua = loss_args.get("uncertainty", {})
    return PointPillarUncertaintyLoss(_build_base(loss_args).cfg,
                                      UncertaintyCfg(
        dim=ua.get("dim", 3),
        weight=ua.get("weight", 1.0),
        angle_weight=ua.get("angle_weight", 1.0),
        xy_loss_type=ua.get("xy_loss_type", "l2"),
        angle_loss_type=ua.get("angle_loss_type", "von-mise"),
        lambda_v=ua.get("lambda_V", 0.001),
        s0=ua.get("s0", 1.0),
        limit_period=ua.get("limit_period", True)))
