"""Pose-error (localization noise) injection, the fault model of the
robustness experiments.

Port of coalign_tpu/utils/pose_noise.py (ref opencood/utils/pose_utils.py):
batched over padded agent poses, drawn from an explicit ``torch.Generator``
where the JAX package takes a key. The same distributions, not the same
draws. Noise perturbs x and y in metres and the yaw in degrees and leaves
z, roll and pitch clean, as ref pose_utils.py:43 (generate_noise), :77
(generate_noise_laplace) and :108 (generate_noise_torch, von Mises yaw).
"""

from __future__ import annotations

import math

import torch


def _laplace(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Laplace draws (scale 1) by the inverse CDF of uniforms in
    (-1/2, 1/2)."""
    u = torch.rand(shape, generator=generator,
                   device=generator.device) - 0.5
    return -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


def generate_pose_noise(generator: torch.Generator, shape, pos_std, rot_std,
                        pos_mean=0.0, rot_mean=0.0, kind: str = "gaussian"):
    """Pose noise [dx, dy, 0, 0, dyaw, 0] for ``shape`` agents (e.g.
    (B, L)), float32 on the generator's device: (*shape, 6). x and y are
    drawn first, then the yaw.

    kind: 'gaussian' | 'laplace' | 'von_mises'. von_mises draws x and y as
    'gaussian' does and the yaw with concentration (180 / (pi * rot_std))^2
    (ref pose_utils.py:134), as a wrapped normal (_sample_von_mises)."""
    shape = tuple(shape)
    dev = generator.device
    if kind == "gaussian":
        xy = pos_mean + pos_std * torch.randn(shape + (2,),
                                              generator=generator, device=dev)
        yaw = rot_mean + rot_std * torch.randn(shape + (1,),
                                               generator=generator,
                                               device=dev)
    elif kind == "laplace":
        xy = _laplace(generator, shape + (2,)) * pos_std + pos_mean
        yaw = _laplace(generator, shape + (1,)) * rot_std + rot_mean
    elif kind == "von_mises":
        xy = pos_mean + pos_std * torch.randn(shape + (2,),
                                              generator=generator, device=dev)
        concentration = (180.0 / (math.pi * rot_std)) ** 2
        yaw = torch.rad2deg(_sample_von_mises(
            generator, shape + (1,), concentration)) + rot_mean
    else:
        raise ValueError(f"unknown noise kind {kind!r}")
    zeros = torch.zeros(shape + (1,), dtype=xy.dtype, device=dev)
    return torch.cat([xy, zeros, zeros, yaw, zeros], dim=-1)


def add_pose_noise(generator: torch.Generator, lidar_pose, agent_mask=None,
                   pos_std=0.2, rot_std=0.2, pos_mean=0.0, rot_mean=0.0,
                   kind: str = "gaussian"):
    """Noisy poses; the caller keeps the input as ``lidar_pose_clean``.

    lidar_pose (..., 6) tensor. Every agent, the ego too, is perturbed (ref
    pose_utils.py:10 add_noise_data_dict loops over all cavs); with
    ``agent_mask`` (...,) the masked-out agents keep their poses. With both
    standard deviations 0 the input comes back as it is, and nothing is
    drawn."""
    if pos_std == 0.0 and rot_std == 0.0:
        return lidar_pose
    noise = generate_pose_noise(generator, lidar_pose.shape[:-1], pos_std,
                                rot_std, pos_mean, rot_mean, kind)
    noisy = lidar_pose + noise.to(lidar_pose.device, lidar_pose.dtype)
    if agent_mask is not None:
        noisy = torch.where(torch.as_tensor(
            agent_mask, device=lidar_pose.device)[..., None], noisy,
            lidar_pose)
    return noisy


def _sample_von_mises(generator: torch.Generator, shape, concentration):
    """A von Mises sample (radians) approximated by a wrapped normal with
    sigma = 1 / sqrt(concentration), which is close for the large
    concentrations of yaw noise of a few degrees (kappa >> 1)."""
    sigma = 1.0 / math.sqrt(concentration)
    raw = sigma * torch.randn(shape, generator=generator,
                              device=generator.device)
    return torch.remainder(raw + math.pi, 2 * math.pi) - math.pi
