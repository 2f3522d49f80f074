"""Weights into the port: reference ``.pth`` checkpoints and JAX variables.

Port modules carry the reference opencood state-dict names, so a reference
checkpoint loads with ``load_state_dict(strict=True)`` (:func:`load_pth`).
:func:`from_jax_params` turns the variables of a coalign_tpu flagship model
(``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays)
into such a state dict: it is the inverse of the PointPillars-family maps of
coalign_tpu/utils/ckpt_import.py (``_map_pfn``, ``_map_resnet_trunk``,
``_map_deblocks``, ``_map_shrink`` and the head keys).

Layouts (flax -> torch):
  Dense kernel (in, out)                        -> Linear weight (out, in)
  Conv kernel HWIO                              -> Conv2d weight OIHW
  ConvTranspose kernel (kh, kw, in, out),
      stored spatially flipped                  -> ConvTranspose2d weight
                                                   (in, out, kh, kw)
  MaskedBatchNorm scale / bias, batch_stats mean / var
                                                -> BatchNorm weight / bias /
                                                   running_mean / running_var
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _conv(k):  # HWIO -> OIHW
    return np.transpose(k, (3, 2, 0, 1))


def _tconv(k):  # flipped (kh, kw, in, out) -> (in, out, kh, kw)
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def _block_names(paths) -> dict[int, str]:
    """Global flax BasicBlock index -> 'layer{s}.{b}'. A stage starts at
    each block with a downsample (Conv_2), which every first block of a
    strided or widening stage has; a wrong split fails the strict load."""
    blocks = sorted({int(m.group(1)) for p in paths
                     if (m := re.match(r"backbone/trunk/BasicBlock_(\d+)/",
                                       p))})
    names, stage, pos = {}, -1, 0
    for g in blocks:
        if f"backbone/trunk/BasicBlock_{g}/Conv_2/kernel" in paths or \
                stage < 0:
            stage, pos = stage + 1, 0
        names[g] = f"layer{stage}.{pos}"
        pos += 1
    return names


_BLOCK_PARTS = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "downsample.0",
                "MaskedBatchNorm_0": "bn1", "MaskedBatchNorm_1": "bn2",
                "MaskedBatchNorm_2": "downsample.1"}
_BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _torch_key(path: str, blocks: dict) -> tuple[str, str]:
    """flax path -> (torch key, layout kind)."""
    parts = path.split("/")
    leaf = parts[-1]
    if m := re.fullmatch(r"encoder/Dense_(\d+)/(kernel|bias)", path):
        field = "weight" if leaf == "kernel" else "bias"
        return f"pillar_vfe.pfn_layers.{m.group(1)}.linear.{field}", \
            ("linear" if leaf == "kernel" else "plain")
    if m := re.fullmatch(r"encoder/MaskedBatchNorm_(\d+)/\w+", path):
        return (f"pillar_vfe.pfn_layers.{m.group(1)}.norm."
                f"{_BN_FIELDS[leaf]}"), "plain"
    if m := re.fullmatch(r"backbone/trunk/BasicBlock_(\d+)/(\w+)/\w+", path):
        part = _BLOCK_PARTS[m.group(2)]
        if part.startswith(("conv", "downsample.0")):
            return f"backbone.resnet.{blocks[int(m.group(1))]}.{part}.weight", \
                "conv"
        return (f"backbone.resnet.{blocks[int(m.group(1))]}.{part}."
                f"{_BN_FIELDS[leaf]}"), "plain"
    if m := re.fullmatch(r"backbone/deblocks_(\d+)/(\w+)/\w+", path):
        i, mod = m.groups()
        if mod == "ConvTranspose_0":
            return f"backbone.deblocks.{i}.0.weight", "tconv"
        if mod == "Conv_0":
            return f"backbone.deblocks.{i}.0.weight", "conv"
        return f"backbone.deblocks.{i}.1.{_BN_FIELDS[leaf]}", "plain"
    if m := re.fullmatch(r"shrink/Conv_(\d+)/(kernel|bias)", path):
        c = int(m.group(1))
        key = f"shrink_conv.layers.{c // 2}.double_conv.{2 * (c % 2)}"
        return (f"{key}.weight", "conv") if leaf == "kernel" else \
            (f"{key}.bias", "plain")
    if m := re.fullmatch(r"heads/(cls|reg|dir)_head/(kernel|bias)", path):
        return (f"{m.group(1)}_head.weight", "conv") if leaf == "kernel" \
            else (f"{m.group(1)}_head.bias", "plain")
    raise KeyError(f"no port parameter for flax variable {path!r}")


def from_jax_params(variables: dict) -> dict:
    """coalign_tpu flagship variables (nested numpy dicts) -> port state
    dict, including each batch norm's ``num_batches_tracked``."""
    flat = {**_flatten(variables.get("params", {})),
            **_flatten(variables.get("batch_stats", {}))}
    blocks = _block_names(set(flat))
    convert = {"plain": lambda v: v, "linear": lambda v: v.T,
               "conv": _conv, "tconv": _tconv}
    sd = {}
    for path, value in flat.items():
        key, kind = _torch_key(path, blocks)
        sd[key] = torch.from_numpy(np.array(convert[kind](value),
                                            dtype=np.float32))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


def load_pth(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference checkpoint into ``model`` with every key matched."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model
