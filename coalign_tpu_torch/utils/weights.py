"""Weights into the port: reference ``.pth`` checkpoints and JAX variables.

Port modules carry the reference opencood state-dict names, so a reference
checkpoint loads with ``load_state_dict(strict=True)`` (:func:`load_pth`).
:func:`from_jax_params` turns the variables of a coalign_tpu PointPillars
model (the flagship, ``point_pillar``, ``point_pillar_uncertainty``;
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays)
into such a state dict: it is the inverse of the PointPillars-family maps of
coalign_tpu/utils/ckpt_import.py (``_map_pfn``, ``_map_resnet_trunk``, the
plain backbone's stages, ``_map_deblocks`` with the extra deblock,
``_map_shrink`` and the head keys).

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


def _block_names(layer_nums) -> dict[int, str]:
    """Global flax BasicBlock index -> 'layer{s}.{b}', stage by stage from
    the backbone's ``layer_nums`` (flax numbers a trunk's blocks
    BasicBlock_0, 1, ... across its stages)."""
    names, g = {}, 0
    for stage, n in enumerate(layer_nums):
        for pos in range(n):
            names[g] = f"layer{stage}.{pos}"
            g += 1
    return names


_BLOCK_PARTS = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "downsample.0",
                "MaskedBatchNorm_0": "bn1", "MaskedBatchNorm_1": "bn2",
                "MaskedBatchNorm_2": "downsample.1"}
_BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _deblock_key(prefix: str, mod: str, leaf: str) -> tuple[str, str]:
    if mod == "ConvTranspose_0":
        return f"{prefix}.0.weight", "tconv"
    if mod == "Conv_0":
        return f"{prefix}.0.weight", "conv"
    return f"{prefix}.1.{_BN_FIELDS[leaf]}", "plain"


def _torch_key(path: str, layer_nums) -> tuple[str, str]:
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
        block = _block_names(_need(layer_nums, path))[int(m.group(1))]
        part = _BLOCK_PARTS[m.group(2)]
        if part.startswith(("conv", "downsample.0")):
            return f"backbone.resnet.{block}.{part}.weight", "conv"
        return f"backbone.resnet.{block}.{part}.{_BN_FIELDS[leaf]}", "plain"
    if m := re.fullmatch(
            r"backbone/stages_(\d+)/ConvBNReLU_(\d+)/(\w+)/\w+", path):
        i, j, mod = int(m.group(1)), int(m.group(2)), m.group(3)
        if mod == "Conv_0":
            return f"backbone.blocks.{i}.{1 + 3 * j}.weight", "conv"
        return f"backbone.blocks.{i}.{2 + 3 * j}.{_BN_FIELDS[leaf]}", "plain"
    if m := re.fullmatch(r"backbone/deblocks_(\d+)/(\w+)/\w+", path):
        return _deblock_key(f"backbone.deblocks.{m.group(1)}", m.group(2),
                            leaf)
    if m := re.fullmatch(r"backbone/extra_deblock/(\w+)/\w+", path):
        levels = len(_need(layer_nums, path))
        return _deblock_key(f"backbone.deblocks.{levels}", m.group(1), leaf)
    if m := re.fullmatch(r"shrink/Conv_(\d+)/(kernel|bias)", path):
        c = int(m.group(1))
        key = f"shrink_conv.layers.{c // 2}.double_conv.{2 * (c % 2)}"
        return (f"{key}.weight", "conv") if leaf == "kernel" else \
            (f"{key}.bias", "plain")
    if m := re.fullmatch(r"heads/(cls|reg|dir|unc)_head/(kernel|bias)", path):
        return (f"{m.group(1)}_head.weight", "conv") if leaf == "kernel" \
            else (f"{m.group(1)}_head.bias", "plain")
    raise KeyError(f"no port parameter for flax variable {path!r}")


def _need(layer_nums, path: str):
    if layer_nums is None:
        raise ValueError(f"{path!r} needs the backbone's layer_nums: pass "
                         f"from_jax_params(..., layer_nums=...)")
    return layer_nums


def from_jax_params(variables: dict, layer_nums=None) -> dict:
    """coalign_tpu PointPillars variables (nested numpy dicts) -> port
    state dict, including each batch norm's ``num_batches_tracked``.

    ``layer_nums`` is the backbone's (``base_bev_backbone.layer_nums`` of
    the model's args): it says where each ResNet stage starts and which
    deblock is the extra one. A tree with a trunk or an extra deblock
    needs it; a stage's first block has a downsample conv only when it
    strides or widens, so the names cannot tell."""
    flat = {**_flatten(variables.get("params", {})),
            **_flatten(variables.get("batch_stats", {}))}
    convert = {"plain": lambda v: v, "linear": lambda v: v.T,
               "conv": _conv, "tconv": _tconv}
    sd = {}
    for path, value in flat.items():
        key, kind = _torch_key(path, layer_nums)
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
