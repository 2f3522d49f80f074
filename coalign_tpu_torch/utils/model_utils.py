"""Checkpoint parameter surgery on torch state dicts.

Port of coalign_tpu/utils/model_utils.py (ref opencood/utils/
model_utils.py: rename_model_dict_keys:44, compose_model:71;
utils/cleanup_utils.py): renaming parameter keys and composing a model's
state dict from two checkpoints (the V2VNet-robust curriculum's stages, ref
hypes_yaml/readme.md), functionally. A state dict's keys are "."-joined
paths (the JAX package's flax trees join with "/"); flatten_params and
unflatten_params convert between a nested dict and such keys.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict

import torch

from coalign_tpu_torch.train import _EPOCH_FILE, _numbered


def flatten_params(params: dict, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = v
    return out


def unflatten_params(flat: Dict[str, Any]) -> dict:
    """{"a.b.c": leaf} -> nested dict."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def rename_param_keys(state_dict: dict, pattern: str, repl: str) -> dict:
    """A new state dict with ``re.sub(pattern, repl, key)`` for each key, in
    the same order (ref rename_model_dict_keys:44)."""
    return {re.sub(pattern, repl, k): v for k, v in state_dict.items()}


def compose_params(base: dict, donor: dict, key_patterns) -> dict:
    """A new state dict: every key of ``base`` that some pattern matches
    (re.search) and ``donor`` has takes the donor's value, the rest keep
    base's (ref compose_model:71, stage-wise checkpoint composition)."""
    pats = [re.compile(p) for p in key_patterns]
    return {k: donor[k] if k in donor and any(p.search(k) for p in pats)
            else v for k, v in base.items()}


def count_params(params) -> int:
    """Elements of a module's parameters, or of every tensor of a (flat or
    nested) state dict."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(math.prod(v.shape) for v in flatten_params(params).values()
                   if hasattr(v, "shape")))


def cleanup_checkpoints(ckpt_dir: str, keep: int = 3) -> list:
    """Delete all but the numerically newest ``keep`` ``net_epoch{N}.pth``
    of ``ckpt_dir`` (the bestval file is always kept; ref
    utils/cleanup_utils.py). Returns the removed file names."""
    found = _numbered(ckpt_dir, _EPOCH_FILE)
    removed = []
    for _, path in (found[:-keep] if keep else found):
        os.remove(path)
        removed.append(os.path.basename(path))
    return removed
