"""Weights into the port: reference ``.pth`` checkpoints and JAX variables.

Port modules carry the reference opencood state-dict names, so a reference
checkpoint loads with ``load_state_dict(strict=True)`` (:func:`load_pth`).
:func:`from_jax_params` turns the variables of a coalign_tpu PointPillars
model (the flagship, ``point_pillar``, ``point_pillar_uncertainty``,
``point_pillar_baseline`` with any ported fusion, ``point_pillar_
intermediate``, ``point_pillar_disconet`` and its teacher, ``point_pillar_
deform_transformer``, ``point_pillar_where2comm`` with its
``single_heads``, ``point_pillar_v2vnet_robust`` with its pair nets and
``alpha``, ``point_pillar_mash`` with its down blocks and ``no_match``;
``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays) into such a state
dict: it is the inverse of the PointPillars-family maps of
coalign_tpu/utils/ckpt_import.py (``_map_pfn``, ``_map_resnet_trunk``, the
plain backbone's stages, ``_map_deblocks`` with the extra deblock,
``_map_shrink``, ``_map_compressor``, ``_map_fusion`` with
``_map_pixel_weight``, ``_map_v2vnet_fusion``, ``_map_when2comm_fusion``,
``_map_cbr`` and ``_map_v2xvit_fusion``, and the head keys). A baseline's
fusion is ``fusion`` in flax and ``fusion_net`` here, the multiscale
model's ``fusion_nets_{i}`` and ``fusion_net.{i}``. It also takes the SECOND
family's variables (the inverse of ckpt_import.py:708-880:
``_SECOND_3D_SLOTS``, ``_conv3d_weight``'s spconv 1.x layout, which the
port keeps, ``_map_ssfa`` and the CIA-SSD head names; VoxelNet's VFE,
middle convs and 2D backbone), the PIXOR family's (the inverse of
ckpt_import.py:652 ``_map_pixor_family``) and the LSS camera family's
(the inverse of ckpt_import.py:545 ``_map_lss_family``).

Where the reference has weights the JAX package has not, the state dict
gets zeros, which compute what the JAX package computes: the bias of a
conv before a batch norm (the JAX import folds it into the running mean),
and the weights the reference's forward never reads (When2comm's
``attention_net.linear_out``, V2X-ViT's ``encoder.prior_feed``). V2X-ViT's
per-type HGT linears are stacked (T, in, out) in flax and ``{k,q,v,a}_
linears.{t}`` here; When2comm's first key and query Linear reads the
pooled (128, 5, 7) map flattened HWC in flax and CHW here.

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
    if m := re.fullmatch(r"(single_)?heads/(cls|reg|dir|iou|unc)_head/"
                         r"(kernel|bias)", path):
        head = f"{m.group(1) and 'single_heads.' or ''}{m.group(2)}_head"
        return (f"{head}.weight", "conv") if leaf == "kernel" \
            else (f"{head}.bias", "plain")
    raise KeyError(f"no port parameter for flax variable {path!r}")


# fusion modules: flax module path (inside ``fusion`` / ``fusion_nets_{i}``)
# -> (port module, layout of its kernel); "conv0" is a conv whose
# reference bias the JAX package folded into the next batch norm
def _cbr(pattern: str, unit) -> list:
    """A flax ConvBNReLU -> the reference's [conv with bias, batch norm]
    at ``{unit}.0`` and ``{unit}.1``."""
    def name(i):
        return lambda m: f"{unit(m) if callable(unit) else unit}.{i}"
    return [(rf"{pattern}/Conv_0", name(0), "conv0"),
            (rf"{pattern}/MaskedBatchNorm_0", name(1), "bn")]


_FUSION_MODULES = [
    (r"PixelWeightLayer_0/ConvBNReLU_(\d)/Conv_0",
     lambda m: f"pixel_weight_layer.conv1_{int(m[1]) + 1}", "conv0"),
    (r"PixelWeightLayer_0/ConvBNReLU_(\d)/MaskedBatchNorm_0",
     lambda m: f"pixel_weight_layer.bn1_{int(m[1]) + 1}", "bn"),
    (r"PixelWeightLayer_0/Conv_0", "pixel_weight_layer.conv1_4", "conv"),
    (r"msg_cnn", "msg_cnn", "conv"),
    (r"conv_gru/(conv_gates|conv_can)",
     lambda m: f"conv_gru.cell_list.0.{m[1]}", "conv"),
    (r"mlp", "mlp", "linear"),
    *_cbr(r"ConvBNReLU_([0-4])",
          lambda m: f"query_key_net.conv{int(m[1]) + 1}.cbr_unit"),
    *_cbr(r"ConvBNReLU_5", "key_net.conv1.cbr_unit"),
    *_cbr(r"ConvBNReLU_6", "query_net.conv1.cbr_unit"),
    (r"(key|query)_fc1", lambda m: f"{m[1]}_net.fc.0", "linear_hwc"),
    (r"(key|query)_fc([23])",
     lambda m: f"{m[1]}_net.fc.{2 * int(m[2]) - 2}", "linear"),
    (r"att_(feat|context)", lambda m: f"attention_net.linear_{m[1]}",
     "linear"),
    # robust V2VNet's pair nets
    (r"(pose_regression|attention)/ConvBNReLU_(\d)/Conv_0",
     lambda m: f"{m[1]}.convs.{3 * int(m[2])}", "conv"),
    (r"(pose_regression|attention)/ConvBNReLU_(\d)/MaskedBatchNorm_0",
     lambda m: f"{m[1]}.convs.{3 * int(m[2]) + 1}", "bn"),
    (r"(pose_regression|attention)/Dense_([01])",
     lambda m: f"{m[1]}.{('fc', 'out')[int(m[2])]}", "linear"),
    # MASH's down blocks: flax numbers them query, key, query, key, ...
    (r"_Down_(\d+)/ConvBNReLU_(\d)/Conv_0",
     lambda m: f"{('query', 'key')[int(m[1]) % 2]}_net.{int(m[1]) // 2}."
               f"{3 * int(m[2])}", "conv"),
    (r"_Down_(\d+)/ConvBNReLU_(\d)/MaskedBatchNorm_0",
     lambda m: f"{('query', 'key')[int(m[1]) % 2]}_net.{int(m[1]) // 2}."
               f"{3 * int(m[2]) + 1}", "bn"),
    # the deformable fusion's offset and weight head
    (r"Dense_0", "head", "linear"),
]
# fusion parameters that are leaves of the fusion module itself
_FUSION_LEAVES = ("no_match", "alpha")
_COMPRESSOR_SLOTS = {"0": ("encoder.0", "encoder.1"),
                     "1": ("decoder.0", "decoder.1"),
                     "2": ("decoder.3", "decoder.4")}
_LEAF_FIELDS = {"kernel": "weight", "bias": "bias", **_BN_FIELDS}


def _hwc_rows_to_chw(k):
    """When2comm's fc1: flax (5*7*128 HWC rows, out) -> torch (out, 128*5*7
    CHW columns), the inverse of ckpt_import.py:407-412."""
    return k.reshape(5, 7, 128, -1).transpose(3, 2, 0, 1).reshape(
        k.shape[-1], -1)


_KERNELS = {"conv": _conv, "conv0": _conv, "linear": lambda k: k.T,
            "linear_hwc": _hwc_rows_to_chw}


def _module_entries(module: str, kind: str, leaf: str, value) -> list:
    """One flax leaf of a mapped module -> [(port key, array)]; a conv0
    kernel brings its zero bias."""
    if leaf != "kernel":
        return [(f"{module}.{_LEAF_FIELDS[leaf]}", value)]
    out = [(f"{module}.weight", _KERNELS[kind](value))]
    if kind == "conv0":
        out.append((f"{module}.bias", np.zeros(value.shape[-1], np.float32)))
    return out


def _v2xvit_entries(rest: str, value, nb: int) -> list:
    """A flax leaf of the JAX V2XViTFusion -> [(key under its
    ``fusion_net.``, array)] (the inverse of ckpt_import.py:264-360; nb =
    blocks per depth)."""
    enc = "fusion_net.encoder.layers"
    leaf = rest.split("/")[-1]
    if m := re.fullmatch(r"LayerNorm_(\d+)/\w+", rest):
        d, r = divmod(int(m[1]), 2 * nb + 1)
        mod = (f"{enc}.{d}.1.norm" if r == 2 * nb
               else f"{enc}.{d}.0.layers.{r // 2}.{r % 2}.norm")
        return [(f"{mod}.{'weight' if leaf == 'scale' else 'bias'}", value)]
    if m := re.fullmatch(r"Dense_(\d+)/\w+", rest):
        d, second = divmod(int(m[1]), 2)
        out = _module_entries(f"{enc}.{d}.1.fn.net.{3 * second}", "linear",
                              leaf, value)
        if int(m[1]) == 0 and leaf == "kernel":   # dead in the reference
            dim = value.shape[0]
            out += [("fusion_net.encoder.prior_feed.weight",
                     np.zeros((dim, dim + 3), np.float32)),
                     ("fusion_net.encoder.prior_feed.bias",
                      np.zeros(dim, np.float32))]
        return out
    m = re.fullmatch(r"(HGTCavAttention|CavAttention|PyramidWindowAttention)"
                     r"_(\d+)/(.+)", rest)
    if not m:
        raise KeyError(f"no port parameter for V2X-ViT variable {rest!r}")
    d, b = divmod(int(m[2]), nb)
    base = f"{enc}.{d}.0.layers.{b}.{int(m[1] == 'PyramidWindowAttention')}.fn"
    inner = m[3]
    if m2 := re.fullmatch(r"([kqva])_([wb])", inner):       # (T, ...) stacked
        field = "weight" if m2[2] == "w" else "bias"
        return [(f"{base}.{m2[1]}_linears.{t}.{field}",
                 v.T if field == "weight" else v)
                for t, v in enumerate(value)]
    if inner in ("relation_att", "relation_msg"):
        return [(f"{base}.{inner}", value)]
    if m2 := re.fullmatch(r"WindowAttention_(\d+)/pos_embedding", inner):
        return [(f"{base}.pwmsa.{m2[1]}.pos_embedding", value)]
    if m2 := re.fullmatch(r"(?:WindowAttention_(\d+)/)?(to_qkv|to_out)/\w+",
                          inner):
        mod = f"{base}.pwmsa.{m2[1]}" if m2[1] is not None else base
        mod += ".to_qkv" if m2[2] == "to_qkv" else ".to_out.0"
        return _module_entries(mod, "linear", leaf, value)
    if m2 := re.fullmatch(r"SplitAttn_0/(fc1|fc2|bn1)/\w+", inner):
        if m2[1] == "bn1":
            return [(f"{base}.split_attn.bn1."
                     f"{'weight' if leaf == 'scale' else 'bias'}", value)]
        return _module_entries(f"{base}.split_attn.{m2[1]}", "linear", leaf,
                               value)
    raise KeyError(f"no port parameter for V2X-ViT variable {rest!r}")


def _fusion_entries(rest: str, value, nb) -> list:
    """A flax leaf inside a fusion module -> [(key under the port's fusion
    module, array)]; ``nb`` is V2X-ViT's blocks per depth, None for the
    other fusions."""
    if nb is not None:
        return _v2xvit_entries(rest, value, nb)
    if rest in _FUSION_LEAVES:
        return [(rest, value)]
    module, leaf = rest.rsplit("/", 1)
    for pattern, name, kind in _FUSION_MODULES:
        if m := re.fullmatch(pattern, module):
            name = name(m) if callable(name) else name
            out = _module_entries(name, kind, leaf, value)
            if name == "attention_net.linear_context" and leaf == "kernel":
                out += [("attention_net.linear_out.weight",  # dead in the ref
                         np.zeros((1, value.shape[-1]), np.float32)),
                        ("attention_net.linear_out.bias",
                         np.zeros(1, np.float32))]
            return out
    raise KeyError(f"no port parameter for fusion variable {rest!r}")


def _v2xvit_blocks(flat: dict) -> dict:
    """flax fusion prefix -> V2X-ViT's blocks per depth, for the fusions
    that are V2X-ViT: agent-attention modules over feed-forward pairs."""
    atts, denses = {}, {}
    for path in flat:
        if m := re.match(r"(fusion(?:_nets_\d+)?)/(?:HGT)?CavAttention_(\d+)/",
                         path):
            atts.setdefault(m[1], set()).add(m[2])
        elif m := re.match(r"(fusion(?:_nets_\d+)?)/Dense_(\d+)/", path):
            denses.setdefault(m[1], set()).add(m[2])
    return {p: len(a) // (len(denses[p]) // 2) for p, a in atts.items()}


def _entries(path: str, value, layer_nums, v2xvit_blocks: dict) -> list:
    """A flax variable -> [(port key, array)]."""
    if m := re.fullmatch(r"compressor/ConvBNReLU_(\d)/(Conv_0|"
                         r"MaskedBatchNorm_0)/(\w+)", path):
        conv, bn = _COMPRESSOR_SLOTS[m[1]]
        if m[2] == "Conv_0":
            return _module_entries(f"naive_compressor.{conv}", "conv0", m[3],
                                   value)
        return _module_entries(f"naive_compressor.{bn}", "bn", m[3], value)
    if m := re.fullmatch(r"(fusion(?:_nets_(\d+))?)/(.+)", path):
        prefix = "fusion_net." if m[2] is None else f"fusion_net.{m[2]}."
        return [(prefix + k, v) for k, v in _fusion_entries(
            m[3], value, v2xvit_blocks.get(m[1]))]
    key, kind = _torch_key(path, layer_nums)
    convert = {"plain": lambda v: v, "linear": lambda v: v.T,
               "conv": _conv, "tconv": _tconv}
    return [(key, convert[kind](value))]


def _need(layer_nums, path: str):
    if layer_nums is None:
        raise ValueError(f"{path!r} needs the backbone's layer_nums: pass "
                         f"from_jax_params(..., layer_nums=...)")
    return layer_nums


# the SECOND family (ckpt_import.py:708-880, inverted): the flax
# Conv3DBNReLU creation order -> the reference's 3D blocks
_SECOND_3D_BLOCKS = ("conv_input", "conv1.0", "conv2.0", "conv2.1", "conv2.2",
                     "conv3.0", "conv3.1", "conv3.2", "conv4.0", "conv4.1",
                     "conv4.2", "conv_out")
# SSFA's ConvBNReLU_k -> (its Sequential, the conv's index); the norm
# follows the conv (bottom_up_block_0 starts with a ZeroPad2d)
_SSFA_CONVS = (("bottom_up_block_0", 1), ("bottom_up_block_0", 4),
               ("bottom_up_block_0", 7), ("bottom_up_block_1", 0),
               ("bottom_up_block_1", 3), ("bottom_up_block_1", 6),
               ("trans_0", 0), ("trans_1", 0), ("conv_0", 0), ("conv_1", 0))
_CIASSD_HEADS = {"cls": "conv_cls", "reg": "conv_box", "dir": "conv_dir",
                 "iou": "conv_iou", "unc": "conv_unc"}


def _second_key(path: str, ssfa: bool, layer_nums) -> tuple[str, str]:
    """A flax path of the SECOND family -> (torch key, layout kind)."""
    leaf = path.split("/")[-1]
    field = _LEAF_FIELDS[leaf]
    if m := re.fullmatch(r"VoxelBackbone8x_0/Conv3DBNReLU_(\d+)/(\w+)/\w+",
                         path):
        block = (f"{'spconv_block' if ssfa else 'backbone_3d'}."
                 f"{_SECOND_3D_BLOCKS[int(m[1])]}")
        if m[2] == "Conv_0":      # (kz, ky, kx, in, out), spconv 1.x's
            return f"{block}.0.weight", "plain"
        return f"{block}.1.{field}", "plain"
    if m := re.fullmatch(r"Conv3DBNReLU_(\d)/(\w+)/\w+", path):
        if m[2] == "Conv_0":
            return f"cml.{m[1]}.0.weight", "conv3d"
        return f"cml.{m[1]}.1.{field}", "plain"
    if m := re.fullmatch(r"(?:VFELayer_(\d)/)?(Dense|MaskedBatchNorm)_0/\w+",
                         path):
        mod = "svfe" + (f".vfe_{int(m[1]) + 1}" if m[1] else "")
        if m[2] == "Dense":
            return f"{mod}.linear.weight", "linear"
        return f"{mod}.norm.{field}", "plain"
    if m := re.fullmatch(r"SSFA_0/ConvBNReLU_(\d+)/(\w+)/\w+", path):
        mod, i = _SSFA_CONVS[int(m[1])]
        if m[2] == "Conv_0":
            return f"ssfa.{mod}.{i}.weight", "conv"
        return f"ssfa.{mod}.{i + 1}.{field}", "plain"
    if m := re.fullmatch(r"SSFA_0/ConvTranspose_(\d)/kernel", path):
        return f"ssfa.deconv_block_{m[1]}.0.weight", "tconv"
    if m := re.fullmatch(r"SSFA_0/Conv_(\d)/kernel", path):
        return f"ssfa.w_{m[1]}.0.weight", "conv"
    if m := re.fullmatch(r"SSFA_0/MaskedBatchNorm_(\d)/\w+", path):
        i = int(m[1])
        mod = f"deconv_block_{i}" if i < 2 else f"w_{i - 2}"
        return f"ssfa.{mod}.1.{field}", "plain"
    if m := re.fullmatch(r"DetectionHeads_0/(\w+)_head/\w+", path):
        head = f"head.{_CIASSD_HEADS[m[1]]}" if ssfa else f"{m[1]}_head"
        return f"{head}.{field}", "conv" if leaf == "kernel" else "plain"
    if path.startswith("BaseBEVBackbone_0/"):
        key, kind = _torch_key("backbone/" + path[len("BaseBEVBackbone_0/"):],
                               layer_nums)
        return "backbone_2d." + key[len("backbone."):], kind
    raise KeyError(f"no port parameter for flax variable {path!r}")


def _second_family_state(flat: dict, layer_nums) -> dict:
    """The SECOND family's flax variables (flat) -> port arrays. The first
    2D conv reads the height-compressed grid, flattened D-major by the JAX
    package and C-major by the port (and the reference): its kernel's input
    rows are permuted (ckpt_import.py:843-850, inverted). The JAX
    package's IoU head has a bias that CIA-SSD's reference head lacks: it
    must be 0 (no loss reaches it), and is dropped."""
    ssfa = any(p.startswith("SSFA_0/") for p in flat)
    c3d = next((v.shape[-1] for p, v in flat.items() if re.fullmatch(
        r"(VoxelBackbone8x_0/Conv3DBNReLU_11|Conv3DBNReLU_2)/Conv_0/kernel",
        p)), None)
    first = ("SSFA_0/ConvBNReLU_0/Conv_0/kernel" if ssfa else
             "BaseBEVBackbone_0/stages_0/ConvBNReLU_0/Conv_0/kernel")
    convert = {"plain": lambda v: v, "linear": lambda v: v.T, "conv": _conv,
               "tconv": _tconv,
               "conv3d": lambda v: np.transpose(v, (4, 3, 0, 1, 2))}
    out = {}
    for path, value in flat.items():
        if ssfa and path == "DetectionHeads_0/iou_head/bias":
            if np.any(value != 0):
                raise ValueError("CIA-SSD's IoU head has no bias, but the "
                                 "JAX variables' is not 0")
            continue
        if path == first and c3d:
            kh, kw, cd, o = value.shape
            value = value.reshape(kh, kw, cd // c3d, c3d, o).transpose(
                0, 1, 3, 2, 4).reshape(kh, kw, cd, o)
        key, kind = _second_key(path, ssfa, layer_nums)
        out[key] = convert[kind](value)
    return out


def _pixor_family_state(flat: dict) -> dict:
    """The PIXOR family's flax variables (flat) -> port arrays: the inverse
    of ckpt_import.py:652 ``_map_pixor_family``. A Bottleneck is flax's
    ``block{s}_{i}`` and the reference's ``block{s}.{i}``; its
    ``down_conv``/``down_bn`` are ``downsample.0``/``.1``; the deconvs'
    kernels are TorchConvTranspose2d's flipped (kh, kw, in, out)."""
    out = {}
    for path, value in flat.items():
        parts = path.split("/")
        leaf, mod = parts[-1], parts[:-1]
        if m := re.fullmatch(r"block(\d)_(\d+)", mod[1]):
            sub = {"down_conv": "downsample.0", "down_bn": "downsample.1"}
            name = (f"{mod[0]}.block{m[1]}.{m[2]}."
                    f"{sub.get(mod[2], mod[2])}")
        else:
            name = ".".join(mod)
        if leaf == "kernel":
            value = (_tconv(value) if mod[-1].startswith("deconv")
                     else _conv(value))
        out[f"{name}.{_LEAF_FIELDS[leaf]}"] = value
    return out


_UP_SLOTS = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_BOTTLENECK_PARTS = {"down_conv": "downsample.0", "down_bn": "downsample.1"}
_LSS_MODULES = {"bevencode/up2_conv": "bevencode.up2.1",
                "bevencode/up2_bn": "bevencode.up2.2",
                "bevencode/up2_out": "bevencode.up2.4",
                "bevencode/down1": "bevencode.down_layer.0",
                "bevencode/down2": "bevencode.down_layer.2",
                "camencode/trunk/conv_stem": "camencode.trunk._conv_stem",
                "camencode/trunk/bn0": "camencode.trunk._bn0"}


def _lss_module(mod: str) -> str:
    """A flax module path of the LSS family -> the port's module name (the
    inverse of ckpt_import.py:465-650)."""
    if mod in _LSS_MODULES:
        return _LSS_MODULES[mod]
    if m := re.fullmatch(r"(\w+)/(up\d|up_layer\d)/(\w+)", mod):
        return f"{m[1]}.{m[2]}.conv.{_UP_SLOTS[m[3]]}"
    if m := re.fullmatch(r"camencode/trunk/blocks_(\d+)/(\w+)", mod):
        return f"camencode.trunk._blocks.{m[1]}._{m[2]}"
    if m := re.fullmatch(r"(\w+)/trunk/(conv1|bn1)", mod):
        return f"{m[1]}.{m[2]}"
    if m := re.fullmatch(r"camencode/trunk/layer(\d)_(\d+)/(\w+)", mod):
        return (f"camencode.layer{m[1]}.{m[2]}."
                f"{_BOTTLENECK_PARTS.get(m[3], m[3])}")
    if m := re.fullmatch(r"bevencode/trunk/layer(\d)_(\d+)/(\w+)", mod):
        return f"bevencode.layer{m[1]}.{m[2]}.{_BLOCK_PARTS[m[3]]}"
    if m := re.fullmatch(r"camencode/(image_head|depth_head)", mod):
        return f"camencode.{m[1]}"
    if m := re.fullmatch(r"heads(_single)?/(cls|reg|dir)_head", mod):
        return f"{m[2]}_head" + ("_before_fusion" if m[1] else "")
    raise KeyError(f"no port parameter for LSS variable {mod!r}")


def _lss_family_state(flat: dict) -> dict:
    """The LSS camera family's flax variables (flat) -> port arrays: the
    inverse of ckpt_import.py:545 ``_map_lss_family``. The collaborative
    model's single-scale fusion ``bevencode/fuse`` is the port's
    ``bevencode.fuse_module``; the multiscale fusions have no
    parameters."""
    fuse = {"fusion/" + p[len("bevencode/fuse/"):]: v for p, v in flat.items()
            if p.startswith("bevencode/fuse/")}
    nb = _v2xvit_blocks(fuse).get("fusion")
    out = {}
    for path, value in flat.items():
        if path.startswith("bevencode/fuse/"):
            out.update({"bevencode.fuse_module." + k: v
                        for k, v in _fusion_entries(
                            path[len("bevencode/fuse/"):], value, nb)})
            continue
        if path.startswith("shrink/"):
            key, kind = _torch_key(path, None)
            out[key] = _conv(value) if kind == "conv" else value
            continue
        mod, leaf = path.rsplit("/", 1)
        out[f"{_lss_module(mod)}.{_LEAF_FIELDS[leaf]}"] = (
            _conv(value) if leaf == "kernel" else value)
    return out


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
    if any(p.startswith(("VoxelBackbone8x_0/", "VFELayer_0/", "SSFA_0/"))
           for p in flat):
        arrays = _second_family_state(flat, layer_nums).items()
    elif any(p.startswith("backbone/block2_0/") for p in flat):
        arrays = _pixor_family_state(flat).items()
    elif any(p.startswith("camencode/") for p in flat):
        arrays = _lss_family_state(flat).items()
    else:
        v2xvit_blocks = _v2xvit_blocks(flat)
        arrays = [kv for path, value in flat.items()
                  for kv in _entries(path, value, layer_nums, v2xvit_blocks)]
    sd = {}
    for key, array in arrays:
        sd[key] = torch.from_numpy(np.array(array, dtype=np.float32))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


def load_pth(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference checkpoint into ``model`` with every key matched.
    A model's ``STATE_DICT_ALIASES`` ({checkpoint prefix: the model's})
    renames a block the reference names two ways (the SECOND family's 3D
    backbone, ``backbone_3d`` or ``spconv_block``); its ``STATE_DICT_DEAD``
    prefixes name reference modules that no forward reads, whose keys are
    dropped (the LSS encoders' efficientnet classifier and ResNet-101's
    up1/up2, as coalign_tpu/utils/ckpt_import.py:521-590 drops them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    dead = tuple(getattr(model, "STATE_DICT_DEAD", ()))
    if dead:
        sd = {k: v for k, v in sd.items() if not k.startswith(dead)}
    for alias, name in getattr(model, "STATE_DICT_ALIASES", {}).items():
        sd = {name + k[len(alias):] if k.startswith(alias) else k: v
              for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model
