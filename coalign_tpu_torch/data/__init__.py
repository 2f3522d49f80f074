"""The port's host data feed: datasets, batchers, augmentation, prefetch.

``build_dataset`` is the port of coalign_tpu/data/__init__.py:7-68: OPV2V
and V2XSet (data/opv2v.py), DAIR-V2X (data/dairv2x.py) and V2X-Sim
(data/v2xsim.py)."""

from coalign_tpu_torch.data.batch import (EarlyFusionBatcher,  # noqa: F401
                                          IntermediateFusionBatcher,
                                          KDFusionBatcher, LateFusionBatcher)
from coalign_tpu_torch.data.synthetic import SyntheticScenes  # noqa: F401

_BATCHERS = {"intermediate": IntermediateFusionBatcher,
             "early": EarlyFusionBatcher,
             "late": LateFusionBatcher}


def build_dataset(params: dict, train: bool = True, native: bool = True):
    """(base dataset, batcher) from a hypes yaml's ``fusion``, ``root_dir``
    (``validate_dir`` first when not ``train``), ``train_params.max_cav``,
    ``preprocess.cav_lidar_range``, ``comm_range``, ``noise_setting`` and,
    when ``train``, ``data_augment`` (ref data_utils/datasets/__init__.py:
    10-28). The base dataset serves frames; the batcher assembles padded
    fixed-shape host batches. DAIR-V2X reads the tree at ``data_dir`` with
    the root as its split json; V2X-Sim's root is its info pickle. The
    fusion method picks the batcher:
    intermediate unless it names early or late. ``native`` picks the C++
    data plane for both (the default) or their numpy paths (reader and
    batcher ``native=False``)."""
    fusion = params["fusion"]["core_method"].lower()
    name = params["fusion"].get("dataset",
                                params.get("dataset", "opv2v")).lower()
    if name not in ("opv2v", "v2xset", "dairv2x", "v2xsim"):
        raise KeyError(f"unknown dataset {name!r}")
    max_cav = params["train_params"].get("max_cav", 5)
    root = params["root_dir"] if train else (
        params.get("validate_dir") or params["root_dir"])
    if name == "dairv2x":
        # DAIR-V2X: the yaml's data_dir is the tree, the root its split json
        from coalign_tpu_torch.data.dairv2x import DAIRV2XBaseDataset
        if "data_dir" not in params:
            raise KeyError("a dairv2x yaml needs data_dir, the DAIR-V2X-C "
                           "tree its split jsons index")
        base = DAIRV2XBaseDataset(params["data_dir"], split_json=root,
                                  train=train, native=native)
    elif name == "v2xsim":
        # V2X-Sim: the root is the info pickle, the scans beside it
        from coalign_tpu_torch.data.v2xsim import V2XSIMBaseDataset
        base = V2XSIMBaseDataset(root, train=train, max_cav=max_cav)
    else:
        from coalign_tpu_torch.data.opv2v import (OPV2VBaseDataset,
                                                  V2XSETBaseDataset)
        cls = OPV2VBaseDataset if name == "opv2v" else V2XSETBaseDataset
        base = cls(root, train=train, max_cav=max_cav, native=native)

    noise = params.get("noise_setting", {})
    args = noise.get("args", {}) if noise.get("add_noise") else {}
    kw = dict(
        max_cav=max_cav,
        lidar_range=params["preprocess"]["cav_lidar_range"],
        comm_range=params.get("comm_range", 70.0),
        pos_std=args.get("pos_std", 0.0),
        rot_std=args.get("rot_std", 0.0),
        laplace=bool(args.get("laplace", False)),
        train=train,
        native=native,
    )
    if "camera" in params.get("input_source", ["lidar"]):
        # camera batches (coalign_tpu/data/__init__.py:48-56): the reader's
        # camera parameters and image paths, images at the model's
        # final_dim; no world augmentation
        from coalign_tpu_torch.data.camera_batch import CameraBatcher
        if hasattr(base, "load_camera"):
            base.load_camera = True
        return base, CameraBatcher(
            max_cav=max_cav,
            final_dim=params["model"]["args"]["data_aug_conf"]["final_dim"],
            lidar_range=kw["lidar_range"], comm_range=kw["comm_range"],
            pos_std=kw["pos_std"], rot_std=kw["rot_std"],
            laplace=kw["laplace"])
    if train and params.get("data_augment"):
        from coalign_tpu_torch.data.augment import WorldAugmentor
        kw["augmentor"] = WorldAugmentor(params["data_augment"])
    key = next((k for k in _BATCHERS if k in fusion), "intermediate")
    return base, _BATCHERS[key](**kw)
