"""The port's host data feed: datasets, batchers, augmentation, prefetch.

``build_dataset`` is the port of coalign_tpu/data/__init__.py:7-68."""

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
    fixed-shape host batches. The fusion method picks the batcher:
    intermediate unless it names early or late. ``native`` picks the C++
    data plane for both (the default) or their numpy paths (reader and
    batcher ``native=False``)."""
    fusion = params["fusion"]["core_method"].lower()
    name = params["fusion"].get("dataset",
                                params.get("dataset", "opv2v")).lower()
    if name in ("dairv2x", "v2xsim"):
        raise NotImplementedError(
            f"the {name} reader is not ported yet (ROADMAP item 4)")
    if name not in ("opv2v", "v2xset"):
        raise KeyError(f"unknown dataset {name!r}")
    if "camera" in params.get("input_source", ["lidar"]):
        raise NotImplementedError(
            "camera batches come with the LSS camera family (ROADMAP item 7)")

    from coalign_tpu_torch.data.opv2v import (OPV2VBaseDataset,
                                              V2XSETBaseDataset)
    max_cav = params["train_params"].get("max_cav", 5)
    root = params["root_dir"] if train else (
        params.get("validate_dir") or params["root_dir"])
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
    if train and params.get("data_augment"):
        from coalign_tpu_torch.data.augment import WorldAugmentor
        kw["augmentor"] = WorldAugmentor(params["data_augment"])
    key = next((k for k in _BATCHERS if k in fusion), "intermediate")
    return base, _BATCHERS[key](**kw)
