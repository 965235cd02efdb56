"""Data modules: wire datasets + loaders from the data yaml (port of
`pl_yolo_tpu/data/datamodule.py`).

Capability parity with reference PL_DataModules/coco.py:10-116 and
voc.py:10-95 ('coco'/'voc' registry, utils/build_data.py:5-12): a DataModule
owns train/val/test datasets, loaders, and the device-augmentation config.
The datasets and loaders are numpy / PIL code; only `make_augment_fn`'s
augmentation runs in torch, on the device of the images it is handed.
"""

from __future__ import annotations

from pathlib import Path

from .augment import AugmentConfig, make_augment_fn
from .datasets import COCODataset, VOCDataset
from .loader import TrainLoader, eval_batches


class DataModule:
    def __init__(self, data_cfg: dict, seed: int = 96, cache: bool = False):
        self.cfg = data_cfg
        d = data_cfg["dataset"]
        self.train_size = tuple(d["train_size"])
        self.val_size = tuple(d["val_size"])
        self.train_batch_size = int(d["train_batch_size"])
        self.val_batch_size = int(d["val_batch_size"])
        self.num_classes = int(data_cfg["num_classes"])
        self.class_names = list(data_cfg["classes"])
        self.seed = seed
        self.cache = cache
        # input-path scaling knobs (reference coco.py:85-86 runs 6 workers;
        # disk_cache replaces its full-RAM ThreadPool cache for datasets
        # that don't fit RAM — see data/disk_cache.py)
        self.num_workers = int(d.get("num_workers", 0))
        self.disk_cache = d.get("disk_cache")
        self.augment_cfg = AugmentConfig.from_dict(
            data_cfg.get("transform", {}), max_labels=100)
        self.dataset_train = None
        self.dataset_val = None
        self.dataset_test = None

    # subclasses create datasets
    def setup(self, stage: str = "fit"):
        raise NotImplementedError

    def train_loader(self, shard_id: int = 0, num_shards: int = 1) -> TrainLoader:
        from .aug_extra import make_host_augment
        host_aug = make_host_augment(
            self.cfg.get("transform", {}), self.dataset_train,
            self.num_classes, seed=self.seed)
        return TrainLoader(self.dataset_train, self.train_batch_size,
                           shard_id=shard_id, num_shards=num_shards,
                           seed=self.seed, host_augment=host_aug,
                           num_workers=self.num_workers)

    def val_batches(self, shard_id: int = 0, num_shards: int = 1):
        return eval_batches(self.dataset_val, self.val_batch_size,
                            shard_id, num_shards)

    def test_batches(self, shard_id: int = 0, num_shards: int = 1):
        return eval_batches(self.dataset_test or self.dataset_val,
                            self.val_batch_size, shard_id, num_shards)

    def make_augment_fn(self, out_s2d: bool = False):
        """The train step's `augment_fn(generator, images, labels,
        enable=True)` over this data config's transform."""
        return make_augment_fn(self.augment_cfg, out_s2d=out_s2d)


class COCODataModule(DataModule):
    def setup(self, stage: str = "fit"):
        d = self.cfg["dataset"]
        root = d["dir"]
        if stage in ("fit", "all"):
            self.dataset_train = COCODataset(
                root, d["train_json"], d["train"], img_size=self.train_size,
                max_labels=50, cache=self.cache)
            if self.disk_cache:
                self.dataset_train.attach_disk_cache(
                    str(Path(self.disk_cache) / "train"))
            self.dataset_train.preload_cache()
        if stage in ("fit", "val", "all"):
            self.dataset_val = COCODataset(
                root, d["val_json"], d["val"], img_size=self.val_size,
                max_labels=100)
        if stage in ("test", "all"):
            self.dataset_test = COCODataset(
                root, d.get("test_json", d["val_json"]),
                d.get("test", d["val"]), img_size=self.val_size,
                max_labels=100)


class VOCDataModule(DataModule):
    def setup(self, stage: str = "fit"):
        d = self.cfg["dataset"]
        root = d["dir"]
        img_dir = d.get("images", "JPEGImages")
        ann_dir = d.get("annotations", "Annotations")
        kw = dict(img_dir=img_dir, ann_dir=ann_dir,
                  class_names=self.class_names)
        if stage in ("fit", "all"):
            self.dataset_train = VOCDataset(
                root, d["train"], img_size=self.train_size, max_labels=50,
                cache=self.cache, **kw)
            if self.disk_cache:
                self.dataset_train.attach_disk_cache(
                    str(Path(self.disk_cache) / "train"))
            self.dataset_train.preload_cache()
        if stage in ("fit", "val", "all"):
            self.dataset_val = VOCDataset(
                root, d["val"], img_size=self.val_size, max_labels=100, **kw)
        if stage in ("test", "all"):
            self.dataset_test = VOCDataset(
                root, d.get("test", d["val"]), img_size=self.val_size,
                max_labels=100, **kw)


DATAMODULES = {"coco": COCODataModule, "voc": VOCDataModule}


def build_data(data_cfg: dict, seed: int = 96, cache: bool = False) -> DataModule:
    """Registry lookup (reference utils/build_data.py:5-12)."""
    name = data_cfg["datamodule"]
    if name not in DATAMODULES:
        raise KeyError(f"Unknown datamodule '{name}'. Available: "
                       f"{sorted(DATAMODULES)}")
    return DATAMODULES[name](data_cfg, seed=seed, cache=cache)
