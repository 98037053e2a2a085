from .cifar10 import CIFAR10, CIFAR100
from .datamodule import DataModuleFromConfig
from .ffhq import FFHQ
from .h5cond import ConditionLookup, LostLookup, ds_has_label_info, skip_id2name
from .imagenet_pickle import ImageNetPickle
from .loader import DataLoader, prefetch_to_device
from .synthetic import SyntheticImages, SyntheticSegImages, collate

__all__ = [
    "CIFAR10", "CIFAR100", "DataModuleFromConfig", "FFHQ", "ConditionLookup", "LostLookup",
    "ds_has_label_info", "skip_id2name", "ImageNetPickle", "DataLoader", "prefetch_to_device",
    "SyntheticImages", "SyntheticSegImages", "collate",
]
