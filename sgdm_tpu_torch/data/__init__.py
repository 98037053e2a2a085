from .cifar10 import CIFAR10, CIFAR100
from .cityscapes import CityscapesDataset
from .coco14 import Coco14Dataset
from .cocostuff import CocoStuffDataset
from .complex_base import ComplexSegDataset
from .datamodule import DataModuleFromConfig
from .ffhq import FFHQ
from .h5cond import ConditionLookup, LostLookup, ds_has_label_info, skip_id2name
from .imagenet_folder import ImageNetFolder
from .imagenet_pickle import ImageNetPickle
from .loader import DataLoader, prefetch_to_device
from .synthetic import SyntheticImages, SyntheticSegImages, collate
from .transforms import RandomScaleCrop
from .voc12 import VOCSegmentation

__all__ = [
    "CIFAR10", "CIFAR100", "CityscapesDataset", "Coco14Dataset", "CocoStuffDataset", "ComplexSegDataset", "DataModuleFromConfig",
    "FFHQ", "ConditionLookup", "LostLookup", "ds_has_label_info", "skip_id2name",
    "ImageNetFolder", "ImageNetPickle", "DataLoader", "prefetch_to_device", "RandomScaleCrop",
    "SyntheticImages", "SyntheticSegImages", "VOCSegmentation", "collate",
]
