"""The self-annotation path of the port: features, clusters, LOST boxes, STEGO masks.

The port's copy of `sgdm_tpu/selfsup` for the modules the self-labeled
runs need (`feat_extractor`, `ssl_backbone`, `cluster`, `cluster_patch`,
`cluster_pca`, `lost`, `stego`, `stego_train`); MAE / MSN pre-training and
the probes are not ported yet (`config/engine.py _NOT_PORTED` names their
items).
"""

from .cluster import cal_cluster_metric, clustering
from .cluster_patch import clustering_withpatches
from .cluster_pca import clustering_ensemble, clustering_pca, run_pca_views
from .feat_extractor import extract_feat
from .lost import lost, run_lost, write_lost_h5
from .ssl_backbone import SSLBackbone, get_ssl_backbone
from .stego import StegoInference
from .stego_train import train_stego

__all__ = [
    "cal_cluster_metric", "clustering", "clustering_withpatches", "clustering_ensemble",
    "clustering_pca", "run_pca_views", "extract_feat", "lost", "run_lost", "write_lost_h5",
    "SSLBackbone", "get_ssl_backbone", "StegoInference", "train_stego",
]
