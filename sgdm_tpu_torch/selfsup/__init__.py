"""The self-labeling path of the port: features, clusters, LOST boxes.

The port's copy of `sgdm_tpu/selfsup` for the modules the self-labeled
runs need (`feat_extractor`, `ssl_backbone`, `cluster`, `cluster_patch`,
`lost`); STEGO, the PCA clusterer, MAE / MSN pre-training and the probes
are not ported yet (`config/engine.py _NOT_PORTED` names their items).
"""

from .cluster import cal_cluster_metric, clustering
from .cluster_patch import clustering_withpatches
from .feat_extractor import extract_feat
from .lost import lost, run_lost, write_lost_h5
from .ssl_backbone import SSLBackbone, get_ssl_backbone

__all__ = [
    "cal_cluster_metric", "clustering", "clustering_withpatches", "extract_feat",
    "lost", "run_lost", "write_lost_h5", "SSLBackbone", "get_ssl_backbone",
]
