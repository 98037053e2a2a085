"""kNN evaluation and t-SNE (`eval/knn_eval.py`, `eval/tsne.py`) against the
JAX package and sklearn, on the CPU.

  * kNN: both packages embed the same PNG dirs with the same SimCLR
    ResNet-50 weights (a written checkpoint, 32-px input), search the 5
    nearest real images of each sample: distances within 1e-5 relative of
    JAX's (the squared ones, |q|² + |g|² − 2q·g of features that differ in
    their last bits, read up to 1.5e-5), the same neighbour ids, the same
    metrics (1e-5) and the same ``knn_grid.png`` pixels.
  * t-SNE's joint probabilities P within 1e-6 of sklearn's
    ``_joint_probabilities_nn`` (on sklearn's own neighbour graph).
  * The embedding (exact gradient) against sklearn's Barnes-Hut TSNE with
    ``init="pca"`` on the same points: its KL on the same P at most 5 %
    above sklearn's, plus 0.02; its trustworthiness (k = 5) at most 0.01
    below.  sklearn is used in this test only.
  * Cluster ids parsed from ``…cluster{id}.png`` file names as the JAX
    package parses them; a file without the tag gives none.
"""

import numpy as np
import pytest

from sgdm_tpu.eval import knn_eval as jknn
from sgdm_tpu.eval import tsne as jtsne
from sgdm_tpu.ops.knn import knn_search as jknn_search
from sgdm_tpu_torch.eval import knn_eval, tsne
from sgdm_tpu_torch.ops.knn import knn_search
from sgdm_tpu_torch.utils.png import read_png, write_png

from test_torch_backbones import _write_named

from torch_port_common import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")


def _write_dir(d, n, seed, names=None):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        base = rng.integers(0, 256, (4, 4, 3))
        img = np.kron(base, np.ones((4, 4, 1))).astype(np.uint8)     # smooth 16-px images
        write_png(d / (names[i] if names else f"img{i}.png"), img)
    return d


def test_knn_matches_jax_with_the_same_backbone(tmp_path, monkeypatch):
    import sgdm_tpu.selfsup.ssl_backbone as jax_sb
    import sgdm_tpu_torch.selfsup.ssl_backbone as sb

    _write_named(tmp_path, "simclr_rn50")
    monkeypatch.setenv("SGDM_SSL_CKPT_DIR", str(tmp_path))
    ours = sb.get_ssl_backbone("simclr_rn50", image_size=32, device="cpu")
    ref = jax_sb.get_ssl_backbone("simclr_rn50", image_size=32)
    samples = _write_dir(tmp_path / "samples", 12, 0)
    real = _write_dir(tmp_path / "real", 20, 1)

    qf, qi = knn_eval.embed_image_dir(samples, ours, batch_size=8)
    gf, gi = knn_eval.embed_image_dir(real, ours, batch_size=8)
    jqf, jqi = jknn.embed_image_dir(samples, ref, batch_size=8)
    jgf, _ = jknn.embed_image_dir(real, ref, batch_size=8)
    assert np.array_equal(qi, jqi) and qf.shape == (12, 2048)
    d2, idx = knn_search(gf, qf, k=5, device="cpu")
    jd2, jidx = jknn_search(jgf, jqf, k=5)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(np.sqrt(d2), np.sqrt(np.asarray(jd2)), rtol=1e-5)

    got = knn_eval.get_knn_eval_dict(samples, real, backbone=ours, batch_size=8,
                                     papervis_dir=tmp_path / "port", device="cpu")
    want = jknn.get_knn_eval_dict(samples, real, backbone=ref, batch_size=8,
                                  papervis_dir=tmp_path / "jax")
    assert got == pytest.approx(want, rel=1e-5)
    assert np.array_equal(read_png(tmp_path / "port" / "knn_grid.png"),
                          read_png(tmp_path / "jax" / "knn_grid.png"))


def _mixture(n_per=100, dims=24, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(3, dims))
    return np.concatenate([c + rng.normal(size=(n_per, dims)) for c in centres]).astype(np.float32)


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_joint_probabilities_match_sklearn(perplexity):
    from sklearn.manifold._t_sne import _joint_probabilities_nn
    from sklearn.neighbors import NearestNeighbors

    x = _mixture()
    k = min(len(x) - 1, int(3.0 * perplexity + 1))
    graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(mode="distance")
    graph.data **= 2
    want = _joint_probabilities_nn(graph, perplexity, 0).toarray()
    got = tsne.joint_probabilities_nn(x, perplexity, device="cpu")
    assert got.shape == want.shape and got.sum() == pytest.approx(1.0, abs=1e-12)
    assert np.abs(got - want).max() <= 1e-6
    assert np.allclose(got, got.T)


def test_embedding_is_no_worse_than_sklearn_barnes_hut():
    from sklearn.manifold import TSNE, trustworthiness

    x = _mixture(seed=1)
    p = tsne.joint_probabilities_nn(x, 30.0, device="cpu")
    y, kl = tsne.tsne_embed(x, 30.0, device="cpu", p=p)
    ys = TSNE(n_components=2, perplexity=30.0, init="pca", random_state=0).fit_transform(x)
    kl_sk = tsne.kl_divergence(p, ys)
    assert kl == pytest.approx(tsne.kl_divergence(p, y), rel=1e-4)
    assert kl <= 1.05 * kl_sk + 0.02, (kl, kl_sk)
    assert trustworthiness(x, y, n_neighbors=5) >= trustworthiness(x, ys, n_neighbors=5) - 0.01
    img = tsne.scatter_image(y, np.arange(len(y)) % 2, cluster_ids=np.arange(len(y)) // 100)
    assert img.shape == (600, 600, 3) and (img != 255).any(-1).sum() > 1000


@pytest.mark.parametrize("names,want", [
    (["a_cluster3.png", "b_cluster12.png", "c_cluster0.jpg"], [3, 12, 0]),
    (["a_cluster3.png", "b.png"], None),
    (["img_cluster7.PNG", "x_cluster10.png"], [7, 10]),
])
def test_cluster_ids_parse_as_jax(tmp_path, names, want):
    d = _write_dir(tmp_path / "d", len(names), 2, names)
    (d / "notes.txt").write_text("not an image")
    got, ref = tsne._dir_cluster_ids(d, None), jtsne._dir_cluster_ids(d, None)
    if want is None:
        assert got is None and ref is None
    else:
        order = [int(n.split("cluster")[1].split(".")[0]) for n in sorted(names)]
        assert got.tolist() == ref.tolist() == order and sorted(order) == sorted(want)
        assert tsne._dir_cluster_ids(d, 1).tolist() == jtsne._dir_cluster_ids(d, 1).tolist()
