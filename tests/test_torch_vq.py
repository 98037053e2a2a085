"""`VectorQuantize` (`sgdm_tpu_torch/models/vq.py`) against the JAX package's,
float32 on the CPU: the same input, the JAX module's initial codebook state
bridged by `models/convert.py vq_from_flax`, and where the module draws
(k-means' initial rows, the expired codes' replacements) JAX's own draws,
read out of its call and handed to the port.

One train call (the EMA update, the straight-through estimator, the
commitment and orthogonal losses), then an eval call on the updated state:
quantize, indices, loss and the codebook state (``embed``, ``embed_avg``,
``cluster_size``, ``initted``) within 1e-6 of the larger of 1 and each
array's largest value; indices equal.  Cases: Euclidean and cosine
codebooks, two heads sharing a codebook and with separate codebooks (with
and without the in / out projections), k-means init, dead-code expiry, the
orthogonal loss (a learned codebook), image feature maps and channels-first
input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import vq as jvq
from sgdm_tpu_torch.models import vq
from sgdm_tpu_torch.models.convert import vq_from_flax

from torch_port_common import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-6
CASES = {
    "euclidean": dict(dim=8, codebook_size=16),
    "cosine": dict(dim=8, codebook_size=16, use_cosine_sim=True),
    "shared_heads": dict(dim=8, codebook_size=16, heads=2, codebook_dim=4),
    "separate_heads": dict(dim=8, codebook_size=16, heads=2, codebook_dim=4,
                           separate_codebook_per_head=True),
    "separate_heads_projected": dict(dim=8, codebook_size=16, heads=2, codebook_dim=6,
                                     separate_codebook_per_head=True),
    "kmeans_init": dict(dim=8, codebook_size=16, kmeans_init=True, kmeans_iters=4),
    "kmeans_init_cosine": dict(dim=8, codebook_size=16, kmeans_init=True, kmeans_iters=4,
                               use_cosine_sim=True),
    "expiry": dict(dim=8, codebook_size=16, threshold_ema_dead_code=2.0),
    "orthogonal": dict(dim=8, codebook_size=16, orthogonal_reg_weight=0.5,
                       commitment_weight=0.25),
    "image_fmap": dict(dim=8, codebook_size=16, accept_image_fmap=True),
    "channels_first": dict(dim=8, codebook_size=16, channel_last=False),
}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max()), what


@pytest.mark.parametrize("case", sorted(CASES))
def test_vector_quantize_matches_jax(case, monkeypatch):
    kw = CASES[case]
    rng = np.random.default_rng(len(case))
    shape = {"image_fmap": (2, 4, 4, 8), "channels_first": (2, 8, 12)}.get(case, (2, 12, 8))
    x = rng.normal(size=shape).astype(np.float32)

    draws = []   # JAX's _sample_vectors draws, in call order

    def recorded(key, samples, num):
        idx = jax.random.randint(key, (samples.shape[0], num), 0, samples.shape[1])
        jax.debug.callback(lambda i: draws.append(np.asarray(i)), idx)
        return jnp.take_along_axis(samples, idx[..., None], axis=1)

    monkeypatch.setattr(jvq, "_sample_vectors", recorded)
    jm = jvq.VectorQuantize(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = vq.VectorQuantize(**kw)
    tm.load_state_dict(vq_from_flax(variables.get("params"), variables["vq"], tm))

    (jq, jind, jloss), mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["vq"],
                                      rngs={"vq": jax.random.PRNGKey(1)})
    port_draws = {}
    if kw.get("kmeans_init"):
        port_draws["kmeans"] = draws.pop(0)
    if kw.get("threshold_ema_dead_code"):
        port_draws["expire"] = draws.pop(0)
    assert not draws
    xt = torch.from_numpy(x).requires_grad_(True)
    q, ind, loss = tm(xt, train=True, draws=port_draws)
    _close(q.detach(), jq, "quantize")
    assert np.array_equal(ind.numpy(), np.asarray(jind))
    _close(loss.detach(), jloss, "loss")
    state = {k: np.asarray(v) for k, v in mut["vq"].items()}
    for k, v in state.items():
        _close(getattr(tm, k).detach(), v, k)
    if kw.get("orthogonal_reg_weight"):
        _close(tm.embed.detach(), variables["params"]["embed"], "learned codebook")
    loss.backward()          # the straight-through estimator passes the gradient to x
    assert xt.grad is not None and torch.isfinite(xt.grad).all()

    # an eval call on the updated state
    params = variables.get("params")
    # (mutable: a k-means-init module writes its collection on every call)
    (jq2, jind2, _), _ = jm.apply(dict(variables, vq=mut["vq"]), jnp.asarray(x), train=False,
                                  mutable=["vq"])
    with torch.no_grad():
        q2, ind2, loss2 = tm(torch.from_numpy(x))
    _close(q2, jq2, "eval quantize")
    assert np.array_equal(ind2.numpy(), np.asarray(jind2)) and float(loss2) == 0.0
    assert params is None or set(params) <= {"project_in", "project_out", "embed"}


def test_kmeans_and_orthogonal_loss_match_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(2, 30, 5)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 6))
    for cosine in (False, True):
        ss = s / np.linalg.norm(s, axis=-1, keepdims=True) if cosine else s

        def fixed(key, samples, num):
            return jnp.take_along_axis(samples, jnp.asarray(idx)[..., None], axis=1)

        orig = jvq._sample_vectors
        jvq._sample_vectors = fixed
        try:
            jm, jb = jvq.kmeans(jax.random.PRNGKey(0), jnp.asarray(ss), 6, 5, cosine)
        finally:
            jvq._sample_vectors = orig
        tm, tb = vq.kmeans(torch.from_numpy(ss), 6, 5, cosine, idx=torch.from_numpy(idx))
        _close(tm, jm, "means")
        _close(tb, jb, "bins")
    _close(vq.orthogonal_loss_fn(torch.from_numpy(s)), jvq.orthogonal_loss_fn(jnp.asarray(s)),
           "orthogonal")


def test_draws_default_to_a_seeded_generator():
    x = torch.randn(2, 12, 8, generator=torch.Generator().manual_seed(0))
    a, b = vq.VectorQuantize(8, 16, kmeans_init=True), vq.VectorQuantize(8, 16, kmeans_init=True)
    qa, _, _ = a(x, train=True)
    qb, _, _ = b(x, train=True)
    assert torch.equal(qa, qb) and bool(a.initted)        # the crc32-seeded fallback
    c = vq.VectorQuantize(8, 16, kmeans_init=True)
    qc, _, _ = c(x, train=True, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(c.embed, a.embed)
