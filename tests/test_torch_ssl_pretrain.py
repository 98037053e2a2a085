"""The SSL pre-trainers of the port (`sgdm_tpu_torch/selfsup/`: `mae`,
`mae_train`, `msn`, `msn_train`, `pretrain_common`, `eval_probes`, the
``.msgpack`` encoders of `ssl_backbone`) and the ViT's training options
against the JAX package on the CPU, float32, at a tiny size (patch 8,
width 32, depth 2, 16-32 px).  Inputs and weights come from numpy seeds;
where JAX draws (masking noise, patch-keep ids, drop-path masks) its draw
is handed to the port, which then computes the same values.

Tolerances (each test's docstring repeats its own):
  * ATOL 2e-5 on outputs and losses of order one (float32 sums in another
    order: oneDNN's against XLA's);
  * gradients within GRAD_TOL 1e-4 of the largest element of the leaf;
  * parameters after one Adam update within STEP_TOL 1e-6 absolute: an
    update is ±lr·(m̂ / √v̂) with lr ≤ 1e-3, so f32 rounding of its terms
    moves it by ≈ 1e-10, and an element whose gradient is at float32's
    noise floor (Adam normalises it to ±lr) is counted apart, at most
    EXEMPT of a leaf;
  * schedules exact to float32 (rtol 1e-6: XLA's cos against numpy's);
  * the host datasets and the ``.msgpack`` bytes exactly equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sgdm_tpu.models import vit as jax_vit
from sgdm_tpu.selfsup import eval_probes as jax_probes
from sgdm_tpu.selfsup import mae as jax_mae
from sgdm_tpu.selfsup import mae_train as jax_mae_train
from sgdm_tpu.selfsup import msn as jax_msn
from sgdm_tpu.selfsup import msn_train as jax_msn_train
from sgdm_tpu.selfsup import pretrain_common as jax_pc
from sgdm_tpu_torch.models.convert import vit_from_flax, vit_to_flax
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import eval_probes, mae, mae_train, msn, msn_train, pretrain_common as pc
from sgdm_tpu_torch.selfsup import ssl_backbone as sb
from torch_port_common import perturbed_flat, unflatten

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
TINY_MAE = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, decoder_dim=16,
                decoder_depth=1, decoder_heads=2, mask_ratio=0.75, pretrain_img_size=32)
ATOL = 2e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-6
EXEMPT = 0.02


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _images(seed: int, b: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _jax_params(module, x, seed: int, **kw):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x), **kw)["params"]
    return perturbed_flat(shapes, seed)


def _flat(tree) -> dict:
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _no_key_bias(flat: dict) -> dict:
    """The tree without the key third of every ``qkv`` bias.  A key bias adds
    the same q·b to every logit of a row, which the softmax cancels: its
    gradient is 0 up to rounding, and Adam's first step turns that
    rounding noise into ±lr, so the two packages' updates there are noise."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("qkv/bias"):
            d = v.shape[0] // 3
            v = np.concatenate([v[:d], v[2 * d:]])
        out[k] = v
    return out


def _close_trees(got: dict, want: dict, atol: float, rel: bool = False, exempt: float = 0.0):
    """Every leaf of the flattened flax trees within ``atol`` (of the leaf's
    largest element when ``rel``); at most ``exempt`` of a leaf beyond it."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        tol = atol * max(float(np.abs(w).max()), 1e-30) if rel else atol
        bad = np.abs(g - w) > tol
        assert bad.mean() <= exempt and (exempt or not bad.any()), (
            k, float(np.abs(g - w).max()), tol, float(bad.mean()))


@pytest.fixture(scope="module")
def tiny_vit():
    jm = jax_vit.VisionTransformer(**TINY, drop_path_rate=0.3)
    flat = _jax_params(jm, _images(0, 1, 32), 3)
    tm = VisionTransformer(**TINY, drop_path_rate=0.3)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    return jm, flat, tm


def _record_bernoulli(monkeypatch):
    draws = []
    orig = jax.random.bernoulli

    def rec(key, p, shape=None):
        out = orig(key, p, shape)
        draws.append(out.reshape(-1))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", rec)
    return draws


def _jax_drop_masks(draws, depth: int, b: int) -> torch.Tensor:
    """JAX's draws in their order (blocks 1.. depth-1, attention then MLP; block
    0 has rate 0 and draws nothing) as the port's [depth, 2, B]."""
    masks = np.ones((depth, 2, b), np.float32)
    masks[1:] = np.stack([np.asarray(d) for d in draws]).reshape(depth - 1, 2, b)
    return torch.from_numpy(masks)


def test_vit_training_options_match_jax(tiny_vit, monkeypatch):
    """`VisionTransformer(patch_keep_ids=, drop_masks=)` against the JAX ViT
    with its ids and its drop-path draws (``deterministic=False``): CLS
    outputs within ATOL 2e-5 and the gradients of a random projection of
    them (every parameter and the input) within GRAD_TOL 1e-4 of each
    leaf's largest element, off the pretrain grid (48 px: ``pos_embed``
    resampled inside the loss).  Each option alone is held against JAX in
    tests/test_torch_vit.py."""
    jm, flat, tm = tiny_vit
    b, size = 3, 48
    x = _images(1, b, size)
    n = (size // 8) ** 2
    rng = np.random.default_rng(2)
    ids = np.stack([rng.permutation(n)[:5] for _ in range(b)]).astype(np.int32)
    keep = jnp.asarray(ids)
    cot = rng.standard_normal((b, 32)).astype(np.float32)
    draws = _record_bernoulli(monkeypatch)

    def jloss(p, xx):
        draws.clear()
        out = jm.apply({"params": p}, xx, out="cls", patch_keep_ids=keep,
                       deterministic=False, rngs={"drop_path": jax.random.PRNGKey(7)})
        return jnp.sum(out * cot), (out, list(draws))

    (_, (jout, jdraws)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(unflatten(flat), jnp.asarray(x))
    assert len(jdraws) == 2 * (TINY["depth"] - 1)
    masks = _jax_drop_masks(jdraws, TINY["depth"], b)
    xt = _nchw(x).requires_grad_(True)
    tm.zero_grad()
    out = tm(xt, out="cls", patch_keep_ids=torch.from_numpy(ids).long(), drop_masks=masks)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL)
    got = vit_to_flax({k: p.grad for k, p in tm.named_parameters()})
    _close_trees(got, _flat(jgp), GRAD_TOL, rel=True)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx),
                               atol=GRAD_TOL * float(np.abs(jgx).max()))
    assert masks[1:].min() == 0                          # the draw drops a branch
    with torch.no_grad():
        assert not torch.allclose(tm(_nchw(x), out="cls", patch_keep_ids=torch.from_numpy(ids).long()),
                                  out.detach())


def test_vit_drop_masks_drawn_by_their_law():
    """`draw_drop_masks` from a torch.Generator: block 0 never drops, block i
    keeps with probability 1 − rate·i/(depth − 1) (within 4 standard errors
    over 20,000 samples); the deterministic network equals JAX's rule of
    no draws (drop_masks=None is the network without drop-path)."""
    tm = VisionTransformer(patch_size=8, embed_dim=32, depth=4, num_heads=2, pretrain_img_size=32,
                           drop_path_rate=0.3)
    m = tm.draw_drop_masks(20000, torch.Generator().manual_seed(0))
    assert m.shape == (4, 2, 20000) and set(m.unique().tolist()) <= {0.0, 1.0}
    for i in range(4):
        keep = 1 - 0.3 * i / 3
        se = max((keep * (1 - keep) / 20000) ** 0.5, 1e-12)
        assert abs(float(m[i].mean()) - keep) <= 4 * se + (1e-12 if i else 0), i


@pytest.fixture(scope="module")
def tiny_mae():
    jm = jax_mae.MAE(**TINY_MAE)
    x = _images(0, 1, 32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jax.random.PRNGKey(1))["params"]
    flat = perturbed_flat(shapes, 5)
    tm = mae.MAE(**TINY_MAE)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    return jm, flat, tm


def test_mae_forward_loss_and_grads_match_jax(tiny_mae):
    """`MAE` fed JAX's masking noise: pred, the normalised target and the mask
    within ATOL 2e-5 (the mask exactly), `mae_loss` within ATOL, and the
    gradient of the loss for every parameter (the scattered mask token, the
    decoder position embedding and, at 48 px off the 32-px grid, both
    position embeddings resampled by the cubic inside the loss) within
    GRAD_TOL 1e-4 of each leaf's largest."""
    jm, flat, tm = tiny_mae
    size = 48
    x = _images(4, 2, size)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, (2, (size // 8) ** 2)))   # MAE's own draw

    def jloss(p):
        pred, target, m = jm.apply({"params": p}, jnp.asarray(x), key)
        return jax_mae.mae_loss(pred, target, m), (pred, target, m)

    (jl, (jp, jt, jmask)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(unflatten(flat))
    tm.zero_grad()
    pred, target, m = tm(_nchw(x), noise=torch.from_numpy(noise))
    loss = mae.mae_loss(pred, target, m)
    loss.backward()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    for g, w in ((pred, jp), (target, jt)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)
    assert abs(float(loss.detach()) - float(jl)) <= ATOL
    got = vit_to_flax({k: p.grad for k, p in tm.named_parameters()})
    _close_trees(got, _flat(jg), GRAD_TOL, rel=True)


def test_mae_masking_drawn_by_its_law():
    """The port's own noise (torch.Generator): exactly n_keep visible patches a
    row, each patch hidden with probability 0.75 (4 standard errors over
    4,000 rows), and the same generator seed gives the same mask."""
    tm = mae.MAE(**TINY_MAE)
    x = torch.zeros(4000, 3, 32, 32)
    with torch.no_grad():
        _, _, m = tm(x, generator=torch.Generator().manual_seed(1))
        _, _, m2 = tm(x[:8], generator=torch.Generator().manual_seed(1))
    assert (m.sum(1) == 16 - tm.n_keep(16)).all()
    se = (0.75 * 0.25 / 4000) ** 0.5
    assert (m.mean(0) - 0.75).abs().max() <= 4 * se
    assert torch.equal(m[:8], m2)


def _mae_port_tx(lr_fn):
    return pc.chain(pc.scale_by_adam(0.9, 0.95), pc.add_decayed_weights(0.05, mask=pc.wd_mask),
                    pc.scale_by_schedule(lambda s: -lr_fn(s)))


def test_mae_train_steps_match_jax(tiny_mae):
    """Two steps of `make_mae_train_step` under the MAE trainer's update
    (``scale_by_adam(0.9, 0.95) → add_decayed_weights(0.05, mask) → −lr``,
    `mae_lr_schedule`) against the JAX trainer's jitted step from the same
    params, fed the same masking noise: losses within ATOL 2e-5, every
    parameter after each step within STEP_TOL 1e-6 (at most EXEMPT 2 % of a
    leaf beyond it: gradients at float32's noise floor, which Adam
    normalises to ±lr; the key bias, whose gradient is 0, is left out:
    `_no_key_bias`)."""
    jm, flat, _ = tiny_mae
    tm = mae.MAE(**TINY_MAE)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    lr_args = (1e-3, 1e-5, 0.0, 1, 4)
    jlr = jax_mae_train.mae_lr_schedule(*lr_args)
    jtx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.95),
                      optax.add_decayed_weights(0.05, mask=jax_pc.wd_mask),
                      optax.scale_by_schedule(lambda s: -jlr(s)))
    jstep = jax_mae_train.make_mae_full_train_step(jm, jtx)
    step = mae.make_mae_train_step(tm, _mae_port_tx(mae_train.mae_lr_schedule(*lr_args)))
    params = unflatten(flat)
    opt = jtx.init(params)
    for it in range(2):
        x = _images(10 + it, 3, 32)
        key = jax.random.PRNGKey(20 + it)
        params, opt, jl = jstep(params, opt, jnp.asarray(x), key)
        noise = np.array(jax.random.uniform(key, (3, 16)))
        loss = step(_nchw(x), noise=torch.from_numpy(noise))
        assert abs(float(loss) - float(jl)) <= ATOL, it
        _close_trees(_no_key_bias(vit_to_flax(tm.state_dict())), _no_key_bias(_flat(params)),
                     STEP_TOL, exempt=EXEMPT)


def test_msn_loss_and_masking_match_jax():
    """`sharpen`, `msn_loss` (value and the gradients for the anchors and the
    prototypes) and `mask_patches` with JAX's noise against `sgdm_tpu.selfsup.
    msn`: within ATOL 2e-5 (gradients GRAD_TOL 1e-4 of their largest), the
    masked image exactly."""
    rng = np.random.default_rng(3)
    a, t, pr = (rng.standard_normal(s).astype(np.float32) for s in ((6, 8), (6, 8), (5, 8)))
    p = np.abs(rng.standard_normal((4, 5))).astype(np.float32)
    np.testing.assert_allclose(msn.sharpen(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_msn.sharpen(jnp.asarray(p))), rtol=1e-6)

    def jl(a_, pr_):
        return jax_msn.msn_loss(a_, jnp.asarray(t), pr_)

    (jloss, jaux), (jga, jgp) = jax.jit(jax.value_and_grad(jl, argnums=(0, 1), has_aux=True))(
        jnp.asarray(a), jnp.asarray(pr))
    at, prt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(pr).requires_grad_()
    loss, aux = msn.msn_loss(at, torch.from_numpy(t), prt)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    assert abs(float(aux["me_max"]) - float(jaux["me_max"])) <= ATOL
    for g, w in ((at.grad, jga), (prt.grad, jgp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL * float(np.abs(w).max()))
    x = _images(5, 2, 32)
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.uniform(key, (2, 16)))
    got = msn.mask_patches(_nchw(x), 8, 0.7, noise=torch.from_numpy(noise))
    want = np.asarray(jax.jit(jax_msn.mask_patches, static_argnums=(2, 3))(
        key, jnp.asarray(x), 8, 0.7))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert int((got.abs().sum((1, 2, 3)) > 0).sum()) == 2


def test_compact_msn_step_composes_its_pieces():
    """`msn.make_msn_train_step` is `mask_patches` → the anchor encoder →
    `msn_loss` against the unmasked EMA target, ``tx``'s update, then the
    target at 0.996·t + 0.004·p (its pieces are held against JAX above and,
    with the EMA, by the full MSN step below): the returned loss equals
    `msn_loss` on the same masked input before the update, exactly; every
    parameter and the prototypes move; the target equals the EMA of the
    updated encoder within 1e-7."""
    _, flat, _ = _tiny_state(12)
    enc, tgt = VisionTransformer(**TINY), VisionTransformer(**TINY)
    enc.load_state_dict(vit_from_flax(flat, enc))
    tgt.load_state_dict(vit_from_flax(flat, tgt))
    tgt.requires_grad_(False)
    protos = torch.from_numpy(np.random.default_rng(13).standard_normal((16, 32)) * 0.025).float()
    tp = protos.clone().requires_grad_(True)
    x = _nchw(_images(14, 3, 32))
    noise = torch.rand(3, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = msn.msn_loss(enc(msn.mask_patches(x, 8, 0.7, noise), out="cls"),
                               tgt(x, out="cls"), tp)
    before = [p.detach().clone() for p in enc.parameters()]
    target0 = [p.detach().clone() for p in tgt.parameters()]
    step = msn.make_msn_train_step(enc, tp, tgt, pc.chain(
        pc.scale_by_adam(), pc.scale_by_schedule(lambda s: -1e-3)), 8)
    loss, _ = step(x, noise=noise)
    assert float(loss) == float(want)
    assert all(not torch.equal(p, q) for p, q in zip(enc.parameters(), before))
    assert not torch.equal(tp.detach(), protos)
    for t, t0, p in zip(tgt.parameters(), target0, enc.parameters()):
        torch.testing.assert_close(t, 0.996 * t0 + (1 - 0.996) * p.detach(), atol=1e-7, rtol=0)


def _msn_batch(seed: int, b: int):
    rng = np.random.default_rng(seed)
    return {"target": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            "anchors": rng.standard_normal((b, 1, 32, 32, 3)).astype(np.float32),
            "focals": rng.standard_normal((b, 2, 16, 16, 3)).astype(np.float32)}


def _msn_to_port(batch):
    return {"target": _nchw(batch["target"]),
            "anchors": torch.from_numpy(batch["anchors"]).permute(0, 1, 4, 2, 3),
            "focals": torch.from_numpy(batch["focals"]).permute(0, 1, 4, 2, 3)}


def test_msn_full_train_steps_match_jax(tiny_vit):
    """Two steps of `make_msn_full_train_step` (1 anchor view at 32 px, 2 focal
    views at 16 px, patch drop 0.15, 16 prototypes, the trainer's update
    ``clip_by_global_norm(3) → scale_by_adam → scheduled_weight_decay (1-D
    params and the prototypes excluded) → −lr``, the EMA target at m) against
    the JAX trainer's jitted step from the same params, prototypes and
    target, fed JAX's keep ids: losses within ATOL 2e-5; encoder,
    prototypes and the EMA target after each step within STEP_TOL 1e-6 (at
    most EXEMPT 2 % of a leaf beyond it; the key bias left out, as in the
    MAE test)."""
    jm = jax_vit.VisionTransformer(**TINY)
    flat = _jax_params(jm, _images(0, 1, 32), 8)
    protos = (np.random.default_rng(9).standard_normal((16, 32)) * 0.025).astype(np.float32)
    kw = dict(rand_size=32, focal_size=16, rand_views=1, focal_views=2, patch_drop=0.15)
    total = 8
    jlr = jax_pc.warmup_cosine_lr(2e-4, 1e-3, 1e-6, 1, total)
    jtx = optax.chain(optax.clip_by_global_norm(3.0), optax.scale_by_adam(),
                      jax_pc.scheduled_weight_decay(0.04, 0.4, total,
                                                    mask=lambda tr: (jax_pc.wd_mask(tr[0]), False)),
                      optax.scale_by_schedule(lambda s: -jlr(s)))
    jstep = jax_msn_train.make_msn_full_train_step(jm, jtx, **kw)
    params, target, jp = unflatten(flat), unflatten(flat), jnp.asarray(protos)
    opt = jtx.init((params, jp))

    enc, tgt = VisionTransformer(**TINY), VisionTransformer(**TINY)
    enc.load_state_dict(vit_from_flax(flat, enc))
    tgt.load_state_dict(vit_from_flax(flat, tgt))
    tgt.requires_grad_(False)
    tp = torch.from_numpy(protos.copy()).requires_grad_(True)
    lr = pc.warmup_cosine_lr(2e-4, 1e-3, 1e-6, 1, total)
    tx = pc.chain(pc.clip_by_global_norm(3.0), pc.scale_by_adam(),
                  pc.scheduled_weight_decay(0.04, 0.4, total,
                                            mask=pc.wd_mask(list(enc.parameters())) + [False]),
                  pc.scale_by_schedule(lambda s: -lr(s)))
    step = msn_train.make_msn_full_train_step(enc, tp, tgt, tx, **kw)
    m_fn, t_fn = jax_pc.linear_ramp(0.996, 1.0, total), jax_pc.linear_ramp(0.25, 0.3, total)
    for it in range(2):
        batch = _msn_batch(30 + it, 3)
        key = jax.random.PRNGKey(40 + it)
        m, T = m_fn(it), t_fn(it)
        params, target, jp, opt, jl, _ = jstep(params, target, jp, opt,
                                               {k: jnp.asarray(v) for k, v in batch.items()},
                                               key, jnp.float32(m), jnp.float32(T))
        kr, kf = jax.random.split(key)
        ids = tuple(torch.from_numpy(np.array(jax_msn_train._keep_ids(k_, 3 * v, n, 0.15))).long()
                    for k_, v, n in ((kr, 1, 16), (kf, 2, 4)))
        loss, _ = step(_msn_to_port(batch), m, T, ids=ids)
        assert abs(float(loss) - float(jl)) <= ATOL, it
        for mine, theirs in ((enc, params), (tgt, target)):
            _close_trees(_no_key_bias(vit_to_flax(mine.state_dict())), _no_key_bias(_flat(theirs)),
                         STEP_TOL, exempt=EXEMPT)
        _close_trees({"p": tp.detach().numpy()}, {"p": np.asarray(jp)}, STEP_TOL, exempt=EXEMPT)


def test_views_first_pairs_each_anchor_with_its_target():
    """`_views_first` orders [B, V, ...] view-major exactly as the JAX
    package's, so row v·B + j of the anchors meets target j."""
    x = np.arange(3 * 4 * 2, dtype=np.float32).reshape(3, 4, 2)
    np.testing.assert_array_equal(msn_train._views_first(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_msn_train._views_first(jnp.asarray(x))))


@pytest.mark.parametrize("which", ["warmup_cosine_lr", "scheduled_wd", "linear_ramp",
                                   "mae_lr_schedule"])
def test_schedules_match_jax(which):
    """Every schedule at steps 0-130 against the JAX package's, exact to
    float32 (rtol 1e-6: XLA's cosine against numpy's, an ulp apart at most)."""
    steps = [0, 1, 2, 5, 9, 10, 11, 37, 99, 124, 125, 130]
    if which == "warmup_cosine_lr":
        got, want = pc.warmup_cosine_lr(2e-4, 1e-3, 1e-6, 10, 100), \
            jax_pc.warmup_cosine_lr(2e-4, 1e-3, 1e-6, 10, 100)
    elif which == "linear_ramp":
        got, want = pc.linear_ramp(0.996, 1.0, 100), jax_pc.linear_ramp(0.996, 1.0, 100)
    elif which == "mae_lr_schedule":
        got, want = mae_train.mae_lr_schedule(1.5e-4, 1e-6, 2.5, 10, 10), \
            jax_mae_train.mae_lr_schedule(1.5e-4, 1e-6, 2.5, 10, 10)
    else:
        port = pc.scheduled_weight_decay(0.04, 0.4, 100)
        jtx = jax_pc.scheduled_weight_decay(0.04, 0.4, 100)
        ones = {"w": jnp.ones((1,))}

        def want(s):
            u, _ = jtx.update({"w": jnp.zeros((1,))}, {"count": jnp.int32(s)}, ones)
            return float(u["w"][0])
        got = port.wd
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, err_msg=str(s))


def test_host_datasets_equal_jax_sample_for_sample():
    """`AugmentedDataset` (MAE) and `MultiCropDataset` (MSN) over the port's
    `SyntheticImages` against the JAX package's datasets over its own, in two
    epochs: every view equal, value for value (the crops and flips draw
    from ``default_rng((seed, epoch, i))``; PIL's bilinear against
    `data/transforms.py resize`)."""
    from sgdm_tpu.data.synthetic import SyntheticImages as JSynth
    from sgdm_tpu_torch.data.synthetic import SyntheticImages

    base, jbase = SyntheticImages(size=40, length=6), JSynth(size=40, length=6)
    kw = dict(rand_size=32, focal_size=16, rand_views=2, focal_views=3, seed=1)
    pairs = [(mae_train.AugmentedDataset(base, 32, seed=1),
              jax_mae_train.AugmentedDataset(jbase, 32, seed=1)),
             (msn_train.MultiCropDataset(base, **kw), jax_msn_train.MultiCropDataset(jbase, **kw))]
    for ds, jds in pairs:
        for epoch in (0, 3):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            for i in range(len(ds)):
                got, want = ds[i], jds[i]
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    rng = np.random.default_rng(0)
    img = rng.random((20, 30, 3)).astype(np.float32)
    for scale in ((0.3, 1.0), (0.99, 1.0), (1.5, 2.0)):   # the last never fits: the whole image
        a = pc.random_resized_crop(np.random.default_rng(5), img, 24, scale)
        b = jax_pc.random_resized_crop(np.random.default_rng(5), img, 24, scale)
        assert np.array_equal(a, b), scale


def _tiny_state(seed: int):
    jm = jax_vit.VisionTransformer(**TINY)
    flat = _jax_params(jm, _images(0, 1, 32), seed)
    tm = VisionTransformer(**TINY)
    tm.load_state_dict(vit_from_flax(flat, tm))
    return jm, flat, tm


META = {"arch": "vit", "patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2,
        "pretrain_img_size": 32, "method": "mae"}


def test_msgpack_encoders_equal_both_ways_and_load_as_backbones(tmp_path):
    """`save_encoder_ckpt` writes the JAX package's bytes for the same weights
    (byte for byte, the .json equal too); each package's loader reads the
    other's file to the same weights; `get_ssl_backbone(ckpt_path=….msgpack)`
    encodes a uint8 batch as the ViT it was written from (equal: the same
    network; tests/test_torch_vit.py holds a loaded backbone's features
    against the JAX `_load_native_backbone`'s)."""
    jm, flat, tm = _tiny_state(11)
    pc.save_encoder_ckpt(tmp_path / "port.msgpack", tm.state_dict(), META)
    jax_pc.save_encoder_ckpt(tmp_path / "jax.msgpack", unflatten(flat), META)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack.json").read_text() == (tmp_path / "jax.msgpack.json").read_text()
    back = pc.load_encoder_ckpt(tmp_path / "jax.msgpack", tm)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    jback = _flat(jax_pc.load_encoder_ckpt(tmp_path / "port.msgpack", unflatten(flat)))
    assert all(np.array_equal(jback[k], flat[k]) for k in flat)

    imgs = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    bb = sb.get_ssl_backbone("mae_vitb16", image_size=32, device="cpu",
                             ckpt_path=str(tmp_path / "jax.msgpack"))
    x = bb.transform_batch(imgs)
    got = bb.batch_encode_feat(x)
    with torch.no_grad():
        want = tm.eval()(x).numpy()
    assert bb.feat_dim == 32 and got.shape == (4, 32) and np.array_equal(got, want)


def _probe_data():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((4, 16)) * 2
    ytr, yte = rng.integers(0, 4, 96), rng.integers(0, 4, 40)
    xtr = (centers[ytr] + rng.standard_normal((96, 16))).astype(np.float32)
    xte = (centers[yte] + rng.standard_normal((40, 16))).astype(np.float32)
    return xtr, ytr, xte, yte


@pytest.mark.parametrize("probe", ["logistic_eval", "linear_probe"])
def test_probes_match_jax(probe, monkeypatch):
    """`logistic_eval` (full-batch Adam to ``tol``) and `linear_probe` (LARS
    in optax's order, the momentum after the lr; 4 epochs of minibatch 16
    from the same permutations) against the JAX functions on the same
    embeddings: train and test accuracy equal (the same count of rows
    right; JAX rounds its float32 mean otherwise), the fitted weights within
    1e-5 of their largest (JAX's read where its `_accuracy` gets them)."""
    xtr, ytr, xte, yte = _probe_data()
    seen = []
    orig = jax_probes._accuracy
    monkeypatch.setattr(jax_probes, "_accuracy",
                        lambda w, b, x, y: seen.append((np.asarray(w), np.asarray(b))) or orig(w, b, x, y))
    if probe == "logistic_eval":
        kw = dict(max_epochs=120)
    else:
        kw = dict(epochs=4, batch_size=16, weight_decay=1e-4)
    want = getattr(jax_probes, probe)(xtr, ytr, xte, yte, **kw)
    got = getattr(eval_probes, probe)(xtr, ytr, xte, yte, device="cpu", return_params=True, **kw)
    for split, n in (("train_score", len(ytr)), ("test_score", len(yte))):   # the same rows right
        assert round(got[split] * n) == round(want[split] * n), split
    assert got["train_score"] > 0.5
    w, b = seen[0]
    np.testing.assert_allclose(got["w"], w, atol=1e-5 * float(np.abs(w).max()))
    np.testing.assert_allclose(got["b"], b, atol=1e-5 * max(float(np.abs(b).max()), 1e-3))


@pytest.mark.parametrize("cli", ["mae_train", "msn_train"])
def test_clis_export_what_both_packages_load(cli, tmp_path):
    """One tiny epoch of each CLI on ``--device cpu`` (16 synthetic images,
    batch 8): the ``.msgpack`` + ``.json`` written, the JAX package's
    ``load_encoder_ckpt`` reads the encoder's exact weights from it, and the
    port's `get_ssl_backbone` on it gives finite features.  (Features of one
    file against the JAX backbone's: the msgpack test above.)"""
    out = tmp_path / f"{cli}.msgpack"
    mod = {"mae_train": mae_train, "msn_train": msn_train}[cli]
    path = mod.main(["--device", "cpu", "--data-len", "16", "--batch-size", "8", "--workers", "2",
                     "--out", str(out), "--log-every", "1"])
    assert path == out and out.exists()
    meta = json.loads((tmp_path / f"{cli}.msgpack.json").read_text())
    assert meta == dict(META, embed_dim=64, method=cli.split("_")[0])
    bb = sb.get_ssl_backbone("msn_vits16", image_size=32, ckpt_path=str(out), device="cpu")
    mine = vit_to_flax(bb.model.state_dict())
    theirs = _flat(jax_pc.load_encoder_ckpt(out, unflatten(mine)))
    assert sorted(theirs) == sorted(mine) and all(np.array_equal(theirs[k], mine[k]) for k in mine)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    got = bb.batch_encode_feat(bb.transform_batch(imgs))
    assert got.shape == (2, 64) and np.isfinite(got).all()
