"""MAE fine-tuning in the port (`sgdm_tpu_torch/selfsup/mae_finetune.py`,
`data/image_ops.py`) against `sgdm_tpu.selfsup.mae_finetune` on the CPU,
float32, at a tiny size (patch 8, width 32, depth 2, 32 px).

  * every RandAugment op through both packages' `_rand_augment`, each with a
    seed whose draws pick that op, with either sign: equal to PIL's output
    pixel for pixel (the JAX package's `_rand_augment` is PIL);
  * `FinetuneDataset` (RRC, RandAugment, random erasing; eval resize) equal
    sample for sample over two epochs;
  * `apply_mixup` fed JAX's λ, box centre, switch and apply draws: images
    and soft targets equal to float32 rounding (atol 1e-6);
  * `layerwise_lr_scales` and `finetune_wd_mask` leaf for leaf;
  * the classifier's logits (both pools), one train step (mixup + cutmix,
    drop-path, label smoothing, AdamW with layer decay) fed JAX's draws and
    the eval step: within ATOL 2e-5, parameters within STEP_TOL 1e-6;
  * the CLI on ``--device cpu`` from a port MAE export, its files read by
    the JAX package's loaders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization, traverse_util

from sgdm_tpu.data.synthetic import SyntheticImages as JSynth
from sgdm_tpu.models import vit as jax_vit
from sgdm_tpu.selfsup import mae_finetune as jft
from sgdm_tpu.selfsup import mae_train as jax_mae_train
from sgdm_tpu.selfsup import pretrain_common as jax_pc
from sgdm_tpu_torch.data.synthetic import SyntheticImages
from sgdm_tpu_torch.models.convert import vit_from_flax, vit_to_flax
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import mae_finetune as ft
from sgdm_tpu_torch.selfsup import mae_train
from torch_port_common import perturbed_flat, unflatten

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
ATOL = 2e-5
STEP_TOL = 1e-6
EXEMPT = 0.02
K = 10


def _seed_for(op: int, negative: bool) -> int:
    """The first seed whose `_rand_augment` draws (choice, magnitude, sign) pick
    ``op`` with that sign."""
    for s in range(10000):
        rng = np.random.default_rng(s)
        if int(rng.choice(15, size=1, replace=True)[0]) != op:
            continue
        rng.normal(9.0, 0.5)
        if (rng.random() < 0.5) == negative:
            return s
    raise AssertionError(op)


@pytest.mark.parametrize("sign", ["neg", "pos"])
@pytest.mark.parametrize("op", ft._RA_OPS)
def test_rand_augment_op_equals_pil(op, sign):
    """One op of `_rand_augment` (num_ops=1) on a 48x40 image with structure
    and noise, against the JAX package's PIL op at the same draws: equal,
    every pixel (PIL's rules: `data/image_ops.py`)."""
    seed = _seed_for(ft._RA_OPS.index(op), sign == "neg")
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:48, 0:40] / 48.0
    img = np.clip(np.stack([yy, xx, 0.5 * (yy + xx)], -1) * 0.8 + 0.1
                  + 0.05 * rng.standard_normal((48, 40, 3)), 0, 1).astype(np.float32)
    got = ft._rand_augment(np.random.default_rng(seed), img, num_ops=1)
    want = jft._rand_augment(np.random.default_rng(seed), img, num_ops=1)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_finetune_dataset_equals_jax_sample_for_sample():
    """`FinetuneDataset` train (RRC 0.08-1, RandAugment, normalise, random
    erasing at p 0.5) and eval (resize, normalise) over the port's
    `SyntheticImages` against the JAX package's over its own, two epochs:
    images and labels equal, value for value."""
    base, jbase = SyntheticImages(size=40, length=8), JSynth(size=40, length=8)
    for train in (True, False):
        ds = ft.FinetuneDataset(base, 32, train=train, seed=2, reprob=0.5)
        jds = jft.FinetuneDataset(jbase, 32, train=train, seed=2, reprob=0.5)
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            for i in range(len(ds)):
                got, want = ds[i], jds[i]
                assert got["label_id"] == want["label_id"]
                assert np.array_equal(got["image"], want["image"]), (train, epoch, i)


def _jax_mixup_draws(rng, h: int, w: int, mixup_alpha, cutmix_alpha, prob, switch_prob) -> dict:
    """The draws `sgdm_tpu.selfsup.mae_finetune.apply_mixup` takes from ``rng``."""
    r_apply, r_switch, r_lam_m, r_lam_c, r_cy, r_cx = jax.random.split(rng, 6)
    f = lambda v: float(np.asarray(v))  # noqa: E731
    return dict(
        lam_m=f(jax.random.beta(r_lam_m, mixup_alpha, mixup_alpha)) if mixup_alpha > 0 else 1.0,
        lam0=f(jax.random.beta(r_lam_c, cutmix_alpha, cutmix_alpha)) if cutmix_alpha > 0 else 1.0,
        cy=f(jax.random.uniform(r_cy, (), minval=0.0, maxval=float(h))),
        cx=f(jax.random.uniform(r_cx, (), minval=0.0, maxval=float(w))),
        use_cut=bool(jax.random.bernoulli(r_switch, switch_prob)),
        applied=bool(jax.random.bernoulli(r_apply, prob)))


@pytest.mark.parametrize("mode", ["both", "mixup", "cutmix", "half"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_mixup_with_jax_draws(mode, seed):
    """`apply_mixup` fed the draws JAX's takes from its key: the mixed images
    and the soft targets within 1e-6 (float32 rounding of the same
    products), for mixup + cutmix (switch 0.5), each alone, and an apply
    probability of 0.5."""
    a, c, prob = {"both": (0.8, 1.0, 1.0), "mixup": (0.8, 0.0, 1.0), "cutmix": (0.0, 1.0, 1.0),
                  "half": (0.8, 1.0, 0.5)}[mode]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 24, 20, 3)).astype(np.float32)
    y = rng.integers(0, K, 4)
    key = jax.random.PRNGKey(100 + seed)
    jx, jt = jft.apply_mixup(key, jnp.asarray(x), jnp.asarray(y), K, mixup_alpha=a, cutmix_alpha=c,
                             prob=prob, switch_prob=0.5, smoothing=0.1)
    draws = _jax_mixup_draws(key, 24, 20, a, c, prob, 0.5)
    gx, gt = ft.apply_mixup(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y), K, draws,
                            mixup_alpha=a, cutmix_alpha=c, smoothing=0.1)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jt), atol=1e-6)


def _jax_classifier(global_pool=True, drop_path=0.0):
    enc = jax_vit.VisionTransformer(**TINY, drop_path_rate=drop_path)
    return jft.ViTClassifier(encoder=enc, num_classes=K, global_pool=global_pool)


def _port_classifier(flat, global_pool=True, drop_path=0.0):
    tm = ft.ViTClassifier(VisionTransformer(**TINY, drop_path_rate=drop_path), K, global_pool)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    return tm


def _flat_params(jm, seed):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return perturbed_flat(shapes, seed)


def test_layerwise_scales_and_wd_mask_leaf_for_leaf():
    """`layerwise_lr_scales` (layer decay 0.65) and `finetune_wd_mask` against
    the JAX package's on the classifier's tree, leaf for leaf, exactly."""
    jm = _jax_classifier()
    flat = _flat_params(jm, 0)
    tm = _port_classifier(flat)
    names = [n for n, _ in tm.named_parameters()]
    jscales = traverse_util.flatten_dict(jft.layerwise_lr_scales(unflatten(flat), 0.65, 2), sep="/")
    jmask = traverse_util.flatten_dict(jft.finetune_wd_mask(unflatten(flat)), sep="/")
    scales = ft.layerwise_lr_scales(names, 0.65, 2)
    masks = ft.finetune_wd_mask(list(tm.named_parameters()))
    keys = [next(iter(vit_to_flax({n: p.detach()}))) for n, p in tm.named_parameters()]
    assert sorted(keys) == sorted(jscales)
    for key, sc, m in zip(keys, scales, masks):
        assert sc == jscales[key] and m == bool(jmask[key]), key


def _close(got: dict, want: dict, atol: float, exempt: float = 0.0):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k.endswith("qkv/bias"):     # the key bias's gradient is 0: Adam's noise (see below)
            d = g.shape[0] // 3
            g, w = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        bad = np.abs(g - w) > atol
        assert bad.mean() <= exempt, (k, float(np.abs(g - w).max()), float(bad.mean()))


def _record_bernoulli(monkeypatch):
    """Drop-path draws of a jitted JAX function, read back at run time in the
    order the trace made them."""
    slots: list = []
    orig = jax.random.bernoulli

    def rec(key, p, shape=None):
        out = orig(key, p, shape)
        i = len(slots)
        slots.append(None)
        jax.debug.callback(lambda v, i=i: slots.__setitem__(i, np.asarray(v).reshape(-1)), out)
        return out

    monkeypatch.setattr(jax.random, "bernoulli", rec)
    return slots


@pytest.mark.parametrize("pool", ["global_pool", "cls_token"])
def test_classifier_logits_and_eval_step_match_jax(pool):
    """`ViTClassifier` logits (pre-norm token mean through ``fc_norm``, or the
    normed CLS) within ATOL 2e-5 of JAX's, and `make_finetune_eval_step`'s
    loss, top-1 and top-5 within ATOL of the JAX eval step's definitions
    (optax's integer-label CE, ``lax.top_k``) on JAX's logits."""
    gp = pool == "global_pool"
    jm = _jax_classifier(gp)
    flat = _flat_params(jm, 1)
    tm = _port_classifier(flat, gp)
    x = np.random.default_rng(3).standard_normal((6, 32, 32, 3)).astype(np.float32)
    y = np.arange(6) % K
    jlog = jax.jit(jm.apply)({"params": unflatten(flat)}, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        np.testing.assert_allclose(tm(xt).numpy(), np.asarray(jlog), atol=ATOL)
    want = (optax.softmax_cross_entropy_with_integer_labels(jlog, jnp.asarray(y)).mean(),
            jnp.mean(jnp.argmax(jlog, -1) == y),
            jnp.mean(jnp.any(jax.lax.top_k(jlog, 5)[1] == y[:, None], axis=-1)))
    got = ft.make_finetune_eval_step(tm)(xt, torch.from_numpy(y))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= ATOL


def test_finetune_train_step_matches_jax(monkeypatch):
    """One step of `make_finetune_train_step` (mixup 0.8 + cutmix 1.0, label
    smoothing 0.1, drop-path 0.3, AdamW with weight decay 0.05 masked and
    layer decay 0.65) from the JAX params, fed the draws the JAX package's
    jitted step takes from its key (the mixup draws from its split, the
    drop-path masks read back from the compiled step): the loss within
    ATOL 2e-5, every parameter after the update within STEP_TOL 1e-6 (at
    most EXEMPT 2 % of a leaf beyond it: gradients at float32's noise
    floor, which Adam normalises to ±lr; the key bias, whose gradient is 0,
    left out)."""
    jm = _jax_classifier(drop_path=0.3)
    flat = _flat_params(jm, 2)
    tm = _port_classifier(flat, drop_path=0.3)
    lr_args = (1e-3, 1e-6, 0.0, 2, 4)
    jtx = jft.make_finetune_tx(unflatten(flat), jax_mae_train.mae_lr_schedule(*lr_args),
                               weight_decay=0.05, layer_decay=0.65, depth=2)
    tx = ft.make_finetune_tx(tm, mae_train.mae_lr_schedule(*lr_args), weight_decay=0.05,
                             layer_decay=0.65, depth=2)
    slots = _record_bernoulli(monkeypatch)
    jstep = jft.make_finetune_train_step(jm, jtx, K, mixup_alpha=0.8, cutmix_alpha=1.0,
                                         smoothing=0.1)
    step = ft.make_finetune_train_step(tm, tx, K, mixup_alpha=0.8, cutmix_alpha=1.0, smoothing=0.1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, K, 4)
    key = jax.random.PRNGKey(9)
    params = unflatten(flat)
    params, _, jl = jstep(params, jtx.init(params), jnp.asarray(x), jnp.asarray(y), key)
    jax.effects_barrier()
    slots = list(slots)             # the recorder sees the draws below too
    # the trace's Bernoulli draws: mixup's switch and apply, then block 1's two masks
    assert len(slots) == 4 and all(s is not None for s in slots)
    rng_mix, _ = jax.random.split(key)
    draws = _jax_mixup_draws(rng_mix, 32, 32, 0.8, 1.0, 1.0, 0.5)
    assert [bool(slots[0][0]), bool(slots[1][0])] == [draws["use_cut"], draws["applied"]]
    masks = np.ones((2, 2, 4), np.float32)
    masks[1] = np.stack(slots[2:])
    draws["drop_masks"] = torch.from_numpy(masks)
    loss = step(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y), draws=draws)
    assert abs(float(loss) - float(jl)) <= ATOL
    jflat = traverse_util.flatten_dict(params, sep="/")
    _close(vit_to_flax(tm.state_dict()), {k: np.asarray(v) for k, v in jflat.items()}, STEP_TOL,
           EXEMPT)


def test_soft_and_smoothed_ce_match_jax():
    """`soft_target_ce` on mixed targets and `label_smoothing_ce` (0.1) against
    the JAX package's, within 1e-6 of the loss."""
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((6, K))).astype(np.float32)
    y = rng.integers(0, K, 6)
    soft = rng.dirichlet(np.ones(K), 6).astype(np.float32)
    got = [ft.soft_target_ce(torch.from_numpy(logits), torch.from_numpy(soft)),
           ft.label_smoothing_ce(torch.from_numpy(logits), torch.from_numpy(y), K, 0.1)]
    want = [jft.soft_target_ce(jnp.asarray(logits), jnp.asarray(soft)),
            jft.label_smoothing_ce(jnp.asarray(logits), jnp.asarray(y), K, 0.1)]
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6


def test_draws_by_their_law():
    """`draw_finetune` from a torch.Generator: λ ~ Beta(0.8, 0.8) (mean 0.5
    within 4 standard errors of 2,000 draws), the box centre inside the
    image, cutmix chosen about half the time, drop-path masks of the
    encoder's shape."""
    gen = torch.Generator().manual_seed(0)
    enc = VisionTransformer(**TINY, drop_path_rate=0.2)
    d = [ft.draw_finetune(gen, mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
                          height=24, width=20, model=enc, batch=3) for _ in range(2000)]
    lam = np.array([v["lam_m"] for v in d])
    se = (0.25 / (2 * 0.8 + 1) / 2000) ** 0.5          # Beta(a, a): variance 1 / (4 (2a + 1))
    assert abs(lam.mean() - 0.5) <= 4 * se and ((lam >= 0) & (lam <= 1)).all()
    assert all(0 <= v["cy"] < 24 and 0 <= v["cx"] < 20 and v["applied"] for v in d)
    assert abs(np.mean([v["use_cut"] for v in d]) - 0.5) <= 4 * (0.25 / 2000) ** 0.5
    assert d[0]["drop_masks"].shape == (2, 2, 3)


def test_cli_finetunes_a_port_export_and_jax_reads_it(tmp_path):
    """`python -m sgdm_tpu_torch.selfsup.mae_finetune` on ``--device cpu``:
    one epoch of 2 steps from the port MAE CLI's export (mixup, cutmix,
    RandAugment, erasing, drop-path on); ``finetuned.msgpack`` is read by
    flax's ``from_bytes`` into the JAX classifier's tree and by the port's
    `load_classifier`, equal; ``finetuned_encoder.msgpack`` by the JAX
    ``load_encoder_ckpt``."""
    enc = mae_train.main(["--device", "cpu", "--data-len", "8", "--batch-size", "8",
                          "--workers", "2", "--out", str(tmp_path / "mae.msgpack")])
    args = ["--device", "cpu", "--finetune", str(enc), "--n_train", "16", "--n_val", "8",
            "--batch_size", "8", "--epochs", "1", "--embed_dim", "64", "--depth", "2",
            "--num_heads", "2", "--mixup", "0.8", "--cutmix", "1.0", "--workers", "2",
            "--output_dir", str(tmp_path / "ft")]
    out = ft.main(args)
    assert out == tmp_path / "ft" / "finetuned.msgpack"
    model = ft.load_classifier(out, ft.build_model(ft.build_argparser().parse_args(args)))
    mine = vit_to_flax(model.state_dict())
    jm = jft.ViTClassifier(encoder=jax_vit.VisionTransformer(patch_size=8, embed_dim=64, depth=2,
                                                             num_heads=2, pretrain_img_size=32),
                           num_classes=K)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    template = traverse_util.unflatten_dict(
        {k: np.zeros(v.shape, np.float32) for k, v in traverse_util.flatten_dict(shapes, sep="/").items()},
        sep="/")
    theirs = traverse_util.flatten_dict(serialization.from_bytes(template, out.read_bytes()), sep="/")
    assert sorted(theirs) == sorted(mine)
    assert all(np.array_equal(np.asarray(theirs[k]), mine[k]) for k in mine)
    assert np.isfinite(np.concatenate([v.ravel() for v in mine.values()])).all()
    ejax = jax_pc.load_encoder_ckpt(tmp_path / "ft" / "finetuned_encoder.msgpack",
                                    template["encoder"])
    enc_flat = traverse_util.flatten_dict(ejax, sep="/")
    assert all(np.array_equal(np.asarray(v), mine["encoder/" + k]) for k, v in enc_flat.items())
