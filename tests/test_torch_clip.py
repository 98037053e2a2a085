"""The port's CLIP (`sgdm_tpu_torch/models/clip.py`) against
`sgdm_tpu/models/clip.py`, in float32 on the CPU, at a tiny config (embed 16,
32 px in 8-px patches, a 32-wide image tower and a 16-wide text tower of two
blocks each):

  * both towers on the JAX module's parameters, every leaf drawn from a
    numpy seed, carried by `models/convert.py clip_from_flax`: within 1e-5
    of the largest output;
  * `load_clip_torch_weights` on a written OpenAI-style state dict (with
    the ``logit_scale`` and ``input_resolution`` entries the port drops):
    the same config as the JAX loader's, and equal forwards;
  * the tokenizers token for token: `SimpleTokenizer` on a synthetic merges
    file, `HashTokenizer`, `tokenize`'s framing and truncation;
  * `ClipEncoder` from the weights file (text and image embeddings equal
    the JAX encoder's; the image path differentiable) and from seeded
    random weights (deterministic), and the CLI's default resolution.
"""

from __future__ import annotations

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import clip as jclip
from sgdm_tpu_torch.models import clip as tclip
from sgdm_tpu_torch.models.convert import clip_from_flax

from torch_port_common import one_torch_thread, perturbed_flat, unflatten  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(embed_dim=16, image_resolution=32, vision_width=32, vision_layers=2,
            vision_patch=8, text_width=16, text_heads=1, text_layers=2)
TEXTS = ["hell", "hello world", "  HELL\n\thell ", "a photo of a dog!", "x" * 5, "",
         "wor ld's 42 &amp; more", "hello " * 60]


@pytest.fixture(scope="module")
def tiny():
    """(flat flax params, port state dict, JAX module, port module)."""
    jcfg, tcfg = jclip.ClipConfig(**TINY), tclip.ClipConfig(**TINY)
    jmod = jclip.CLIP(jcfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 77), jnp.int32))
    flat = perturbed_flat(shapes["params"], 11)
    model = tclip.CLIP(tcfg)
    sd = clip_from_flax(flat, model)
    model.load_state_dict(sd)
    return flat, sd, jmod, model.eval()


def tokens(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, 1000, (3, 77)).astype(np.int32)
    for row, eot in enumerate((5, 40, 76)):       # EOT (the largest id) at three places
        tok[row, eot] = jclip.EOT_TOKEN
        tok[row, eot + 1:] = 0
    return tok


def _err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / float(np.abs(want).max())


def test_towers_match(tiny):
    flat, _, jmod, model = tiny
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    tok = tokens()
    params = {"params": unflatten(flat)}
    want_img = jmod.apply(params, jnp.asarray(x), method=jmod.encode_image)
    want_txt = jmod.apply(params, jnp.asarray(tok), method=jmod.encode_text)
    with torch.no_grad():
        got_img = model.encode_image(torch.as_tensor(x).permute(0, 3, 1, 2))
        got_txt = model.encode_text(torch.as_tensor(tok))
    assert _err(got_img, want_img) <= 1e-5 and _err(got_txt, want_txt) <= 1e-5


@pytest.fixture(scope="module")
def weights_file(tiny, tmp_path_factory):
    _, sd, _, _ = tiny
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    torch.save(dict(sd, logit_scale=torch.tensor(4.6052), input_resolution=torch.tensor(32)),
               path)
    return str(path)


def test_load_clip_torch_weights_matches_jax(tiny, weights_file):
    _, sd, jmod, _ = tiny
    variables, jcfg = jclip.load_clip_torch_weights(weights_file)
    got_sd, cfg = tclip.load_clip_torch_weights(weights_file)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == TINY
    assert got_sd.keys() == sd.keys()
    model = tclip.CLIP(cfg)
    model.load_state_dict(got_sd)
    tok = tokens(2)
    with torch.no_grad():
        got = model.encode_text(torch.as_tensor(tok))
    want = jmod.apply(variables, jnp.asarray(tok), method=jmod.encode_text)
    assert _err(got, want) <= 1e-5


def test_load_clip_torch_weights_names_a_missing_key(tiny, tmp_path):
    _, sd, _, _ = tiny
    sd = dict(sd)
    sd.pop("visual.ln_post.bias")
    torch.save(sd, tmp_path / "broken.pt")
    with pytest.raises(KeyError, match="visual.ln_post.bias"):
        tclip.load_clip_torch_weights(str(tmp_path / "broken.pt"))


def test_encoder_from_weights_matches_jax(weights_file, monkeypatch):
    monkeypatch.delenv("SGDM_CLIP_BPE", raising=False)
    jenc = jclip.ClipEncoder("ViT-B/16", weights=weights_file)
    tenc = tclip.ClipEncoder("ViT-B/16", weights=weights_file, device="cpu")
    assert (tenc.embed_dim, tenc.input_resolution) == (16, 32)
    texts = ["a dog", "A  Dog", "a cat sat"]
    assert _err(tenc.encode_text(texts), jenc.encode_text(texts)) <= 1e-5
    x01 = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jenc.encode_image_fn(jnp.asarray(x01))
    xt = torch.as_tensor(x01).permute(0, 3, 1, 2).requires_grad_()
    got = tenc.encode_image_fn(xt)
    assert _err(got.detach(), want) <= 1e-5
    jg = jax.grad(lambda x: jnp.sum(jenc.encode_image_fn(x) ** 2))(jnp.asarray(x01))
    g, = torch.autograd.grad(got.square().sum(), xt)
    assert _err(g.permute(0, 2, 3, 1), jg) <= 1e-4


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    merges = ["#version: synthetic", "h e", "l l</w>", "he ll</w>", "w o", "r l", "o r",
              "wo rl", "d o", "g</w> !"]
    p = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    with gzip.open(p, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges))
    return str(p)


def test_bpe_tokenizer_matches(bpe_file):
    jt, tt = jclip.SimpleTokenizer(bpe_file), tclip.SimpleTokenizer(bpe_file)
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text), text
    np.testing.assert_array_equal(tclip.tokenize(TEXTS, tt), jclip.tokenize(TEXTS, jt))


def test_hash_tokenizer_and_truncation_match():
    jt, tt = jclip.HashTokenizer(), tclip.HashTokenizer()
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text), text
    np.testing.assert_array_equal(tclip.tokenize(TEXTS, tt), jclip.tokenize(TEXTS, jt))
    with pytest.raises(ValueError, match="too long"):
        tclip.tokenize(["word " * 100], tt, truncate=False)


@pytest.fixture()
def tiny_named(monkeypatch):
    """ViT-B/16 shrunk to the tiny config (no weights file, no merges)."""
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "ViT-B/16", tclip.ClipConfig(**TINY))
    monkeypatch.delenv("SGDM_CLIP_WEIGHTS", raising=False)
    monkeypatch.delenv("SGDM_CLIP_BPE", raising=False)


@pytest.mark.usefixtures("tiny_named")
def test_random_encoder_is_deterministic():
    a = tclip.ClipEncoder("ViT-B/16", device="cpu")
    b = tclip.ClipEncoder("ViT-B/16", device="cpu")
    np.testing.assert_array_equal(a.encode_text(["hello world"]), b.encode_text(["hello world"]))
    sd = a.model.state_dict()
    assert float(sd["visual.ln_pre.weight"].min()) == 1.0
    assert float(sd["visual.transformer.resblocks.0.attn.in_proj_bias"].abs().max()) == 0.0
    std = float(sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].std())
    assert abs(std * 32 ** 0.5 - 1) < 0.1, std


@pytest.mark.usefixtures("tiny_named")
def test_cli_default_encoder_resolution(monkeypatch):
    from sgdm_tpu_torch.diffusion.vdiff_cli import resolve_clip_encoder

    monkeypatch.delenv("SGDM_CLIP_ENCODER", raising=False)
    cpu = torch.device("cpu")
    assert resolve_clip_encoder("none", "ViT-B/16", cpu) is None
    enc = resolve_clip_encoder(None, None, cpu)
    assert isinstance(enc, tclip.ClipEncoder) and enc.device == cpu
    with pytest.raises(ValueError, match="unknown CLIP model"):
        tclip.ClipEncoder("RN50", device="cpu")
