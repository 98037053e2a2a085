"""Native CLIP (image and text towers): the v-diffusion CLI's default encoder.

Port of `sgdm_tpu/models/clip.py`, under OpenAI's state-dict names, so an
OpenAI checkpoint loads with ``load_state_dict``:

* `CLIP`: the ViT image tower (``visual.conv1`` patch convolution without
  bias, ``class_embedding``, ``positional_embedding``, ``ln_pre``, pre-LN
  blocks of ``attn.in_proj_weight`` / ``attn.out_proj`` / QuickGELU
  ``mlp.c_fc`` / ``mlp.c_proj``, ``ln_post``, ``proj``) and the text
  transformer (``token_embedding``, ``positional_embedding``, causal mask,
  ``ln_final``, the EOT token's row times ``text_projection``).  Images are
  NCHW and CLIP-normalised; attention is explicit matmuls with the softmax
  in float32, as the JAX package's XLA einsum (no fused kernel).
* `load_clip_torch_weights`: an OpenAI checkpoint (a state dict, or the
  published TorchScript archive) → (the port's state dict, the config
  inferred from it).
* The tokenizers: `SimpleTokenizer` (CLIP's byte-level BPE without the
  ``ftfy`` pass; merges file from ``SGDM_CLIP_BPE``), `HashTokenizer` (one
  stable id per word when there is no merges file: NOT CLIP's ids) and
  `tokenize` (<sot> ids <eot>, zero-padded to 77).
* `ClipEncoder` / `build`: the encoder `diffusion.vdiff_cli` plugs in by
  default.  Without ``SGDM_CLIP_WEIGHTS`` it initialises the towers from a
  generator seeded by the model name: deterministic, but neither the JAX
  package's draws nor real CLIP's embeddings.
"""

from __future__ import annotations

import gzip
import html
import math
import os
import zlib
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import no_tf32, resolve_device

__all__ = [
    "CLIP", "ClipConfig", "ClipEncoder", "build", "load_clip_torch_weights",
    "SimpleTokenizer", "HashTokenizer", "tokenize", "CLIP_CONFIGS",
    "CLIP_PIXEL_MEAN", "CLIP_PIXEL_STD", "random_clip_state",
]

# clip/clip.py's Normalize
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407


@dataclass(frozen=True)
class ClipConfig:
    embed_dim: int
    image_resolution: int
    vision_width: int
    vision_layers: int
    vision_patch: int
    text_width: int
    text_heads: int
    text_layers: int


# the published ViT variants; cc12m_1 is conditioned on ViT-B/16
CLIP_CONFIGS: dict[str, ClipConfig] = {
    "ViT-B/32": ClipConfig(512, 224, 768, 12, 32, 512, 8, 12),
    "ViT-B/16": ClipConfig(512, 224, 768, 12, 16, 512, 8, 12),
    "ViT-L/14": ClipConfig(768, 224, 1024, 24, 14, 768, 12, 12),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed ``in_proj``), explicit matmuls."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (z.reshape(b, n, self.heads, d).transpose(1, 2) for z in (q, k, v))
        attn = (q @ k.transpose(-1, -2)) * d ** -0.5
        if mask is not None:
            attn = attn + mask
        out = (attn.float().softmax(-1).to(x.dtype) @ v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class ClipMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ClipBlock(nn.Module):
    """ResidualAttentionBlock: pre-LN attention and QuickGELU MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = ClipAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = ClipMlp(width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class ClipTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ClipBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


class ClipVisual(nn.Module):
    """VisionTransformer: [B, 3, R, R] CLIP-normalised pixels → [B, embed_dim]."""

    def __init__(self, width: int, layers: int, patch: int, embed_dim: int,
                 resolution: int = 224):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((resolution // patch) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = ClipTransformer(width, layers, max(width // 64, 1))
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


class CLIP(nn.Module):
    """Both towers: `encode_image` (NCHW, CLIP-normalised) and `encode_text`
    (int tokens [B, 77])."""

    def __init__(self, config: ClipConfig):
        super().__init__()
        c = self.config = config
        self.visual = ClipVisual(c.vision_width, c.vision_layers, c.vision_patch, c.embed_dim,
                                 c.image_resolution)
        self.token_embedding = nn.Embedding(VOCAB_SIZE, c.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(CONTEXT_LENGTH, c.text_width))
        self.transformer = ClipTransformer(c.text_width, c.text_layers, c.text_heads)
        self.ln_final = nn.LayerNorm(c.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(c.text_width, c.embed_dim))

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.visual(x)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding
        n = CONTEXT_LENGTH
        mask = torch.full((n, n), -math.inf, device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, mask))
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection

    def forward(self, x: torch.Tensor, tokens: torch.Tensor):
        return self.encode_image(x), self.encode_text(tokens)


def random_clip_state(config: ClipConfig, seed: int) -> dict[str, torch.Tensor]:
    """A state dict of `CLIP` drawn from a generator seeded by ``seed``, with
    the JAX module's initialisers: normal(width^-½) for the class and position
    embeddings of the image tower and both projections, normal(0.02) and
    normal(0.01) for the text tower's token and position embeddings, LeCun
    normal (std fan_in^-½) for the linear and convolution weights, zero
    biases, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in CLIP(config).state_dict().items()}
    vw, tw = config.vision_width, config.text_width
    std = {"visual.class_embedding": vw ** -0.5, "visual.positional_embedding": vw ** -0.5,
           "visual.proj": vw ** -0.5, "text_projection": tw ** -0.5,
           "token_embedding.weight": 0.02, "positional_embedding": 0.01}
    state = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if key in std:
            val = torch.randn(shape, generator=gen) * std[key]
        elif "ln_" in key and leaf == "weight":
            val = torch.ones(shape)
        elif leaf.endswith("bias"):
            val = torch.zeros(shape)
        else:                                          # [out, in, …]: fan_in = in·k·k
            val = torch.randn(shape, generator=gen) * math.prod(shape[1:]) ** -0.5
        state[key] = val
    return state


# ---------------------------------------------------------------------------
# OpenAI checkpoints
# ---------------------------------------------------------------------------

def load_clip_torch_weights(path: str) -> tuple[dict[str, torch.Tensor], ClipConfig]:
    """An OpenAI CLIP checkpoint (a state dict ``.pt``, possibly under
    ``"state_dict"``, or the TorchScript archive) → (the port's state dict
    in float32, the config inferred from it).  Keys the port has no use for
    (``logit_scale``, the archive's ``input_resolution`` …) are dropped; a
    key it needs and does not find raises."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    vw, _, patch, _ = sd["visual.conv1.weight"].shape
    n_pos = sd["visual.positional_embedding"].shape[0]
    layers = lambda pre: 1 + max(int(k[len(pre):].split(".")[0]) for k in sd  # noqa: E731
                                 if k.startswith(pre))
    tw = sd["ln_final.weight"].shape[0]
    # heads are not in the state dict; OpenAI's are width // 64 in both towers
    cfg = ClipConfig(sd["text_projection"].shape[1], patch * int(round((n_pos - 1) ** 0.5)),
                     vw, layers("visual.transformer.resblocks."), patch, tw, max(tw // 64, 1),
                     layers("transformer.resblocks."))
    with torch.device("meta"):
        keys = CLIP(cfg).state_dict().keys()
    missing = sorted(set(keys) - set(sd))
    if missing:
        raise KeyError(f"{path}: CLIP keys missing: {missing[:4]}")
    return {k: sd[k].float() for k in keys}, cfg


# ---------------------------------------------------------------------------
# BPE tokenizer (clip/simple_tokenizer.py without ftfy)
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    # basic_clean without ftfy.fix_text: html unescape only
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class SimpleTokenizer:
    """CLIP's byte-level BPE.  ``bpe_path``: bpe_simple_vocab_16e6.txt.gz."""

    def __init__(self, bpe_path: str):
        import regex

        self.pat = regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            regex.IGNORECASE)
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if str(bpe_path).endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in self.pat.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids


class HashTokenizer:
    """One stable id per cleaned word, for when no merges file is available:
    the text path runs, but the ids are NOT CLIP's."""

    def encode(self, text: str) -> list[int]:
        return [zlib.crc32(w.encode("utf-8")) % (SOT_TOKEN - 1) + 1
                for w in _clean(text).split(" ") if w]


def tokenize(texts: list[str], tokenizer, truncate: bool = True) -> np.ndarray:
    """<sot> ids <eot>, zero-padded to 77 (int32 [len(texts), 77])."""
    out = np.zeros((len(texts), CONTEXT_LENGTH), np.int32)
    for i, text in enumerate(texts):
        ids = [SOT_TOKEN] + tokenizer.encode(text) + [EOT_TOKEN]
        if len(ids) > CONTEXT_LENGTH:
            if not truncate:
                raise ValueError(f"text too long for CLIP context: {text!r}")
            ids = ids[:CONTEXT_LENGTH]
            ids[-1] = EOT_TOKEN
        out[i, :len(ids)] = ids
    return out


# ---------------------------------------------------------------------------
# the encoder the v-diffusion CLI plugs in
# ---------------------------------------------------------------------------

class ClipEncoder:
    """`diffusion.vdiff_cli.ClipEncoderProtocol` on the native towers, on
    ``device`` (the card unless the caller asks for the CPU), float32 with
    TF32 off.  ``encode_image_fn`` takes RGB in [0, 1], NCHW at
    ``input_resolution``, and normalises the pixels itself."""

    def __init__(self, model_name: str = "ViT-B/16", weights: str | None = None,
                 bpe_path: str | None = None, device: str | torch.device = "cuda"):
        from ..utils.logging import logger

        name = model_name or "ViT-B/16"
        self.device = resolve_device(device)
        weights = weights or os.environ.get("SGDM_CLIP_WEIGHTS")
        if weights and Path(weights).exists():
            state, cfg = load_clip_torch_weights(weights)
            self._real_weights = True
        else:
            if name not in CLIP_CONFIGS:
                raise ValueError(f"unknown CLIP model {name!r}; have {sorted(CLIP_CONFIGS)}")
            cfg = CLIP_CONFIGS[name]
            state = random_clip_state(cfg, zlib.crc32(name.encode()) & 0x7FFFFFFF)
            self._real_weights = False
            logger.warning(
                "No CLIP weights found (set SGDM_CLIP_WEIGHTS). Using a "
                "DETERMINISTIC RANDOM %s - embeddings are self-consistent "
                "but NOT comparable to real CLIP.", name)
        self.config = cfg
        with torch.device("meta"):
            self.model = CLIP(cfg)
        self.model.load_state_dict(state, assign=True)
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self.embed_dim = cfg.embed_dim
        self.input_resolution = cfg.image_resolution

        bpe_path = bpe_path or os.environ.get("SGDM_CLIP_BPE")
        if bpe_path and Path(bpe_path).exists():
            self.tokenizer: Any = SimpleTokenizer(bpe_path)
        else:
            self.tokenizer = HashTokenizer()
            if self._real_weights:
                logger.warning(
                    "CLIP weights loaded but no BPE merges file "
                    "(SGDM_CLIP_BPE) — falling back to a hash tokenizer; "
                    "text embeddings will NOT match real CLIP.")
        self._mean = torch.tensor(CLIP_PIXEL_MEAN, device=self.device)[:, None, None]
        self._std = torch.tensor(CLIP_PIXEL_STD, device=self.device)[:, None, None]

    def encode_image_fn(self, x01: torch.Tensor) -> torch.Tensor:
        """Raw (unnormalised) image embeddings [n, D]; differentiable."""
        with no_tf32():
            return self.model.encode_image((x01.to(self.device) - self._mean) / self._std)

    def encode_text(self, texts: list[str]) -> np.ndarray:
        toks = torch.as_tensor(tokenize(list(texts), self.tokenizer), device=self.device)
        with torch.no_grad(), no_tf32():
            return self.model.encode_text(toks).cpu().numpy()


def build(model_name: str | None = "ViT-B/16", device: str | torch.device = "cuda"
          ) -> ClipEncoder:
    """The ``--clip-encoder sgdm_tpu_torch.models.clip:build`` factory, and
    the CLI's default encoder."""
    return ClipEncoder(model_name or "ViT-B/16", device=device)
