"""SSL-quality probes on frozen embeddings: MSN's logistic eval and MAE's
linear probe.

The port's copy of `sgdm_tpu/selfsup/eval_probes.py`:

  * `logistic_eval` (MSN ``logistic_eval.py``): cyanure's preprocessing
    (`preprocess_embs`: each feature centred, each row L2-normalised; train
    and test preprocessed independently, as the reference does), then an
    L2-regularised multiclass logistic regression (lambd / N) fitted by a
    full-batch Adam (lr 0.1, optax's order) until the loss moves by less
    than ``tol``; train and test accuracy;
  * `linear_probe` (MAE ``main_linprobe.py``): BatchNorm1d(affine=False,
    eps 1e-6) as the train set's standardisation, then a Linear head
    trained by LARS in optax's order — ``add_decayed_weights →
    scale_by_trust_ratio (0.001) → −lr (optax.cosine_decay_schedule, lr =
    blr·bs/256) → trace(momentum 0.9)``: the momentum comes after the lr,
    unlike torch's usual LARS — on minibatches from
    ``np.random.default_rng(seed)`` permutations.

Both take embeddings [N, D] and integer labels [N], run on ``device`` (the
card by default; raises without one), and with ``return_params=True`` add
the fitted weights ``w`` [D, K] and ``b`` [K] (numpy) to the scores.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32, resolve_device

__all__ = ["preprocess_embs", "logistic_eval", "linear_probe"]

_f32 = np.float32


def preprocess_embs(embs: np.ndarray, normalize: bool = True,
                    centering: bool = True) -> np.ndarray:
    """cyanure.preprocess(columns=False): centre each feature, then
    L2-normalise each row (floor 1e-12)."""
    e = np.asarray(embs, np.float32).copy()
    if centering:
        e -= e.mean(axis=0, keepdims=True)
    if normalize:
        e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    return e


def _accuracy(w, b, x, y) -> float:
    return float((torch.argmax(x @ w + b, dim=-1) == y).float().mean())


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, y.long(), reduction="mean")


def _result(w, b, xtr, ytr, xte, yte, return_params: bool) -> dict:
    out = {"train_score": _accuracy(w, b, xtr, ytr), "test_score": _accuracy(w, b, xte, yte)}
    if return_params:
        out.update(w=w.detach().cpu().numpy(), b=b.detach().cpu().numpy())
    return out


def logistic_eval(train_embs, train_labs, test_embs, test_labs, lambd: float = 0.00025,
                  normalize: bool = True, max_epochs: int = 300, lr: float = 0.1,
                  tol: float = 1e-6, fit_intercept: bool = False, seed: int = 0,
                  device: str | torch.device = "cuda",
                  return_params: bool = False) -> dict[str, float]:
    """L2-regularised softmax regression on frozen embeddings (lambd / N);
    train and test preprocessed independently."""
    dev = resolve_device(device)
    xtr = torch.from_numpy(preprocess_embs(train_embs, normalize)).to(dev)
    xte = torch.from_numpy(preprocess_embs(test_embs, normalize)).to(dev)
    ytr = torch.from_numpy(np.asarray(train_labs, np.int64)).to(dev)
    yte = torch.from_numpy(np.asarray(test_labs, np.int64)).to(dev)
    n, d = xtr.shape
    k = int(max(np.max(train_labs), np.max(test_labs))) + 1
    lam = lambd / n
    w = torch.zeros(d, k, device=dev, requires_grad=True)
    b = torch.zeros(k, device=dev, requires_grad=True)
    params = [w, b]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    prev = math.inf
    with no_tf32():
        for count in range(1, max_epochs + 1):
            logits = xtr @ w + (b if fit_intercept else 0.0)
            loss = _ce(logits, ytr) + lam * torch.sum(w * w)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            c1 = float(_f32(1.0) - _f32(0.9) ** _f32(count))
            c2 = float(_f32(1.0) - _f32(0.999) ** _f32(count))
            with torch.no_grad():
                for p, g, m, v in zip(params, grads, mu, nu):
                    g = torch.zeros_like(p) if g is None else g
                    m.mul_(0.9).add_(0.1 * g)
                    v.mul_(0.999).add_(0.001 * g * g)
                    p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8)))
            cur = float(loss.detach())
            if abs(prev - cur) < tol:
                break
            prev = cur
        bb = b if fit_intercept else torch.zeros_like(b)
        return _result(w.detach(), bb.detach(), xtr, ytr, xte, yte, return_params)


def linear_probe(train_feats, train_labs, test_feats, test_labs, epochs: int = 90,
                 batch_size: int = 512, blr: float = 0.1, weight_decay: float = 0.0,
                 seed: int = 0, device: str | torch.device = "cuda",
                 return_params: bool = False) -> dict[str, float]:
    """MAE's linear probe on frozen features: the train set's standardisation
    (BatchNorm1d(affine=False, eps=1e-6)), a Linear head trained by LARS with a
    cosine-decayed lr = blr·bs/256."""
    dev = resolve_device(device)
    xtr_np = np.asarray(train_feats, np.float32)
    mu = xtr_np.mean(axis=0, keepdims=True)
    sig = np.sqrt(xtr_np.var(axis=0, keepdims=True) + 1e-6)
    xtr = torch.from_numpy((xtr_np - mu) / sig).to(dev)
    xte = torch.from_numpy((np.asarray(test_feats, np.float32) - mu) / sig).to(dev)
    ytr = torch.from_numpy(np.asarray(train_labs, np.int64)).to(dev)
    yte = torch.from_numpy(np.asarray(test_labs, np.int64)).to(dev)
    n, d = xtr.shape
    k = int(max(np.max(train_labs), np.max(test_labs))) + 1
    batch_size = min(batch_size, n)
    steps_per_epoch = max(n // batch_size, 1)
    lr = blr * batch_size / 256.0
    decay_steps = float(epochs * steps_per_epoch)

    def sched(count: int) -> float:
        c = _f32(min(float(count), decay_steps))
        cosine = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return float(_f32(lr) * (_f32(1.0) * cosine + _f32(0.0)))

    w = torch.zeros(d, k, device=dev, requires_grad=True)
    b = torch.zeros(k, device=dev, requires_grad=True)
    params = [w, b]
    trace = [torch.zeros_like(p) for p in params]
    rng = np.random.default_rng(seed)
    count = 0
    with no_tf32():
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(dev)
            for i in range(steps_per_epoch):
                idx = order[i * batch_size:(i + 1) * batch_size]
                loss = _ce(xtr[idx] @ w + b, ytr[idx])
                grads = torch.autograd.grad(loss, params)
                step = -sched(count)
                count += 1
                with torch.no_grad():
                    for p, g, t in zip(params, grads, trace):
                        u = g + weight_decay * p
                        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                            0.001 * pn / un)
                        t.copy_(u * ratio * step + 0.9 * t)
                        p.add_(t)
        return _result(w.detach(), b.detach(), xtr, ytr, xte, yte, return_params)
