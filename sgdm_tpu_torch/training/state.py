"""Train state and the train / eval / sample steps.

Port of `sgdm_tpu/training/state.py` without a mesh (parallelism comes
later):

  * `TrainState` holds the step, the parameters, their EMA, optax.adamw's
    state (`training.optim.OptState`) and LitEma's update count.  The
    parameters, the EMA, μ and ν are each ONE flat f32 buffer in the
    model's `named_parameters` order; the model's parameters are views of
    ``params`` (`bind_params`), so the fused AdamW+EMA kernel (K8) updates
    the whole tree in one launch.  A step updates the state **in place** and
    returns it (`TrainState.clone` copies one).
  * `make_train_step` is loss, gradient, optimizer and EMA in one call, with
    micro-batch gradient accumulation; ``fused_optim`` takes K8
    (`ops.fused_optim`), else the optax-order update and `models.ema`.
    The model runs its training routes (K4/K5 ResBlocks, K9 attention).
  * `make_eval_step` is the validation loss; `make_scoremix_sample_fn`
    the score-mixing sampler of the test phase; `make_sample_fn` the guided
    sampling program: conditioning plus classifier-free guidance baked into
    the denoise closure the sampler calls once per step, kernels on (the JAX
    package switches to ``use_pallas=True`` there), under
    `torch.inference_mode`.

RNG: a step's draws (t, noise, condition-drop mask) come from a
`torch.Generator` seeded from (seed, step, micro-batch), and its dropout
seed from the same triple; ``draws=`` hands in t/noise/drop_mask instead
(the tests give the port the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from ..conditioning.condition import layout_to_device
from ..device import resolve_device
from ..diffusion.core import GaussianDiffusion
from ..diffusion.guidance import guided_score, make_guided_denoiser
from ..models.ema import ema_update
from ..ops.fused_optim import adamw_ema_scalars, fused_adamw_ema
from .optim import Optimizer, OptState

__all__ = ["TrainState", "create_train_state", "bind_params", "make_train_step",
           "make_eval_step", "make_sample_fn", "make_scoremix_sample_fn"]

_COND_KEYS = ("cond", "layout", "image_batch_ids")


@dataclasses.dataclass
class TrainState:
    step: int
    params: torch.Tensor       # flat f32, the model's parameters in named_parameters order
    ema_params: torch.Tensor   # flat f32
    opt_state: OptState
    ema_updates: int           # LitEma num_updates
    layout: tuple[tuple[str, tuple[int, ...]], ...]  # (name, shape) of every leaf, in order

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """{name: view of ``flat``} for a flat buffer of this state's layout."""
        out, off = {}, 0
        for name, shape in self.layout:
            n = 1
            for d in shape:
                n *= d
            out[name] = flat[off:off + n].view(shape)
            off += n
        return out

    def clone(self) -> "TrainState":
        o = self.opt_state
        return TrainState(self.step, self.params.clone(), self.ema_params.clone(),
                          OptState(o.count, o.mu.clone(), o.nu.clone(), o.schedule_count),
                          self.ema_updates, self.layout)


def bind_params(model: torch.nn.Module, flat: torch.Tensor, state: TrainState) -> None:
    """Make every parameter of ``model`` a view of ``flat`` (state's layout)."""
    views = state.unflatten(flat)
    for name, p in model.named_parameters():
        p.data = views[name]


def create_train_state(model: torch.nn.Module, tx: Optimizer, *,
                       device: str | torch.device = "cuda") -> TrainState:
    """A state from the model's current parameter values (initialise them
    first, e.g. `models.factory.init_train_params`), which it then binds.
    The EMA starts as a copy of the parameters; μ and ν at zero."""
    dev = resolve_device(device)
    named = list(model.named_parameters())
    params = torch.cat([p.detach().reshape(-1).float() for _, p in named]).to(dev)
    state = TrainState(0, params, params.clone(), tx.init(params), 0,
                       tuple((name, tuple(p.shape)) for name, p in named))
    model.to(dev)
    bind_params(model, state.params, state)
    return state


def _step_seed(seed: int, step: int, micro: int) -> int:
    """A 63-bit seed from (seed, step, micro-batch), as fold_in does for keys."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro * 0x94D049BB133111EB)
    z &= (1 << 64) - 1
    z ^= z >> 31
    return z & ((1 << 63) - 1)


def _batch_to(batch: Mapping[str, Any], dev: torch.device,
              layout_dim: int = 0) -> dict[str, torch.Tensor]:
    """The batch's image and condition entries on ``dev``; a layout goes
    through `layout_to_device` (id masks become one-hot there)."""
    out = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
           if v is not None and (k == "image" or k in _COND_KEYS) and k != "layout"}
    if batch.get("layout") is not None:
        out["layout"] = layout_to_device(batch["layout"], layout_dim, dev)
    return out


def _loss(model, diffusion, batch, generator, cond_drop_prob, *, train, dropout_seed=0,
          draws=None):
    cond_kwargs = {k: batch[k] for k in _COND_KEYS if k in batch}

    def denoise(x, t, cond_drop_mask=None, **ck):
        return model(x, t, cond_drop_mask=cond_drop_mask, train=train, dropout_seed=dropout_seed,
                     **ck)

    d = {k: torch.as_tensor(v).to(batch["image"].device) for k, v in (draws or {}).items()}
    return diffusion.loss(denoise, generator, batch["image"], cond_kwargs=cond_kwargs,
                          cond_drop_prob=cond_drop_prob, **d)


def make_train_step(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    tx: Optimizer,
    *,
    cond_drop_prob: float = 0.0,
    ema_decay: float = 0.9999,
    use_ema: bool = True,
    accumulate_grad_batches: int = 1,
    fused_optim: bool = False,
    optim_hparams: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch, seed=0, draws=None, return_grads=False)
    -> (state, metrics)``.

    ``batch``: 'image' (NHWC, [-1, 1]) and any of 'cond' / 'layout' (one-hot
    maps, or integer id masks the model's ``layout_dim`` expands on the
    device) / 'image_batch_ids'.  ``accumulate_grad_batches`` k > 1 splits the batch
    into k micro-batches and averages their gradients before one update.
    ``draws``: None, or one dict per micro-batch of 't', 'noise',
    'drop_mask'.  ``fused_optim`` takes the fused AdamW+EMA update (K8 when
    the model's ``kernels`` is on and the state is on the card) with
    ``optim_hparams`` (default: ``tx``'s); it raises on a ``tx`` that clips
    gradients or keeps μ in bf16, which only ``tx.update`` applies.  Metrics: loss, ddpm_loss,
    grad_norm, epoch_stats_x (t), epoch_stats_y (per-sample loss), as
    tensors on the device, and with ``return_grads`` the flat f32 gradient
    (``grads``).  Raises when ``device`` is CUDA and there is none.
    """
    dev = resolve_device(device)
    model.to(dev)
    if fused_optim and (getattr(tx, "grad_clip", None)
                        or getattr(tx, "mu_dtype", torch.float32) != torch.float32):
        # the JAX fused path builds its update from optim_hparams and drops
        # both silently (sgdm_tpu/training/state.py); the port refuses
        raise NotImplementedError(
            "fused_optim=True (K8) has no gradient clip and keeps μ in float32: "
            "use fused_optim=False for grad_clip or mu_dtype='bfloat16'")
    hp = dict(optim_hparams or tx.hparams())
    k = int(accumulate_grad_batches)

    def train_step(state: TrainState, batch: Mapping[str, Any], seed: int = 0,
                   draws: Sequence[Mapping[str, Any]] | None = None, return_grads: bool = False):
        bind_params(model, state.params, state)
        model.train()
        batch = _batch_to(batch, dev, getattr(model, "layout_dim", 0))
        b = batch["image"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} micro-batches")
        m = b // k
        names = [name for name, _ in state.layout]
        params = dict(model.named_parameters())
        params = [params[name] for name in names]
        grads = None
        losses, ddpm, stats_x, stats_y = [], [], [], []
        for i in range(k):
            mb = {key: v[i * m:(i + 1) * m] for key, v in batch.items()}
            s = _step_seed(seed, state.step, i)
            gen = torch.Generator(device=dev)
            gen.manual_seed(s)
            loss, aux = _loss(model, diffusion, mb, gen, cond_drop_prob, train=True,
                              dropout_seed=s & 0x7FFFFFFF, draws=draws[i] if draws else None)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            flat = torch.cat([torch.zeros_like(p).reshape(-1) if gi is None else gi.reshape(-1)
                              for p, gi in zip(params, g)]).float()
            grads = flat if grads is None else grads + flat
            losses.append(loss.detach())
            ddpm.append(aux["ddpm_loss"].detach())
            stats_x.append(aux["epoch_stats_x"])
            stats_y.append(aux["epoch_stats_y"].detach())
        if k > 1:
            grads = grads / k
        loss = torch.stack(losses).sum() / k if k > 1 else losses[0]
        grad_norm = torch.linalg.vector_norm(grads)

        o = state.opt_state
        if fused_optim:
            sc = adamw_ema_scalars(
                hp["lr_schedule"], o.count, state.ema_updates, b1=hp.get("beta1", 0.9),
                b2=hp.get("beta2", 0.999), eps=hp.get("eps", 1e-8),
                weight_decay=hp.get("weight_decay", 1e-2), ema_decay=ema_decay, use_ema=use_ema)
            fused_adamw_ema(state.params, grads, o.mu, o.nu, state.ema_params, sc,
                            kernels=getattr(model, "kernels", True))
            state.opt_state = OptState(o.count + 1, o.mu, o.nu, o.schedule_count + 1)
        else:
            updates, state.opt_state = tx.update(grads, o, state.params)
            state.params.copy_(state.params + updates)
            if use_ema:
                state.ema_params.copy_(ema_update(state.ema_params, state.params,
                                                  state.ema_updates + 1, ema_decay))
        if not use_ema:
            state.ema_params.copy_(state.params)  # a copy, never an alias
        else:
            state.ema_updates += 1
        state.step += 1
        metrics = {
            "loss": loss,
            "ddpm_loss": torch.stack(ddpm).mean(),
            "grad_norm": grad_norm,
            "epoch_stats_x": torch.cat(stats_x),
            "epoch_stats_y": torch.cat(stats_y),
        }
        if return_grads:
            metrics["grads"] = grads
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                   device: str | torch.device = "cuda") -> Callable[..., dict[str, torch.Tensor]]:
    """Returns ``eval_step(params, state, batch, seed=0, cond_drop_prob=1.0,
    draws=None) -> {loss, ddpm_loss}``: the validation loss of the flat
    ``params`` (``state.params`` or ``state.ema_params``), without gradients
    or dropout."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def eval_step(params: torch.Tensor, state: TrainState, batch: Mapping[str, Any],
                  seed: int = 0, cond_drop_prob: float = 1.0,
                  draws: Mapping[str, Any] | None = None):
        bind_params(model, params, state)
        model.eval()
        batch = _batch_to(batch, dev, getattr(model, "layout_dim", 0))
        gen = torch.Generator(device=dev)
        gen.manual_seed(_step_seed(seed, state.step, 0))
        loss, aux = _loss(model, diffusion, batch, gen, cond_drop_prob, train=False,
                          draws=draws)
        return {"loss": loss, "ddpm_loss": aux["ddpm_loss"]}

    return eval_step


def make_sample_fn(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    *,
    sampling_method: str = "ddim",
    num_steps: int = 50,
    cond_scale: float = 2.0,
    scale_type: str = "imagen",
    ddim_eta: float = 0.0,
    clip_denoised: bool = True,
    dtp: float = 1.0,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    log_num_per_prog: int = 10,
    return_uint8: bool = True,
    device: str | torch.device = "cuda",
) -> Callable[..., tuple[torch.Tensor, dict[str, torch.Tensor]]]:
    """Returns ``sample(params_or_model, generator, batch_size, image_size,
    channels, cond=None, layout=None, image_batch_ids=None, x_T=None)`` →
    (images NHWC, intermediates).

    ``params_or_model`` is the model to sample (on ``device``) or a
    `state_dict` to load into ``model`` first.  ``generator`` is a
    `torch.Generator` on ``device``.  ``layout``: one-hot maps or integer id
    masks (`conditioning.condition.layout_to_device`); the guided pass
    doubles it with the batch and the model zeroes the unconditional half's.
    Raises when ``device`` is CUDA and there is none.
    """
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def sample(params_or_model: torch.nn.Module | Mapping[str, Any],
               generator: torch.Generator, batch_size: int, image_size: int,
               channels: int, cond=None, layout=None, image_batch_ids=None, x_T=None):
        net = model
        if isinstance(params_or_model, torch.nn.Module):
            net = params_or_model.to(dev).eval()
        elif params_or_model is not None:
            model.load_state_dict(params_or_model)
        cond_kwargs = {}
        if cond is not None:
            cond_kwargs["cond"] = torch.as_tensor(cond, device=dev)
        if layout is not None:
            cond_kwargs["layout"] = layout_to_device(layout, getattr(net, "layout_dim", 0), dev)
        if image_batch_ids is not None:
            cond_kwargs["image_batch_ids"] = torch.as_tensor(image_batch_ids, device=dev)
        guided = make_guided_denoiser(net, scale_type=scale_type)
        denoise = lambda x, t: guided(x, t, cond_scale=cond_scale, **cond_kwargs)
        shape = (batch_size, image_size, image_size, channels)
        return diffusion.sample(
            sampling_method, denoise, generator, shape, device=dev,
            num_steps=num_steps, ddim_eta=ddim_eta,
            clip_denoised=clip_denoised, dtp=dtp,
            temperature=temperature, noise_dropout=noise_dropout,
            log_num_per_prog=log_num_per_prog, x_T=x_T, return_uint8=return_uint8,
        )

    return sample


def make_scoremix_sample_fn(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    *,
    sampling_method: str = "ddim",
    num_steps: int = 50,
    cond_scale: float = 2.0,
    scale_type: str = "imagen",
    clip_denoised: bool = True,
    dtp: float = 1.0,
    return_uint8: bool = True,
    device: str | torch.device = "cuda",
) -> Callable[..., tuple[torch.Tensor, dict[str, torch.Tensor]]]:
    """Score-mixing sampler: eps = (1-w)·eps_guided(c_a) + w·eps_guided(c_b).

    Returns ``sample(params_or_model, generator, batch_size, image_size,
    channels, cond_a, cond_b, w, layout_a=None, layout_b=None, x_T=None)``
    (as `make_sample_fn`'s first arguments).  The weight ``w`` is per
    sample ([B]): row i mixes cond_a[i] → cond_b[i] at w[i], so one call
    covers a sweep; ``x_T`` gives rows a shared initial noise
    (``same_noise``).  Port of `sgdm_tpu/training/state.py
    make_scoremix_sample_fn`."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def sample(params_or_model, generator: torch.Generator, batch_size: int, image_size: int,
               channels: int, cond_a, cond_b, w, layout_a=None, layout_b=None, x_T=None):
        net = model
        if isinstance(params_or_model, torch.nn.Module):
            net = params_or_model.to(dev).eval()
        elif params_or_model is not None:
            model.load_state_dict(params_or_model)
        guided = make_guided_denoiser(net, scale_type=scale_type)
        layout_dim = getattr(net, "layout_dim", 0)
        kw_a = {"cond": torch.as_tensor(cond_a, device=dev)}
        kw_b = {"cond": torch.as_tensor(cond_b, device=dev)}
        if layout_a is not None:
            kw_a["layout"] = layout_to_device(layout_a, layout_dim, dev)
            kw_b["layout"] = layout_to_device(layout_b, layout_dim, dev)
        w_t = torch.as_tensor(w, dtype=torch.float32, device=dev)

        def denoise(x, t):
            eps_a = guided(x, t, cond_scale=cond_scale, **kw_a)
            eps_b = guided(x, t, cond_scale=cond_scale, **kw_b)
            # guided_score's per-sample broadcast: (1-w)·a + w·b
            return guided_score(z=eps_a, zc=eps_b, w=w_t.to(eps_a.dtype), scale_type="imagen")

        shape = (batch_size, image_size, image_size, channels)
        return diffusion.sample(sampling_method, denoise, generator, shape, device=dev,
                                num_steps=num_steps, clip_denoised=clip_denoised, dtp=dtp,
                                x_T=x_T, return_uint8=return_uint8)

    return sample
