"""The orchestration layer: SelfGuidedDiffusionTrainer, on one device.

The port's counterpart of `sgdm_tpu/training/trainer.py`, with its
semantics kept line for line on the port's train state:

  * owns the denoiser, the EMA, the diffusion process and the optimizer,
    built from the same Hydra-shaped sub-configs (``dynamic``,
    ``diffusion_model``, ``optim``) through the port's config engine;
  * the epoch loop over the threaded loader with the port's
    `make_train_step` (the optax-order update, as the JAX trainer calls it:
    no fused optimizer), a bounded window of steps in flight, per-step
    metrics logged one window late (no host read of a step's metrics until
    the next log point), the per-timestep loss scatter, epoch time and peak
    device memory;
  * validation: the unconditional val loss of the params and of the EMA,
    and FID-driven best checkpoints when an FID function is injected
    (`set_fid_fn`; `eval.harness.make_val_fid_fn`);
  * guided EMA sample grids (the ImageLogger) and `sampling_progressive`;
  * checkpoints best + last (`training.checkpoints`) and resume at the
    checkpoint's own epoch.

Only one device: ``pl.trainer.devices`` > 1, ``tensor_parallel`` > 1 and
``fsdp: true`` raise (ROADMAP §1 item 9).  ``dynamic.params.use_pallas`` is
accepted and not used: the model's ``kernels`` switch routes training to
K4/K5/K9 and sampling to K1/K2/K3 already (`models/layers.py`).
"""

from __future__ import annotations

import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..conditioning.condition import layout_dim_of, layout_to_device, prepare_condition_kwargs
from ..config.engine import instantiate_from_config, to_container
from ..data.loader import to_device
from ..device import resolve_device
from ..diffusion.core import GaussianDiffusion
from ..models.factory import init_train_params
from ..utils.logging import Tracker, get_tracker, logger, make_grid
from .checkpoints import CheckpointManager
from .optim import create_optimizer
from .state import (TrainState, bind_params, create_train_state, make_eval_step, make_sample_fn,
                    make_train_step)

__all__ = ["SelfGuidedDiffusionTrainer"]

_PRECISION = {"32": "float32", 32: "float32", "fp32": "float32", "16": "bfloat16",
              16: "bfloat16", "bf16": "bfloat16", None: "bfloat16"}


class SelfGuidedDiffusionTrainer:
    def __init__(self, device: str | torch.device = "cuda", **hparams: Any):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.condition_method = hparams.get("condition_method")
        self.cond_dim = hparams.get("cond_dim") or 0
        self.cond_drop_prob = hparams.get("cond_drop_prob") or 0.0
        self.cond_scale = hparams.get("cond_scale")
        self.use_ema = hparams.get("use_ema", True)
        self.ema_decay = hparams.get("ema_decay", 0.9999)
        self.seed = hparams.get("seed", 23)
        self.debug = bool(hparams.get("debug", False))
        self.log_dir = Path(hparams.get("log_dir", "./outputs/run"))
        self.condition_cfg = to_container(hparams.get("condition") or {})
        self.scale_type = self.condition_cfg.get("scale_type", "imagen")
        self.dtp = float(hparams.get("dtp", 1.0))
        self.ddim_eta = float(hparams.get("ddim_eta", 0.0))
        self.log_num_per_prog = int(hparams.get("log_num_per_prog", 10))

        # compute dtype: explicit compute_dtype wins, else pl.trainer.precision
        pl_cfg = to_container(hparams.get("pl") or {})
        trainer_cfg = pl_cfg.get("trainer") or {}
        compute_dtype = hparams.get("compute_dtype")
        if compute_dtype is None:
            prec = trainer_cfg.get("precision")
            compute_dtype = _PRECISION.get(prec, str(prec))
        self._dtype = (torch.bfloat16 if str(compute_dtype) in ("bf16", "bfloat16")
                       else torch.float32)

        # model (dynamic group); use_pallas has no meaning here (see above)
        dyn = to_container(hparams["dynamic"])
        dyn["params"] = {k: v for k, v in (dyn.get("params") or {}).items() if k != "use_pallas"}
        self.model = instantiate_from_config(dyn, dtype=self._dtype)

        # diffusion process (model group)
        diff_cfg = to_container(hparams["diffusion_model"])
        self.diff_params = diff_cfg["params"]
        self.diffusion: GaussianDiffusion = instantiate_from_config(diff_cfg)
        self.clip_denoised = bool(self.diff_params.get("clip_denoised", True))

        # optimizer (optim group)
        optim = to_container(hparams["optim"])
        self.tx = create_optimizer(name=optim["name"], scheduler=optim.get("scheduler_config"),
                                   **optim["params"])

        # runtime: one device
        n_dev = trainer_cfg.get("devices")
        if (isinstance(n_dev, int) and n_dev > 1) or int(trainer_cfg.get("tensor_parallel", 1)) > 1 \
                or trainer_cfg.get("fsdp"):
            raise NotImplementedError(
                "the port trains on one device: pl.trainer.devices > 1, tensor_parallel > 1 "
                "and fsdp come with the parallel slice (ROADMAP §1 item 9)")
        self.state: TrainState | None = None
        self.tracker: Tracker | None = None
        self.ckpt: CheckpointManager | None = None
        self.global_step = 0
        self._train_step = None
        self._eval_step = None
        self._pending_log = None
        self._sampler_cache: dict = {}
        self._data_cfg = to_container(hparams.get("data") or {})
        self.fid_fn = None  # injected by the eval harness (set_fid_fn)

    # ------------------------------------------------------------------
    def set_fid_fn(self, fn) -> None:
        """Inject the FID evaluator, keeping training free of eval imports."""
        self.fid_fn = fn

    def _cond_kwargs(self, batch: Mapping[str, np.ndarray], training: bool) -> dict:
        return prepare_condition_kwargs(
            self.condition_method, batch,
            cond_drop_prob=self.cond_drop_prob if self.condition_method else None,
            training=training, condition_cfg=self.condition_cfg)

    def _layout_dim(self) -> int:
        return layout_dim_of(self.condition_method, self.condition_cfg)

    def _device_batch(self, batch: Mapping[str, np.ndarray], training: bool = True) -> dict:
        kw = self._cond_kwargs(batch, training)
        host = {"image": np.asarray(batch["image"], np.float32)}
        if kw.get("cond") is not None:
            host["cond"] = np.asarray(kw["cond"], np.float32)
        if kw.get("image_batch_ids") is not None:
            host["image_batch_ids"] = np.asarray(kw["image_batch_ids"], np.int64)
        out = to_device(host, self.device)
        if kw.get("layout") is not None:
            # uint8 id masks travel as one byte a pixel and expand on the device
            out["layout"] = layout_to_device(kw["layout"], self._layout_dim(), self.device)
        return out

    def _emit_pending_train_log(self) -> None:
        """Emit the train-log record of the previous log point; its copies to
        the host were started then, so reading them here does not wait on
        the steps launched since."""
        pending = self._pending_log
        if pending is None:
            return
        step, ep, host, done, iters_per_sec, img_million = pending
        self._pending_log = None
        if done is not None:
            done.synchronize()
        loss = float(host["loss"])
        self.tracker.log(
            {
                "train/loss": loss,
                "train/ddpm_loss": float(host["ddpm_loss"]),
                "train/grad_norm": float(host["grad_norm"]),
                "train/iters_per_sec": iters_per_sec,
                "train/img_million": img_million,
                "epoch": ep,
            },
            step=step,
        )
        logger.info(f"epoch {ep} step {step} loss {loss:.4f} it/s {iters_per_sec:.2f}")

    def _start_metric_copy(self, metrics: Mapping[str, torch.Tensor]):
        """Host copies of the step's scalar metrics, started without waiting
        (pinned buffers, non_blocking) and an event that marks them done."""
        keys = ("loss", "ddpm_loss", "grad_norm")
        if self.device.type != "cuda":
            return {k: metrics[k].detach().clone() for k in keys}, None
        host = {k: torch.empty((), dtype=metrics[k].dtype, pin_memory=True) for k in keys}
        for k in keys:
            host[k].copy_(metrics[k].detach(), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _init_state(self) -> None:
        """Training init from ``seed`` (the port's modules know their shapes:
        the JAX trainer's example batch is not needed)."""
        init_train_params(self.model, self.seed)
        self.state = create_train_state(self.model, self.tx, device=self.device)
        logger.info(f"model params: {self.state.params.numel() / 1e6:.2f}M")

    # ------------------------------------------------------------------
    def fit(
        self,
        datamodule,
        max_epochs: int = 1,
        limit_train_batches: float | int = 1.0,
        log_every_n_steps: int = 50,
        resume_from: str | None = None,
        fid_every_n_epoch: int | None = None,
        vis_every_iter: int | None = None,
    ) -> TrainState:
        self.tracker = self.tracker or get_tracker(self.log_dir, config=self.hparams)
        self.ckpt = self.ckpt or CheckpointManager(self.log_dir / "ckpts")
        data_cfg = self._data_cfg
        fid_every_n_epoch = fid_every_n_epoch or data_cfg.get("fid_every_n_epoch", 10 ** 9)
        vis_every_iter = vis_every_iter or data_cfg.get("vis_every_iter", 10 ** 9)

        self.datamodule = datamodule  # exposed for the eval harness
        train_dl = datamodule.train_dataloader()
        if self.state is None:
            self._init_state()
        resumed = False
        resume_epoch = None
        if resume_from:
            self.state = self.ckpt.restore(self.state, resume_from)
            self.global_step = int(self.state.step)
            resume_epoch = self.ckpt.epoch_of(resume_from)
            resumed = True
            logger.warning(f"resumed from {resume_from} at step {self.global_step}")

        pl_trainer = to_container(self.hparams.get("pl") or {}).get("trainer") or {}
        self._train_step = self._train_step or make_train_step(
            self.model, self.diffusion, self.tx,
            cond_drop_prob=self.cond_drop_prob if self.condition_method else 0.0,
            ema_decay=self.ema_decay, use_ema=self.use_ema,
            accumulate_grad_batches=int(pl_trainer.get("accumulate_grad_batches", 1)),
            device=self.device,
        )
        seed = self.seed + 1  # the step folds in state.step, as fold_in does

        limit = limit_train_batches
        n_batches = len(train_dl)
        max_batches = int(n_batches * limit) if isinstance(limit, float) else int(limit)

        profile = bool(self.hparams.get("profile"))
        prof = None
        # one optimizer step consumes one global batch: img_million continues
        samples_seen = self.global_step * train_dl.batch_size
        # resume continues from the checkpoint's own epoch toward max_epochs
        # total; the step // steps_per_epoch fallback is for bare checkpoints
        steps_per_epoch = max(1, min(n_batches, max_batches))
        if not resumed:
            start_epoch = 0
        elif resume_epoch is not None:
            start_epoch = resume_epoch + 1
        else:
            start_epoch = self.global_step // steps_per_epoch
        if resumed and start_epoch:
            logger.info(f"resuming at epoch {start_epoch}/{max_epochs}")

        # bounded window of steps in flight: the host waits on the step K
        # behind (an event), never on the one it just launched
        inflight: deque = deque()
        inflight_depth = int(os.environ.get("SGDM_INFLIGHT_DEPTH", "8"))
        cuda = self.device.type == "cuda"
        for epoch in range(start_epoch, max_epochs):
            train_dl.set_epoch(epoch)
            t_epoch = time.perf_counter()
            t_last = t_epoch
            stats_x: list[torch.Tensor] = []
            stats_y: list[torch.Tensor] = []
            for i, raw in enumerate(train_dl):
                if i >= max_batches:
                    break
                # profile=1: trace steps 2-12 of epoch 1
                if profile and epoch == 1 and i == 2:
                    prof = _start_profiler(cuda)
                batch = self._device_batch(raw, training=True)
                self.state, metrics = self._train_step(self.state, batch, seed=seed)
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append(ev)
                    if len(inflight) > inflight_depth:
                        inflight.popleft().synchronize()
                if prof is not None and i == 12:
                    _stop_profiler(prof, self.log_dir / "profile", cuda)
                    prof = None
                self.global_step += 1
                samples_seen += raw["image"].shape[0]

                if self.global_step % log_every_n_steps == 0:
                    now = time.perf_counter()
                    iters_per_sec = log_every_n_steps / max(now - t_last, 1e-9)
                    t_last = now
                    self._emit_pending_train_log()
                    host, done = self._start_metric_copy(metrics)
                    self._pending_log = (self.global_step, epoch, host, done, iters_per_sec,
                                         samples_seen / 1e6)
                # device tensors: read once at the epoch's end
                stats_x.append(metrics["epoch_stats_x"])
                stats_y.append(metrics["epoch_stats_y"])

                if vis_every_iter and self.global_step % vis_every_iter == 0:
                    self._log_images(raw, epoch)
            if prof is not None:  # an epoch shorter than 13 steps
                _stop_profiler(prof, self.log_dir / "profile", cuda)
                prof = None

            self._emit_pending_train_log()
            # the previous epoch's 'last' save had the whole epoch to commit
            self.ckpt.wait_until_finished()
            if stats_x:
                x = torch.cat(stats_x).cpu().numpy()
                y = torch.cat(stats_y).float().cpu().numpy()
                bins = np.linspace(0, self.diffusion.num_timesteps, 21)
                idx = np.digitize(x, bins) - 1
                per_bin = {f"loss_vs_t/bin{j:02d}": float(y[idx == j].mean())
                           for j in range(20) if np.any(idx == j)}
                self.tracker.log(per_bin, step=self.global_step)
            epoch_time = time.perf_counter() - t_epoch
            self.tracker.log({"epoch_time_sec": epoch_time, "epoch": epoch,
                              **self._device_stats()}, step=self.global_step)

            # check_val_every_n_epoch cadence; forced on resume
            check_val_n = int(pl_trainer.get("check_val_every_n_epoch") or 1)
            if resumed or (epoch + 1) % check_val_n == 0:
                self._run_validation(datamodule, epoch, fid_every_n_epoch, resumed)
            resumed = False
            self.ckpt.save_last(self.state, epoch)
        self.ckpt.wait_until_finished()
        return self.state

    # ------------------------------------------------------------------
    def _run_validation(self, datamodule, epoch: int, fid_every_n_epoch: int,
                        force_fid: bool) -> None:
        try:
            val_dl = datamodule.val_dataloader()
        except KeyError:
            return
        self._eval_step = self._eval_step or make_eval_step(self.model, self.diffusion,
                                                            device=self.device)
        pl_trainer = to_container(self.hparams.get("pl") or {}).get("trainer") or {}
        limit_val = pl_trainer.get("limit_val_batches", 8)
        limit_val = (int(len(val_dl) * limit_val) if isinstance(limit_val, float)
                     else int(limit_val))
        seed = self.seed + 2 + epoch
        losses, losses_ema = [], []
        for i, raw in enumerate(val_dl):
            if i >= limit_val:
                break
            # training=False forces a condition drop of 1.0: the val loss is
            # the unconditional loss, as in the reference
            batch = self._device_batch(raw, training=False)
            losses.append(float(self._eval_step(self.state.params, self.state, batch,
                                                seed=seed)["loss"]))
            losses_ema.append(float(self._eval_step(self.state.ema_params, self.state, batch,
                                                    seed=seed)["loss"]))
        if losses:
            self.tracker.log({"val/loss": float(np.mean(losses)),
                              "val/loss_ema": float(np.mean(losses_ema)), "epoch": epoch},
                             step=self.global_step)

        # FID-driven checkpoint selection: epoch 0 runs a 10 %-sized FID;
        # resume forces FID on its first epoch
        run_fid = (self.fid_fn is not None
                   and ((epoch + 1) % fid_every_n_epoch == 0 or epoch == 0 or force_fid))
        if run_fid:
            frac = 0.1 if epoch == 0 else 1.0
            fid = float(self.fid_fn(self, epoch=epoch, fid_num_fraction=frac))
            self.tracker.log({"val/fid_for_ckpt": fid, "epoch": epoch}, step=self.global_step)
            self.ckpt.save_best_if_improved(self.state, epoch, fid)

    # ------------------------------------------------------------------
    def _log_images(self, raw_batch: Mapping[str, np.ndarray], epoch: int,
                    max_images: int = 8) -> None:
        """ImageLogger: EMA guided grids at cond_scale ∈ {s, 0}, a
        same-condition batch, a condition-interpolation (slerp) chain, and
        the progressive pred-x0 chain, each as its ``vis`` switch says."""
        from ..utils.batch_ops import batch_interp_condition, batch_to_samecondition

        vis_cfg = to_container(self.hparams.get("vis") or {})
        sampler_kw = dict(
            sampling_method=self.diff_params.get("sampling_imagelogger", "ddim"),
            num_steps=int(self.diff_params.get("num_timesteps_imagelogger", 250)),
        )
        kw = self._cond_kwargs(raw_batch, training=False)
        cond = kw.get("cond")
        layout = kw.get("layout")
        ids = kw.get("image_batch_ids")  # cluster_lookup learned table
        n = min(max_images, raw_batch["image"].shape[0])
        img_size = raw_batch["image"].shape[1]
        channels = raw_batch["image"].shape[-1]

        def run(tag, s, cond_arr, layout_arr, log_chain=False):
            sample = self._make_sampler(cond_scale=float(s), **sampler_kw)
            b = len(cond_arr) if cond_arr is not None else n
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.global_step)
            imgs, inter = sample(self._bound_model(use_ema=True), gen, b, img_size, channels,
                                 cond=None if cond_arr is None
                                 else torch.as_tensor(cond_arr, dtype=torch.float32),
                                 layout=layout_arr,
                                 image_batch_ids=None if ids is None else ids[:b])
            log = {f"images/{tag}": make_grid(imgs.cpu().numpy())}
            if log_chain:
                chain = inter["pred_x0"].cpu().numpy()  # [K,B,H,W,C]
                k, b = chain.shape[:2]
                rows = chain.transpose(1, 0, 2, 3, 4).reshape(k * b, *chain.shape[2:])
                log[f"images/{tag}_chain"] = make_grid(rows, ncol=k)
            self.tracker.log(log, step=self.global_step)

        scales = [self.cond_scale or 0.0]
        if self.condition_method and self.cond_scale:
            scales.append(0.0)
        c_n = None if cond is None else np.asarray(cond[:n])
        l_n = None if layout is None else np.asarray(layout[:n])
        for s in scales:
            run(f"sample_scale{s}", s, c_n, l_n, log_chain=bool(vis_cfg.get("chainvis")))

        if self.condition_method and cond is not None:
            if vis_cfg.get("samecondition", vis_cfg.get("samecond", True)):
                same = batch_to_samecondition({"c": np.asarray(cond[:n])}, 4)["c"]
                same_l = (batch_to_samecondition({"l": np.asarray(layout[:n])}, 4)["l"]
                          if layout is not None else None)
                run("samecondition", self.cond_scale or 1.0, same, same_l)
            if vis_cfg.get("interp") and np.asarray(cond).ndim == 2 and n >= 2:
                mixed = batch_interp_condition(np.asarray(cond[:3]), interp_num=4)
                run("cond_interp", self.cond_scale or 1.0, mixed,
                    None if layout is None
                    else np.repeat(np.asarray(layout[:1]), len(mixed), axis=0))

    def _bound_model(self, use_ema: bool) -> torch.nn.Module:
        """The model with its parameters bound to the EMA or the raw params
        (the next train step binds ``state.params`` again)."""
        flat = self.state.ema_params if use_ema else self.state.params
        bind_params(self.model, flat, self.state)
        return self.model

    def _device_stats(self) -> dict[str, float]:
        """Peak and current device memory, under the JAX trainer's keys."""
        if self.device.type != "cuda":
            return {}
        return {"peak_hbm_mib": torch.cuda.max_memory_allocated(self.device) / 2 ** 20,
                "hbm_in_use_mib": torch.cuda.memory_allocated(self.device) / 2 ** 20}

    def _make_sampler(self, sampling_method: str, num_steps: int, cond_scale):
        # one sampler per (method, steps, scale): the FID loop samples per batch
        scale_key = tuple(np.ravel(np.asarray(cond_scale)).tolist())
        key = (sampling_method, num_steps, scale_key)
        if key not in self._sampler_cache:
            self._sampler_cache[key] = make_sample_fn(
                self.model, self.diffusion, sampling_method=sampling_method,
                num_steps=num_steps, cond_scale=cond_scale, scale_type=self.scale_type,
                ddim_eta=self.ddim_eta, clip_denoised=self.clip_denoised, dtp=self.dtp,
                log_num_per_prog=self.log_num_per_prog, device=self.device)
        return self._sampler_cache[key]

    # ------------------------------------------------------------------
    def sampling_progressive(
        self,
        batch_size: int,
        image_size: int,
        channels: int,
        generator: torch.Generator,
        cond=None,
        layout=None,
        cond_scale: float | None = None,
        sampling_method: str | None = None,
        num_steps: int | None = None,
        use_ema: bool = True,
        image_batch_ids=None,
    ):
        """Public sampling API: (uint8 images NHWC, intermediates)."""
        sample = self._make_sampler(
            sampling_method or self.diff_params.get("sampling_test", "ddim"),
            num_steps or int(self.diff_params.get("num_timesteps_test", 250)),
            self.cond_scale if cond_scale is None else cond_scale,
        )
        return sample(self._bound_model(use_ema), generator, batch_size, image_size, channels,
                      cond=cond, layout=layout, image_batch_ids=image_batch_ids)


def _start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    return prof


def _stop_profiler(prof, out: Path, cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.warning(f"profiler trace → {out}")
