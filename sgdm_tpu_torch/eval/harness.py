"""Evaluation orchestration: validation FID and the test phase.

The port's counterpart of `sgdm_tpu/eval/harness.py`:

  * `make_val_fid_fn` — the validation FID that picks the best checkpoint:
    at epoch 0 first the oracle FID (real train images against the
    reference dir), then ``val_fid_num × fraction`` samples at the
    configured cond_scale (the trainer asks 10 % at epoch 0) against
    ``data.fid_train_image_dir``, in a per-process dir (``_rank{i}``);
  * `run_test_and_all_exploration` — the cond-scale list ``[s, 0]``, and
    as ``exp`` switches them on: the oracle (``directimage``), random
    conditions, the ``ablate_scale`` sweep, condition mixing and score
    mixing; every metric dict goes into ``test_results.json``.  The vis
    toggles that draw paper figures or run kNN / t-SNE (papervis, knn_eval,
    tsne: ROADMAP §1 item 11) raise `NotImplementedError` when switched on
    (`check_vis_toggles`); all are off in ``configs/vis/default.yaml``.
    Without a reference dir the test phase is skipped with a warning, as in
    the JAX package;
  * `generate_fid_reference_dir` — real images of a dataset as PNGs.

Sampling goes through ``trainer.sampling_progressive`` on the trainer's
device with a `torch.Generator` seeded by the batch index; the extractor
runs on the same device.  Across ranks each rank samples its share of
every FID's samples into its own ``_rank{r}`` dir from its slice of the
train batches, and the Fréchet statistics are reduced over the data axis
(`fid_engine.get_fid_dict`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..conditioning.condition import layout_dim_of, layout_to_device, prepare_sampling_kwargs
from ..parallel.mesh import current_mesh, data_coords, rank
from ..utils.logging import logger, make_grid
from ..utils.png import write_png
from .fid_engine import InceptionExtractor, get_fid_dict, sample_to_dir

__all__ = ["make_val_fid_fn", "run_test_and_all_exploration", "generate_fid_reference_dir",
           "get_condition_scale_list", "check_vis_toggles"]

_EXTRACTORS: dict[str, InceptionExtractor] = {}

# the vis toggles of the JAX harness: papervis grids in the FID loop, and
# kmeans / cluster-histogram / chain / cond-scale figures, kNN and t-SNE
VIS_TOGGLES = (
    "random", "random_stego_with_mask", "random_lost_with_box", "samecondition", "interp",
    "same_cluster_same_lost", "same_cluster_diff_lost", "diff_cluster_same_lost",
    "same_stego_diff_cluster", "diff_z_same_stego", "kmeans_vis", "cluster_hist_vis",
    "chainvis", "stego_chainvis", "lost_chainvis", "condscale", "knn", "knn_vis", "tsne",
    "tsne_vis",
)


def _extractor(device: torch.device) -> InceptionExtractor:
    key = str(device)
    if key not in _EXTRACTORS:
        _EXTRACTORS[key] = InceptionExtractor(device=device)
    return _EXTRACTORS[key]


def check_vis_toggles(vis: Mapping[str, Any] | None) -> None:
    """Raise when a vis toggle of the test phase is on: they need papervis,
    knn_eval and tsne, which are not ported yet."""
    on = [k for k in VIS_TOGGLES if (vis or {}).get(k)]
    if on:
        raise NotImplementedError(
            f"vis toggles {on} need eval/papervis.py, knn_eval.py and tsne.py, which are not "
            "ported yet: ROADMAP §1 item 11")


def get_condition_scale_list(cond_scale: float | None) -> list[float]:
    """``[s, 0]``, or ``[0]`` without a scale."""
    if not cond_scale:
        return [0]
    return [cond_scale, 0]


def _process_suffix() -> str:
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return f"_rank{rank}"


def _score_dir(sample_fn, loader, fid_num: int, sample_dir: Path, gt_dir, extractor,
               debug: bool):
    """This rank's share of ``fid_num`` samples into ``sample_dir``, then the
    metrics over every data-axis rank's samples (`get_fid_dict`)."""
    sample_to_dir(sample_fn, loader, fid_num, sample_dir, share=data_coords())
    mesh = current_mesh()
    across = {} if mesh is None else {"group": mesh.group("data")}
    return get_fid_dict(sample_dir, gt_dir, extractor, debug=debug, **across)


def _make_batch_sample_fn(trainer, cond_scale: float, sampling_method: str | None = None,
                          num_steps: int | None = None, random_sample_condition: bool = False):
    """raw batch dict → uint8 samples [B, H, W, C] (numpy), through the
    trainer's sampler; ``directimage`` passes the real images through."""
    if sampling_method == "directimage":
        def direct(batch, seed):
            img = np.asarray(batch["image"])
            return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)

        return direct

    dev = trainer.device

    def sample_fn(batch, seed):
        kw = prepare_sampling_kwargs(
            trainer.condition_method, dict(batch), cond_scale,
            random_sample_condition=random_sample_condition,
            condition_cfg=trainer.condition_cfg,
            cond_drop_prob=trainer.cond_drop_prob or 0.1)
        cond = kw.get("cond")
        b, h, w, c = batch["image"].shape
        imgs, _ = trainer.sampling_progressive(
            b, h, c, torch.Generator(device=dev).manual_seed(int(seed)),
            cond=None if cond is None
            else torch.as_tensor(np.asarray(cond), dtype=torch.float32, device=dev),
            layout=layout_to_device(
                kw.get("layout"), layout_dim_of(trainer.condition_method, trainer.condition_cfg),
                device=dev),
            cond_scale=cond_scale, sampling_method=sampling_method, num_steps=num_steps,
            image_batch_ids=kw.get("image_batch_ids"))
        return imgs.cpu().numpy()

    return sample_fn


def _resolve_gt_dir(data_cfg: Mapping[str, Any]) -> Path:
    gt = Path(str(data_cfg["fid_train_image_dir"])).expanduser()
    if not gt.exists():
        raise FileNotFoundError(
            f"FID reference dir {gt} missing: write it with "
            "`sgdm_tpu_torch.eval.harness.generate_fid_reference_dir`")
    return gt


def make_val_fid_fn(data_cfg: Mapping[str, Any]):
    """The trainer's validation-FID hook (`SelfGuidedDiffusionTrainer.set_fid_fn`)."""

    def val_fid(trainer, epoch: int, fid_num_fraction: float = 1.0) -> float:
        gt_dir = _resolve_gt_dir(data_cfg)
        fid_num = max(int(data_cfg["val_fid_num"] * fid_num_fraction), 16)
        extractor = _extractor(trainer.device)
        if epoch == 0:
            # the oracle: real train images against the reference dir, sized
            # to the validation budget
            oracle_dir = Path(trainer.log_dir) / f"oracle{_process_suffix()}"
            _, oracle = _score_dir(_make_batch_sample_fn(trainer, 0.0, "directimage"),
                                   trainer.datamodule.train_dataloader(), fid_num, oracle_dir,
                                   gt_dir, extractor, trainer.debug)
            trainer.tracker.log({"val/oracle_fid": oracle, "epoch": epoch},
                                step=trainer.global_step)
            logger.warning(f"oracle fid = {oracle}")
        sample_dir = Path(trainer.log_dir) / f"val_samples_ep{epoch}{_process_suffix()}"
        sample_fn = _make_batch_sample_fn(
            trainer, trainer.cond_scale or 0.0, trainer.diff_params.get("sampling_val", "ddim"),
            int(trainer.diff_params.get("num_timesteps_val", 50)))
        # FID samples the TRAIN loader's conditions
        fid_dict, fid = _score_dir(sample_fn, trainer.datamodule.train_dataloader(), fid_num,
                                   sample_dir, gt_dir, extractor, trainer.debug)
        trainer.tracker.log({f"val/{k}": v for k, v in fid_dict.items()},
                            step=trainer.global_step)
        return fid

    return val_fid


def run_test_and_all_exploration(trainer, cfg: Mapping[str, Any]) -> dict:
    """The test phase of a fitted or restored trainer; ``cfg`` the whole
    config as plain dicts.  Returns the results written to
    ``test_results.json`` ({} and no file when the reference dir is missing)."""
    from ..config.engine import instantiate_from_config, to_container

    data_cfg = cfg["data"]
    exp = cfg.get("exp") or {}
    debug = bool(cfg.get("debug"))
    check_vis_toggles(cfg.get("vis"))
    results: dict[str, Any] = {}
    try:
        # exp.dir4fid overrides the reference dir; else the val image dir,
        # then the train image dir
        if exp.get("dir4fid"):
            gt_dir = Path(str(exp["dir4fid"])).expanduser()
            assert gt_dir.exists(), f"exp.dir4fid={gt_dir} not found"
        else:
            gt_dir = Path(str(data_cfg.get("fid_val_image_dir")
                              or data_cfg["fid_train_image_dir"])).expanduser()
            if not gt_dir.exists():
                gt_dir = _resolve_gt_dir(data_cfg)
    except (FileNotFoundError, KeyError, TypeError) as e:
        logger.warning(f"test phase skipped: {e}")
        return results

    data = instantiate_from_config(to_container(data_cfg))
    data.setup()
    train_dl = data.train_dataloader()  # FID samples the train loader's conditions
    fid_num = int(data_cfg["test_fid_num"]) if not debug else 16
    sampling_method = trainer.diff_params.get("sampling_test", "ddim")
    num_steps = int(trainer.diff_params.get("num_timesteps_test", 250))
    log_dir = Path(trainer.log_dir)
    extractor = _extractor(trainer.device)

    def score(tag: str, sample_fn, num: int | None = None) -> float:
        sample_dir = log_dir / f"test_{tag}{_process_suffix()}"
        d, fid = _score_dir(sample_fn, train_dl, num or fid_num, sample_dir, gt_dir, extractor,
                            debug)
        results.update({f"test/{tag}/{k}": v for k, v in d.items()})
        if trainer.tracker:
            trainer.tracker.log({f"test/{tag}/{k}": v for k, v in d.items()},
                                step=trainer.global_step)
        logger.warning(f"test[{tag}] fid={fid}")
        return fid

    def one_run(tag: str, cond_scale: float, *, method=None, random_cond=False, num=None):
        return score(tag, _make_batch_sample_fn(trainer, cond_scale, method or sampling_method,
                                                num_steps, random_sample_condition=random_cond),
                     num)

    if exp.get("cond_scale", True):
        for s in get_condition_scale_list(trainer.cond_scale):
            one_run(f"{sampling_method}{num_steps}_s{s}", float(s))

    if exp.get("test_oracle"):
        one_run("oracle", 0.0, method="directimage", num=500 if debug else 50_000)

    if exp.get("randomsample"):
        one_run(f"randomsample_s{trainer.cond_scale}", float(trainer.cond_scale or 0),
                random_cond=True)

    if exp.get("ablate_scale"):
        for s in exp.get("ablate_scale_list", [6]):
            one_run(f"ablate_s{s}", float(s))

    if exp.get("condmix"):
        # condition mixing: slerp chains between consecutive conditions
        from ..utils.batch_ops import batch_interp_condition

        interp = int((exp.get("condmix_c") or {}).get("interp", 3))
        base_fn = _make_batch_sample_fn(trainer, float(trainer.cond_scale or 0), sampling_method,
                                        num_steps)

        def condmix_fn(batch, seed):
            batch = dict(batch)
            m = trainer.condition_method
            if m in batch and np.asarray(batch[m]).ndim == 2:
                cond = np.asarray(batch[m])
                mixed = batch_interp_condition(cond, interp)[: len(cond)]
                if len(mixed) < len(cond):
                    mixed = np.concatenate([mixed, cond[len(mixed):]])
                batch[m] = mixed
            return base_fn(batch, seed)

        score("condmix", condmix_fn)

    if exp.get("scoremix"):
        # score-level mixing: each consecutive condition pair swept over
        # `interp` weights in one sampler call (per-sample weights);
        # same_noise gives the rows of a pair one x_T
        from ..training.state import make_scoremix_sample_fn

        sc = exp.get("scoremix_c") or {}
        interp = int(sc.get("interp", 3))
        same_noise = bool(sc.get("same_noise", True))
        dev = trainer.device
        mixer = make_scoremix_sample_fn(
            trainer.model, trainer.diffusion, sampling_method=sampling_method,
            num_steps=num_steps, cond_scale=float(trainer.cond_scale or 1.0),
            scale_type=trainer.scale_type, clip_denoised=trainer.clip_denoised, dtp=trainer.dtp,
            device=dev)

        def scoremix_fn(batch, seed):
            kw = prepare_sampling_kwargs(
                trainer.condition_method, dict(batch), trainer.cond_scale,
                condition_cfg=trainer.condition_cfg,
                cond_drop_prob=trainer.cond_drop_prob or 0.1)
            cond = np.asarray(kw["cond"], np.float32)
            n_pairs = max(len(cond) // interp, 1)
            # pair p = (cond[p], cond[p+1]); rows = pairs × interp weights
            ca = np.repeat(cond[:n_pairs], interp, axis=0)
            cb = np.repeat(np.roll(cond, -1, axis=0)[:n_pairs], interp, axis=0)
            w = np.tile(np.linspace(0.0, 1.0, interp), n_pairs).astype(np.float32)
            h, c = batch["image"].shape[1], batch["image"].shape[-1]
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            x_T = None
            if same_noise:
                noise = torch.randn((n_pairs, h, h, c), generator=gen, device=dev)
                x_T = noise.repeat_interleave(interp, dim=0)
            imgs, _ = mixer(trainer._bound_model(use_ema=True), gen, len(ca), h, c, ca, cb, w,
                            x_T=x_T)
            return imgs.cpu().numpy()

        score("scoremix", scoremix_fn)
        # the panel: rows = pairs, columns = mixing weights
        panel = make_grid(scoremix_fn(dict(next(iter(train_dl))), 0), ncol=interp, pad=2)
        if rank() == 0:
            (log_dir / "papervis").mkdir(parents=True, exist_ok=True)
            write_png(log_dir / "papervis" / "scoremix.png", panel)

    if rank() == 0:
        (log_dir / "test_results.json").write_text(json.dumps(results, indent=2))
    return results


# ----------------------------------------------------------------------

def generate_fid_reference_dir(dataset, out_dir: str | Path, num: int = 50_000) -> Path:
    """The first ``num`` images of ``dataset`` (``image`` in [-1, 1]) as ``img{i}.png``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = min(num, len(dataset))
    for i in range(n):
        arr = np.clip((np.asarray(dataset[i]["image"]) + 1) * 127.5, 0, 255).astype(np.uint8)
        write_png(out / f"img{i}.png", arr if arr.shape[-1] > 1 else arr[..., 0])
    logger.info(f"wrote {n} reference images to {out}")
    return out
