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
    mixing; every metric dict goes into ``test_results.json``.  The ``vis``
    toggles draw the paper's figures under ``papervis/`` (`papervis`): the
    in-loop grids (random, same-condition, interpolation, STEGO-mask and
    LOST-box figures) from the first batches of the primary scale's run,
    whose batches the same-condition and interpolation toggles rewrite
    first (`_make_vis_hooks`); then, on their own, real-image grids per
    cluster, the images-per-cluster histogram, the denoising chains
    (``pred_x0``), the guidance sweep in one sampler call, kNN
    (`knn_eval`) and t-SNE (`tsne`) of the primary run's samples.  Without
    a reference dir the test phase is skipped with a warning, as in the JAX
    package;
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
           "get_condition_scale_list"]

_EXTRACTORS: dict[str, InceptionExtractor] = {}

def _extractor(device: torch.device) -> InceptionExtractor:
    key = str(device)
    if key not in _EXTRACTORS:
        _EXTRACTORS[key] = InceptionExtractor(device=device)
    return _EXTRACTORS[key]


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
               debug: bool, **hooks):
    """This rank's share of ``fid_num`` samples into ``sample_dir``, then the
    metrics over every data-axis rank's samples (`get_fid_dict`);
    ``hooks``: `sample_to_dir`'s ``batch_transform`` / ``vis_callback``."""
    sample_to_dir(sample_fn, loader, fid_num, sample_dir, share=data_coords(), **hooks)
    mesh = current_mesh()
    across = {} if mesh is None else {"group": mesh.group("data")}
    return get_fid_dict(sample_dir, gt_dir, extractor, debug=debug, **across)


def _make_batch_sample_fn(trainer, cond_scale: float, sampling_method: str | None = None,
                          num_steps: int | None = None, random_sample_condition: bool = False,
                          want_chain: bool = False):
    """raw batch dict → uint8 samples [B, H, W, C] (numpy), through the
    trainer's sampler; ``directimage`` passes the real images through.  With
    ``want_chain`` the fn returns (samples, the uint8 ``pred_x0`` chain
    [K, B, H, W, C]) for the chain figures."""
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
        imgs, inter = trainer.sampling_progressive(
            b, h, c, torch.Generator(device=dev).manual_seed(int(seed)),
            cond=None if cond is None
            else torch.as_tensor(np.asarray(cond), dtype=torch.float32, device=dev),
            layout=layout_to_device(
                kw.get("layout"), layout_dim_of(trainer.condition_method, trainer.condition_cfg),
                device=dev),
            cond_scale=cond_scale, sampling_method=sampling_method, num_steps=num_steps,
            image_batch_ids=kw.get("image_batch_ids"))
        if want_chain:
            return imgs.cpu().numpy(), inter["pred_x0"].cpu().numpy()
        return imgs.cpu().numpy()

    return sample_fn


def _ds_vis_params(image_size: int, dataset_name: str = "") -> tuple[int, int]:
    """(samecondition_num, grid padding) by dataset name (in32 → 18 / 1, in64
    → 9 / 2, cocostuff64 / coco64 / voc64 → 11 / 5), else by image size."""
    name = (dataset_name or "").lower()
    if name.startswith("in32"):
        return 18, 1
    if name.startswith("in64"):
        return 9, 2
    if name.startswith(("cocostuff64", "coco64", "voc64")):
        return 11, 5
    if image_size <= 32:
        return 18, 1
    if image_size <= 64:
        return 9, 2
    return 11, 5


def _make_vis_hooks(trainer, vis: Mapping[str, Any], papervis_dir: Path, image_size: int,
                    dataset_name: str = "", draw: bool = True):
    """(batch_transform, vis_callback) for the sampling loop of the primary
    scale's run: the same-condition and interpolation toggles rewrite the
    batches before they are sampled, the grid toggles draw the first
    batches' samples (only where ``draw``: rank 0).  (None, None) when no
    in-loop toggle is on."""
    from ..utils.batch_ops import (
        batch_interp_condition, batch_to_samecondition, batch_to_samecondition_v2,
    )
    from . import papervis as pv

    same_n, pad = _ds_vis_params(image_size, dataset_name)
    m = trainer.condition_method
    prefix = f"{m or 'uncond'}"
    v2_modes = {  # toggle → the key that keeps its own rows
        "same_cluster_diff_lost": "lostbboxmask",
        "diff_cluster_same_lost": "cluster",
        "same_stego_diff_cluster": "cluster",
        "diff_z_same_stego": "cluster",
    }
    before_on = [k for k in ("samecondition", "interp", "same_cluster_same_lost", *v2_modes)
                 if vis.get(k)]
    after_on = [k for k in ("random", "random_stego_with_mask", "random_lost_with_box",
                            "samecondition", "interp", "same_cluster_same_lost", *v2_modes)
                if vis.get(k)]
    if not (before_on or after_on):
        return None, None

    def batch_transform(batch: dict) -> dict:
        if vis.get("samecondition") or vis.get("same_cluster_same_lost"):
            batch = batch_to_samecondition(batch, same_n)
        for mode, diff_key in v2_modes.items():
            if vis.get(mode):
                batch = batch_to_samecondition_v2(
                    batch, diff_key, 8 if mode == "diff_z_same_stego" else same_n)
        if vis.get("interp") and m and m in batch and np.asarray(batch[m]).ndim == 2:
            c = np.asarray(batch[m])
            n_pts = int((vis.get("interp_c") or {}).get("n", 9))
            mixed = batch_interp_condition(c, n_pts)[: len(c)]
            if len(mixed) < len(c):
                mixed = np.concatenate([mixed, c[len(mixed):]])
            batch[m] = mixed
        return batch

    def vis_callback(bi: int, batch: dict, samples: np.ndarray) -> None:
        p = papervis_dir
        stego, lost, img = batch.get("stegomask"), batch.get("lostbboxmask"), batch.get("image")
        if vis.get("random"):
            ncol = 16 if image_size <= 32 else 9
            pv.draw_grid_img(samples[: ncol * ncol], p / f"{prefix}_random_uncurated_{bi}.png",
                             ncol=ncol, padding=pad)
        if vis.get("random_stego_with_mask") and stego is not None:
            pv.draw_grid_random_stego_with_mask(
                samples[:32], stego[:32], img[:32],
                p / f"{prefix}_random_stego_with_mask_{bi}.png", ncol=4, padding=pad)
        if vis.get("random_lost_with_box") and lost is not None:
            pv.draw_grid_random_lost_with_box(
                samples[:64], lost[:64], p / f"{prefix}_random_lost_with_box_{bi}.png",
                ncol=8, padding=pad)
        if vis.get("samecondition"):
            pv.draw_grid_img(samples, p / f"{prefix}_samecondition_{bi}.png", ncol=same_n,
                             padding=pad)
        if vis.get("interp"):
            ic = vis.get("interp_c") or {}
            n_pts, n_smp = int(ic.get("n", 9)), int(ic.get("samples", 16))
            pv.draw_grid_interp(samples[: n_pts * n_smp], p / f"{prefix}_interp_{bi}.png",
                                ncol=n_pts, padding=pad)
        for mode in ("same_cluster_same_lost", "same_cluster_diff_lost",
                     "diff_cluster_same_lost"):
            if vis.get(mode) and lost is not None:
                for gi, s0 in enumerate(range(0, len(samples) - same_n + 1, same_n)):
                    pv.draw_grid_lost_bbox(
                        samples[s0:s0 + same_n], lost[s0:s0 + same_n], img[s0:s0 + same_n],
                        p / f"{prefix}_{mode}_{bi}_{gi}.png", padding=pad)
        for mode, n in (("same_stego_diff_cluster", same_n), ("diff_z_same_stego", 8)):
            if vis.get(mode) and stego is not None:
                for gi, s0 in enumerate(range(0, len(samples) - n + 1, n)):
                    pv.draw_grid_stego(
                        samples[s0:s0 + n], stego[s0:s0 + n], img[s0:s0 + n],
                        p / f"{prefix}_{mode}_{bi}_{gi}.png", padding=pad)

    return (batch_transform if before_on else None), (vis_callback if after_on and draw
                                                      else None)


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
    lead = rank() == 0   # figures and the results file: rank 0

    # the in-loop figures ride the primary scale's run
    vis = cfg.get("vis") or {}
    papervis_dir = log_dir / "papervis"
    first_raw = next(iter(train_dl))
    image_size = first_raw["image"].shape[1]
    batch_transform, vis_callback = _make_vis_hooks(
        trainer, vis, papervis_dir, image_size, dataset_name=str(data_cfg.get("name") or ""),
        draw=lead)

    def score(tag: str, sample_fn, num: int | None = None, **hooks) -> float:
        sample_dir = log_dir / f"test_{tag}{_process_suffix()}"
        d, fid = _score_dir(sample_fn, train_dl, num or fid_num, sample_dir, gt_dir, extractor,
                            debug, **hooks)
        results.update({f"test/{tag}/{k}": v for k, v in d.items()})
        if trainer.tracker:
            trainer.tracker.log({f"test/{tag}/{k}": v for k, v in d.items()},
                                step=trainer.global_step)
        logger.warning(f"test[{tag}] fid={fid}")
        return fid

    def one_run(tag: str, cond_scale: float, *, method=None, random_cond=False, num=None,
                with_vis=False):
        hooks = dict(batch_transform=batch_transform, vis_callback=vis_callback) \
            if with_vis else {}
        return score(tag, _make_batch_sample_fn(trainer, cond_scale, method or sampling_method,
                                                num_steps, random_sample_condition=random_cond),
                     num, **hooks)

    scale_list = get_condition_scale_list(trainer.cond_scale)
    if exp.get("cond_scale", True):
        for s in scale_list:
            one_run(f"{sampling_method}{num_steps}_s{s}", float(s), with_vis=s == scale_list[0])

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
        if lead:
            papervis_dir.mkdir(parents=True, exist_ok=True)
            write_png(papervis_dir / "scoremix.png", panel)

    _standalone_figures(trainer, vis, train_dl, first_raw, papervis_dir, image_size,
                        sampling_method, num_steps, lead)
    # the primary run's dir, named as the cond-scale loop names it (the
    # scale-list element, not the raw trainer.cond_scale)
    primary_dir = log_dir / (f"test_{sampling_method}{num_steps}_s{scale_list[0]}"
                             f"{_process_suffix()}")
    if lead and (vis.get("knn") or vis.get("knn_vis")) and primary_dir.exists():
        from .knn_eval import get_knn_eval_dict

        results.update(get_knn_eval_dict(primary_dir, gt_dir, papervis_dir=papervis_dir,
                                         device=trainer.device))
    if lead and (vis.get("tsne") or vis.get("tsne_vis")) and primary_dir.exists():
        from .tsne import kluster_tsne_vis

        kluster_tsne_vis(primary_dir, gt_dir, save_path=papervis_dir / "tsne.png",
                         device=trainer.device)

    if lead:
        (log_dir / "test_results.json").write_text(json.dumps(results, indent=2))
    return results


def _standalone_figures(trainer, vis: Mapping[str, Any], train_dl, first_raw: dict,
                        papervis_dir: Path, image_size: int, sampling_method: str,
                        num_steps: int, lead: bool) -> None:
    """The toggles that draw on their own: real-image grids per cluster, the
    images-per-cluster histogram, the denoising chains of one batch and the
    guidance sweep of one condition.  Every rank samples (their collectives
    stay in step), rank 0 draws."""
    from . import papervis as pv

    if lead and vis.get("kmeans_vis"):
        # real train images of 20 random cluster ids
        k = int((trainer.condition_cfg.get("cluster") or {}).get("k", 100))
        cluster_ids = np.random.default_rng(0).integers(0, max(k, 1), size=20)
        per = 256 if image_size <= 32 else 32
        found: dict[int, list] = {int(i): [] for i in cluster_ids}
        for raw in train_dl:
            cl = raw.get("cluster")
            if cl is None:
                break
            for j, cid in enumerate(np.asarray(cl).argmax(-1)):
                bucket = found.get(int(cid))
                if bucket is not None and len(bucket) < per:
                    bucket.append(np.clip((np.asarray(raw["image"][j]) + 1) * 127.5, 0, 255
                                          ).astype(np.uint8))
            if all(len(v) >= per for v in found.values()):
                break
        for cid, imgs in found.items():
            if imgs:
                pv.draw_grid_clustervis(imgs, papervis_dir / f"cluster{cid}.png",
                                        ncol=16 if image_size <= 32 else 8)

    if lead and vis.get("cluster_hist_vis"):
        counts: dict[int, int] = {}
        for raw in train_dl:
            cl = raw.get("cluster")
            if cl is None:
                break
            for cid in np.asarray(cl).argmax(-1):
                counts[int(cid)] = counts.get(int(cid), 0) + 1
        if counts:
            pv.cluster_hist_vis_fn(np.asarray(list(counts.values())),
                                   papervis_dir / "cluster_hist_vis.png")

    if vis.get("chainvis") or vis.get("stego_chainvis") or vis.get("lost_chainvis"):
        n = int((vis.get("chainvis_c") or {}).get("samples", 7))
        raw = {k: np.asarray(v)[:n] for k, v in dict(first_raw).items()}
        chain_fn = _make_batch_sample_fn(trainer, float(trainer.cond_scale or 0),
                                         sampling_method, num_steps, want_chain=True)
        _, chain = chain_fn(raw, 0)
        if lead and vis.get("chainvis"):
            pv.draw_chain_grid(chain, papervis_dir / "chainvis.png")
        if lead and vis.get("stego_chainvis") and raw.get("stegomask") is not None:
            pv.draw_grid_stego_chainvis(chain, raw["stegomask"], raw["image"],
                                        papervis_dir / "stego_chainvis.png")
        if lead and vis.get("lost_chainvis") and raw.get("lostbboxmask") is not None:
            pv.draw_grid_lost_chainvis(chain, raw["lostbboxmask"], raw["image"],
                                       papervis_dir / "lost_chainvis.png")

    if vis.get("condscale"):
        raw = next(iter(train_dl))
        kw = prepare_sampling_kwargs(
            trainer.condition_method, dict(raw), trainer.cond_scale,
            condition_cfg=trainer.condition_cfg, cond_drop_prob=trainer.cond_drop_prob or 0.1)
        if kw.get("cond") is not None:
            h, c = raw["image"].shape[1], raw["image"].shape[-1]
            layout = None if kw.get("layout") is None else layout_to_device(
                np.asarray(kw["layout"][0]),
                layout_dim_of(trainer.condition_method, trainer.condition_cfg),
                device=trainer.device)
            imgs = pv.condscale_sweep_images(
                trainer, np.asarray(kw["cond"][0]), scales=[0.0, 1.0, 2.0, 4.0, 6.0],
                image_size=h, channels=c, layout=layout, sampling_method=sampling_method,
                num_steps=num_steps)
            if lead:
                pv.draw_grid(imgs, papervis_dir / "condscale_sweep.png", ncol=5)


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
