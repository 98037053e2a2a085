"""Parity-day runbook: quality parity against the reference, one command per
stage.  The port's counterpart of `sgdm_tpu/utils/parity_runbook.py`, with
the same stages, flags, environment variables and acceptance thresholds,
each stage run through the port's modules on ``--device`` (the card unless
``--device cpu``):

    python -m sgdm_tpu_torch.utils.parity_runbook --stage all \\
        --data-root ~/data --out-root ~/data/sg_data

  1. ``weights`` — load the pretrained checkpoints the pipelines consume
     (DINO ViT-B/16 and ViT-S/16 by `models.convert.load_dino_torch_weights`,
     checked by `utils.weight_verify.verify_dino_load`; CLIP by
     `models.clip.ClipEncoder`).  Accept: max |Δ| ≤ 1e-3 against the golden.
  2. ``feat`` — `selfsup.feat_extractor` over the dataset with the DINO
     backbone → feat h5.  Accept: median CLS norm in [5, 50].
  3. ``cluster`` — `selfsup.cluster.clustering` (faiss's k-means semantics)
     on the stage-2 h5 → NMI against its labels (`cal_cluster_metric`).
     Accept: NMI ≥ ``--nmi-floor`` (0.50).
  4. ``inception`` — `eval.inception.load_torch_weights` checked by
     `utils.weight_verify.verify_inception_load` (pool3, tol 1e-3).
  5. ``fid`` — FID of one folder pair by `eval.fid_engine.InceptionExtractor`
     (clean resize) against the external `clean-fid` package where it is
     importable.  Accept: |Δ| ≤ max(0.02, 0.5 % of clean-fid's).  Without
     clean-fid the stage reports the clean-vs-bilinear spread and SKIPs; a
     seeded (not pretrained) Inception SKIPs too.

No weight and no dataset is fetched: a stage whose artifact is absent
reports SKIPPED and names what it needs.  The h5 files are read through
`utils.h5`.  Output: one PASS / FAIL / SKIPPED line a stage and a final
JSON line ``{"parity_runbook": [...], "failed": n}``; exit code 1 if a
stage FAILed.  An exception a check raises becomes that stage's FAIL line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from .logging import logger

__all__ = ["main", "run_stage", "STAGES"]


def _result(stage: str, status: str, detail: str = "", value=None) -> dict:
    line = f"[{status:7s}] {stage}: {detail}"
    (logger.warning if status == "FAIL" else logger.info)(line)
    return {"stage": stage, "status": status, "detail": detail, "value": value}


# ---------------------------------------------------------------------------
# stage 1: pretrained weight loads + first-use goldens
# ---------------------------------------------------------------------------

def stage_weights(args) -> list[dict]:
    out = []
    for name, env in [("dino_vitb16", "SGDM_DINO_VITB16"),
                      ("dino_vits16", "SGDM_DINO_VITS16")]:
        path = getattr(args, name, None) or os.environ.get(env)
        if not path or not Path(path).exists():
            out.append(_result(f"weights/{name}", "SKIPPED", f"no checkpoint (set ${env})"))
            continue
        from ..models.convert import load_dino_torch_weights
        from ..models.vit import vit_base, vit_small
        from .weight_verify import verify_dino_load

        model = vit_base(16) if "vitb" in name else vit_small(16)
        model.load_state_dict(load_dino_torch_weights(path))
        ok = verify_dino_load(path, model)
        out.append(_result(
            f"weights/{name}", "PASS" if ok else "SKIPPED",
            "golden verified" if ok else "no torch ground truth — sidecar not yet created"))
    clip_w = args.clip_weights or os.environ.get("SGDM_CLIP_WEIGHTS")
    if clip_w and Path(clip_w).exists():
        from ..models.clip import ClipEncoder

        enc = ClipEncoder(weights=clip_w, bpe_path=args.clip_bpe, device=args.device)
        e = enc.encode_text(["a photo of a dog"])
        norm = float(np.linalg.norm(e))
        ok = np.isfinite(e).all() and 1.0 < norm < 100.0
        out.append(_result("weights/clip", "PASS" if ok else "FAIL",
                           f"text-embed norm {norm:.2f}", norm))
    else:
        out.append(_result("weights/clip", "SKIPPED", "no checkpoint (set $SGDM_CLIP_WEIGHTS)"))
    return out


# ---------------------------------------------------------------------------
# stage 2: feat extraction on real data
# ---------------------------------------------------------------------------

def _feat_h5_path(args) -> Path | None:
    root = Path(os.path.expanduser(args.out_root)) / "feat"
    if not root.is_dir():
        return None
    cands = sorted(root.glob(f"*{args.ds}*{args.feat}*.h5"))
    return cands[-1] if cands else None


def stage_feat(args) -> list[dict]:
    from ..selfsup.feat_extractor import _build_datasets, extract_feat
    from . import h5

    try:
        train, val = _build_datasets(args.ds, args.image_size,
                                     os.path.expanduser(args.data_root), False)
        h5_path = extract_feat(train, val, dataset_name=args.ds, feat_from=args.feat,
                               batch_size=args.bs, out_root=os.path.join(args.out_root, "feat"),
                               device=args.device)
    except (FileNotFoundError, OSError) as e:
        return [_result("feat", "SKIPPED", f"dataset not mounted: {e}")]
    with h5.File(h5_path, "r") as f:
        feats = f["train"][:4096]
        n = f["train"].shape[0]
    med = float(np.median(np.linalg.norm(feats, axis=1)))
    ok = 5.0 <= med <= 50.0
    return [_result("feat", "PASS" if ok else "FAIL",
                    f"{n} rows, median CLS norm {med:.2f} (accept 5-50) → {h5_path}", med)]


# ---------------------------------------------------------------------------
# stage 3: clustering NMI on real features
# ---------------------------------------------------------------------------

def stage_cluster(args) -> list[dict]:
    feat_h5 = args.feat_h5 or _feat_h5_path(args)
    if not feat_h5 or not Path(feat_h5).exists():
        return [_result("cluster", "SKIPPED",
                        "no feat h5 (run --stage feat first or pass --feat-h5)")]
    from ..selfsup.cluster import cal_cluster_metric, clustering
    from . import h5

    cl_h5 = clustering(str(feat_h5), nns=0, cluster_k=args.k, niter=30, minp=200,
                       cluster_h5_root=os.path.join(args.out_root, "cluster"),
                       device=args.device)
    with h5.File(feat_h5, "r") as ff, h5.File(cl_h5, "r") as fc:
        if "train_labels" not in ff:
            return [_result("cluster", "SKIPPED", f"dataset has no labels — wrote {cl_h5}")]
        labels = ff["train_labels"][:]
        assigned = fc["train"][:len(labels)]
    nmi = float(cal_cluster_metric(labels, assigned, need_ami=False, need_ari=False)["nmi"])
    ok = nmi >= args.nmi_floor
    return [_result("cluster", "PASS" if ok else "FAIL",
                    f"NMI {nmi:.4f} (floor {args.nmi_floor}; reference dino_vitb16 k=5000 "
                    f"runs land ~0.6-0.7) → {cl_h5}", nmi)]


# ---------------------------------------------------------------------------
# stage 4: inception port check
# ---------------------------------------------------------------------------

def stage_inception(args) -> list[dict]:
    from ..eval.fid_engine import _find_weights
    from ..eval.inception import load_torch_weights
    from .weight_verify import verify_inception_load

    path = args.inception_weights or _find_weights()
    if not path:
        return [_result("inception", "SKIPPED",
                        "no pt_inception weights (set $SGDM_INCEPTION_WEIGHTS)")]
    ok = verify_inception_load(path, load_torch_weights(path))
    return [_result("inception", "PASS" if ok else "SKIPPED",
                    "pool3 golden verified (tol 1e-3)" if ok else
                    "no torch ground truth available")]


# ---------------------------------------------------------------------------
# stage 5: FID cross-check vs clean-fid
# ---------------------------------------------------------------------------

def stage_fid(args) -> list[dict]:
    d1, d2 = args.fid_dir1, args.fid_dir2
    if not (d1 and d2 and Path(d1).is_dir() and Path(d2).is_dir()):
        return [_result("fid", "SKIPPED",
                        "pass --fid-dir1/--fid-dir2 (two image folders, e.g. the 10k train "
                        "dump vs a sample dir)")]
    from ..eval.fid_engine import InceptionExtractor
    from ..eval.metrics import FeatureStats, frechet_distance

    ext = InceptionExtractor(weights_path=args.inception_weights, device=args.device)
    if not ext.pretrained:
        return [_result("fid", "SKIPPED",
                        "random-fallback inception — mount pt_inception weights first "
                        "(stage 4)")]

    def our_fid(mode: str) -> float:
        stats = []
        for d in (d1, d2):
            st = FeatureStats()
            st.append(ext.features_from_dir(d, mode=mode)["pool3"])
            stats.append(st.mean_cov())
        return float(frechet_distance(*stats[0], *stats[1]))

    ours = our_fid("clean")
    try:
        from cleanfid import fid as _cleanfid  # external, the parity target

        theirs = float(_cleanfid.compute_fid(d1, d2, mode="clean"))
    except ImportError:
        spread = abs(ours - our_fid("bilinear"))
        return [_result(
            "fid", "SKIPPED",
            f"clean-fid not installed; ours(clean)={ours:.4f}, clean-vs-bilinear spread "
            f"{spread:.4f} (install clean-fid on the parity machine for the binding check)",
            ours)]
    tol = max(0.02, 0.005 * theirs)
    ok = abs(ours - theirs) <= tol
    return [_result("fid", "PASS" if ok else "FAIL",
                    f"ours {ours:.4f} vs clean-fid {theirs:.4f} (|Δ| ≤ {tol:.4f})", ours)]


STAGES = {"weights": stage_weights, "feat": stage_feat, "cluster": stage_cluster,
          "inception": stage_inception, "fid": stage_fid}


def run_stage(name: str, args) -> list[dict]:
    try:
        return STAGES[name](args)
    except (RuntimeError, AssertionError, ValueError) as e:
        # a golden mismatch raises (weight_verify._check): that is the parity
        # failure this runbook reports, as a FAIL line, so the later stages
        # still run and the summary and exit code hold
        return [_result(name, "FAIL", f"{type(e).__name__}: {e}")]


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description="quality-parity runbook (one command per stage)")
    p.add_argument("--stage", default="all", choices=["all", *STAGES])
    p.add_argument("--data-root", default="~/data")
    p.add_argument("--out-root", default="~/data/sg_data")
    p.add_argument("--ds", default="in32p")
    p.add_argument("--feat", default="dino_vitb16")
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--k", type=int, default=5000)
    p.add_argument("--nmi-floor", type=float, default=0.50)
    p.add_argument("--feat-h5", default=None)
    p.add_argument("--dino_vitb16", default=None)
    p.add_argument("--dino_vits16", default=None)
    p.add_argument("--clip-weights", default=None)
    p.add_argument("--clip-bpe", default=None)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--fid-dir1", default=None)
    p.add_argument("--fid-dir2", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..device import resolve_device

    args.device = resolve_device(args.device)
    stages = list(STAGES) if args.stage == "all" else [args.stage]
    results: list[dict] = []
    for s in stages:
        results.extend(run_stage(s, args))
    summary = {"parity_runbook": results,
               "failed": sum(r["status"] == "FAIL" for r in results)}
    print(json.dumps(summary))
    if summary["failed"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
