"""LUNA-proxy cross-validation: accuracy at scale, from raw ``.mhd`` files to
a CPM, on the port.

The port's counterpart of the repository's ``scripts_dev/luna_proxy.py``,
driven by arguments instead of ``PROXY_*`` environment knobs. It runs the
pipeline nnDetection runs for its published LUNA result (cross-validated
FROC/CPM):

    generate -> Task016 convert -> prep (plan + preprocess) ->
    train and sweep each fold -> consolidate ->
    restored validation predictions -> pooled -> world-coordinate CPM csv ->
    official-semantics FROC/CPM over the scored folds' validation series ->
    box-AP evaluation of the pool.

Stage 1 writes the synthetic LUNA16-layout dataset
(:mod:`nndetection_tpu_torch.data.luna_proxy`) into ``root/raw`` unless
``root/raw/annotations.csv`` exists: put real LUNA16 (``subset*/``,
``annotations.csv``) there and the same run uses it.

Every stage is resume-safe: ``dataset.yaml`` ends the conversion, the plan
pickle the prep, ``fold{k}/.train_done`` a fold's training (an interrupted
fold resumes from ``model_last.ckpt``), ``fold{k}/plan_inference.pkl`` its
sweep and ``consolidated/plan_inference.pkl`` the consolidation;
validation predictions older than the swept parameters are made again.

    python -m nndetection_tpu_torch.projects.Task016_Luna.proxy_cv \\
        --root /data/luna_proxy --num-cases 125 --inplane 256 --epochs 16 \\
        --steps 400 --swa-epochs 2 --val-steps 20 --warmup 320 --batch-size 8

Every stage that touches a device runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from nndetection_tpu_torch.projects.Task016_Luna import prepare as task016  # noqa: E402

MAP_KEY = "mAP_IoU_0.10_0.50_0.05_MaxDet_100"
TASK_NAME = "Task916_LunaProxy"
MODULE = "RetinaUNetV001"


def rss_gb() -> float:
    """This process's resident host memory in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024 / 1024
    return -1.0


def pool_and_score(task_dir, raw_dir, model_dir, folds: Sequence[int],
                   device="cuda", log=print) -> Dict[str, Any]:
    """Stage 7: pool the folds' ``val_predictions`` into
    ``model_dir/cv_predictions``, export them as the LUNA CPM csv
    (``model_dir/cpm_predictions.csv``), score it over the union of the
    folds' validation series (a series without a prediction counts its
    nodules as misses) and evaluate the pool's boxes. Returns ``cpm``,
    ``box_metrics`` and ``missing`` (the series without a prediction)."""
    from nndetection_tpu_torch.pipeline import run_evaluate
    from nndetection_tpu_torch.utils.io import load_pickle

    task_dir, raw_dir, model_dir = Path(task_dir), Path(raw_dir), Path(model_dir)
    pooled = model_dir / "cv_predictions"
    pooled.mkdir(exist_ok=True)
    for fold in folds:
        for p in (model_dir / f"fold{fold}" / "val_predictions").glob("*_boxes.pkl"):
            dst = pooled / p.name
            if not dst.exists() or p.stat().st_mtime > dst.stat().st_mtime:
                shutil.copy(p, dst)

    cpm_csv = model_dir / "cpm_predictions.csv"
    task016.export_cpm(pooled, task_dir / "raw_splitted" / "labelsTr", cpm_csv)
    # the scored series are the union of the scored folds' validation splits,
    # not the prediction pickles that exist
    splits = load_pickle(task_dir / "preprocessed" / "splits_final.pkl")
    series = sorted({cid for f in folds for cid in splits[f]["val"]})
    predicted = {p.name[: -len("_boxes.pkl")] for p in pooled.glob("*_boxes.pkl")
                 if p.name != "results_boxes.pkl"}
    missing = sorted(set(series) - predicted)
    if missing:
        log(f"WARNING: {len(missing)} val cases have no prediction pickle (scored as all-miss): "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    cpm = task016.score_cpm(cpm_csv, raw_dir / "annotations.csv", series=series)
    log(f"CPM={cpm['cpm']:.4f} FROC={cpm['froc']}")
    box_metrics, _curves = run_evaluate(task_dir, pooled, split="Tr", device=device)
    log(f"box eval mAP={box_metrics.get(MAP_KEY)}")
    return dict(cpm=cpm, box_metrics=box_metrics, missing=missing, series=series)


def run_proxy_cv(
    root,
    num_cases: int,
    inplane: int,
    epochs: int,
    steps: int,
    swa_epochs: int,
    val_steps: int,
    warmup: int,
    folds: Sequence[int],
    batch_size: Optional[int] = None,
    device="cuda",
    out_json=None,
    planner=None,
    num_workers: int = 0,
) -> Dict[str, Any]:
    """The LUNA-proxy cross-validation under ``root`` (``raw/``,
    ``Task916_LunaProxy/``, ``models/Task916_LunaProxy/RetinaUNetV001/``):
    ``num_cases`` generated cases of ``inplane``² voxels per slice, ``folds``
    of the 5-fold split each trained for ``epochs`` + ``swa_epochs`` epochs
    of ``steps`` steps (``warmup`` warm-up iterations, ``val_steps``
    validation batches, ``batch_size`` or the plan's), swept, consolidated,
    their validation predictions pooled and scored.

    Writes ``out_json`` (``root/luna_proxy.json`` by default; the keys of
    the JAX script's artifact) and, after each fold, ``*_partial.json``
    beside it; returns the result. ``planner`` (``run_prep``'s default
    otherwise; on the CPU one with a budget) and ``num_workers`` (prep's
    host processes) go to ``run_prep``. ``device`` is the card unless the
    caller passes another (``"cpu"``)."""
    from nndetection_tpu_torch import resolve_device
    from nndetection_tpu_torch.data.luna_proxy import generate_luna_proxy
    from nndetection_tpu_torch.pipeline import (
        materialize_val_predictions,
        run_consolidate,
        run_prep,
        run_sweep,
        run_train,
    )
    from nndetection_tpu_torch.planning.planner import load_plan
    from nndetection_tpu_torch.utils.io import save_json

    dev = resolve_device(device)
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    root = Path(root)
    folds = [int(f) for f in folds]
    raw, task = root / "raw", root / TASK_NAME
    model_dir = root / "models" / task.name / MODULE
    out_json = Path(out_json) if out_json else root / "luna_proxy.json"
    stage_times: Dict[str, float] = {}
    rss_trace = []

    # ---- stage 1: generate
    if not (raw / "annotations.csv").exists():
        log(f"generating {num_cases} proxy cases (inplane={inplane})")
        t = time.time()
        generate_luna_proxy(raw, num_cases=num_cases, inplane=inplane)
        stage_times["generate"] = time.time() - t
    else:
        log("stage generate: already done")

    # ---- stage 2: convert (the Task016 converter)
    if not (task / "dataset.yaml").exists():
        log("converting via projects/Task016_Luna/prepare.py::convert")
        t = time.time()
        task016.convert(raw, task)
        stage_times["convert"] = time.time() - t
    else:
        log("stage convert: already done")

    # ---- stage 3: prep
    plan_pkl = task / "preprocessed" / "D3V001_3d.pkl"
    if not plan_pkl.exists():
        log("prep: crop -> analyze -> plan -> preprocess")
        t = time.time()
        plan = run_prep(task, num_workers=num_workers, planner=planner, device=dev)
        stage_times["prep"] = time.time() - t
    else:
        plan = load_plan(plan_pkl)
    log(f"plan: patch={list(plan.patch_size)} batch={plan.batch_size} "
        f"spacing={np.round(plan.target_spacing, 3).tolist()} dummy2d={plan.do_dummy_2d}")

    trainer_overrides = dict(max_epochs=epochs, num_train_batches_per_epoch=steps,
                             num_val_batches_per_epoch=val_steps, swa_epochs=swa_epochs,
                             warm_iterations=warmup)
    if batch_size:
        trainer_overrides["batch_size"] = int(batch_size)

    # ---- stage 4: train + sweep per fold
    fold_summaries: Dict[int, Dict] = {}
    fold_histories: Dict[int, list] = {}
    for fold in folds:
        fold_dir = model_dir / f"fold{fold}"
        marker = fold_dir / ".train_done"
        hist_path = fold_dir / "train_history.jsonl"
        if marker.exists():
            log(f"fold {fold}: training already done")
        else:
            # a run that cannot resume must not append to a stale history
            if hist_path.exists() and not (fold_dir / "model_last.ckpt").exists():
                log(f"fold {fold}: no resumable checkpoint, truncating stale history")
                hist_path.unlink()
            log(f"fold {fold}: training {epochs}+{swa_epochs} epochs x {steps} steps")
            t = time.time()
            fold_dir.mkdir(parents=True, exist_ok=True)
            with open(hist_path, "a") as hist_f:
                def log_epoch(epoch, metrics, fold=fold, hist_f=hist_f):
                    row = {"epoch": epoch, "rss_gb": round(rss_gb(), 3),
                           **{k: round(float(v), 5) for k, v in metrics.items()
                              if np.isscalar(v) or getattr(v, "ndim", 1) == 0}}
                    rss_trace.append(row["rss_gb"])
                    hist_f.write(json.dumps(row) + "\n")
                    hist_f.flush()
                    log(f"fold {fold} epoch {epoch}: "
                        f"mAP={metrics.get(MAP_KEY, float('nan')):.4f} "
                        f"loss={metrics.get('train_total', float('nan')):.4f} "
                        f"nonfinite={metrics.get('train_nonfinite_steps', 0):.0f} "
                        f"rss={row['rss_gb']:.2f}GB")

                run_train(task, model_dir, fold=fold, trainer_overrides=trainer_overrides,
                          log_fn=log_epoch, resume=True, device=dev)
            marker.write_text(json.dumps(trainer_overrides))
            stage_times[f"train_fold{fold}"] = time.time() - t
        if not (fold_dir / "plan_inference.pkl").exists():
            log(f"fold {fold}: postprocessing sweep")
            t = time.time()
            sweep_res = run_sweep(task, model_dir, fold, device=dev)
            stage_times[f"sweep_fold{fold}"] = time.time() - t
            log(f"fold {fold}: sweep best score {sweep_res.get('score', 'n/a')}")
        if hist_path.exists():
            rows = [json.loads(line) for line in hist_path.read_text().splitlines()]
            if rows:
                fold_summaries[fold] = rows[-1]
                fold_histories[fold] = rows
        # the completed folds' evidence survives a run cut short
        save_json({"completed_folds": sorted(fold_summaries),
                   "fold_final_epochs": fold_summaries,
                   "fold_histories": fold_histories,
                   "stage_times_s": {k: round(v, 1) for k, v in stage_times.items()}},
                  out_json.with_name(out_json.stem + "_partial.json"))

    # ---- stage 5: consolidate
    if not (model_dir / "consolidated" / "plan_inference.pkl").exists():
        log("consolidate: unified cross-fold sweep")
        t = time.time()
        run_consolidate(task, model_dir, num_folds=max(folds) + 1, device=dev)
        stage_times["consolidate"] = time.time() - t

    # ---- stage 6: restored validation predictions from the sweep's states
    for fold in folds:
        out = model_dir / f"fold{fold}" / "val_predictions"
        existing = list(out.glob("*_boxes.pkl"))
        # predictions older than the swept parameters are made again
        plan_mtimes = [p.stat().st_mtime for p in (
            model_dir / "consolidated" / "plan_inference.pkl",
            model_dir / f"fold{fold}" / "plan_inference.pkl") if p.exists()]
        if existing and (not plan_mtimes or min(q.stat().st_mtime for q in existing)
                         >= max(plan_mtimes)):
            log(f"fold {fold}: val predictions already exist")
            continue
        log(f"fold {fold}: restored val predictions from sweep states")
        t = time.time()
        materialize_val_predictions(task, model_dir, fold, device=dev)
        stage_times[f"predict_fold{fold}"] = time.time() - t

    # ---- stage 7: CPM + box AP on the pooled predictions
    t = time.time()
    scored = pool_and_score(task, raw, model_dir, folds, device=dev, log=log)
    stage_times["score"] = time.time() - t
    box_metrics = scored["box_metrics"]
    result = {
        "config": {
            "num_cases": num_cases, "inplane": inplane, "epochs": epochs, "steps": steps,
            "swa_epochs": swa_epochs, "warmup": warmup, "folds": folds,
            "batch_size": int(batch_size or plan.batch_size),
            "patch_size": [int(p) for p in plan.patch_size],
            "target_spacing": [float(s) for s in plan.target_spacing],
        },
        "cpm": scored["cpm"],
        "box_eval": {k: round(float(v), 4) for k, v in box_metrics.items()
                     if isinstance(v, (int, float)) and ("AP" in k or "FROC" in k)},
        "fold_final_epochs": fold_summaries,
        "fold_histories": fold_histories,
        "telemetry": {
            "stage_times_s": {k: round(v, 1) for k, v in stage_times.items()},
            "rss_gb_max": max(rss_trace) if rss_trace else None,
        },
        "reference_bar": {
            "luna16_cpm_10fold": 0.930,
            "note": "real LUNA16 is not available; this is the synthetic proxy",
        },
        "in_stats_provenance": "one instance-norm schedule, the model config's, in every "
                               "fold and epoch of this run",
    }
    out_json.parent.mkdir(parents=True, exist_ok=True)
    save_json(result, out_json)
    log(f"wrote {out_json}")
    return result


def main() -> None:
    p = argparse.ArgumentParser(description="LUNA-proxy cross-validation, raw .mhd to CPM")
    p.add_argument("--root", required=True, help="working directory (raw/, the task, models/)")
    p.add_argument("--num-cases", type=int, default=125)
    p.add_argument("--inplane", type=int, default=256)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--swa-epochs", type=int, default=2)
    p.add_argument("--val-steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=None,
                   help="warm-up iterations (default max(200, epochs * steps // 20))")
    p.add_argument("--folds", type=str, default="0,1,2,3,4")
    p.add_argument("--batch-size", type=int, default=None, help="default: the plan's")
    p.add_argument("--num-workers", type=int, default=0, help="prep's host processes")
    p.add_argument("--out", type=str, default=None, help="result JSON (root/luna_proxy.json)")
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args()
    warmup = a.warmup if a.warmup is not None else max(200, a.epochs * a.steps // 20)
    run_proxy_cv(a.root, a.num_cases, a.inplane, a.epochs, a.steps, a.swa_epochs, a.val_steps,
                 warmup, [int(f) for f in a.folds.split(",")], batch_size=a.batch_size,
                 device=a.device, out_json=a.out, num_workers=a.num_workers)


if __name__ == "__main__":
    main()
