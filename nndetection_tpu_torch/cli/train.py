"""Train one fold, then optionally sweep its post-processing parameters
(counterpart of ``nndet_train``). In a multi-process job (the ``NNDET_*``
environment of :mod:`nndetection_tpu_torch.parallel.distributed`) every
rank runs this command; rank 0 alone writes ``metrics.json`` and sweeps
(the JAX package's command writes and sweeps on every process)."""
from __future__ import annotations

import logging

from nndetection_tpu_torch.cli.common import (
    base_parser,
    resolve_cli_device,
    resolve_model_dir,
    resolve_task,
    setup_logging,
)
from nndetection_tpu_torch.parallel import distributed
from nndetection_tpu_torch.pipeline import run_sweep, run_train
from nndetection_tpu_torch.utils.config import compose, get_dotted
from nndetection_tpu_torch.utils.io import save_json

log = logging.getLogger("nndet")


def trainer_overrides_from_cfg(cfg) -> dict:
    t = dict(cfg.get("trainer_cfg", {}))
    out = {
        "max_epochs": t.get("max_num_epochs", 50),
        "num_train_batches_per_epoch": t.get("num_train_batches_per_epoch", 2500),
        "num_val_batches_per_epoch": t.get("num_val_batches_per_epoch", 100),
        "initial_lr": t.get("initial_lr", 0.01),
        "sgd_momentum": t.get("sgd_momentum", 0.9),
        "sgd_nesterov": t.get("sgd_nesterov", True),
        "weight_decay": t.get("weight_decay", 3e-5),
        "warm_iterations": t.get("warm_iterations", 4000),
        "warm_lr": t.get("warm_lr", 1e-6),
        "poly_gamma": t.get("poly_gamma", 0.9),
        "swa_epochs": t.get("swa_epochs", 10),
        "monitor_key": t.get("monitor_key", "mAP_IoU_0.10_0.50_0.05_MaxDet_100"),
        "seed": t.get("seed", 42),
    }
    if t.get("batch_size"):
        out["batch_size"] = t["batch_size"]
    return out


def main() -> None:
    parser = base_parser("Train a fold")
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--no_aug", action="store_true")
    parser.add_argument(
        "--resume", action="store_true",
        help="continue from the fold's model_last.ckpt",
    )
    args = parser.parse_args()
    cfg = compose(overrides=args.overrides)
    device = resolve_cli_device(cfg)

    task_dir = resolve_task(args.task)
    model_dir = resolve_model_dir(task_dir, cfg["module"], cfg["plan"])
    setup_logging(model_dir / f"fold{args.fold}" / "train.log")

    metrics_log = []

    def log_fn(epoch, metrics):
        log.info(
            f"epoch {epoch}: "
            + " ".join(f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float))
        )
        metrics_log.append({"epoch": epoch, **metrics})

    out_dir = run_train(
        task_dir,
        model_dir,
        fold=args.fold,
        trainer_overrides=trainer_overrides_from_cfg(cfg),
        model_overrides=get_dotted(cfg, "model_cfg.plan_arch_overwrites", {}),
        plan_id=cfg["plan"],
        module=cfg["module"],
        augment=not args.no_aug,
        augmentation=get_dotted(cfg, "augment_cfg.augmentation", "base_more"),
        oversample=get_dotted(cfg, "augment_cfg.oversample_foreground_percent", 0.5),
        log_fn=log_fn,
        resume=args.resume,
        device=device,
    )
    if not distributed.is_main_process():
        return  # in a multi-process job rank 0 writes the files and sweeps
    save_json(metrics_log, out_dir / "metrics.json")
    if args.sweep:
        run_sweep(task_dir, model_dir, fold=args.fold, plan_id=cfg["plan"], device=device)


if __name__ == "__main__":
    main()
