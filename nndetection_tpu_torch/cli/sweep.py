"""Sweep the post-processing parameters of a trained fold (counterpart of
``nndet_sweep``)."""
from __future__ import annotations

from nndetection_tpu_torch.cli.common import (
    base_parser,
    resolve_cli_device,
    resolve_model_dir,
    resolve_task,
    setup_logging,
)
from nndetection_tpu_torch.pipeline import run_sweep
from nndetection_tpu_torch.utils.config import compose


def main() -> None:
    parser = base_parser("Sweep postprocessing parameters")
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("--no_tta", action="store_true")
    args = parser.parse_args()
    cfg = compose(overrides=args.overrides)
    device = resolve_cli_device(cfg)
    task_dir = resolve_task(args.task)
    model_dir = resolve_model_dir(task_dir, cfg["module"], cfg["plan"])
    setup_logging(model_dir / f"fold{args.fold}" / "sweep.log")
    run_sweep(task_dir, model_dir, fold=args.fold, plan_id=cfg["plan"], tta=not args.no_tta,
              device=device)


if __name__ == "__main__":
    main()
