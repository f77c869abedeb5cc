"""Prepare and predict the test split with the consolidated folds
(counterpart of ``nndet_predict``)."""
from __future__ import annotations

from nndetection_tpu_torch.cli.common import (
    base_parser,
    resolve_cli_device,
    resolve_model_dir,
    resolve_task,
    setup_logging,
)
from nndetection_tpu_torch.pipeline import run_predict_test
from nndetection_tpu_torch.utils.config import compose


def main() -> None:
    parser = base_parser("Predict test split")
    parser.add_argument("--no_tta", action="store_true")
    parser.add_argument("--num_folds", type=int, default=5)
    parser.add_argument(
        "--ensembler", default="BoxEnsemblerSelective",
        help="box ensembler variant (BoxEnsemblerSelective | BoxEnsembler | "
        "BoxEnsemblerLW | BoxEnsemblerFastest)",
    )
    args = parser.parse_args()
    cfg = compose(overrides=args.overrides)
    device = resolve_cli_device(cfg)
    task_dir = resolve_task(args.task)
    model_dir = resolve_model_dir(task_dir, cfg["module"], cfg["plan"])
    setup_logging(model_dir / "inference.log")
    run_predict_test(
        task_dir,
        model_dir,
        plan_id=cfg["plan"],
        tta=not args.no_tta,
        num_folds=args.num_folds,
        ensembler=args.ensembler,
        device=device,
    )


if __name__ == "__main__":
    main()
