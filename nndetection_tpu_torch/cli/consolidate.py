"""Copy the trained folds into ``consolidated/`` and sweep their pooled
states (counterpart of ``nndet_consolidate``)."""
from __future__ import annotations

from nndetection_tpu_torch.cli.common import (
    base_parser,
    resolve_cli_device,
    resolve_model_dir,
    resolve_task,
    setup_logging,
)
from nndetection_tpu_torch.pipeline import run_consolidate
from nndetection_tpu_torch.utils.config import compose


def main() -> None:
    parser = base_parser("Consolidate trained folds")
    parser.add_argument("--num_folds", type=int, default=5)
    args = parser.parse_args()
    cfg = compose(overrides=args.overrides)
    device = resolve_cli_device(cfg)
    task_dir = resolve_task(args.task)
    model_dir = resolve_model_dir(task_dir, cfg["module"], cfg["plan"])
    setup_logging(model_dir / "consolidate.log")
    run_consolidate(task_dir, model_dir, num_folds=args.num_folds, plan_id=cfg["plan"],
                    device=device)


if __name__ == "__main__":
    main()
