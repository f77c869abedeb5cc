"""Dataset checks -> crop -> analyze -> plan -> preprocess (counterpart of
``nndet_prep``). The planner plans to the card's memory and confirms its
plan there."""
from __future__ import annotations

import logging

from nndetection_tpu_torch.cli.common import (
    base_parser,
    resolve_cli_device,
    resolve_task,
    setup_logging,
)
from nndetection_tpu_torch.pipeline import run_prep
from nndetection_tpu_torch.planning.planner import Planner
from nndetection_tpu_torch.utils.config import compose

log = logging.getLogger("nndet")


def check_dataset(task_dir, full: bool = False) -> None:
    """Schema + consistency checks of the raw task; raises on any problem."""
    from nndetection_tpu_torch.utils.check import check_data_and_label_consistency

    problems = check_data_and_label_consistency(task_dir, full=full)
    if problems:
        raise RuntimeError("dataset check failed:\n" + "\n".join(problems))
    log.info("dataset check passed")


def main() -> None:
    parser = base_parser("Plan and preprocess a dataset")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--full_check", action="store_true")
    parser.add_argument(
        "--force_patch_size", type=int, nargs=3, default=None,
        help="pin the patch (transposed z y x). A patch too large for one "
        "device is planned spatially partitioned (plan.n_model in {2,4}) "
        "instead of shrunk",
    )
    args = parser.parse_args()
    cfg = compose(overrides=args.overrides)
    device = resolve_cli_device(cfg)

    task_dir = resolve_task(args.task)
    setup_logging(task_dir / "preprocessed" / "prep.log")
    check_dataset(task_dir, full=args.full_check)
    planner = Planner(force_patch_size=args.force_patch_size, device=device)
    plan = run_prep(task_dir, num_workers=args.num_workers, planner=planner, device=device)
    log.info(
        f"plan {plan.plan_id}: patch={plan.patch_size} batch={plan.batch_size} "
        f"spacing={plan.target_spacing} anchors_score={plan.anchor_score:.3f} "
        f"mem={plan.mem_estimate_bytes / 1e9:.2f}GB lowres={plan.requires_lowres}"
        f" n_model={plan.n_model} remat={plan.remat}"
    )


if __name__ == "__main__":
    main()
