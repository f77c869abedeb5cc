"""Generate the synthetic toy task under ``det_data`` (counterpart of
``nndet_example``)."""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from nndetection_tpu_torch.data.example import generate_example_dataset


def main() -> None:
    parser = argparse.ArgumentParser(description="Generate toy example dataset")
    parser.add_argument("--full", action="store_true", help="1000/1000 cases")
    parser.add_argument("--num_train", type=int, default=None)
    parser.add_argument("--num_test", type=int, default=None)
    parser.add_argument("--size", type=int, default=256, help="cubic volume size")
    args = parser.parse_args()
    n_train = args.num_train or (1000 if args.full else 10)
    n_test = args.num_test or (1000 if args.full else 10)
    root = Path(os.environ.get("det_data", "."))
    task = generate_example_dataset(
        root / "Task000D3_Example",
        num_train=n_train,
        num_test=n_test,
        image_size=(args.size,) * 3,
        object_size=(args.size // 16, args.size // 8),
        object_width=max(args.size // 64, 2),
    )
    print(f"wrote toy dataset to {task}")


if __name__ == "__main__":
    main()
