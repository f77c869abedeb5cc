"""Utility entry points (counterparts of ``nndet_unpack``,
``nndet_boxes2nii``, ``nndet_seg2nii``, ``nndet_env`` and
``nndet_searchpath``). Run as ``python -m nndetection_tpu_torch.cli.utils
<unpack|boxes2nii|seg2nii|env|searchpath> [arguments]``; ``env`` without
a command."""
from __future__ import annotations

import argparse
import os
import platform
import sys
from pathlib import Path

import numpy as np

from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.data.preprocess import unpack_dataset
from nndetection_tpu_torch.utils.io import load_pickle


def main_unpack() -> None:
    parser = argparse.ArgumentParser(description="Unpack npz -> npy for memmaps")
    parser.add_argument("dir", type=str)
    args = parser.parse_args()
    unpack_dataset(args.dir)


def main_boxes2nii() -> None:
    """Export box predictions as a labelled NIfTI volume for visualization."""
    from nndetection_tpu_torch.utils.analysis import convert_boxes_to_mask
    from nndetection_tpu_torch.utils.io import save_json

    parser = argparse.ArgumentParser(description="Export boxes to nii masks")
    parser.add_argument("pred_dir", type=str)
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--shape_dir", type=str, default=None,
                        help="dir with {case}.pkl props for target shapes")
    parser.add_argument("--score_thresh", type=float, default=0.0)
    args = parser.parse_args()
    pred_dir, out_dir = Path(args.pred_dir), Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in sorted(pred_dir.glob("*_boxes.pkl")):
        # a box evaluation's results are not a case (the JAX command reads
        # them as one and fails)
        if p.name == "results_boxes.pkl":
            continue
        cid = p.name[: -len("_boxes.pkl")]
        pred = load_pickle(p)
        boxes = np.asarray(pred["pred_boxes"])
        scores = np.asarray(pred["pred_scores"])
        keep = scores >= args.score_thresh
        boxes = boxes[keep]
        if args.shape_dir and (Path(args.shape_dir) / f"{cid}.pkl").exists():
            props = load_pickle(Path(args.shape_dir) / f"{cid}.pkl")
            shape = props.get("shape_after_resampling") or props.get("shape_after_crop")
        else:
            shape = tuple(int(np.ceil(boxes[:, i].max())) + 1 if len(boxes) else 64
                          for i in (2, 3, 5))
        vol, meta = convert_boxes_to_mask(boxes, scores[keep],
                                          np.asarray(pred["pred_labels"])[keep], shape)
        nifti.save(out_dir / f"{cid}_boxes.nii.gz", vol.astype(np.int16))
        # per-instance score and label
        save_json(meta, out_dir / f"{cid}_boxes.json")
    print(f"exported {out_dir}")


def main_seg2nii() -> None:
    parser = argparse.ArgumentParser(description="Export seg npz to nii")
    parser.add_argument("pred_dir", type=str)
    parser.add_argument("out_dir", type=str)
    args = parser.parse_args()
    pred_dir, out_dir = Path(args.pred_dir), Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in sorted(pred_dir.glob("*_seg.npz")):
        cid = p.name[: -len("_seg.npz")]
        with np.load(p) as f:
            nifti.save(out_dir / f"{cid}_seg.nii.gz", f["seg"].astype(np.int16))
    print(f"exported {out_dir}")


def main_env() -> None:
    """Environment dump: Python, PyTorch, CUDA and the card."""
    import torch

    print(f"python: {sys.version.split()[0]} on {platform.platform()}")
    print(f"torch: {torch.__version__}")
    print(f"cuda: {torch.version.cuda or 'none (a CPU build)'}")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: {names}")
    else:
        print("devices: no CUDA device")
    for var in ("det_data", "det_models", "det_num_threads", "det_verbose"):
        print(f"{var}={os.environ.get(var, '<unset>')}")


def main_searchpath() -> None:
    """Where the composed config comes from: built-in defaults, the
    optional per-task yaml, and CLI dot overrides."""
    print("Found config sources:")
    print("---------------------")
    print("defaults: nndetection_tpu_torch.utils.config.DEFAULT_CONFIG")
    task = os.environ.get("det_data", "<det_data unset>")
    print(f"task yaml: <task_dir>/config.yaml under det_data={task}")
    print("overrides: -o key=value CLI dot-list (applied last); device=cpu runs on the CPU")


COMMANDS = {"unpack": main_unpack, "boxes2nii": main_boxes2nii, "seg2nii": main_seg2nii,
            "env": main_env, "searchpath": main_searchpath}


def main() -> None:
    """Run the command named by the first argument (``env`` without one)."""
    name = sys.argv[1] if len(sys.argv) > 1 else "env"
    if name not in COMMANDS:
        raise SystemExit(f"unknown command {name!r}; known: {', '.join(COMMANDS)}")
    sys.argv = [f"{sys.argv[0]} {name}"] + sys.argv[2:]
    COMMANDS[name]()


if __name__ == "__main__":
    main()
