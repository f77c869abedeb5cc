"""Tiny cells for the benchmark's CPU tests: the float32 configurations of
``data/``, small mixes, and a run of the harness on the CPU that returns the
result line."""
from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
# limits of the tiny float32 cells: the program casts a case to bfloat16
# before tiling, so its forward differs from the float32 reference by
# ~3e-3 there; everything else agrees to rounding
PREDICT_LIMITS = {"fwd_cls_err": 1e-2, "fwd_reg_err": 1e-2, "post_mismatch": 0,
                  "case_mismatch": 0}
TRAIN_LIMITS = {"cut_mismatch": 0, "aug_img_err": 1e-5, "target_mismatch": 0,
                "fwd_cls_err": 1e-3, "fwd_reg_err": 1e-3, "loss_gap": 1e-3,
                "grad_gap_med": 1e-3, "update_gap_med": 1e-3}


def config(name: str) -> dict:
    return harness.load_json(DATA / f"{name}.json")


def predict_cell(models: int = 1, tta: bool = False) -> dict:
    return {"name": "tiny.predict", "config": "tiny3d", "traffic": "tiny", "chips": 1,
            "entry": "predict", "models": models, "tta": tta,
            "ensembler": "BoxEnsemblerSelective",
            "mix": {"kind": "cases", "shapes": [[24, 40, 48], [40, 56, 40]], "objects": [1, 3],
                    "radius": [2.0, 5.0], "contrast": 2.0},
            "check": {"forward_cases": 2, "forward_tiles": 4, "cases": 2},
            "limits": dict(PREDICT_LIMITS)}


def train_cell(dim: int = 3) -> dict:
    shape = [48, 56, 52] if dim == 3 else [80, 72]
    return {"name": "tiny.train", "config": f"tiny{dim}d", "traffic": "tiny", "chips": 1,
            "entry": "train_pool",
            "mix": {"kind": "train_cases", "n_cases": 4, "shape": shape, "instances": [1, 3],
                    "radius": [3.0, 6.0], "classes": 1 if dim == 3 else 2, "contrast": 2.0,
                    "resident_cases": 2, "swaps_per_epoch": 1, "steps_per_epoch": 3},
            "check": {"steps": 3}, "limits": dict(TRAIN_LIMITS)}


def bench_for(cell: dict) -> dict:
    """``BENCHMARK.json`` with the tiny cell added to its metrics."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [cell["name"]]
    return bench


def run_cell(cell: dict, seed: int = 2147483659, seconds: float = 1.0) -> dict:
    """One run of the harness on the CPU; the result line as a dict."""
    torch.manual_seed(0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell["name"], "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0"], device="cpu",
                         bench=bench_for(cell), cell=cell, config=config(cell["config"]))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def entry_after_window(cell: dict, seed: int = 2147483659, seconds: float = 1.0):
    """The cell's entry after set-up, a window and release, as the
    calibration leaves it for its checks."""
    cfg = config(cell["config"])
    run = harness.Run(bench=bench_for(cell), workload=cell, config=cfg, seed=seed,
                      seconds=seconds, trace=False, device=torch.device("cpu"),
                      spans=harness.Spans(False))
    entry = harness.load_piece("entries", cell["entry"]).Entry(run)
    entry.window(seconds)
    entry.release()
    return entry
