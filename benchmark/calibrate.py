#!/usr/bin/env python3
"""The readings the check's limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --seconds 5 [--controls fp8 bf16 half_batch]

For each seed, one process-local run of the cell (set-up, a short window,
the program's state freed), then the check's numbers of the program (the
lower readings) and of each control (``fp8``: the reference in float8 in
the program's place; training only: ``bf16``, the reference rounded to
bfloat16, a witness of that precision, and ``half_batch``, the reference on
half of each batch, a fault), one JSON line each, with the worst
parameters of the training gaps (``diagnosis``) and, for training, each
captured epoch's numbers apart (``per_epoch``) and each step's losses on
both sides (``losses``). The benchmark's own runs
never run a control.
"""
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(BENCH_DIR))
    from benchmark import run as run_script

    run_script._environment()
    import argparse

    import torch

    from benchmark import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", nargs="*", default=["fp8"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("calibration runs on the card")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, config = harness.find_cell(bench, args.workload)
    os.environ["NNDET_IN_STATS"] = config["instance_norm_stats"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(bench=bench, workload=cell, config=config, seed=seed,
                          seconds=args.seconds, trace=False, device=torch.device("cuda"),
                          spans=harness.Spans(False))
        entry = harness.load_piece("entries", cell["entry"]).Entry(run)
        e2e = entry.window(args.seconds)
        entry.release()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"workload": cell["name"], "seed": seed, "window": e2e,
               "program": {c["name"]: c["value"] for c in entry.check()}}
        diagnosis = {"program": getattr(entry, "diagnosis", None)}
        row["per_epoch"] = {"program": getattr(entry, "readings", None)}
        row["losses"] = {"program": getattr(entry, "loss_pairs", None)}
        for control in args.controls:
            row[control] = {c["name"]: c["value"] for c in entry.check(control=control)}
            diagnosis[control] = getattr(entry, "diagnosis", None)
            row["per_epoch"][control] = getattr(entry, "readings", None)
            row["losses"][control] = getattr(entry, "loss_pairs", None)
        if diagnosis["program"] is not None:
            row["diagnosis"] = diagnosis
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del entry, run
        gc.collect()
        torch.cuda.empty_cache()
