"""File-based experiment tracking (counterpart of
:mod:`nndetection_tpu.utils.tracking`): ``run_meta.json`` and
``params.json`` once per run, one ``metrics.jsonl`` row per epoch.

``run_meta.json`` records the torch version, its CUDA version and the CUDA
device's name where the JAX package records the JAX backend."""
from __future__ import annotations

import json
import platform
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch


class RunTracker:
    def __init__(self, run_dir, params: Optional[Dict[str, Any]] = None,
                 tags: Optional[Dict[str, str]] = None, device=None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        dev = torch.device(device) if device is not None else None
        meta = {
            "start_time": time.time(),
            "host": platform.node(),
            "platform": platform.platform(),
            "python": platform.python_version(),
            "tags": tags or {},
            "torch_version": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "device": str(dev) if dev is not None else None,
            "cuda_device_name": (torch.cuda.get_device_name(dev)
                                 if dev is not None and dev.type == "cuda" else None),
        }
        try:
            meta["framework_git"] = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=Path(__file__).resolve().parent,
                capture_output=True, text=True, timeout=5,
            ).stdout.strip() or None
        except Exception:  # noqa: BLE001 - tracking never breaks a run
            meta["framework_git"] = None
        with open(self.run_dir / "run_meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)
        if params is not None:
            with open(self.run_dir / "params.json", "w") as f:
                json.dump(params, f, indent=2, default=str)

    def log_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def read_metrics(self):
        if not self.metrics_path.exists():
            return []
        with open(self.metrics_path) as f:
            return [json.loads(line) for line in f if line.strip()]
