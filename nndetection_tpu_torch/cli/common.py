"""Shared CLI plumbing: env contract, task resolution, logging, and the
device a command runs on."""
from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path
from typing import Any, Dict

import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.data.dataset import get_task_dir
from nndetection_tpu_torch.utils.config import config_device


def setup_logging(log_file: Path = None, verbose: bool = True) -> None:
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s | %(levelname)s | %(message)s",
        handlers=handlers,
        force=True,
    )


def resolve_task(task: str) -> Path:
    return get_task_dir(task)


def resolve_model_dir(task_dir: Path, module: str = "RetinaUNetV001", plan: str = "D3V001_3d") -> Path:
    models_root = Path(os.environ.get("det_models", "."))
    return models_root / task_dir.name / f"{module}_{plan}"


def resolve_cli_device(cfg: Dict[str, Any]) -> torch.device:
    """The device of a command: ``-o device=...`` when given, else the card;
    raises without CUDA unless the config names the CPU."""
    return resolve_device(config_device(cfg))


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("task", type=str, help="task name or id (e.g. Task000D3_Example)")
    p.add_argument(
        "-o", "--overrides", nargs="*", default=[],
        help="config overrides key=value (device=cpu runs on the CPU)",
    )
    return p
