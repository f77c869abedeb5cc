"""The configuration of the command line (copy of
:mod:`nndetection_tpu.utils.config`): defaults -> per-task YAML -> ``-o
key=value`` dot-list overrides, with environment interpolation
(``${env:det_data}``) for paths. The port adds one key, ``device``: the
card unless an override names another (``-o device=cpu``).

PyYAML is imported only where YAML is read: a task file, or the value of
an override.
"""
from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?::([^}]*))?\}")


def _interp(value: Any) -> Any:
    if isinstance(value, str):
        def sub(m):
            return os.environ.get(m.group(1), m.group(2) or "")

        return _ENV_RE.sub(sub, value)
    if isinstance(value, dict):
        return {k: _interp(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_interp(v) for v in value]
    return value


def _parse_scalar(text: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def set_dotted(cfg: Dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def get_dotted(cfg: Dict, key: str, default=None) -> Any:
    node = cfg
    for p in key.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node


def merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


DEFAULT_CONFIG: Dict[str, Any] = {
    "module": "RetinaUNetV001",
    "plan": "D3V001_3d",
    "planner": "D3V001",
    "augment_cfg": {
        "augmentation": "base_more",
        "oversample_foreground_percent": 0.5,
    },
    "trainer_cfg": {
        "max_num_epochs": 50,
        "num_train_batches_per_epoch": 2500,
        "num_val_batches_per_epoch": 100,
        "batch_size": None,  # None -> from plan
        "initial_lr": 0.01,
        "sgd_momentum": 0.9,
        "sgd_nesterov": True,
        "weight_decay": 3.0e-5,
        "warm_iterations": 4000,
        "warm_lr": 1.0e-6,
        "poly_gamma": 0.9,
        "swa_epochs": 10,
        "monitor_key": "mAP_IoU_0.10_0.50_0.05_MaxDet_100",
        "seed": 42,
    },
    "model_cfg": {
        "plan_arch_overwrites": {},
        "plan_anchors_overwrites": {},
    },
}

# the device of every entry point when no override names one
DEFAULT_DEVICE = "cuda"


def compose(
    task_config: Optional[Path] = None,
    overrides: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Defaults -> optional task yaml -> ``key=value`` dot overrides."""
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if task_config is not None and Path(task_config).exists():
        import yaml

        with open(task_config) as f:
            cfg = merge(cfg, yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        set_dotted(cfg, k.strip(), _parse_scalar(v.strip()))
    return _interp(cfg)


def config_device(cfg: Dict[str, Any]) -> str:
    """The device a composed config names: ``cfg["device"]`` when an
    override or the task file sets it, else the card."""
    return str(cfg.get("device") or DEFAULT_DEVICE)


def load_additional_imports(cfg: Dict[str, Any]) -> None:
    """Import plugin modules listed under ``additional_imports`` so their
    registry entries become available."""
    import importlib

    for name in cfg.get("additional_imports", []) or []:
        importlib.import_module(name)


def env_paths() -> Dict[str, Path]:
    """Resolve the ``det_data`` / ``det_models`` environment contract."""
    data = os.environ.get("det_data")
    models = os.environ.get("det_models")
    if not data or not models:
        raise EnvironmentError(
            "det_data and det_models environment variables must be set; "
            "e.g. export det_data=/data det_models=/models"
        )
    return {"det_data": Path(data), "det_models": Path(models)}
