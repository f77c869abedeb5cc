"""JSON, pickle, YAML and npz helpers (copy of
:mod:`nndetection_tpu.utils.io`). PyYAML is imported when a YAML file is
read or written, never when this module is imported."""
from __future__ import annotations

import json
import os
import pickle
import time
from pathlib import Path
from typing import Any, Union

import numpy as np

PathLike = Union[str, Path]


def _atomic_write(path: Path, write_fn, mode: str) -> None:
    """Write via a sibling temp file and ``os.replace``, so that a kill
    mid-write never leaves a truncated file at ``path`` (later stages take an
    existing output file as done)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        with open(tmp, mode) as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink(missing_ok=True)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def save_json(data: Any, path: PathLike) -> None:
    _atomic_write(Path(path), lambda f: json.dump(data, f, indent=2, default=_json_default), "w")


def save_pickle(data: Any, path: PathLike) -> None:
    _atomic_write(Path(path), lambda f: pickle.dump(data, f), "wb")


def load_pickle(path: PathLike) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_json(path: PathLike) -> Any:
    with open(path) as f:
        return json.load(f)


def save_yaml(data: Any, path: PathLike) -> None:
    import yaml

    _atomic_write(Path(path), lambda f: yaml.safe_dump(data, f), "w")


def load_yaml(path: PathLike) -> Any:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_npz_looped(path: PathLike, keys=None, num_tries: int = 3) -> dict:
    """Retry-looped npz load, the data-integrity check of the reference's
    preprocessing."""
    last_err = None
    for i in range(num_tries):
        try:
            with np.load(path, allow_pickle=True) as f:
                if keys is None:
                    return {k: f[k] for k in f.files}
                return {k: f[k] for k in keys}
        except Exception as e:  # noqa: BLE001 - retried, then raised
            last_err = e
            time.sleep(0.5 * (i + 1))
    raise RuntimeError(f"failed to load {path} after {num_tries} tries") from last_err
