"""JSON and pickle helpers (copy of the part of
:mod:`nndetection_tpu.utils.io` that ensembler states and the sweep use)."""
from __future__ import annotations

import json
import os
import pickle
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
