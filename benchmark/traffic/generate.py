"""The one generator of the benchmark's traffic: it reads a mix's data file
(``benchmark/traffic/<mix>.json``) and makes its inputs from the run's seed.

Two kinds of mix:

* ``cases``: whole volumes for prediction, one of each shape in
  ``shapes``; noise with brighter ellipsoids, as CT intensities look after
  nnDetection's normalisation. The cases are made once, on the device, and
  kept on the host; the order in which they are sent changes with the seed
  (``order``), the set never does.
* ``train_cases``: preprocessed training cases as ``run_prep`` leaves them
  (``{case}.npy`` holding ``[image, instance ids]`` and
  ``{case}_boxes.pkl``), written under a directory the caller owns; ellipsoid
  (ellipse in 2D) instances, brighter than the noise, of the classes in
  turn. ``storage`` sets the ``.npy`` type, float16 by default, so that a
  run writes half of what float32 would.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

TRAFFIC = Path(__file__).resolve().parent


def load(name: str) -> dict:
    with open(TRAFFIC / f"{name}.json") as f:
        return json.load(f)


def _objects(rng: np.random.Generator, shape, n: int, radius) -> List[tuple]:
    """``n`` ellipsoids inside ``shape``: ``(lo, hi, inside-mask)``."""
    out = []
    for _ in range(n):
        r = rng.uniform(radius[0], radius[1], len(shape))
        centre = rng.uniform(r + 2, np.asarray(shape) - r - 2)
        lo = np.floor(centre - r).astype(int)
        hi = np.ceil(centre + r).astype(int) + 1
        grid = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij")
        inside = sum(((g - m) / rr) ** 2 for g, m, rr in zip(grid, centre, r)) <= 1.0
        out.append((lo, hi, inside))
    return out


def case_volumes(mix: dict, seed: int, device) -> List[np.ndarray]:
    """One float32 ``[1, *shape]`` host volume for each shape of the mix."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    cases = []
    for shape in mix["shapes"]:
        vol = torch.randn((1, *shape), generator=gen, device=device).cpu().numpy()
        n = int(rng.integers(mix["objects"][0], mix["objects"][1] + 1))
        for lo, hi, inside in _objects(rng, shape, n, mix["radius"]):
            region = (0,) + tuple(slice(a, b) for a, b in zip(lo, hi))
            vol[region][inside] += mix["contrast"]
        cases.append(vol)
    return cases


def order(mix: dict, seed: int, n_rounds: int) -> List[int]:
    """Indices into the mix's shapes, each round a seeded permutation of
    them all."""
    rng = np.random.default_rng(seed)
    return [int(i) for _ in range(n_rounds) for i in rng.permutation(len(mix["shapes"]))]


def write_train_cases(mix: dict, seed: int, directory: Path) -> Dict[str, tuple]:
    """Writes ``n_cases`` training cases under ``directory``; returns each
    case id's shape."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    shape = tuple(mix["shape"])
    storage = np.dtype(mix.get("storage", "float16"))
    ids = {}
    for c in range(mix["n_cases"]):
        arr = np.empty((2, *shape), storage)
        arr[0] = rng.standard_normal(shape, dtype=np.float32)
        arr[1] = 0
        boxes, classes = [], []
        n_inst = int(rng.integers(mix["instances"][0], mix["instances"][1] + 1))
        for iid, (lo, hi, inside) in enumerate(_objects(rng, shape, n_inst, mix["radius"]),
                                               start=1):
            region = tuple(slice(a, b) for a, b in zip(lo, hi))
            arr[1][region][inside] = iid
            arr[0][region][inside] += mix["contrast"]
            where = np.nonzero(inside)
            b_lo = [int(w.min()) + a for w, a in zip(where, lo)]
            b_hi = [int(w.max()) + a + 1 for w, a in zip(where, lo)]
            box = [b_lo[0], b_lo[1], b_hi[0], b_hi[1]] + (
                [b_lo[2], b_hi[2]] if len(shape) == 3 else [])
            boxes.append(box)
            classes.append((c + iid - 1) % mix["classes"])
        cid = f"case_{c:03d}"
        np.save(directory / f"{cid}.npy", arr)
        with open(directory / f"{cid}_boxes.pkl", "wb") as f:
            pickle.dump({"boxes": np.asarray(boxes, np.float32),
                         "classes": np.asarray(classes, np.int64),
                         "instance_ids": np.arange(1, n_inst + 1, dtype=np.int64)}, f)
        ids[cid] = shape
    return ids
