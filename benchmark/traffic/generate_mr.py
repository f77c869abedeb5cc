"""Multi-sequence MR training cases: the generator of ``train_mr_cases``
mixes (``benchmark/traffic/<mix>.json``), beside :mod:`.generate`, whose
ellipsoids it draws.

A case is what ``run_prep`` leaves for a task of several co-registered
sequences: ``{case}.npy`` holding ``[sequence_0, ..., sequence_{C-1},
instance ids]`` and ``{case}_boxes.pkl``. Each sequence is unit noise; a
lesion is an ellipsoid whose radius is drawn per axis from ``radius`` (one
``[lo, hi]`` per axis, so that a lesion spans few slices of a thick-slice
series and many voxels in plane), and it shifts each sequence by that
sequence's entry of ``contrast`` (darker or brighter). Classes are taken in
turn, as :func:`.generate.write_train_cases` takes them.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict

import numpy as np

from benchmark.traffic import generate


def write_mr_cases(mix: dict, seed: int, directory: Path) -> Dict[str, tuple]:
    """Writes ``n_cases`` cases of ``len(mix["contrast"])`` sequences under
    ``directory``; returns each case id's shape."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    shape = tuple(mix["shape"])
    contrast = np.asarray(mix["contrast"], np.float32)
    channels = len(contrast)
    radius = (np.asarray([r[0] for r in mix["radius"]], np.float64),
              np.asarray([r[1] for r in mix["radius"]], np.float64))
    storage = np.dtype(mix.get("storage", "float16"))
    ids = {}
    for c in range(mix["n_cases"]):
        arr = np.empty((channels + 1, *shape), storage)
        for ch in range(channels):
            arr[ch] = rng.standard_normal(shape, dtype=np.float32)
        arr[channels] = 0
        boxes, classes = [], []
        n_inst = int(rng.integers(mix["instances"][0], mix["instances"][1] + 1))
        for iid, (lo, hi, inside) in enumerate(generate._objects(rng, shape, n_inst, radius),
                                               start=1):
            region = tuple(slice(a, b) for a, b in zip(lo, hi))
            arr[channels][region][inside] = iid
            for ch in range(channels):
                arr[ch][region][inside] += contrast[ch]
            where = np.nonzero(inside)
            b_lo = [int(w.min()) + a for w, a in zip(where, lo)]
            b_hi = [int(w.max()) + a + 1 for w, a in zip(where, lo)]
            boxes.append([b_lo[0], b_lo[1], b_hi[0], b_hi[1], b_lo[2], b_hi[2]])
            classes.append((c + iid - 1) % mix["classes"])
        cid = f"case_{c:03d}"
        np.save(directory / f"{cid}.npy", arr)
        with open(directory / f"{cid}_boxes.pkl", "wb") as f:
            pickle.dump({"boxes": np.asarray(boxes, np.float32),
                         "classes": np.asarray(classes, np.int64),
                         "instance_ids": np.arange(1, n_inst + 1, dtype=np.int64)}, f)
        ids[cid] = shape
    return ids
