"""Per-modality intensity normalization (copy of
:mod:`nndetection_tpu.data.normalize`):

* ``CT``: clip to the *global* (dataset-wide) foreground 0.5/99.5 percentiles,
  z-score with global foreground mean/std
* ``CT2``: clip to global percentiles, then per-case stats inside the clipped
  mask
* other (MR etc.): per-case z-score, optionally restricted to the nonzero
  mask (``seg != -1``) with outside set to 0
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def normalize_ct(
    data: np.ndarray,
    stats: Dict[str, float],
) -> np.ndarray:
    """Global-statistics CT normalization. ``stats`` needs keys
    ``percentile_00_5, percentile_99_5, mean, sd``."""
    lo, hi = stats["percentile_00_5"], stats["percentile_99_5"]
    out = np.clip(data, lo, hi)
    return (out - stats["mean"]) / max(stats["sd"], 1e-8)


def normalize_ct2(data: np.ndarray, stats: Dict[str, float]) -> np.ndarray:
    lo, hi = stats["percentile_00_5"], stats["percentile_99_5"]
    mask = (data > lo) & (data < hi)
    out = np.clip(data, lo, hi)
    if mask.any():
        mn, sd = out[mask].mean(), out[mask].std()
    else:
        mn, sd = out.mean(), out.std()
    return (out - mn) / max(sd, 1e-8)


def normalize_zscore(
    data: np.ndarray,
    nonzero_mask: Optional[np.ndarray] = None,
    use_mask: bool = False,
) -> np.ndarray:
    if use_mask and nonzero_mask is not None:
        m = nonzero_mask
        if m.any():
            mn, sd = data[m].mean(), data[m].std()
        else:
            mn, sd = data.mean(), data.std()
        out = (data - mn) / max(sd, 1e-8)
        out[~m] = 0.0
        return out
    mn, sd = data.mean(), data.std()
    return (data - mn) / max(sd, 1e-8)


def normalize_case(
    data: np.ndarray,
    schemes: Sequence[str],
    intensity_stats: Optional[Dict[int, Dict[str, float]]] = None,
    nonzero_mask: Optional[np.ndarray] = None,
    use_nonzero_mask: bool = False,
) -> np.ndarray:
    """Normalize all modalities of a case ``[C, *spatial]`` in place-ish."""
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        scheme = schemes[c]
        if scheme == "CT":
            out[c] = normalize_ct(data[c], intensity_stats[c])
        elif scheme == "CT2":
            out[c] = normalize_ct2(data[c], intensity_stats[c])
        else:
            out[c] = normalize_zscore(data[c], nonzero_mask, use_nonzero_mask)
    return out
