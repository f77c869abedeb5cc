"""Label-map resampling on the host (copy of the segmentation part of
:mod:`nndetection_tpu.data.resample`): a per-label one-hot zoom (order 1)
thresholded at 0.5, so that labels never bleed into each other; anisotropic
volumes ("separate z") zoom in plane and take the nearest slice along the
low-resolution axis."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage


def _zoom_separate_z(vol: np.ndarray, new_shape: Sequence[int], axis: int, order: int) -> np.ndarray:
    """In-plane order-``order`` zoom slice by slice, nearest along ``axis``."""
    vol = np.moveaxis(vol, axis, 0)
    n_slices, *inplane = vol.shape
    target_inplane = [new_shape[i] for i in range(3) if i != axis]
    slices = np.stack([
        ndimage.zoom(vol[i], [t / s for t, s in zip(target_inplane, inplane)], order=order,
                     mode="nearest")
        for i in range(n_slices)
    ], axis=0)
    target_n = new_shape[axis]
    if target_n != n_slices:
        idx = np.round(np.linspace(0, n_slices - 1, target_n)).astype(int)
        slices = slices[idx]
    return np.moveaxis(slices, 0, axis)


def resample_seg(
    seg: np.ndarray,
    new_shape: Sequence[int],
    order: int = 1,
    do_separate_z: bool = False,
    axis: Optional[int] = None,
) -> np.ndarray:
    """Resample a label map to ``new_shape`` by per-label one-hot resize; a
    higher label wins where two overlap."""
    new_shape = tuple(int(v) for v in new_shape)
    if tuple(seg.shape) == new_shape:
        return seg.copy()
    out = np.zeros(new_shape, dtype=seg.dtype)
    for lab in np.unique(seg):
        if lab == 0:
            continue
        mask = (seg == lab).astype(np.float32)
        if do_separate_z and axis is not None and seg.ndim == 3:
            res = _zoom_separate_z(mask, new_shape, axis, order)
        else:
            res = ndimage.zoom(mask, [t / s for t, s in zip(new_shape, mask.shape)], order=order,
                               mode="nearest")
        out[res >= 0.5] = lab
    return out
