"""Resampling on the host with nnU-Net's semantics (copy of
:mod:`nndetection_tpu.data.resample`):

* image data: order-3 spline zoom;
* label maps: a per-label one-hot zoom (order 1) thresholded at 0.5, so
  that labels never bleed into each other;
* anisotropic volumes (max / min spacing > 3, "separate z"): zoom in plane
  and take the nearest slice along the low-resolution axis.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

ANISO_THRESHOLD = 3.0


def get_do_separate_z(spacing: Sequence[float], threshold: float = ANISO_THRESHOLD):
    """``(separate z, its axis)``: the largest spacing's axis when the
    spacing's max / min exceeds ``threshold``."""
    spacing = np.asarray(spacing, dtype=np.float64)
    do = (spacing.max() / max(spacing.min(), 1e-8)) > threshold
    axis = int(np.argmax(spacing)) if do else None
    return bool(do), axis


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


def resample_data(
    data: np.ndarray,
    new_shape: Sequence[int],
    order: int = 3,
    do_separate_z: bool = False,
    axis: Optional[int] = None,
) -> np.ndarray:
    """Resample stacked modalities ``[C, *spatial]`` to ``new_shape``
    (float32; each channel zoomed in float64)."""
    new_shape = tuple(int(v) for v in new_shape)
    if tuple(data.shape[1:]) == new_shape:
        return data.astype(np.float32)
    out = np.empty((data.shape[0], *new_shape), dtype=np.float32)
    for c in range(data.shape[0]):
        vol = data[c].astype(np.float64)
        if do_separate_z and axis is not None and data.ndim - 1 == 3:
            out[c] = _zoom_separate_z(vol, new_shape, axis, order)
        else:
            factors = [t / s for t, s in zip(new_shape, vol.shape)]
            out[c] = ndimage.zoom(vol, factors, order=order, mode="nearest")
    return out


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


def compute_new_shape(
    old_shape: Sequence[int],
    old_spacing: Sequence[float],
    new_spacing: Sequence[float],
) -> np.ndarray:
    return np.round(
        np.asarray(old_shape)
        * np.asarray(old_spacing, dtype=np.float64)
        / np.asarray(new_spacing, dtype=np.float64)
    ).astype(np.int64)


def resample_patient(
    data: np.ndarray,
    seg: Optional[np.ndarray],
    original_spacing: Sequence[float],
    target_spacing: Sequence[float],
    order_data: int = 3,
    order_seg: int = 1,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One case resampled to ``target_spacing`` (data ``[C, *sp]``, seg
    ``[*sp]``): separate z when the original spacing, else the target
    spacing, is anisotropic."""
    new_shape = compute_new_shape(data.shape[1:], original_spacing, target_spacing)
    do_sep, axis = get_do_separate_z(original_spacing)
    if not do_sep:
        do_sep, axis = get_do_separate_z(target_spacing)
    data_r = resample_data(data, new_shape, order_data, do_sep, axis)
    seg_r = (
        resample_seg(seg, new_shape, order_seg, do_sep, axis) if seg is not None else None
    )
    return data_r, seg_r
