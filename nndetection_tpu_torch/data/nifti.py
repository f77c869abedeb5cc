"""Minimal NIfTI-1 IO in NumPy and the standard library (copy of
:mod:`nndetection_tpu.data.nifti`).

The subset of NIfTI-1 that the dataset contract needs
(``raw_splitted/imagesTr/*.nii.gz``): load and save single-file ``.nii`` /
``.nii.gz`` volumes with spacing, affine (sform preferred, qform fallback,
pixdim last) and data scaling.

Arrays come in ``[k, j, i]`` (slowest-varying first) index order, the
reverse of the on-disk Fortran order, as SimpleITK gives them, and
``spacing`` in the same reversed order.
"""
from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


def _open(path: Union[str, Path], mode: str):
    path = Path(path)
    if path.suffix == ".gz" or str(path).endswith(".nii.gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_to_rotation(b: float, c: float, d: float, qfac: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    r[:, 2] *= qfac
    return r


def load(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a NIfTI-1 volume.

    Returns:
        ``(data, spacing, affine)`` where ``data`` has shape ``dims[::-1]``
        (reversed index order), ``spacing`` is per-axis voxel size in the same
        order, and ``affine`` is the 4x4 voxel(i,j,k)->world map.
    """
    with _open(path, "rb") as f:
        hdr = f.read(HEADER_SIZE)
        if len(hdr) < HEADER_SIZE:
            raise ValueError(f"truncated NIfTI header in {path}")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        endian = "<"
        if sizeof_hdr != 348:
            endian = ">"
            if struct.unpack_from(">i", hdr, 0)[0] != 348:
                raise ValueError(f"not a NIfTI-1 file: {path}")
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"bad NIfTI magic in {path}: {magic!r}")

        dim = struct.unpack_from(endian + "8h", hdr, 40)
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 1)])
        datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
        pixdim = struct.unpack_from(endian + "8f", hdr, 76)
        vox_offset = int(struct.unpack_from(endian + "f", hdr, 108)[0])
        scl_slope = struct.unpack_from(endian + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(endian + "f", hdr, 116)[0]
        qform_code = struct.unpack_from(endian + "h", hdr, 252)[0]
        sform_code = struct.unpack_from(endian + "h", hdr, 254)[0]

        if datatype not in _DTYPES:
            raise ValueError(f"unsupported NIfTI datatype {datatype} in {path}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

        f.seek(vox_offset)
        count = int(np.prod(shape))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)
        data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data * slope + scl_inter

    # affine
    affine = np.eye(4)
    if sform_code > 0:
        srow_x = struct.unpack_from(endian + "4f", hdr, 280)
        srow_y = struct.unpack_from(endian + "4f", hdr, 296)
        srow_z = struct.unpack_from(endian + "4f", hdr, 312)
        affine[0, :] = srow_x
        affine[1, :] = srow_y
        affine[2, :] = srow_z
    elif qform_code > 0:
        b, c, d = struct.unpack_from(endian + "3f", hdr, 256)
        qx, qy, qz = struct.unpack_from(endian + "3f", hdr, 268)
        qfac = pixdim[0] if pixdim[0] in (-1.0, 1.0) else 1.0
        rot = _quaternion_to_rotation(b, c, d, qfac)
        affine[:3, :3] = rot * np.asarray(pixdim[1:4])
        affine[:3, 3] = (qx, qy, qz)
    else:
        affine[:3, :3] = np.diag(pixdim[1:4])

    spacing_ijk = np.asarray(pixdim[1 : 1 + len(shape)], dtype=np.float64)
    # reverse to [k, j, i] order (SimpleITK array convention)
    data = np.ascontiguousarray(np.transpose(data, axes=tuple(reversed(range(data.ndim)))))
    spacing = spacing_ijk[::-1].copy()
    return data, spacing, affine


def save(
    path: Union[str, Path],
    data: np.ndarray,
    spacing: Optional[np.ndarray] = None,
    affine: Optional[np.ndarray] = None,
) -> None:
    """Save a volume as single-file NIfTI-1 (.nii or .nii.gz).

    ``data`` is in reversed ``[k, j, i]`` order (the :func:`load` convention);
    ``spacing`` likewise.
    """
    data = np.asarray(data)
    ndim = data.ndim
    if spacing is None:
        spacing = np.ones(ndim)
    spacing_ijk = np.asarray(spacing, dtype=np.float64)[::-1]
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    if affine is None:
        affine = np.eye(4)
        affine[:3, :3] = np.diag(list(spacing_ijk) + [1.0] * (3 - min(3, ndim)))[:3, :3]

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim] + list(reversed(data.shape)) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    pixdim = [1.0] + list(spacing_ijk) + [1.0] * (7 - len(spacing_ijk))
    struct.pack_into("<8f", hdr, 76, *pixdim[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform
    struct.pack_into("<h", hdr, 254, 1)  # sform: use affine rows
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = b"n+1\x00"

    body = np.transpose(data, axes=tuple(reversed(range(ndim)))).tobytes(order="F")
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(body)
