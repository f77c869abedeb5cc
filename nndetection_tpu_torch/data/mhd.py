"""Minimal MetaImage (.mhd/.raw) reader for dataset converters (LUNA16 etc.).

The port's copy of :mod:`nndetection_tpu.data.mhd`: the same names,
signatures and outputs, with its imports pointed at the port.

Supports the subset written by common medical pipelines: MET_SHORT/FLOAT/etc.,
optional external .raw/.zraw (zlib) data files, offset + spacing + transform
matrix. Array convention matches :mod:`nndetection_tpu_torch.data.nifti`:
``[k, j, i]`` index order with spacing reversed accordingly.
"""
from __future__ import annotations

import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

_MET_DTYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}


def read_header(path) -> Dict[str, str]:
    header: Dict[str, str] = {}
    with open(path, "rb") as f:
        for raw_line in f:
            try:
                line = raw_line.decode("ascii").strip()
            except UnicodeDecodeError:
                break
            if "=" not in line:
                break
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()
            if k.strip() == "ElementDataFile":
                break
    return header


def load(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an .mhd volume.

    Returns:
        ``(data [k,j,i], spacing (reversed), origin (x,y,z world))``
    """
    path = Path(path)
    hdr = read_header(path)
    ndims = int(hdr.get("NDims", 3))
    shape_ijk = [int(v) for v in hdr["DimSize"].split()]
    dtype = _MET_DTYPES[hdr.get("ElementType", "MET_SHORT")]
    spacing_ijk = np.asarray(
        [float(v) for v in hdr.get("ElementSpacing", " ".join(["1"] * ndims)).split()]
    )
    origin = np.asarray(
        [float(v) for v in hdr.get("Offset", " ".join(["0"] * ndims)).split()]
    )
    byte_order_msb = hdr.get("BinaryDataByteOrderMSB", "False").lower() == "true"
    compressed = hdr.get("CompressedData", "False").lower() == "true"

    data_file = hdr["ElementDataFile"]
    if data_file == "LOCAL":
        raise ValueError("embedded MHD data not supported")
    data_path = path.parent / data_file
    raw = data_path.read_bytes()
    if compressed:
        raw = zlib.decompress(raw)
    dt = np.dtype(dtype).newbyteorder(">" if byte_order_msb else "<")
    count = int(np.prod(shape_ijk))
    data = np.frombuffer(raw, dtype=dt, count=count)
    # mhd raw data is x-fastest; reshape reversed gives [k, j, i] directly
    data = data.reshape(list(reversed(shape_ijk)))
    return np.ascontiguousarray(data), spacing_ijk[::-1].copy(), origin


_MET_NAMES = {np.dtype(v): k for k, v in _MET_DTYPES.items()}


def save(
    path,
    data_kji: np.ndarray,
    spacing_kji: np.ndarray,
    origin_xyz: np.ndarray,
    compressed: bool = True,
) -> None:
    """Write an .mhd volume (inverse of :func:`load`).

    ``data_kji`` is ``[k, j, i]`` indexed; header fields are written in the
    MetaImage x-fastest convention (``DimSize = i j k``,
    ``ElementSpacing = x y z``). Data goes to a sibling ``.zraw`` (zlib) or
    ``.raw`` file.
    """
    path = Path(path)
    data_kji = np.ascontiguousarray(data_kji)
    met_type = _MET_NAMES[np.dtype(data_kji.dtype)]
    ext = ".zraw" if compressed else ".raw"
    data_name = path.stem + ext
    raw = data_kji.tobytes()
    if compressed:
        raw = zlib.compress(raw, level=1)
    (path.parent / data_name).write_bytes(raw)
    spacing_xyz = np.asarray(spacing_kji, np.float64)[::-1]
    shape_ijk = list(reversed(data_kji.shape))
    header = [
        "ObjectType = Image",
        f"NDims = {data_kji.ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {compressed}",
        f"DimSize = {' '.join(str(int(s)) for s in shape_ijk)}",
        f"ElementSpacing = {' '.join(f'{s:.6f}' for s in spacing_xyz)}",
        f"Offset = {' '.join(f'{float(o):.6f}' for o in np.asarray(origin_xyz))}",
        f"ElementType = {met_type}",
        f"ElementDataFile = {data_name}",
    ]
    path.write_text("\n".join(header) + "\n")


def world_to_voxel(
    world_xyz: np.ndarray, origin_xyz: np.ndarray, spacing_kji: np.ndarray
) -> np.ndarray:
    """World (x,y,z) coordinates -> voxel (k,j,i) indices (no rotation)."""
    spacing_xyz = spacing_kji[::-1]
    vox_xyz = (np.asarray(world_xyz) - np.asarray(origin_xyz)) / spacing_xyz
    return vox_xyz[::-1]
