"""Minimal NRRD reader for dataset converters (LIDC-IDRI etc.).

The port's copy of :mod:`nndetection_tpu.data.nrrd`: the same names,
signatures and outputs, with its imports pointed at the port.

Supports the subset 3D Slicer / SimpleITK write: detached or attached data,
``raw``/``gzip`` encodings, ``space directions`` + ``space origin`` metadata.
Array convention matches :mod:`nndetection_tpu_torch.data.nifti`: ``[k, j, i]``
index order with spacing reversed accordingly (NRRD lists sizes fastest axis
first, so the reversed reshape gives ``[k, j, i]`` directly).
"""
from __future__ import annotations

import gzip
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "int64": np.int64,
    "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


def _parse_vector(text: str) -> np.ndarray:
    return np.asarray(
        [float(v) for v in text.strip().lstrip("(").rstrip(")").split(",")]
    )


def read_header(path) -> Tuple[Dict[str, str], int]:
    """Parse the text header; returns ``(fields, data_offset_bytes)``."""
    fields: Dict[str, str] = {}
    offset = 0
    with open(path, "rb") as f:
        magic = f.readline()
        offset += len(magic)
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"not an NRRD file: {path}")
        while True:
            raw_line = f.readline()
            offset += len(raw_line)
            line = raw_line.decode("ascii", errors="replace").rstrip("\r\n")
            if line == "":  # blank line terminates the header
                break
            if line.startswith("#"):
                continue
            for sep in (": ", ":=", ":"):
                if sep in line:
                    k, v = line.split(sep, 1)
                    fields[k.strip().lower()] = v.strip()
                    break
    return fields, offset


def load(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an .nrrd volume.

    Returns:
        ``(data [k,j,i], spacing (k,j,i order), origin (x,y,z world))``

    Axis-aligned ``space directions`` are reduced to their per-axis norms;
    rotational direction matrices lose the rotation (converters that need it
    should keep the raw header).
    """
    path = Path(path)
    fields, offset = read_header(path)

    dim = int(fields.get("dimension", 3))
    sizes = [int(v) for v in fields["sizes"].split()]
    if len(sizes) != dim:
        raise ValueError(f"sizes {sizes} do not match dimension {dim}")
    dtype = _NRRD_DTYPES[fields["type"].lower()]
    endian = fields.get("endian", "little")
    encoding = fields.get("encoding", "raw").lower()

    spacing_fastest_first = np.ones(dim)
    origin = np.zeros(dim)
    if "space directions" in fields:
        vecs = [
            _parse_vector(v)
            for v in fields["space directions"].split(")")
            if v.strip(" (")
        ]
        spacing_fastest_first = np.asarray([float(np.linalg.norm(v)) for v in vecs])
    elif "spacings" in fields:
        spacing_fastest_first = np.asarray(
            [float(v) for v in fields["spacings"].split()]
        )
    if "space origin" in fields:
        origin = _parse_vector(fields["space origin"])

    data_file = fields.get("data file") or fields.get("datafile")
    if data_file:
        raw = (path.parent / data_file).read_bytes()
    else:
        raw = path.read_bytes()[offset:]

    if encoding in ("gzip", "gz"):
        raw = gzip.decompress(raw)
    elif encoding in ("zlib",):
        raw = zlib.decompress(raw)
    elif encoding != "raw":
        raise ValueError(f"unsupported NRRD encoding: {encoding}")

    dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
    count = int(np.prod(sizes))
    data = np.frombuffer(raw, dtype=dt, count=count)
    # NRRD lists sizes fastest-first; reversed reshape -> [k, j, i]
    data = data.reshape(list(reversed(sizes)))
    return np.ascontiguousarray(data), spacing_fastest_first[::-1].copy(), origin
