"""Minimal DICOM series reader for dataset converters (TCIA CT etc.).

The port's copy of :mod:`nndetection_tpu.data.dicom`: the same names,
signatures and outputs, with its imports pointed at the port.

Pure-Python parser for the subset clinical CT/MR archives actually use:
Part-10 files with Implicit/Explicit VR Little Endian transfer syntax,
native (uncompressed) pixel data, one slice per file.  Replaces the
reference converters' dependency on SimpleITK/GDCM series reading
(nnDetection's ``projects/Task021_ProstateX/scripts/prepare.py:19-23``)
with the same geometric semantics: slices of a series are sorted by the
projection of ImagePositionPatient onto the slice normal (cross product of
the row/column direction cosines), rescale slope/intercept are applied, and
the volume is returned in this repo's ``[k, j, i]`` convention.

Compressed transfer syntaxes (JPEG/RLE) are out of scope and raise.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"

# VRs with a 2-byte reserved field + 4-byte length in explicit encoding
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)


@dataclass
class Slice:
    path: Path
    rows: int = 0
    cols: int = 0
    bits_allocated: int = 16
    pixel_representation: int = 0
    samples_per_pixel: int = 1
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    pixel_spacing: Tuple[float, float] = (1.0, 1.0)  # (row, col)
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation: Tuple[float, ...] = (1, 0, 0, 0, 1, 0)
    series_uid: str = ""
    instance_number: int = 0
    slice_thickness: float = 1.0
    pixels: Optional[np.ndarray] = None
    extra: Dict[Tuple[int, int], bytes] = field(default_factory=dict)


def _decode_text(raw: bytes) -> str:
    return raw.decode("ascii", errors="replace").strip("\x00 ").strip()


def _parse_ds(raw: bytes) -> List[float]:
    text = _decode_text(raw)
    return [float(v) for v in text.split("\\") if v.strip()] if text else []


def _skip_undefined(buf: bytes, pos: int) -> int:
    """Skip an undefined-length sequence/item body; returns pos past the
    delimiter."""
    depth = 1
    while depth > 0 and pos + 8 <= len(buf):
        group, elem, length = struct.unpack_from("<HHI", buf, pos)
        pos += 8
        if (group, elem) == _SEQ_DELIM or (group, elem) == _ITEM_DELIM:
            depth -= 1
        elif length == 0xFFFFFFFF:
            depth += 1
        else:
            pos += length
    return pos


def _iter_elements(buf: bytes, pos: int, explicit: bool, wanted_pixels: bool):
    """Yield ``(group, elem, vr, value_bytes)`` for top-level elements."""
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        vr = b""
        if explicit and group != 0xFFFE:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        if length == 0xFFFFFFFF or vr == b"SQ":
            if length == 0xFFFFFFFF:
                pos = _skip_undefined(buf, pos)
            else:
                pos += length
            continue
        if group == 0x7FE0 and elem == 0x0010 and not wanted_pixels:
            yield group, elem, vr, buf[pos : pos + length]
            return
        yield group, elem, vr, buf[pos : pos + length]
        pos += length


def read_file(path, with_pixels: bool = True) -> Slice:
    """Parse one DICOM file into a :class:`Slice`."""
    path = Path(path)
    buf = path.read_bytes()
    if buf[128:132] != b"DICM":
        raise ValueError(f"not a Part-10 DICOM file: {path}")

    # file meta group (0002) is always Explicit VR LE
    pos = 132
    transfer_syntax = EXPLICIT_VR_LE
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, pos)
        if group != 0x0002:
            break
        vr = buf[pos + 4 : pos + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, pos + 8)
            value = buf[pos + 12 : pos + 12 + length]
            pos += 12 + length
        else:
            (length,) = struct.unpack_from("<H", buf, pos + 6)
            value = buf[pos + 8 : pos + 8 + length]
            pos += 8 + length
        if (group, elem) == (0x0002, 0x0010):
            transfer_syntax = _decode_text(value)

    if transfer_syntax not in (IMPLICIT_VR_LE, EXPLICIT_VR_LE):
        raise ValueError(
            f"unsupported (compressed?) transfer syntax {transfer_syntax}: {path}"
        )
    explicit = transfer_syntax == EXPLICIT_VR_LE

    sl = Slice(path=path)
    pixel_bytes = None
    for group, elem, vr, value in _iter_elements(buf, pos, explicit, with_pixels):
        tag = (group, elem)
        if tag == (0x0028, 0x0010):
            sl.rows = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0011):
            sl.cols = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0100):
            sl.bits_allocated = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0103):
            sl.pixel_representation = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0002):
            sl.samples_per_pixel = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x1053):
            v = _parse_ds(value)
            sl.rescale_slope = v[0] if v else 1.0
        elif tag == (0x0028, 0x1052):
            v = _parse_ds(value)
            sl.rescale_intercept = v[0] if v else 0.0
        elif tag == (0x0028, 0x0030):
            v = _parse_ds(value)
            if len(v) == 2:
                sl.pixel_spacing = (v[0], v[1])
        elif tag == (0x0020, 0x0032):
            v = _parse_ds(value)
            if len(v) == 3:
                sl.position = tuple(v)
        elif tag == (0x0020, 0x0037):
            v = _parse_ds(value)
            if len(v) == 6:
                sl.orientation = tuple(v)
        elif tag == (0x0020, 0x000E):
            sl.series_uid = _decode_text(value)
        elif tag == (0x0020, 0x0013):
            text = _decode_text(value)
            sl.instance_number = int(text) if text else 0
        elif tag == (0x0018, 0x0050):
            v = _parse_ds(value)
            sl.slice_thickness = v[0] if v else 1.0
        elif tag == (0x7FE0, 0x0010):
            pixel_bytes = value

    if with_pixels:
        if pixel_bytes is None:
            raise ValueError(f"no PixelData in {path}")
        if sl.bits_allocated == 16:
            dt = np.int16 if sl.pixel_representation else np.uint16
        elif sl.bits_allocated == 8:
            dt = np.int8 if sl.pixel_representation else np.uint8
        else:
            raise ValueError(f"unsupported BitsAllocated={sl.bits_allocated}")
        count = sl.rows * sl.cols * sl.samples_per_pixel
        sl.pixels = np.frombuffer(pixel_bytes, dtype=dt, count=count).reshape(
            sl.rows, sl.cols
        )
    return sl


def load_series(
    directory, series_uid: Optional[str] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load the slices of one series from a directory of DICOM files.

    Returns:
        ``(volume [k,j,i] float32 with rescale applied,
        spacing (k,j,i), origin (x,y,z of the first slice),
        direction)`` where ``direction`` is the 3x3 matrix whose columns are
        the world directions of the i (column), j (row) and k (slice) axes.
    """
    directory = Path(directory)
    slices: List[Slice] = []
    for p in sorted(directory.iterdir()):
        if not p.is_file():
            continue
        try:
            sl = read_file(p)
        except ValueError:
            continue
        if series_uid and sl.series_uid != series_uid:
            continue
        slices.append(sl)
    if not slices:
        raise FileNotFoundError(f"no readable DICOM slices in {directory}")
    if series_uid is None:
        # keep the most common series in the directory
        uids = [s.series_uid for s in slices]
        best = max(set(uids), key=uids.count)
        slices = [s for s in slices if s.series_uid == best]

    # IOP: first triplet = world direction of increasing column index (i),
    # second = world direction of increasing row index (j)
    i_dir = np.asarray(slices[0].orientation[:3], dtype=np.float64)
    j_dir = np.asarray(slices[0].orientation[3:], dtype=np.float64)
    normal = np.cross(i_dir, j_dir)
    slices.sort(key=lambda s: float(np.dot(normal, np.asarray(s.position))))

    vol = np.stack(
        [s.pixels.astype(np.float32) for s in slices], axis=0
    )  # [k, rows(j), cols(i)]
    slope = slices[0].rescale_slope
    intercept = slices[0].rescale_intercept
    if slope != 1.0 or intercept != 0.0:
        vol = vol * np.float32(slope) + np.float32(intercept)

    if len(slices) > 1:
        zs = [float(np.dot(normal, np.asarray(s.position))) for s in slices]
        slice_spacing = float(np.median(np.diff(zs)))
    else:
        slice_spacing = slices[0].slice_thickness
    row_sp, col_sp = slices[0].pixel_spacing
    spacing = np.asarray([abs(slice_spacing), row_sp, col_sp])
    origin = np.asarray(slices[0].position, dtype=np.float64)
    direction = np.stack([i_dir, j_dir, normal], axis=1)
    return vol, spacing, origin, direction


def affine_from_geometry(
    spacing_kji: np.ndarray, origin_xyz: np.ndarray, direction: np.ndarray
) -> np.ndarray:
    """4x4 voxel(i,j,k)->world map from series geometry (columns of
    ``direction`` are the i/j/k world directions)."""
    aff = np.eye(4)
    aff[:3, 0] = direction[:, 0] * spacing_kji[2]
    aff[:3, 1] = direction[:, 1] * spacing_kji[1]
    aff[:3, 2] = direction[:, 2] * spacing_kji[0]
    aff[:3, 3] = origin_xyz
    return aff


def resample_to_reference(
    data: np.ndarray,
    affine: np.ndarray,
    ref_shape_kji: Sequence[int],
    ref_affine: np.ndarray,
    order: int = 1,
    cval: float = 0.0,
) -> np.ndarray:
    """World-coordinate resampling of ``data`` onto a reference grid
    (the SimpleITK ``ResampleImageFilter.SetReferenceImage`` pattern used by
    the reference ProstateX converter).  ``affine``/``ref_affine`` map voxel
    ``(i, j, k)`` homogeneous coordinates to world; arrays are ``[k, j, i]``.
    """
    from scipy import ndimage

    ref_shape_kji = tuple(int(s) for s in ref_shape_kji)
    # ref voxel -> world -> source voxel, in (i,j,k) coordinates
    m = np.linalg.inv(affine) @ ref_affine
    kk, jj, ii = np.meshgrid(
        np.arange(ref_shape_kji[0]),
        np.arange(ref_shape_kji[1]),
        np.arange(ref_shape_kji[2]),
        indexing="ij",
    )
    ones = np.ones_like(ii, dtype=np.float64)
    src = np.einsum(
        "ab,b...->a...",
        m,
        np.stack([ii.astype(np.float64), jj.astype(np.float64), kk.astype(np.float64), ones]),
    )
    coords = np.stack([src[2], src[1], src[0]])  # back to (k, j, i) index order
    return ndimage.map_coordinates(
        data.astype(np.float32), coords, order=order, cval=cval, mode="constant"
    )
