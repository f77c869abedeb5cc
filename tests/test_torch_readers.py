"""The port's raw-format readers against the JAX package's on the same
files: MetaImage (``data/mhd.py``: raw and zlib ``.zraw``, both byte
orders, the writer both ways, ``world_to_voxel``), NRRD (``data/nrrd.py``:
raw, gzip and zlib, attached and detached data, ``space directions`` and
``spacings``) and DICOM (``data/dicom.py``: explicit and implicit VR, the
rescale, series selection, geometry and world-coordinate resampling).
Files are written as ``tests/test_extras.py::TestMHD``,
``tests/test_nrrd_lidc.py`` and ``tests/test_dicom.py`` write them; arrays,
spacings, origins and directions are held bit for bit."""
import gzip
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from nndetection_tpu.data import dicom as jdicom
from nndetection_tpu.data import mhd as jmhd
from nndetection_tpu.data import nrrd as jnrrd
from nndetection_tpu_torch.data import dicom as tdicom
from nndetection_tpu_torch.data import mhd as tmhd
from nndetection_tpu_torch.data import nrrd as tnrrd
from tests.test_dicom import write_slice
from tests.test_torch_prep import assert_same


def same_load(got, want):
    """Both readers' results (tuples of arrays) equal bit for bit, dtypes
    and byte orders included."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"output {i}")


# ----------------------------------------------------------------- MetaImage
MHD_DTYPES = {"MET_SHORT": np.int16, "MET_FLOAT": np.float32, "MET_UCHAR": np.uint8,
              "MET_DOUBLE": np.float64}


def write_mhd(tmp_path: Path, data: np.ndarray, met: str, compressed=False, msb=False,
              spacing_xyz=(0.7, 0.8, 2.5), origin=(-10.5, -20.25, -30.0)):
    """An ``.mhd`` header beside its data file (x fastest), as
    ``TestMHD._write_mhd`` writes it, with the element type, zlib
    compression and byte order chosen."""
    raw = np.ascontiguousarray(data.astype(data.dtype.newbyteorder(">" if msb else "<")))
    raw = raw.tobytes()
    name = "vol.zraw" if compressed else "vol.raw"
    (tmp_path / name).write_bytes(zlib.compress(raw) if compressed else raw)
    hdr = ("ObjectType = Image\nNDims = 3\nBinaryData = True\n"
           f"BinaryDataByteOrderMSB = {msb}\nCompressedData = {compressed}\n"
           f"DimSize = {' '.join(map(str, reversed(data.shape)))}\n"
           f"ElementSpacing = {' '.join(map(str, spacing_xyz))}\n"
           f"Offset = {' '.join(map(str, origin))}\n"
           f"ElementType = {met}\nElementDataFile = {name}\n")
    (tmp_path / "vol.mhd").write_text(hdr)
    return tmp_path / "vol.mhd"


@pytest.mark.parametrize("met, compressed, msb", [
    ("MET_SHORT", False, False), ("MET_SHORT", True, False), ("MET_FLOAT", True, True),
    ("MET_UCHAR", False, False), ("MET_DOUBLE", False, True)])
def test_mhd_load(tmp_path, met, compressed, msb):
    rng = np.random.RandomState(0)
    data = (rng.rand(5, 6, 7) * 200 - 50).astype(MHD_DTYPES[met])
    path = write_mhd(tmp_path, data, met, compressed, msb)
    assert tmhd.read_header(path) == jmhd.read_header(path)
    got, want = tmhd.load(path), jmhd.load(path)
    same_load(got, want)
    np.testing.assert_array_equal(got[0], data)


def test_mhd_header_stops_at_data_file(tmp_path):
    """The header ends at ``ElementDataFile`` in both readers, whatever
    follows (a ``LOCAL`` file's bytes)."""
    path = tmp_path / "vol.mhd"
    path.write_bytes(b"NDims = 3\nDimSize = 2 2 2\nElementDataFile = LOCAL\n\xff\xfe\x00junk=1\n")
    assert tmhd.read_header(path) == jmhd.read_header(path) == {
        "NDims": "3", "DimSize": "2 2 2", "ElementDataFile": "LOCAL"}
    for reader in (tmhd, jmhd):
        with pytest.raises(ValueError, match="embedded"):
            reader.load(path)


@pytest.mark.parametrize("compressed", [True, False])
def test_mhd_save_both_ways(tmp_path, compressed):
    """Each package's writer read back by both readers gives the same
    arrays, spacing and origin, and the same header fields."""
    rng = np.random.RandomState(1)
    data = rng.randint(-1024, 3071, (6, 9, 8)).astype(np.int16)
    spacing, origin = np.asarray([2.5, 0.75, 0.75]), np.asarray([-180.1, -170.2, -300.3])
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tmhd.save(tmp_path / "t" / "c.mhd", data, spacing, origin, compressed=compressed)
    jmhd.save(tmp_path / "j" / "c.mhd", data, spacing, origin, compressed=compressed)
    assert tmhd.read_header(tmp_path / "t" / "c.mhd") == jmhd.read_header(tmp_path / "j" / "c.mhd")
    for reader in (tmhd, jmhd):
        same_load(reader.load(tmp_path / "t" / "c.mhd"), jmhd.load(tmp_path / "j" / "c.mhd"))
    np.testing.assert_array_equal(tmhd.load(tmp_path / "t" / "c.mhd")[0], data)


def test_world_to_voxel():
    rng = np.random.RandomState(2)
    for _ in range(20):
        world, origin = rng.uniform(-300, 300, 3), rng.uniform(-250, -150, 3)
        spacing = rng.uniform(0.5, 2.5, 3)
        assert_same(tmhd.world_to_voxel(world, origin, spacing),
                    jmhd.world_to_voxel(world, origin, spacing))
    np.testing.assert_allclose(
        tmhd.world_to_voxel(np.asarray([-5.0, -18.0, -26.0]), np.asarray([-10.0, -20.0, -30.0]),
                            np.asarray([2.0, 1.0, 1.0])), [2.0, 2.0, 5.0])


# ----------------------------------------------------------------- NRRD
def write_nrrd(path: Path, data: np.ndarray, spacing_xyz, encoding="gzip", detached=False,
               endian="little", spacings_field=False):
    """An NRRD as ``tests/test_nrrd_lidc.py::write_nrrd`` writes it, with the
    encoding, a detached data file, the byte order and ``spacings`` instead
    of ``space directions`` chosen."""
    sizes = " ".join(str(s) for s in reversed(data.shape))
    if spacings_field:
        geometry = f"spacings: {' '.join(map(str, spacing_xyz))}\n"
    else:
        dirs = " ".join(f"({s},0,0)" if i == 0 else f"(0,{s},0)" if i == 1 else f"(0,0,{s})"
                        for i, s in enumerate(spacing_xyz))
        geometry = (f"space: left-posterior-superior\nspace directions: {dirs}\n"
                    "space origin: (1.0,2.0,3.0)\n")
    raw = np.ascontiguousarray(data.astype(data.dtype.newbyteorder(
        "<" if endian == "little" else ">"))).tobytes()
    raw = {"gzip": gzip.compress, "zlib": zlib.compress, "raw": bytes}[encoding](raw)
    header = ("NRRD0004\n# a comment\n"
              f"type: {data.dtype.name}\ndimension: 3\nsizes: {sizes}\n{geometry}"
              f"endian: {endian}\nencoding: {encoding}\n")
    if detached:
        (path.parent / "data.raw").write_bytes(raw)
        path.write_bytes((header + "data file: data.raw\n\n").encode("ascii"))
    else:
        path.write_bytes((header + "\n").encode("ascii") + raw)


@pytest.mark.parametrize("dtype, encoding, detached, endian, spacings_field", [
    (np.int16, "gzip", False, "little", False), (np.float32, "raw", False, "little", False),
    (np.int16, "zlib", True, "little", False), (np.uint8, "raw", True, "big", True),
    (np.float64, "gzip", False, "big", False)])
def test_nrrd_load(tmp_path, dtype, encoding, detached, endian, spacings_field):
    rng = np.random.RandomState(3)
    data = (rng.rand(5, 6, 7) * 250).astype(dtype)
    path = tmp_path / "v.nrrd"
    write_nrrd(path, data, [0.7, 0.8, 2.5], encoding, detached, endian, spacings_field)
    assert tnrrd.read_header(path) == jnrrd.read_header(path)
    got, want = tnrrd.load(path), jnrrd.load(path)
    same_load(got, want)
    np.testing.assert_array_equal(got[0], data)
    np.testing.assert_allclose(got[1], [2.5, 0.8, 0.7])


@pytest.mark.parametrize("content, match", [
    (b"P6\n", "not an NRRD"),
    (b"NRRD0004\ntype: short\ndimension: 3\nsizes: 2 2 2\nencoding: bzip2\n\n" + b"\0" * 16,
     "unsupported NRRD encoding"),
    (b"NRRD0004\ntype: short\ndimension: 3\nsizes: 2 2\nencoding: raw\n\n", "do not match")])
def test_nrrd_rejects(tmp_path, content, match):
    (tmp_path / "v.nrrd").write_bytes(content)
    for reader in (tnrrd, jnrrd):
        with pytest.raises(ValueError, match=match):
            reader.load(tmp_path / "v.nrrd")


# ----------------------------------------------------------------- DICOM
def make_series(d: Path, explicit=True, n=4, orientation=None, **kw):
    """Slices written out of order (``tests/test_dicom.py::TestDicom``), with
    an optional other orientation (12 bytes, the element's padded length)."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    for k in [2, 0, 3, 1, 5, 4][:n]:
        px = rng.integers(-900, 900, size=(6, 5)).astype(np.int16)
        write_slice(d / f"slice_{k}.dcm", px, (10.0 + 0.3 * k, 20.0, 30.0 + 2.5 * k),
                    explicit=explicit, **kw)
    if orientation is not None:  # the orientation element's value, same length
        for p in d.glob("*.dcm"):
            buf = p.read_bytes().replace(b"1\\0\\0\\0\\1\\0\0", orientation)
            p.write_bytes(buf)
    return d


def same_slice(got, want):
    for f in ("rows", "cols", "bits_allocated", "pixel_representation", "samples_per_pixel",
              "rescale_slope", "rescale_intercept", "pixel_spacing", "position", "orientation",
              "series_uid", "instance_number", "slice_thickness"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.pixels is None) == (want.pixels is None)
    if want.pixels is not None:
        assert_same(got.pixels, want.pixels)


@pytest.mark.parametrize("explicit, slope, intercept, with_pixels", [
    (True, 1.0, 0.0, True), (False, 2.0, -1024.0, True), (True, 1.0, 0.0, False)])
def test_dicom_read_file(tmp_path, explicit, slope, intercept, with_pixels):
    make_series(tmp_path, explicit=explicit, n=2, slope=slope, intercept=intercept)
    for p in sorted(tmp_path.glob("*.dcm")):
        same_slice(tdicom.read_file(p, with_pixels), jdicom.read_file(p, with_pixels))


@pytest.mark.parametrize("explicit, slope, intercept, orientation", [
    (True, 1.0, 0.0, None), (False, 2.0, -1024.0, None),
    (True, 1.0, 0.0, b"0\\1\\0\\-1\\0\\0")])
def test_dicom_load_series(tmp_path, explicit, slope, intercept, orientation):
    make_series(tmp_path, explicit=explicit, n=6, slope=slope, intercept=intercept,
                orientation=orientation)
    got, want = tdicom.load_series(tmp_path), jdicom.load_series(tmp_path)
    same_load(got, want)
    assert got[0].shape == (6, 6, 5)


def test_dicom_series_selection(tmp_path):
    """The majority series by default, another by its UID; files that are
    not Part-10 DICOM are skipped, an empty directory raises in both."""
    make_series(tmp_path, n=4)
    write_slice(tmp_path / "other.dcm", np.zeros((6, 5), np.int16), (0, 0, 0), series_uid="9.9.9")
    (tmp_path / "notes.txt").write_text("not dicom")
    same_load(tdicom.load_series(tmp_path), jdicom.load_series(tmp_path))
    got = tdicom.load_series(tmp_path, series_uid="9.9.9")
    same_load(got, jdicom.load_series(tmp_path, series_uid="9.9.9"))
    assert got[0].shape == (1, 6, 5)
    (tmp_path / "empty").mkdir()
    for reader in (tdicom, jdicom):
        with pytest.raises(FileNotFoundError):
            reader.load_series(tmp_path / "empty")


def test_dicom_rejects_compressed(tmp_path):
    """A JPEG transfer syntax and a file without the ``DICM`` preamble raise
    ``ValueError`` in both readers."""
    jpeg = b"1.2.840.10008.1.2.4.50"
    meta = struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", len(jpeg)) + jpeg
    (tmp_path / "a.dcm").write_bytes(b"\0" * 128 + b"DICM" + meta)
    (tmp_path / "b.dcm").write_bytes(b"\0" * 200)
    for reader in (tdicom, jdicom):
        for name, match in (("a.dcm", "transfer syntax"), ("b.dcm", "Part-10")):
            with pytest.raises(ValueError, match=match):
                reader.read_file(tmp_path / name)


def test_dicom_geometry_and_resampling():
    """``affine_from_geometry`` and ``resample_to_reference`` (identity, a
    shift, an oblique reference, nearest and linear) equal in both."""
    rng = np.random.RandomState(4)
    vol = rng.rand(6, 7, 8).astype(np.float32) * 100
    theta = 0.3
    rot = np.asarray([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                      [0, 0, 1]])
    spacing, origin = np.asarray([2.5, 0.8, 0.7]), np.asarray([1.0, -2.0, 3.0])
    for direction in (np.eye(3), rot):
        assert_same(tdicom.affine_from_geometry(spacing, origin, direction),
                    jdicom.affine_from_geometry(spacing, origin, direction))
    aff = jdicom.affine_from_geometry(spacing, origin, np.eye(3))
    shifted = aff.copy()
    shifted[0, 3] += 0.9
    oblique = jdicom.affine_from_geometry(spacing * 1.3, origin + 0.5, rot)
    for ref in (aff, shifted, oblique):
        for order in (0, 1):
            assert_same(tdicom.resample_to_reference(vol, aff, (5, 7, 9), ref, order=order),
                        jdicom.resample_to_reference(vol, aff, (5, 7, 9), ref, order=order))
