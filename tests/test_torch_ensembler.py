"""The box ensemblers of the PyTorch port against the JAX package's, fed the
same tile streams: all five registry names on the host path (NumPy, float64)
exactly, and with the device formulation of the whole-case WBC on both sides
(``DEVICE_WBC = True``; the port's plain versions on the CPU, the JAX
package's jitted ``batched_wbc``) at the WBC tolerance. Ensembler states
written by either package load in the other, and the sweep-time
memoization returns what a fresh ensembler returns."""
import numpy as np
import pytest
import torch

import nndetection_tpu.inference.ensembler as jax_ens
import nndetection_tpu.ops.native as jax_native
import nndetection_tpu_torch.core.boxes.wbc as port_wbc
import nndetection_tpu_torch.inference.ensembler as ens
from nndetection_tpu_torch.ops import native
from tests.test_torch_nms import random_boxes

torch.set_num_threads(1)

NAMES = ["BoxEnsemblerSelective", "BoxEnsembler", "BoxEnsemblerWBC", "BoxEnsemblerLW",
         "BoxEnsemblerFastest"]
CASE, TILE = (64, 64, 64), (32, 32, 32)
ORIGINS = [(0, 0, 0), (16, 0, 0), (0, 32, 16), (32, 32, 32)]
# float32 against float32 with sums in other orders (tests/test_torch_wbc_device.py)
DEVICE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def numpy_twin(monkeypatch):
    """The host WBC of both packages through their NumPy loops, which the
    port copies, in place of their native C++ WBC (same algorithm, other
    float64 summation); the native one is held to them below and in
    ``tests/test_torch_native.py``."""
    monkeypatch.setattr(jax_native, "wbc_native", lambda *a, **k: None)
    monkeypatch.setattr(port_wbc, "wbc_native", lambda *a, **k: None)


def tile_streams(seed, streams=3, n=40, classes=2):
    """Per stream and tile: boxes (tile coordinates, clumped so that streams
    and tiles overlap), scores, labels."""
    rng = np.random.RandomState(seed)
    centers = random_boxes(rng, 12) * 0.3
    out = []
    for _ in range(streams):
        tiles = []
        for origin in ORIGINS:
            b = centers[rng.randint(0, len(centers), n)] + rng.uniform(-1.5, 1.5, (n, 6))
            b = b.astype(np.float32)
            b[:, 2:4] = np.maximum(b[:, 2:4], b[:, 0:2] + 0.5)
            b[:, 5] = np.maximum(b[:, 5], b[:, 4] + 0.5)
            tiles.append((b, rng.rand(n).astype(np.float32), rng.randint(0, classes, n), origin))
        out.append(tiles)
    return out


def feed(ensemblers, streams):
    for s, tiles in enumerate(streams):
        for e in ensemblers:
            e.add_model(f"m0_t{s}", weight=1.0 + 0.1 * s)
            for boxes, scores, labels, origin in tiles:
                e.process_tile(boxes, scores, labels, origin, TILE)


def pair(name, streams, **params):
    got, want = ens.BOX_ENSEMBLERS[name](CASE, params), jax_ens.BOX_ENSEMBLERS[name](CASE, params)
    if name == "BoxEnsemblerFastest":
        got.num_reduced_cache = want.num_reduced_cache = 50  # truncates the streams
    feed([got, want], streams)
    return got, want


def assert_results(got, want, **tol):
    assert len(want["pred_scores"]) > 2
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    for k in ("pred_scores", "pred_boxes"):
        if tol:
            np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_host_path_equals_jax(name):
    got, want = pair(name, tile_streams(1))
    assert_results(got.get_case_result(), want.get_case_result())


@pytest.mark.parametrize("name", NAMES)
def test_native_host_path_matches_jax(monkeypatch, name):
    """The port's host path through its native library, the JAX package's
    through its own (or its NumPy loop where that is not built): float64
    sums in another order, so at ``rtol=1e-12``."""
    monkeypatch.undo()
    native.NATIVE_CALLS.clear()
    got, want = pair(name, tile_streams(1))
    assert_results(got.get_case_result(), want.get_case_result(), rtol=1e-12, atol=0)
    assert native.NATIVE_CALLS["wbc_3d"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_device_formulation_matches_jax(monkeypatch, name):
    monkeypatch.setattr(ens, "DEVICE_WBC", True)
    monkeypatch.setattr(jax_ens, "DEVICE_WBC", True)
    got, want = pair(name, tile_streams(2), ensemble_score_thresh=0.05)
    assert_results(got.get_case_result(), want.get_case_result(), **DEVICE_TOL)


def test_auto_takes_the_device_only_on_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(ens, "batched_wbc_device", lambda *a, **k: calls.append(k["device"]))
    monkeypatch.setattr(ens, "batched_wbc_np", lambda *a, **k: (np.zeros((0, 6)), np.zeros(0),
                                                               np.zeros(0)))
    for device in (None, "cpu"):
        e = ens.BoxEnsemblerWBC(CASE, device=device)
        feed([e], tile_streams(3, streams=1))
        e.get_case_result()
    assert calls == []
    assert ens._use_device_wbc(torch.device("cuda"))
    assert not ens._use_device_wbc(torch.device("cpu")) and not ens._use_device_wbc(None)


def test_sweep_space_and_parameters_match_jax():
    got, want = ens.BoxEnsemblerSelective.sweep_parameters(), jax_ens.BoxEnsemblerSelective.sweep_parameters()
    assert got == want
    e = ens.BoxEnsemblerSelective(CASE)
    e.update_parameters(model_iou=0.3)
    assert e.parameters == dict(want[0], model_iou=0.3)


def test_overlap_map_matches_jax():
    got, want = ens.OverlapMap((16, 16, 16)), jax_ens.OverlapMap((16, 16, 16))
    for m in (got, want):
        m.add_tile((0, 0, 0), (8, 8, 8))
        m.add_tile((4, 4, 4), (8, 8, 8))
    boxes = random_boxes(np.random.RandomState(4), 20) * 0.15
    np.testing.assert_array_equal(got.map, want.map)
    np.testing.assert_array_equal(got.mean_overlap_in_boxes(boxes), want.mean_overlap_in_boxes(boxes))


def test_overlap_map_takes_2d_boxes():
    """The JAX package's ``mean_overlap_in_boxes`` reads six coordinates and
    fails on a 2D map; the port's gives the 3D result of the same boxes
    lifted to unit depth."""
    tiles = [((0, 0), (8, 8)), ((4, 4), (8, 8)), ((6, 0), (10, 10))]
    boxes = random_boxes(np.random.RandomState(5), 20)[:, :4] * 0.15
    got, want, jax_2d = ens.OverlapMap((16, 16)), ens.OverlapMap((16, 16, 1)), jax_ens.OverlapMap((16, 16))
    for origin, size in tiles:
        got.add_tile(origin, size)
        want.add_tile((*origin, 0), (*size, 1))
        jax_2d.add_tile(origin, size)
    with pytest.raises(IndexError):
        jax_2d.mean_overlap_in_boxes(boxes)
    lifted = np.concatenate([boxes, np.tile([0.0, 1.0], (len(boxes), 1))], axis=1)
    result = got.mean_overlap_in_boxes(boxes)
    np.testing.assert_array_equal(result, want.mean_overlap_in_boxes(lifted))
    assert result.max() > 1.0


@pytest.mark.parametrize("name", ["BoxEnsemblerSelective", "BoxEnsemblerWBC"])
def test_states_load_across_packages(tmp_path, name):
    got, want = pair(name, tile_streams(5))
    want.save_state(tmp_path, "jax_case")
    got.save_state(tmp_path, "port_case")
    cls, jax_cls = ens.BOX_ENSEMBLERS[name], jax_ens.BOX_ENSEMBLERS[name]
    for path in (tmp_path / "jax_case_boxes_state.pkl", tmp_path / "port_case_boxes_state.pkl"):
        assert_results(cls.from_checkpoint(path).get_case_result(),
                       jax_cls.from_checkpoint(path).get_case_result())
    # the port's state file holds what the JAX package's holds
    a = cls.from_checkpoint(tmp_path / "port_case_boxes_state.pkl", device="cpu")
    b = jax_cls.from_checkpoint(tmp_path / "jax_case_boxes_state.pkl")
    assert a.case_shape == b.case_shape and a.parameters == b.parameters
    assert a.device == torch.device("cpu")
    for model in b.model_results:
        for k in ("boxes", "scores", "labels", "weights"):
            np.testing.assert_array_equal(a.model_results[model][k][0], b.model_results[model][k][0])


def _make_state(tmp_path, cid, rng):
    """As ``tests/test_sweeper.py``: a confident true positive + clutter."""
    e = ens.BoxEnsemblerSelective((64, 64, 64))
    e.add_model("m0")
    gt = np.asarray([10, 10, 20, 20, 10, 20], np.float64)
    noise = rng.uniform(5, 55, (20, 1)) + np.asarray([[0, 0, 6, 6, 0, 6]], np.float64)
    boxes = np.concatenate([[gt], noise]).astype(np.float32)
    scores = np.concatenate([[0.9], rng.uniform(0.05, 0.25, len(noise))]).astype(np.float32)
    e.process_tile(boxes, scores, np.zeros(len(boxes), np.int64), (0, 0, 0), (64, 64, 64))
    e.save_state(tmp_path, cid)
    return tmp_path / f"{cid}_boxes_state.pkl"


@pytest.mark.parametrize("device_wbc", [False, True])
def test_memoized_results_match_fresh_ensembler(monkeypatch, tmp_path, device_wbc):
    """A persistent ensembler swept through the sweep space returns exactly
    what a freshly loaded one returns at each point."""
    monkeypatch.setattr(ens, "DEVICE_WBC", device_wbc)
    path = _make_state(tmp_path, "case_m", np.random.RandomState(42))
    persistent = ens.BoxEnsemblerSelective.from_checkpoint(path)
    defaults, space = ens.BoxEnsemblerSelective.sweep_parameters()
    for pname, values in space.items():
        for v in values:
            params = dict(defaults, **{pname: v})
            persistent.update_parameters(**params)
            got = persistent.get_case_result()
            fresh = ens.BoxEnsemblerSelective.from_checkpoint(path)
            fresh.update_parameters(**params)
            want = fresh.get_case_result()
            for k in ("pred_boxes", "pred_scores", "pred_labels"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{pname}={v} {k}")


def test_cache_invalidated_by_new_tiles():
    e = ens.BoxEnsemblerSelective((64, 64, 64))
    e.add_model("m0")
    b = np.asarray([[10, 10, 20, 20, 10, 20]], np.float32)
    e.process_tile(b, np.asarray([0.9], np.float32), np.zeros(1, np.int64), (0, 0, 0), (64, 64, 64))
    assert len(e.get_case_result()["pred_boxes"]) == 1
    e.process_tile(b + 30, np.asarray([0.8], np.float32), np.zeros(1, np.int64), (0, 0, 0),
                   (64, 64, 64))
    assert len(e.get_case_result()["pred_boxes"]) == 2
