"""The model-level NMS of ``BoxEnsemblerSelective`` batched over streams
(``inference/ensembler.py::batched_model_nms_device``, one launch of the
truncated NMS kernel #7 on the card, its plain version on the CPU) against
the host float64 ``batched_nms_np`` of each stream: the same indices in the
same order. Streams of unequal length (one empty, one shorter than
``max_out``), equal ranking keys, one and two classes, 3D and 2D boxes,
both ranking functions. Then the ensembler with the batched path forced on
the CPU: the host path's results, memoised or fresh, and the counter
``ensemble.streams_on_card``.

Imports neither JAX nor the JAX package; the ``cuda`` tests run the real
kernel on deploy-sized streams on a machine with the card:

    python -m pytest -m cuda --noconftest tests/test_torch_model_nms.py
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nndetection_tpu_torch.inference.ensembler as ens
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.utils import trace

torch.set_num_threads(1)

# stream lengths: an empty stream, one shorter than max_out, longer ones
LENGTHS = (60, 0, 7, 150)
CASE = (96, 256, 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_stream(rng, n, dim=3, classes=1, ties=False, extent=CASE):
    """``(boxes, probs, labels, weights)`` of one stream: boxes clumped
    around a few centres inside ``extent`` (so that many overlap), float32.
    ``ties``: probs and weights on a coarse grid, so that many ranking keys
    are equal."""
    extent = np.asarray(extent[:3] if dim == 3 else extent[1:], np.float64)
    centres = rng.uniform(30, extent - 30, (max(n // 8, 1), len(extent)))
    ctr = centres[rng.randint(0, len(centres), n)] + rng.normal(0, 4, (n, len(extent)))
    half = rng.uniform(2, 14, (n, len(extent)))
    lo, hi = ctr - half, ctr + half
    cols = [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]] + ([lo[:, 2], hi[:, 2]] if dim == 3 else [])
    boxes = np.stack(cols, 1).astype(np.float32).reshape(n, 2 * dim)
    if ties:
        probs = (rng.randint(1, 5, n) / 4).astype(np.float32)
        weights = rng.choice([0.5, 1.0], n).astype(np.float32)
    else:
        probs = rng.rand(n).astype(np.float32)
        weights = rng.uniform(0.5, 1.0, n).astype(np.float32)
    return boxes, probs, rng.randint(0, classes, n).astype(np.int64), weights


def host_keeps(streams, fn, iou, max_out):
    return [ens.MODEL_NMS_FNS[fn](b, p, l, w, iou)[:max_out] for b, p, l, w in streams]


def batched_keeps(streams, fn, iou, max_out, device=None):
    rank = ens.MODEL_NMS_KEYS[fn]
    return ens.batched_model_nms_device([(b, rank(p, w), l) for b, p, l, w in streams], iou,
                                        max_out, device)


@pytest.mark.parametrize("max_out", [5, 100])
@pytest.mark.parametrize("iou", [1e-5, 0.1, 0.5])
@pytest.mark.parametrize("fn", ["weighted_nms", "nms"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("classes", [1, 2])
@pytest.mark.parametrize("dim", [3, 2])
def test_batched_equals_host_per_stream(dim, classes, ties, fn, iou, max_out):
    rng = np.random.RandomState(100 * dim + 10 * classes + ties)
    streams = [make_stream(rng, n, dim, classes, ties) for n in LENGTHS]
    got = batched_keeps(streams, fn, iou, max_out)
    want = host_keeps(streams, fn, iou, max_out)
    assert [len(k) for k in got] == [len(k) for k in want]
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == 0 and 0 < len(got[2]) <= 7
    # the NMS suppresses in the longest stream, not merely truncates it
    assert len(host_keeps(streams[3:], fn, iou, LENGTHS[3])[0]) < LENGTHS[3]
    if ties:
        key = ens.MODEL_NMS_KEYS[fn](streams[3][1], streams[3][3])
        assert len(np.unique(key)) < len(key) // 4


def test_batched_takes_no_stream_or_only_empty_ones():
    assert ens.batched_model_nms_device([], 0.1, 100) == []
    empty = (np.zeros((0, 6), np.float32), np.zeros(0, np.float32), np.zeros(0, np.int64))
    got = ens.batched_model_nms_device([empty, empty], 0.1, 100)
    assert [len(k) for k in got] == [0, 0]


# ------------------------------------------------------------- the ensembler
def fill(e, seed, dim=3, classes=2):
    """Five streams of one tile each (the whole case), one of them empty."""
    rng = np.random.RandomState(seed)
    for s, n in enumerate((120, 0, 40, 200, 9)):
        e.add_model(f"m{s}", weight=1.0 + 0.1 * s)
        boxes, probs, labels, _ = make_stream(rng, n, dim, classes)
        e.process_tile(boxes, probs, labels, (0,) * dim, e.case_shape)
    return e


def results_equal(got, want, what=""):
    for k in ("pred_boxes", "pred_scores", "pred_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.fixture
def forced(monkeypatch):
    """The batched path on the CPU: the device predicate forced true."""
    monkeypatch.setattr(ens, "_use_device_model_nms", lambda device: True)


def test_device_predicate_takes_cuda_only():
    assert ens._use_device_model_nms(torch.device("cuda"))
    assert ens._use_device_model_nms("cuda:0")
    assert not ens._use_device_model_nms(torch.device("cpu"))
    assert not ens._use_device_model_nms(None)


@pytest.mark.parametrize("dim,classes", [(3, 1), (3, 2), (2, 2)])
@pytest.mark.parametrize("fn", ["weighted_nms", "nms"])
def test_forced_path_equals_host_path(dim, classes, fn):
    case = CASE if dim == 3 else CASE[1:]
    params = dict(model_nms_fn=fn, model_detections_per_image=30)
    host = fill(ens.BoxEnsemblerSelective(case, params), 7, dim, classes).get_case_result()
    assert len(host["pred_scores"]) > 10
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ens, "_use_device_model_nms", lambda device: True)
        card = fill(ens.BoxEnsemblerSelective(case, params), 7, dim, classes).get_case_result()
    results_equal(card, host)


def _state(tmp_path):
    e = fill(ens.BoxEnsemblerSelective(CASE), 11)
    e.save_state(tmp_path, "case_m")
    return tmp_path / "case_m_boxes_state.pkl"


def test_memoized_results_match_fresh_ensembler(forced, tmp_path):
    """With the batched path forced, a persistent ensembler swept through
    the sweep space returns exactly what a fresh one returns at each point,
    and what the host path returns."""
    path = _state(tmp_path)
    persistent = ens.BoxEnsemblerSelective.from_checkpoint(path)
    defaults, space = ens.BoxEnsemblerSelective.sweep_parameters()
    for pname, values in space.items():
        for v in values:
            params = dict(defaults, **{pname: v})
            persistent.update_parameters(**params)
            got = persistent.get_case_result()
            fresh = ens.BoxEnsemblerSelective.from_checkpoint(path)
            fresh.update_parameters(**params)
            results_equal(got, fresh.get_case_result(), f"{pname}={v}")
            host = ens.BoxEnsemblerSelective.from_checkpoint(path)
            host.update_parameters(**params)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ens, "_use_device_model_nms", lambda device: False)
                results_equal(got, host.get_case_result(), f"{pname}={v}, host")


def traced(fn):
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    spans, counts, _ = trace.take()
    return [s.name for s in spans].count("ensemble.model_nms"), counts


def test_streams_on_card_counts_the_streams(forced):
    e = fill(ens.BoxEnsemblerSelective(CASE), 3)
    spans, counts = traced(e.get_case_result)
    assert spans == 1 and counts == {"ensemble.streams_on_card": 5}
    # memoised: no launch, no span
    spans, counts = traced(e.get_case_result)
    assert spans == 0 and counts == {}
    e.update_parameters(ensemble_iou=0.3)  # an ensemble-level trial
    assert traced(e.get_case_result) == (0, {})
    e.update_parameters(model_iou=0.3)  # a model-level trial: one launch
    assert traced(e.get_case_result) == (1, {"ensemble.streams_on_card": 5})


@pytest.mark.parametrize("device", [None, "cpu"])
def test_host_path_counts_nothing(device):
    e = fill(ens.BoxEnsemblerSelective(CASE, device=device), 3)
    n = LAUNCHES["nms_topk"]
    spans, counts = traced(e.get_case_result)
    assert spans == 5 and "ensemble.streams_on_card" not in counts
    assert LAUNCHES["nms_topk"] == n


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_card_equals_host_at_deploy_size(cuda_device, seed):
    """40 streams of 850-1000 boxes (a deploy case: 5 folds x 8 flips), the
    weighted NMS at the default threshold and ``max_out``: one launch, the
    host library's keep lists."""
    rng = np.random.RandomState(seed)
    streams = [make_stream(rng, int(rng.randint(850, 1001))) for _ in range(40)]
    n0 = LAUNCHES["nms_topk"]
    got = batched_keeps(streams, "weighted_nms", 0.1, 100, cuda_device)
    assert LAUNCHES["nms_topk"] == n0 + 1
    for s, (g, w) in enumerate(zip(got, host_keeps(streams, "weighted_nms", 0.1, 100))):
        np.testing.assert_array_equal(g, w, err_msg=f"seed {seed}, stream {s}")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,classes", [(3, 1), (3, 2), (2, 2)])
def test_card_consolidation_equals_host(cuda_device, dim, classes):
    case = CASE if dim == 3 else CASE[1:]
    host = fill(ens.BoxEnsemblerSelective(case), 5, dim, classes)
    card = fill(ens.BoxEnsemblerSelective(case, device=cuda_device), 5, dim, classes)
    n0 = LAUNCHES["nms_topk"]
    got = card.get_case_result()
    assert LAUNCHES["nms_topk"] == n0 + 1
    want = host.get_case_result()
    assert len(got["pred_scores"]) == len(want["pred_scores"]) > 10
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    # the whole-case WBC runs on the card in float32 against float64
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=1e-5, atol=1e-4)
