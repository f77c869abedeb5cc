"""The segmentation output of the PyTorch port against the JAX package:
``Predictor(predict_seg=True)`` (tiny configuration, identical bridged
parameters, float32) with and without TTA, the ``SegmentationEnsembler``'s
accumulators, ``invert_seg``, ``resample_seg`` and ``restore_fmap``."""
import numpy as np
import pytest
import torch

from nndetection_tpu.data.resample import resample_seg as j_resample_seg
from nndetection_tpu.inference import tta as j_tta
from nndetection_tpu.inference.ensembler import SegmentationEnsembler as JaxSegEnsembler
from nndetection_tpu.inference.predictor import ModelBundle as JaxBundle
from nndetection_tpu.inference.predictor import Predictor as JaxPredictor
from nndetection_tpu.inference.restore import restore_fmap as j_restore_fmap
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.data.resample import resample_seg
from nndetection_tpu_torch.inference import predictor as predictor_mod
from nndetection_tpu_torch.inference import tta
from nndetection_tpu_torch.inference.ensembler import SegmentationEnsembler
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.inference.restore import restore_fmap
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from tests.test_torch_bridge import jax_cfg, jax_params, torch_cfg

torch.set_num_threads(1)

# voxels whose two highest averaged class probabilities lie closer than this
# may take either class: the two packages' float32 forwards differ by ~1e-6
NEAR_TIE = 1e-4
# ... and at most this share of the voxels may differ
MAX_TIE_SHARE = 1e-3
ACCUM_ATOL = 1e-6


class _Recording(SegmentationEnsembler):
    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recording.last = self


@pytest.mark.parametrize("tta_on,shape", [(False, (1, 48, 40, 44)), (True, (1, 40, 48, 24))])
def test_pred_seg_matches_jax(monkeypatch, tta_on, shape):
    """The second case is smaller than the patch along one axis: padded, and
    the map cropped back to the case."""
    for name in ("NNDET_IN_STATS", "NNDET_INFER_TILE_FACTOR", "NNDET_INFER_BATCH_VOXELS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(predictor_mod, "SegmentationEnsembler", _Recording)
    params = jax_params()
    case = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    want = JaxPredictor([JaxBundle(cfg=jax_cfg(), params=params)], tta=tta_on,
                        predict_seg=True).predict_case(case)["pred_seg"]
    sd = bridge.state_dict_from_flax(params, RetinaUNet(torch_cfg()))
    got = Predictor([ModelBundle(cfg=torch_cfg(), params=sd)], tta=tta_on, predict_seg=True,
                    device="cpu").predict_case(case)["pred_seg"]
    assert got.shape == want.shape == shape[1:] and got.dtype == want.dtype == np.int16
    assert set(np.unique(want)) <= {0, 1}

    ens = _Recording.last
    norm = (ens.accum / torch.clamp(ens.weight[None], min=1e-8)).numpy()
    top2 = np.sort(norm, axis=0)[-2:]
    lower = (np.asarray(ens.case_shape) - np.asarray(shape[1:])) // 2
    sl = tuple(slice(int(lo), int(lo) + s) for lo, s in zip(lower, shape[1:]))
    near = (top2[1] - top2[0])[sl] < NEAR_TIE
    differ = got != want
    assert not (differ & ~near).any()
    assert differ.sum() <= MAX_TIE_SHARE * got.size


def test_seg_ensembler_accumulators_match_jax():
    rng = np.random.RandomState(4)
    case, patch, c = (20, 24, 18), (8, 10, 12), 3
    got, want = SegmentationEnsembler(case, c, device="cpu"), JaxSegEnsembler(case, c)
    for origin in ((0, 0, 0), (4, 6, 6), (12, 14, 0), (12, 14, 6), (0, 14, 6)):
        logits = rng.standard_normal((*patch, c)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        got.process_tile(torch.from_numpy(probs), origin)
        want.process_tile(probs, origin)
    np.testing.assert_allclose(got.accum.numpy(), want.accum, rtol=0, atol=ACCUM_ATOL)
    np.testing.assert_allclose(got.weight.numpy(), want.weight, rtol=0, atol=ACCUM_ATOL)
    np.testing.assert_array_equal(got.get_case_result(), want.get_case_result())
    assert SegmentationEnsembler.sweep_parameters() == JaxSegEnsembler.sweep_parameters() == ({}, {})


def test_invert_seg_matches_jax():
    seg = np.random.RandomState(5).rand(2, 4, 5, 6, 3).astype(np.float32)
    for flips in j_tta.get_tta_flips(3):
        np.testing.assert_array_equal(tta.invert_seg(torch.from_numpy(seg), flips).numpy(),
                                      j_tta.invert_seg(seg, flips))


@pytest.mark.parametrize("new_shape,separate", [((30, 20, 14), None), ((9, 31, 16), 0),
                                                 ((12, 16, 20), None)])
def test_resample_seg_matches_jax(new_shape, separate):
    seg = np.random.RandomState(6).randint(0, 3, (12, 16, 20)).astype(np.int16)
    kw = dict(do_separate_z=separate is not None, axis=separate)
    np.testing.assert_array_equal(resample_seg(seg, new_shape, **kw),
                                  j_resample_seg(seg, new_shape, **kw))


@pytest.mark.parametrize("crop", [None, [[2, 22], [0, 30], [5, 29]]])
def test_restore_fmap_matches_jax(crop):
    seg = np.random.RandomState(7).randint(0, 2, (16, 12, 20)).astype(np.int16)
    kw = dict(transpose_forward=[2, 0, 1], original_shape_cropped=(20, 30, 24),
              original_shape=(25, 30, 40), crop_bbox=crop)
    got, want = restore_fmap(seg, **kw), j_restore_fmap(seg, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
