"""Whole-case prediction, ensembling, post-processing sweeps and checkpoint
loading (counterpart of :mod:`nndetection_tpu.inference`)."""
from nndetection_tpu_torch.inference.ensembler import (
    BOX_ENSEMBLERS,
    BoxEnsemblerFastest,
    BoxEnsemblerLW,
    BoxEnsemblerSelective,
    BoxEnsemblerWBC,
    SegmentationEnsembler,
)
from nndetection_tpu_torch.inference.loading import (
    load_all_models,
    load_final_model,
    load_model_bundle,
)
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.inference.restore import restore_detection, restore_fmap
from nndetection_tpu_torch.inference.sweeper import BoxSweeper
from nndetection_tpu_torch.inference.tta import flip_image, get_tta_flips, invert_boxes

__all__ = [
    "ModelBundle",
    "Predictor",
    "BOX_ENSEMBLERS",
    "BoxEnsemblerFastest",
    "BoxEnsemblerLW",
    "BoxEnsemblerSelective",
    "BoxEnsemblerWBC",
    "SegmentationEnsembler",
    "restore_detection",
    "restore_fmap",
    "BoxSweeper",
    "load_all_models",
    "load_final_model",
    "load_model_bundle",
    "get_tta_flips",
    "flip_image",
    "invert_boxes",
]
