"""Model-family registry: named module variants that map a :class:`Plan` to
a ``RetinaUNetConfig`` (counterpart of :mod:`nndetection_tpu.modules`)."""
from __future__ import annotations

from typing import Any, Dict

from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig
from nndetection_tpu_torch.utils.registry import MODULE_REGISTRY


class BaseModule:
    """One entry is the wiring of a published model variant."""

    config_overrides: Dict[str, Any] = {}

    @classmethod
    def model_config(cls, plan, **overrides) -> RetinaUNetConfig:
        merged = dict(cls.config_overrides)
        merged.update(overrides)
        return plan.model_config(**merged)


@MODULE_REGISTRY.register(name="RetinaUNetV001")
class RetinaUNetV001(BaseModule):
    """The published default: ATSS, sigmoid BCE, GIoU, hard-negative mining,
    a foreground/background segmenter."""

    config_overrides = {
        "matcher_type": "atss",
        "cls_loss_type": "bce",
        "reg_loss_type": "giou",
        "segmenter_fg_bg": True,
    }


@MODULE_REGISTRY.register(name="RetinaUNetV000")
class RetinaUNetV000(BaseModule):
    """The reference's base wiring: IoU matcher, class-weighted softmax CE,
    smooth L1, hard-negative mining, a multi-class dice segmenter."""

    config_overrides = {
        "matcher_type": "iou",
        "cls_loss_type": "ce",
        "reg_loss_type": "l1",
        "segmenter_fg_bg": False,
    }


@MODULE_REGISTRY.register(name="RetinaUNetV001RegAll")
class RetinaUNetV001RegAll(BaseModule):
    """V001 regressing every positive, not the sampled subset."""

    config_overrides = {
        "matcher_type": "atss",
        "cls_loss_type": "bce",
        "reg_loss_type": "giou",
        "segmenter_fg_bg": True,
        "head_type": "hnm_reg_all",
    }


@MODULE_REGISTRY.register(name="RetinaUNetV001NoSampler")
class RetinaUNetV001NoSampler(BaseModule):
    """V001 without hard-negative mining: every non-ignored anchor enters
    the classification loss."""

    config_overrides = {
        "matcher_type": "atss",
        "cls_loss_type": "bce",
        "reg_loss_type": "giou",
        "segmenter_fg_bg": True,
        "head_type": "no_sampler",
    }


@MODULE_REGISTRY.register(name="RetinaUNetV002")
class RetinaUNetV002(BaseModule):
    """Focal loss (no label smoothing), ATSS and GIoU."""

    config_overrides = {
        "matcher_type": "atss",
        "cls_loss_type": "focal",
        "reg_loss_type": "giou",
    }


@MODULE_REGISTRY.register(name="RetinaUNetV001TopK")
class RetinaUNetV001TopK(BaseModule):
    """V001 with the dice + top-k CE segmentation loss."""

    config_overrides = {
        "matcher_type": "atss",
        "cls_loss_type": "bce",
        "reg_loss_type": "giou",
        "segmenter_fg_bg": True,
        "seg_loss_type": "dice_topk",
    }


@MODULE_REGISTRY.register(name="RetinaUNetV010")
class RetinaUNetV010(BaseModule):
    """Classic IoU matching, BCE and smooth L1 (a RetinaNet-style
    baseline)."""

    config_overrides = {
        "matcher_type": "iou",
        "cls_loss_type": "bce",
        "reg_loss_type": "l1",
    }
