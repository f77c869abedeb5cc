"""Retina U-Net: encoder + U-FPN + RetinaNet heads + auxiliary segmentation
head (counterpart of :mod:`nndetection_tpu.models.retina_unet`: the config,
the forward, target assignment and the train-step losses, and the detection
post-processing).

The batch is an explicit dimension throughout, where the JAX package
``vmap``s one image at a time: matching and sampling run all images of a
batch together, post-processing too, and their NMS runs as one kernel
launch.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nndetection_tpu_torch import losses as L
from nndetection_tpu_torch.core.boxes.anchors import AnchorGenerator
from nndetection_tpu_torch.core.boxes.coder import BoxCoder
from nndetection_tpu_torch.core.boxes.matcher import ATSSMatcher, IoUMatcher, gather_matched
from nndetection_tpu_torch.core.boxes.nms import batched_nms_topk
from nndetection_tpu_torch.core.boxes.ops import clip_boxes_to_image, small_boxes_mask
from nndetection_tpu_torch.core.boxes.sampler import HardNegativeSamplerBatched
from nndetection_tpu_torch.models.conv import (
    Conv,
    ConvTranspose,
    GroupNorm,
    InstanceNorm,
    channels_last,
)
from nndetection_tpu_torch.models.decoder import UFPN
from nndetection_tpu_torch.models.encoder import Encoder, encoder_strides
from nndetection_tpu_torch.models.heads import (
    Classifier,
    DeepSupervisionSegmenter,
    Regressor,
    Segmenter,
)
from nndetection_tpu_torch.parallel.spatial import gather_spatial, get_spatial_axis
from nndetection_tpu_torch.utils import trace


def _tuplify(v: Any) -> Any:
    return tuple(_tuplify(x) for x in v) if isinstance(v, list) else v


@dataclass(frozen=True)
class RetinaUNetConfig:
    """Static architecture, training-step and post-processing configuration;
    the same fields and defaults as the JAX package's ``RetinaUNetConfig``.
    ``exact_topk`` is carried for the JSON round trip: the port's top-k is
    always exact."""

    dim: int = 3
    in_channels: int = 1
    classifier_classes: int = 1  # foreground classes
    seg_classes: int = 1
    start_channels: int = 32
    max_channels: int = 320
    fpn_channels: int = 128
    head_channels: int = 128
    conv_kernels: Tuple = ((3, 3, 3),) * 5
    strides: Tuple = ((2, 2, 2),) * 4  # between stages
    decoder_levels: Tuple[int, ...] = (1, 2, 3, 4)
    patch_size: Tuple[int, ...] = (96, 96, 96)
    # anchors: per-decoder-level size tuples along each axis
    anchor_width: Tuple = ((8, 16, 24),) * 4
    anchor_height: Tuple = ((8, 16, 24),) * 4
    anchor_depth: Tuple = ((8, 16, 24),) * 4
    # head
    head_num_convs: int = 1
    learn_scale: bool = True
    prior_prob: float = 0.01
    # matcher / sampler
    matcher_type: str = "atss"
    matcher_num_candidates: int = 4
    matcher_center_in_gt: bool = False
    matcher_low_threshold: float = 0.3
    matcher_high_threshold: float = 0.5
    # losses
    cls_loss_type: str = "bce"
    reg_loss_type: str = "giou"
    class_weights: Optional[Tuple[float, ...]] = None
    head_type: str = "hnm"
    focal_gamma: float = 2.0
    focal_alpha: float = -1.0
    batch_size_per_image: int = 32
    positive_fraction: float = 0.33
    pool_size: float = 20.0
    min_neg: int = 1
    # segmenter
    segmenter_alpha: float = 0.5
    segmenter_fg_bg: bool = True
    batch_dice: bool = True
    segmenter_deep_supervision: bool = False
    seg_supervision_levels: int = 3
    seg_loss_type: str = "dice_ce"
    seg_topk_fraction: float = 10.0
    # postprocessing
    topk_candidates: int = 10000
    score_thresh: float = 0.0
    detections_per_img: int = 100
    remove_small_boxes: float = 0.01
    nms_thresh: float = 0.6
    dtype: str = "bfloat16"
    remat: bool = True
    exact_topk: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def num_levels(self) -> int:
        return len(self.conv_kernels)

    @property
    def classifier_out_classes(self) -> int:
        """Logit channels of the classifier: softmax-CE adds a background
        column."""
        return self.classifier_classes + (1 if self.cls_loss_type == "ce" else 0)

    def anchors_per_loc(self) -> int:
        if self.dim == 2:
            return len(self.anchor_width[0]) * len(self.anchor_height[0])
        return (
            len(self.anchor_width[0])
            * len(self.anchor_height[0])
            * len(self.anchor_depth[0])
        )

    def decoder_strides(self) -> List[List[int]]:
        """Cumulative stride of each decoder level used by the heads."""
        all_strides = encoder_strides(self.num_levels, self.strides, self.dim)
        return [all_strides[l] for l in self.decoder_levels]

    def feature_shapes(self, patch_size: Optional[Sequence[int]] = None) -> List[Tuple[int, ...]]:
        ps = tuple(patch_size or self.patch_size)
        return [tuple(-(-p // s) for p, s in zip(ps, stride))
                for stride in self.decoder_strides()]

    def anchors(self, patch_size: Optional[Sequence[int]] = None) -> Tuple[np.ndarray, List[int]]:
        """The full anchor grid for a patch size."""
        gen = AnchorGenerator(
            width=self.anchor_width,
            height=self.anchor_height,
            depth=self.anchor_depth if self.dim == 3 else None,
        )
        return gen.grid_anchors(self.feature_shapes(patch_size), self.decoder_strides())

    def to_dict(self) -> Dict[str, Any]:
        """JSON-compatible dict (tuples become lists)."""
        return json.loads(json.dumps(dataclasses.asdict(self)))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RetinaUNetConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown RetinaUNetConfig fields: {sorted(unknown)}")
        return cls(**{k: _tuplify(v) for k, v in d.items()})


class RetinaUNet(nn.Module):
    """Forward network: channel-last images ``[B, *patch, C_in]`` (2D or 3D
    by ``cfg.dim``) -> detection and segmentation predictions. Submodules are
    named after the flax scopes (``encoder``, ``decoder``, ``classifier``,
    ``regressor``, ``segmenter``). With ``cfg.segmenter_deep_supervision``
    the segmenter has a head per supervised level: ``seg_logits`` is the
    highest resolution's, ``seg_logits_aux{i}`` level ``i``'s.

    Parameters are float32, initialized as flax initializes the JAX model
    (from ``generator`` when given); activations run in
    ``cfg.compute_dtype``. With ``cfg.remat`` and gradients on, the encoder,
    decoder, classifier and regressor recompute their activations in the
    backward pass (``torch.utils.checkpoint``), as the JAX model wraps them
    in ``nn.remat``.
    """

    def __init__(self, cfg: RetinaUNetConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.encoder = Encoder(
            cfg.in_channels, cfg.conv_kernels, cfg.strides,
            start_channels=cfg.start_channels, max_channels=cfg.max_channels, dim=dim,
        )
        all_strides = encoder_strides(cfg.num_levels, cfg.strides, dim)
        self.decoder = UFPN(
            self.encoder.channels, [tuple(s) for s in all_strides],
            cfg.decoder_levels, cfg.fpn_channels, dim=dim,
        )
        head_in = self.decoder.out_channels[cfg.decoder_levels[0]]
        self.classifier = Classifier(
            head_in, cfg.classifier_out_classes, cfg.anchors_per_loc(),
            internal_channels=cfg.head_channels, num_convs=cfg.head_num_convs,
            prior_prob=cfg.prior_prob, dim=dim,
        )
        self.regressor = Regressor(
            head_in, cfg.anchors_per_loc(), len(cfg.decoder_levels),
            internal_channels=cfg.head_channels, num_convs=cfg.head_num_convs,
            learn_scale=cfg.learn_scale, dim=dim,
        )
        seg_classes = 1 if cfg.segmenter_fg_bg else cfg.seg_classes
        if cfg.segmenter_deep_supervision:
            self.segmenter = DeepSupervisionSegmenter(
                self.decoder.out_channels, seg_classes, cfg.seg_supervision_levels, dim=dim)
        else:
            self.segmenter = Segmenter(self.decoder.out_channels[0], seg_classes, dim=dim)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose, InstanceNorm, GroupNorm)):
                m.reset_parameters(generator)
        if self.regressor.scales is not None:
            self.regressor.scales.data.fill_(1.0)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        remat = self.cfg.remat and torch.is_grad_enabled()

        def run(module, arg):
            return checkpoint(module, arg, use_reentrant=False) if remat else module(arg)

        x = images.to(self.cfg.compute_dtype).movedim(-1, 1)
        fmaps = run(self.encoder, channels_last(x))
        decoded = run(self.decoder, fmaps)
        head_maps = [decoded[l] for l in self.cfg.decoder_levels]
        # head outputs stay in the compute dtype; consumers upcast
        out = {
            "box_logits": run(self.classifier, head_maps),
            "box_deltas": run(self.regressor, head_maps),
        }
        seg = self.segmenter(decoded)
        group = get_spatial_axis()
        if group is not None:
            # the seg loss runs on the full maps: gather the z-slabs back
            seg = ([gather_spatial(s, group, spatial_axis=1) for s in seg]
                   if isinstance(seg, list) else gather_spatial(seg, group, spatial_axis=1))
        if self.cfg.segmenter_deep_supervision:
            out["seg_logits"] = seg[0]
            out.update({f"seg_logits_aux{i}": s for i, s in enumerate(seg[1:], start=1)})
        else:
            out["seg_logits"] = seg
        return out


def assign_targets(
    cfg: RetinaUNetConfig,
    anchors: torch.Tensor,
    anchors_per_level: Sequence[int],
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ATSS (or IoU) assignment of a batch: ``labels [B, A]`` (0 bg, -1
    ignore, 1..C fg) and ``matched_boxes [B, A, 2*dim]``."""
    if cfg.matcher_type == "atss":
        matcher = ATSSMatcher(num_candidates=cfg.matcher_num_candidates,
                              center_in_gt=cfg.matcher_center_in_gt)
    else:
        matcher = IoUMatcher(low_threshold=cfg.matcher_low_threshold,
                             high_threshold=cfg.matcher_high_threshold)
    matched = matcher(gt_boxes, gt_mask, anchors, tuple(anchors_per_level), cfg.anchors_per_loc())
    return gather_matched(matched, gt_boxes, gt_classes)


def train_step_loss(
    cfg: RetinaUNetConfig,
    predictions: Dict[str, torch.Tensor],
    anchors: torch.Tensor,
    anchors_per_level: Sequence[int],
    targets: Dict[str, torch.Tensor],
    generator: torch.Generator,
) -> Dict[str, torch.Tensor]:
    """Losses of one train step: the detection head (matching, hard-negative
    sampling per image, classification and box regression) and the
    segmentation head (CE + dice), as the JAX package's ``train_step_loss``.

    With ``cfg.segmenter_deep_supervision`` the segmentation loss is
    :func:`~nndetection_tpu_torch.losses.deep_supervision_seg_loss` over
    ``seg_logits`` and the ``seg_logits_aux{i}`` present, each level's target
    max-pooled to its size; it is reported as ``seg_ce``, and ``seg_dice``
    is 0.

    Args:
        predictions: ``box_logits [B, A, C]``, ``box_deltas [B, A, 2*dim]``,
            ``seg_logits [B, *spatial, C+1]`` (and ``seg_logits_aux{i}``)
        anchors: ``[A, 2*dim]`` on the predictions' device
        targets: ``gt_boxes [B, G, 2*dim]``, ``gt_classes [B, G]``,
            ``gt_mask [B, G]``, ``seg [B, *spatial]`` int
        generator: the sampler's random numbers (unused by ``no_sampler``)

    Returns scalar tensors ``cls``, ``reg``, ``seg_ce``, ``seg_dice``,
    ``num_pos`` and ``num_neg``.
    """
    box_logits = predictions["box_logits"]
    box_deltas = predictions["box_deltas"]
    b, a, c = box_logits.shape
    with trace.span("train.match"):
        labels, matched_boxes = assign_targets(
            cfg, anchors, anchors_per_level,
            targets["gt_boxes"], targets["gt_classes"], targets["gt_mask"])

    if cfg.head_type == "no_sampler":
        # every non-ignore anchor enters the classification loss, every
        # positive the regression loss
        pos_mask, neg_mask = labels >= 1, labels == 0
        sample_mask = labels >= 0
    else:
        # float32 foreground probabilities rank the hard negatives
        # (softmax minus the background column for the CE head)
        logits32 = box_logits.detach().float()
        if cfg.cls_loss_type == "ce":
            fg_probs = torch.softmax(logits32, dim=-1)[..., 1:].amax(dim=-1)
        else:
            fg_probs = torch.sigmoid(logits32).amax(dim=-1)
        sampler = HardNegativeSamplerBatched(
            batch_size_per_image=cfg.batch_size_per_image,
            positive_fraction=cfg.positive_fraction,
            min_neg=cfg.min_neg, pool_size=cfg.pool_size, batch_size=1)
        with trace.span("train.sample"):
            pos_mask, neg_mask = sampler(generator, labels, fg_probs)
        sample_mask = pos_mask | neg_mask
    pos_mask, neg_mask, sample_mask = (m.reshape(-1) for m in (pos_mask, neg_mask, sample_mask))
    flat_labels = labels.reshape(-1)
    # the "RegAll" variants and the no-sampler head regress every positive
    reg_mask = pos_mask if cfg.head_type == "hnm" else flat_labels >= 1
    num_pos = pos_mask.float().sum().clamp(min=1.0)

    flat_logits = box_logits.reshape(-1, c)
    cls_targets = flat_labels.clamp(min=0)
    if cfg.cls_loss_type == "focal":
        cls_loss = L.focal_loss(flat_logits, cls_targets, sample_mask,
                                num_classes=cfg.classifier_classes, gamma=cfg.focal_gamma,
                                alpha=cfg.focal_alpha) / num_pos
    elif cfg.cls_loss_type == "ce":
        cls_loss = L.softmax_ce_masked(flat_logits, cls_targets, sample_mask,
                                       class_weights=cfg.class_weights)
    else:
        cls_loss = L.bce_one_hot(flat_logits, cls_targets, sample_mask,
                                 num_classes=cfg.classifier_classes)
    if cfg.head_type == "no_sampler":
        cls_loss = cls_loss / num_pos

    coder = BoxCoder(dim=cfg.dim)
    n_coords = anchors.shape[-1]
    flat_anchors = anchors[None].expand(b, a, n_coords).reshape(-1, n_coords)
    flat_matched = matched_boxes.reshape(-1, n_coords)
    flat_deltas = box_deltas.reshape(-1, n_coords)
    if cfg.reg_loss_type == "l1":
        reg_loss = L.smooth_l1_loss(flat_deltas, coder.encode(flat_matched, flat_anchors), reg_mask)
    else:
        reg_loss = L.giou_loss(coder.decode(flat_deltas, flat_anchors), flat_matched, reg_mask)

    seg_target = targets["seg"]
    if cfg.segmenter_fg_bg:
        seg_target = (seg_target > 0).long()
    seg_logits = predictions["seg_logits"]
    if cfg.segmenter_deep_supervision:
        logits_list = [seg_logits] + [
            predictions[f"seg_logits_aux{i}"] for i in range(1, cfg.seg_supervision_levels)
            if f"seg_logits_aux{i}" in predictions]
        strides = [tuple(t // s for t, s in zip(seg_target.shape[1:], lg.shape[1:-1]))
                   for lg in logits_list]
        seg_ce = L.deep_supervision_seg_loss(
            logits_list, seg_target, strides, alpha=cfg.segmenter_alpha,
            batch_dice=cfg.batch_dice)
        seg_dice = seg_ce.new_zeros(())
    else:
        if cfg.seg_loss_type == "dice_topk":
            ce = L.topk_ce_loss(seg_logits, seg_target, cfg.seg_topk_fraction)
        else:
            ce = L.softmax_ce_loss(seg_logits, seg_target)
        seg_ce = cfg.segmenter_alpha * ce
        seg_dice = (1 - cfg.segmenter_alpha) * L.soft_dice_loss(
            seg_logits, seg_target, batch_dice=cfg.batch_dice, do_bg=False)
    return {
        "cls": cls_loss,
        "reg": reg_loss,
        "seg_ce": seg_ce,
        "seg_dice": seg_dice,
        "num_pos": pos_mask.float().sum(),
        "num_neg": neg_mask.float().sum(),
    }


def batched_postprocess(
    cfg: RetinaUNetConfig,
    predictions: Dict[str, torch.Tensor],
    anchors: torch.Tensor,
    image_shape: Sequence[int],
    with_seg: bool = True,
    topk_candidates: Optional[int] = None,
    max_out: Optional[int] = None,
    score_thresh: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Detection post-processing of a batch: decode -> clip -> flatten over
    classes -> top-k -> score threshold -> small-box removal -> class-batched
    NMS -> cap at ``max_out``.

    Args:
        predictions: ``box_logits [B, A, C]``, ``box_deltas [B, A, 2*dim]``
            (and ``seg_logits`` for ``with_seg``)
        anchors: ``[A, 2*dim]`` on the predictions' device

    Returns fixed-size ``boxes [B, M, 2*dim]``, ``scores [B, M]``,
    ``labels [B, M]`` int32 and ``valid [B, M]`` with ``M = max_out``.
    """
    logits = predictions["box_logits"].float()
    if cfg.cls_loss_type == "ce":
        # the softmax-CE head's background column is dropped
        probs_fg = torch.softmax(logits, dim=-1)[..., 1:]
    else:
        probs_fg = torch.sigmoid(logits)
    b, a, c = probs_fg.shape
    topk = min(topk_candidates or cfg.topk_candidates, a * c)
    max_out = max_out or cfg.detections_per_img
    score_thresh = cfg.score_thresh if score_thresh is None else score_thresh

    boxes = BoxCoder(dim=cfg.dim).decode(predictions["box_deltas"], anchors)
    boxes = clip_boxes_to_image(boxes, image_shape)

    # a stable descending sort puts the lower index first among equal
    # scores, as jax.lax.top_k does (torch.topk promises no tie order)
    top_probs, top_idx = torch.sort(probs_fg.reshape(b, -1), dim=1, descending=True,
                                    stable=True)
    top_probs, top_idx = top_probs[:, :topk], top_idx[:, :topk]
    top_labels = (top_idx % c).to(torch.int32)
    top_boxes = torch.gather(boxes, 1, (top_idx // c)[..., None].expand(-1, -1, boxes.shape[-1]))

    valid = top_probs > score_thresh
    if cfg.remove_small_boxes is not None:
        valid = valid & small_boxes_mask(top_boxes, cfg.remove_small_boxes)
    keep_idx, keep_valid = batched_nms_topk(
        top_boxes, top_probs, top_labels, valid, cfg.nms_thresh, max_out)
    out = {
        "boxes": torch.gather(top_boxes, 1, keep_idx[..., None].expand(-1, -1, boxes.shape[-1])),
        "scores": torch.gather(top_probs, 1, keep_idx),
        "labels": torch.gather(top_labels, 1, keep_idx),
        "valid": keep_valid,
    }
    if with_seg and "seg_logits" in predictions:
        out["seg_probs"] = torch.softmax(predictions["seg_logits"].float(), dim=-1)
    return out


def postprocess_detections(
    cfg: RetinaUNetConfig,
    box_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    anchors: torch.Tensor,
    image_shape: Sequence[int],
    **kwargs,
) -> Dict[str, torch.Tensor]:
    """Single-image :func:`batched_postprocess`: ``box_logits [A, C]``,
    ``box_deltas [A, 2*dim]``; outputs without the batch axis."""
    out = batched_postprocess(
        cfg, {"box_logits": box_logits[None], "box_deltas": box_deltas[None]},
        anchors, image_shape, with_seg=False, **kwargs)
    return {k: v[0] for k, v in out.items()}
