"""Whole-case sliding-window predictor with mirror TTA and multi-model
ensembling (counterpart of :mod:`nndetection_tpu.inference.predictor`).

The padded case goes to the device once; tiles are cut there in batches of
``tiles_per_call``. For each batch, all flip variants are built on the
device, run through the model as one batch, post-processed together (one NMS
launch for every tile x flip) and their boxes inverted back to tile
coordinates on the device; only the small fixed-size detection arrays come
back to the host, where the box ensembler named by ``ensembler`` (any name
of :data:`BOX_ENSEMBLERS`) merges them. Every (model x flip) is a separate
ensembler stream, as in the JAX package. The ensembler gets the predictor's
device: on the card its whole-case weighted box clustering runs there.

With ``predict_seg`` each variant's softmax map is flipped back and the
variants averaged on the device; the :class:`SegmentationEnsembler` stitches
them there, tile by tile, and only the case's argmax map comes to the host.

Under a profiler a case records the spans ``predict.case`` (its root),
``predict.stage``, ``predict.cut``, and per call ``predict.forward``,
``predict.postprocess``, ``predict.fetch`` and ``predict.ensemble_tiles``
(:mod:`nndetection_tpu_torch.utils.trace`; ``docs/tracing.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.core.boxes.ops_np import box_axis_vector_np
from nndetection_tpu_torch.data.patching import compute_grid, pad_to_min_shape
from nndetection_tpu_torch.inference.ensembler import BOX_ENSEMBLERS, SegmentationEnsembler
from nndetection_tpu_torch.inference.restore import restore_detection
from nndetection_tpu_torch.inference.tta import flip_image, get_tta_flips, invert_boxes, invert_seg
from nndetection_tpu_torch.models.retina_unet import (
    RetinaUNet,
    RetinaUNetConfig,
    batched_postprocess,
)
from nndetection_tpu_torch.utils import trace

# voxels of the model batch of one call (tiles x flips), the JAX package's
# rule: deploy patch 96x128x128 with 8 flips -> 2 tiles per call, without
# TTA -> 16
_BATCH_VOXELS = 26_000_000


@dataclass
class ModelBundle:
    """One trained model (e.g. one CV fold): its config and the port
    ``state_dict`` of its parameters (:mod:`nndetection_tpu_torch.bridge`
    makes one from a flax tree)."""

    cfg: RetinaUNetConfig
    params: Mapping[str, torch.Tensor]
    name: str = "model"


class Predictor:
    def __init__(
        self,
        models: Sequence[ModelBundle],
        batch_size: int = 4,
        overlap: float = 0.5,
        tta: bool = True,
        tile_topk: int = 1000,
        tile_detections: int = 100,
        ensembler_parameters: Optional[Dict[str, Any]] = None,
        predict_seg: bool = False,
        ensembler: str = "BoxEnsemblerSelective",
        device: Union[torch.device, str] = "cuda",
    ):
        """``device`` is the card unless the caller passes another (``"cpu"``
        for the plain versions of the kernels); without CUDA the default
        raises. ``batch_size`` is kept for the JAX signature; the tiles per
        call follow the voxel budget."""
        if not models:
            raise ValueError("Predictor needs at least one model")
        self.ensembler_cls = BOX_ENSEMBLERS[ensembler]
        self.models = list(models)
        self.cfg = models[0].cfg
        self.patch_size = tuple(self.cfg.patch_size)
        self.batch_size = batch_size
        self.overlap = overlap
        self.tta_flips = get_tta_flips(self.cfg.dim, tta)
        self.tile_topk = tile_topk
        self.tile_detections = tile_detections
        self.ensembler_parameters = ensembler_parameters
        self.predict_seg = predict_seg
        self.device = resolve_device(device)
        vox = int(np.prod(self.patch_size))
        self.tiles_per_call = min(16, max(1, _BATCH_VOXELS // (vox * len(self.tta_flips))))
        self.nets = []
        for bundle in self.models:
            net = RetinaUNet(bundle.cfg)
            net.load_state_dict(bundle.params)
            self.nets.append(net.to(self.device).eval())
        self.anchors = torch.from_numpy(self.cfg.anchors()[0]).to(self.device)

    def _infer(self, net: RetinaUNet, tiles: torch.Tensor):
        """tiles ``[B, *patch, C]`` on the device -> per-variant detections
        ``[V, B, K, ...]`` as NumPy arrays, and with ``predict_seg`` the
        variant-averaged softmax maps ``[B, *patch, C_seg]`` on the device
        (else ``None``)."""
        cfg, flips, k = net.cfg, self.tta_flips, self.tile_detections
        n_var, b = len(flips), tiles.shape[0]
        with trace.span("predict.forward"):
            variants = torch.cat([flip_image(tiles, f, spatial_offset=1) for f in flips])
            trace.count("predict.tiles", variants.shape[0])
            preds = net(variants)
        with trace.span("predict.postprocess"):
            out = batched_postprocess(
                cfg, preds, self.anchors, cfg.patch_size, with_seg=self.predict_seg,
                topk_candidates=self.tile_topk, max_out=k,
            )
            seg = None
            if self.predict_seg:
                probs = out["seg_probs"].view(n_var, b, *out["seg_probs"].shape[1:])
                # each variant flipped back, then the mean: feeding it once per
                # tile equals feeding every variant under the ensembler's weight
                # normalization
                seg = sum(invert_seg(probs[v], flips[v], spatial_offset=1)
                          for v in range(n_var)) / float(n_var)
            boxes = out["boxes"].view(n_var, b, k, 2 * cfg.dim)
            result = {
                # each variant's boxes back in unflipped tile coordinates
                "boxes": torch.stack([invert_boxes(boxes[v], flips[v], cfg.patch_size)
                                      for v in range(n_var)]),
                "scores": out["scores"].view(n_var, b, k),
                "labels": out["labels"].view(n_var, b, k),
                "valid": out["valid"].view(n_var, b, k),
            }
        # the host waits here for the card
        with trace.span("predict.fetch"):
            return {name: t.cpu().numpy() for name, t in result.items()}, seg

    @torch.inference_mode()
    def predict_case(
        self,
        data: np.ndarray,  # [C, *spatial] preprocessed
        properties: Optional[Dict[str, Any]] = None,
        restore: bool = False,
    ) -> Dict[str, np.ndarray]:
        with trace.span("predict.case"):
            properties = properties or {}
            # the case goes to the device once, in bfloat16 as the JAX
            # predictor sends its tiles; tiles are cut there, channel-last
            with trace.span("predict.stage"):
                padded, lower = pad_to_min_shape(data, self.patch_size, spatial_offset=1)
                case = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float32))
                case = case.to(torch.bfloat16).to(self.device)
            case_shape = padded.shape[1:]
            grid = compute_grid(case_shape, self.patch_size, self.overlap)
            box_ens = self.ensembler_cls(
                case_shape, parameters=self.ensembler_parameters, properties=properties,
                device=self.device)
            seg_ens = None
            if self.predict_seg:
                n_seg = (1 if self.cfg.segmenter_fg_bg else self.cfg.seg_classes) + 1
                seg_ens = SegmentationEnsembler(case_shape, n_seg, device=self.device)

            bsz = self.tiles_per_call
            n_tiles = len(grid)
            batches = []
            with trace.span("predict.cut"):
                for start in range(0, n_tiles, bsz):
                    tiles = [
                        case[(slice(None),) + tuple(slice(int(o), int(o) + p)
                                                    for o, p in zip(origin, self.patch_size))]
                        for origin in grid[start:start + bsz]
                    ]
                    batches.append(torch.stack(tiles).movedim(1, -1))

            for m_idx, (bundle, net) in enumerate(zip(self.models, self.nets)):
                stream_names = [f"{bundle.name}{m_idx}_t{flips}" for flips in self.tta_flips]
                for b_idx, tiles in enumerate(batches):
                    start = b_idx * bsz
                    out, seg = self._infer(net, tiles)
                    with trace.span("predict.ensemble_tiles"):
                        for v, stream in enumerate(stream_names):
                            box_ens.add_model(stream)
                            for b in range(tiles.shape[0]):
                                valid = out["valid"][v, b]
                                box_ens.process_tile(
                                    out["boxes"][v, b][valid],
                                    out["scores"][v, b][valid],
                                    out["labels"][v, b][valid],
                                    tile_origin=grid[start + b],
                                    tile_size=self.patch_size,
                                )
                        if seg_ens is not None:
                            for b in range(tiles.shape[0]):
                                seg_ens.process_tile(seg[b], grid[start + b])

            result = box_ens.get_case_result()
            # undo the min-shape padding offset
            if lower.any() and len(result["pred_boxes"]):
                off = box_axis_vector_np(lower.astype(np.float64), self.cfg.dim)
                result["pred_boxes"] = result["pred_boxes"] - off[None]
            if seg_ens is not None:
                sl = tuple(slice(int(lo), int(lo) + s) for lo, s in zip(lower, data.shape[1:]))
                result["pred_seg"] = seg_ens.get_case_result()[sl]
            result["ensembler"] = box_ens

            if restore and properties:
                result["pred_boxes"] = restore_detection(
                    result["pred_boxes"],
                    transpose_forward=properties.get("transpose_forward", [0, 1, 2]),
                    original_spacing=properties.get("original_spacing", np.ones(self.cfg.dim)),
                    resampled_spacing=properties.get(
                        "spacing_after_resampling", np.ones(self.cfg.dim)),
                    crop_bbox=properties.get("crop_bbox"),
                )
            return result
