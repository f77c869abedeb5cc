"""Stage entry points of the port (counterpart of :mod:`nndetection_tpu.pipeline`);
so far the prediction of a directory of preprocessed cases."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.inference.restore import restore_fmap
from nndetection_tpu_torch.utils.io import load_pickle, save_pickle


def predict_dir(
    bundles: Sequence[ModelBundle],
    image_dir,
    output_dir,
    case_ids: Optional[Sequence[str]] = None,
    tta: bool = True,
    save_state: bool = False,
    restore: bool = False,
    ensembler_parameters: Optional[Dict[str, Any]] = None,
    batch_size: int = 4,
    predict_seg: bool = False,
    ensembler: str = "BoxEnsemblerSelective",
    resume: bool = False,
    device: Union[torch.device, str] = "cuda",
) -> None:
    """Predict every preprocessed case of ``image_dir`` (``{cid}.npy`` or
    ``{cid}.npz["data"]``, the last channel dropped, and ``{cid}.pkl``
    properties) into ``output_dir``: the ensembler state with
    ``save_state``, then ``{cid}_seg.npz`` with ``predict_seg`` (restored to
    the original grid with ``restore``), then ``{cid}_boxes.pkl``, last and
    atomically, so that its presence marks a finished case.

    ``resume=False`` always predicts again; ``resume=True`` skips the cases
    whose ``{cid}_boxes.pkl`` exists. ``device`` goes to the
    :class:`Predictor`: the card unless the caller asks for another."""
    image_dir, output_dir = Path(image_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    predictor = Predictor(bundles, batch_size=batch_size, tta=tta,
                          ensembler_parameters=ensembler_parameters, predict_seg=predict_seg,
                          ensembler=ensembler, device=device)
    if case_ids is None:
        case_ids = sorted(p.stem for p in image_dir.glob("*.npz") if not p.stem.endswith("_boxes"))
    for cid in case_ids:
        if resume and (output_dir / f"{cid}_boxes.pkl").exists():
            continue
        if (image_dir / f"{cid}.npy").exists():
            arr = np.load(image_dir / f"{cid}.npy", mmap_mode="r")
        else:
            arr = np.load(image_dir / f"{cid}.npz")["data"]
        data = np.asarray(arr[:-1], np.float32)
        props = load_pickle(image_dir / f"{cid}.pkl") if (image_dir / f"{cid}.pkl").exists() else {}
        t0 = time.time()
        result = predictor.predict_case(data, props, restore=restore)
        ens = result.pop("ensembler")
        if save_state:
            ens.save_state(output_dir, cid)
        if predict_seg and "pred_seg" in result:
            seg = result["pred_seg"]
            if restore and props:
                seg = restore_fmap(
                    seg,
                    transpose_forward=props.get("transpose_forward", [0, 1, 2]),
                    original_shape_cropped=props.get("shape_after_crop", seg.shape),
                    original_shape=props.get("shape_before_crop", seg.shape),
                    crop_bbox=props.get("crop_bbox"),
                )
            np.savez_compressed(output_dir / f"{cid}_seg.npz", seg=seg)
        save_pickle(
            {
                "pred_boxes": result["pred_boxes"],
                "pred_scores": result["pred_scores"],
                "pred_labels": result["pred_labels"],
                "restored": bool(restore),
                "prediction_time_s": time.time() - t0,
            },
            output_dir / f"{cid}_boxes.pkl",
        )
