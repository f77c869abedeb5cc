"""Stage entry points of the port (counterpart of :mod:`nndetection_tpu.pipeline`):
the folds and loaders of training, and the prediction of a directory of
preprocessed cases."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.data.augment import (
    AugmentConfig,
    generator_patch_size_for,
    get_generator_patch_size,
)
from nndetection_tpu_torch.data.loader import PatchLoader, build_case_records
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.inference.restore import restore_fmap
from nndetection_tpu_torch.utils.io import load_pickle, save_pickle

NUM_FOLDS = 5
SPLIT_SEED = 12345


def make_splits(case_ids: Sequence[str], path, num_folds: int = NUM_FOLDS) -> List[Dict]:
    """Deterministic K-fold split, read from ``path`` when it exists, else
    written there (``splits_final.pkl``)."""
    path = Path(path)
    if path.exists():
        return load_pickle(path)
    rng = np.random.RandomState(SPLIT_SEED)
    ids = np.asarray(sorted(case_ids))
    perm = rng.permutation(len(ids))
    folds = np.array_split(perm, num_folds)
    splits = []
    for k in range(num_folds):
        val = set(folds[k].tolist())
        splits.append(
            {
                "train": [str(ids[i]) for i in range(len(ids)) if i not in val],
                "val": [str(ids[i]) for i in sorted(val)],
            }
        )
    save_pickle(splits, path)
    return splits


def build_loaders(
    plan: Any,
    image_dir,
    splits: List[Dict],
    fold: int,
    batch_size: int,
    oversample: float = 0.5,
    augment: bool = True,
    seed: int = 0,
    aug_cfg: Optional[AugmentConfig] = None,
    device_pool: Any = "auto",
    device: Union[torch.device, str] = "cuda",
):
    """The train and validation :class:`PatchLoader` of ``fold`` (``-1``:
    every case in both) over the cases of ``image_dir``. ``plan`` is any
    object with ``patch_size`` and ``max_instances_per_patch``.

    The train loader crops the generator patch of ``aug_cfg`` (the final
    patch without augmentation) with the foreground constraint on the
    final patch; the validation loader crops the final patch and replays
    the same patches every epoch. Both are host loaders, as the JAX
    package builds them off a TPU; ``device_pool=True`` (the JAX package's
    TPU patch pool) is not ported. For the card (``device``, unless the
    caller passes ``"cpu"``) the batches come in pinned memory, so that
    their copy to the card is asynchronous."""
    if device_pool is True:
        raise NotImplementedError(
            "the device patch pool is not ported (ROADMAP.md, queue 1 item 4): "
            "the port's loaders are host loaders")
    pin = resolve_device(device).type == "cuda"
    records = build_case_records(image_dir)
    by_id = {r.case_id: r for r in records}
    if fold == -1:
        train_ids = sorted(by_id)
        val_ids = sorted(by_id)
    else:
        train_ids = [c for c in splits[fold]["train"] if c in by_id]
        val_ids = [c for c in splits[fold]["val"] if c in by_id]
    if not augment:
        gen_patch = tuple(plan.patch_size)
    elif aug_cfg is not None:
        gen_patch = generator_patch_size_for(aug_cfg)
    else:
        gen_patch = get_generator_patch_size(plan.patch_size)
    train_loader = PatchLoader(
        [by_id[c] for c in train_ids],
        patch_size=gen_patch,
        batch_size=batch_size,
        oversample_foreground_percent=oversample,
        max_instances=plan.max_instances_per_patch,
        seed=seed,
        inner_patch_size=tuple(plan.patch_size),
        pin_memory=pin,
    )
    val_loader = PatchLoader(
        [by_id[c] for c in val_ids] or [by_id[c] for c in train_ids],
        patch_size=tuple(plan.patch_size),
        batch_size=batch_size,
        oversample_foreground_percent=oversample,
        max_instances=plan.max_instances_per_patch,
        seed=seed + 1,
        fixed_sequence=True,
        pin_memory=pin,
    )
    return train_loader, val_loader


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
