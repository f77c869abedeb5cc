"""Stage entry points of the port (counterpart of :mod:`nndetection_tpu.pipeline`):
preparing a task (:func:`run_prep`: crop, analyze, plan, process), training
a fold (:func:`run_train`, with its folds, loaders and patch-pool budget),
and the prediction of a directory of preprocessed cases."""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.data.augment import (
    AugmentConfig,
    generator_patch_size_for,
    get_generator_patch_size,
)
from nndetection_tpu_torch.data.dataset import DatasetInfo, discover_cases
from nndetection_tpu_torch.data.loader import (
    DevicePatchPool,
    PatchLoader,
    PrefetchIterator,
    build_case_records,
)
from nndetection_tpu_torch.data.preprocess import (
    analyze_dataset,
    process_case,
    run_cropping,
    unpack_dataset,
)
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.inference.restore import restore_fmap
from nndetection_tpu_torch.planning.planner import Plan, Planner
from nndetection_tpu_torch.utils.io import load_npz_looped, load_pickle, save_pickle

NUM_FOLDS = 5
SPLIT_SEED = 12345
# the device patch pool's budget unless NNDET_POOL_BYTES sets it
DEFAULT_POOL_BYTES = 4 * 1024**3


def _process_all(cropped_dir, plan: Plan, case_ids: Sequence[str], plan_dir: Path) -> None:
    """Process every case for ``plan`` into ``plan_dir/{imagesTr,labelsTr}``,
    re-process any whose ``.npz`` does not load back (a corrupted write),
    then unpack the ``.npz`` into ``.npy``."""
    out_images, out_labels = plan_dir / "imagesTr", plan_dir / "labelsTr"
    kw = dict(target_spacing=np.asarray(plan.target_spacing),
              transpose_forward=plan.transpose_forward,
              normalization_schemes=plan.normalization_schemes,
              intensity_properties=plan.intensity_properties,
              use_nonzero_mask=plan.use_nonzero_mask)
    for cid in case_ids:
        process_case(cropped_dir, out_images, out_labels, cid, **kw)
    for cid in case_ids:
        try:
            load_npz_looped(out_images / f"{cid}.npz", keys=["data"])
        except RuntimeError:  # load_npz_looped's verdict after its retries
            process_case(cropped_dir, out_images, out_labels, cid, **kw)
    unpack_dataset(out_images)


def run_prep(
    task_dir,
    num_workers: int = 0,
    planner: Optional[Planner] = None,
    device: Union[torch.device, str] = "cuda",
) -> Plan:
    """Prepare the raw task ``task_dir`` for training: crop -> analyze ->
    plan -> process, as the JAX package's ``run_prep`` does, into the same
    files under the same names (``raw_cropped/``,
    ``preprocessed/properties/dataset_properties.pkl``,
    ``preprocessed/{plan_id}.pkl``, ``preprocessed/{plan_id}/{imagesTr,
    labelsTr}/`` and ``preprocessed/splits_final.pkl``), with the ``3dlr1``
    low-resolution plan when the largest objects exceed the patch.

    Cropping and analysis run in ``num_workers`` host processes (none for 0);
    everything but the planner's probe runs on the host. ``planner``
    defaults to ``Planner(device=device)``: 0.85 x the card's memory, the
    plan confirmed by the train step run on the card. ``device`` is the card
    unless the caller passes another (``"cpu"``, with a ``planner`` that has
    a budget); without CUDA the default raises."""
    dev = resolve_device(device)
    task_dir = Path(task_dir)
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    splitted = task_dir / "raw_splitted"
    cropped_dir = task_dir / "raw_cropped"
    prep_dir = task_dir / "preprocessed"

    cases = discover_cases(splitted / "imagesTr", splitted / "labelsTr", info.num_modalities)
    if not cases:
        raise FileNotFoundError(f"no training cases in {splitted / 'imagesTr'}")
    run_cropping(cases, cropped_dir, num_workers=num_workers)

    case_ids = [c.case_id for c in cases]
    props = analyze_dataset(cropped_dir, case_ids, info.num_modalities, num_workers=num_workers)
    save_pickle(props, prep_dir / "properties" / "dataset_properties.pkl")

    planner = planner or Planner(device=dev)
    plan = planner.plan_experiment(props, info)
    save_pickle(plan, prep_dir / f"{plan.plan_id}.pkl")
    _process_all(cropped_dir, plan, case_ids, prep_dir / plan.plan_id)

    if plan.requires_lowres:
        plan_lr = planner.plan_lowres(plan, props, info)
        save_pickle(plan_lr, prep_dir / f"{plan_lr.plan_id}.pkl")
        _process_all(cropped_dir, plan_lr, case_ids, prep_dir / plan_lr.plan_id)

    make_splits(case_ids, prep_dir / "splits_final.pkl")
    return plan


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
    pool_hbm_budget: int = DEFAULT_POOL_BYTES,
    num_epochs_hint: Optional[int] = None,
    device: Union[torch.device, str] = "cuda",
):
    """The train and validation loaders of ``fold`` (``-1``: every case in
    both) over the cases of ``image_dir``. ``plan`` is any object with
    ``patch_size``, ``max_instances_per_patch`` and ``in_channels``.

    The train loader crops the generator patch of ``aug_cfg`` (the final
    patch without augmentation) with the foreground constraint on the final
    patch. With ``device_pool`` it is a :class:`DevicePatchPool` on
    ``device``, holding as many cases as ``pool_hbm_budget`` bytes take (at
    least 2; the others rotate in during each epoch); ``"auto"`` takes the
    pool on the card, as the JAX package takes it on its accelerator, and
    ``True`` takes it on any ``device``. Otherwise it is a host
    :class:`PatchLoader`. The validation loader is a host loader of the
    final patch that replays the same patches every epoch. Host batches for
    the card come in pinned memory, so that their copy is asynchronous.
    ``device`` is the card unless the caller passes another (``"cpu"``)."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    if device_pool == "auto":
        device_pool = dev.type == "cuda"
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
    train_records = [by_id[c] for c in train_ids]
    common = dict(batch_size=batch_size, oversample_foreground_percent=oversample,
                  max_instances=plan.max_instances_per_patch, seed=seed,
                  inner_patch_size=tuple(plan.patch_size))
    if device_pool:
        max_shape = [max(max(r.shape[d] for r in train_records), gen_patch[d])
                     for d in range(len(gen_patch))]
        per_case = int(np.prod(max_shape)) * (2 * plan.in_channels + 2)
        max_cases = max(2, int(pool_hbm_budget // max(per_case, 1)))
        train_loader = DevicePatchPool(train_records, patch_size=gen_patch,
                                       max_pool_cases=max_cases,
                                       num_epochs_hint=num_epochs_hint, device=dev, **common)
    else:
        train_loader = PatchLoader(train_records, patch_size=gen_patch, pin_memory=pin, **common)
    val_loader = PatchLoader(
        [by_id[c] for c in val_ids] or train_records,
        patch_size=tuple(plan.patch_size),
        batch_size=batch_size,
        oversample_foreground_percent=oversample,
        max_instances=plan.max_instances_per_patch,
        seed=seed + 1,
        fixed_sequence=True,
        pin_memory=pin,
    )
    return train_loader, val_loader


def device_memory_bytes(device: Union[torch.device, str]) -> int:
    """The memory of ``device``: the card's, or the host's for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def pool_budget(plan: Any, batch_size: int, memory_bytes: int) -> int:
    """Bytes the device patch pool may take: ``NNDET_POOL_BYTES`` when set,
    else 4 GiB capped by what the planned train step leaves of
    ``memory_bytes`` (``0.92 x memory - step - reserve``, at least 512 MiB).
    The step's peak is ``plan.mem_compiled_bytes``, scaled up (never down)
    to a larger batch than planned; a plan without it is not capped."""
    if os.environ.get("NNDET_POOL_BYTES"):
        return int(os.environ["NNDET_POOL_BYTES"])
    budget = DEFAULT_POOL_BYTES
    compiled = int(plan.mem_compiled_bytes or 0)
    if compiled:
        compiled = int(compiled * max(1.0, batch_size / max(plan.batch_size, 1)))
        reserve = max(3 << 29, compiled // 4)
        free = int(memory_bytes * 0.92) - compiled - reserve
        budget = max(1 << 29, min(budget, free))
    return budget


def mesh_for_plan(plan: Any, batch_size: int) -> None:
    """The port trains a plan on one card: a plan that partitions its patch
    over devices (``n_model > 1``) raises."""
    if plan.n_model > 1:
        raise NotImplementedError(
            f"plan {plan.plan_id} partitions its patch over {plan.n_model} devices; "
            "multi-GPU training is not ported (ROADMAP.md, queue 1, multi-GPU)")


def run_train(
    task_dir,
    model_dir,
    fold: int = 0,
    trainer_overrides: Optional[Dict[str, Any]] = None,
    model_overrides: Optional[Dict[str, Any]] = None,
    plan_id: str = "D3V001_3d",
    module: str = "RetinaUNetV001",
    augment: bool = True,
    augmentation: str = "base_more",
    oversample: float = 0.5,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    resume: bool = False,
    stop_after_epoch: Optional[int] = None,
    device: Union[torch.device, str] = "cuda",
) -> Path:
    """Train one fold of a preprocessed task into ``model_dir/fold{fold}``:
    ``plan.pkl``, ``model_last.ckpt`` (``model_best.ckpt`` when the monitored
    score improves), ``run_meta.json``, ``params.json`` and one
    ``metrics.jsonl`` row per epoch, the pool's sampling report in it.

    Reads ``preprocessed/{plan_id}.pkl`` (either package's plan),
    ``dataset.yaml`` and the cases of ``preprocessed/{plan_id}/imagesTr``
    (``*.npz`` name the cases, the loaders read the unpacked ``*.npy``). On
    the card the train loader is the device patch pool, sized by
    :func:`pool_budget`. ``resume=True`` continues from ``model_last.ckpt``
    at its next epoch. ``device`` is the card unless the caller passes
    another (``"cpu"``)."""
    from nndetection_tpu_torch import modules  # noqa: F401 - registers the variants
    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.evaluator.det import BoxEvaluator
    from nndetection_tpu_torch.parallel import distributed
    from nndetection_tpu_torch.planning.planner import load_plan
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
    from nndetection_tpu_torch.utils.registry import MODULE_REGISTRY
    from nndetection_tpu_torch.utils.tracking import RunTracker

    distributed.initialize_from_env()
    dev = resolve_device(device)
    task_dir, model_dir = Path(task_dir), Path(model_dir)
    prep_dir = task_dir / "preprocessed"
    plan = load_plan(prep_dir / f"{plan_id}.pkl")
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    splits = make_splits(
        [p.stem for p in (prep_dir / plan.plan_id / "imagesTr").glob("*.npz")],
        prep_dir / "splits_final.pkl",
    )

    tkw = dict(trainer_overrides or {})
    batch_size = tkw.pop("batch_size", None) or plan.batch_size
    tcfg = TrainerConfig(batch_size=batch_size, **tkw)
    model_cfg = MODULE_REGISTRY[module].model_config(plan, **(model_overrides or {}))
    mesh_for_plan(plan, batch_size)

    out_dir = model_dir / f"fold{fold}"
    out_dir.mkdir(parents=True, exist_ok=True)
    save_pickle(plan, out_dir / "plan.pkl")
    tracker = RunTracker(
        out_dir,
        params={"module": module, "plan": plan_id, "fold": fold, "trainer": tkw,
                "batch_size": batch_size},
        tags={"task": task_dir.name},
        device=dev,
    )
    aug_cfg = get_augmentation(augmentation if augment else "no_aug", tuple(plan.patch_size),
                               dummy_2d=plan.do_dummy_2d, mask_norm_zero=plan.use_nonzero_mask)
    trainer = Trainer(model_cfg, tcfg, device=dev, output_dir=out_dir, augment_cfg=aug_cfg)
    train_loader, val_loader = build_loaders(
        plan,
        prep_dir / plan.plan_id / "imagesTr",
        splits,
        fold,
        distributed.local_batch_size(batch_size),
        oversample=oversample,
        augment=augment,
        seed=tcfg.seed + fold + 10007 * distributed.process_index(),
        aug_cfg=aug_cfg if augment else None,
        pool_hbm_budget=pool_budget(plan, batch_size, device_memory_bytes(dev)),
        num_epochs_hint=tcfg.max_epochs + tcfg.swa_epochs,
        device=dev,
    )
    classes = [str(info.labels[k]) for k in sorted(info.labels)]

    def _log(epoch, metrics):
        if hasattr(train_loader, "sampling_report"):
            metrics = {**metrics, **train_loader.sampling_report()}
        tracker.log_metrics(epoch, metrics)
        if log_fn:
            log_fn(epoch, metrics)

    start_epoch, state, best_score = 0, None, -np.inf
    last_ckpt = out_dir / "model_last.ckpt"
    if resume and last_ckpt.exists():
        extra = torch.load(last_ckpt, map_location="cpu", weights_only=True).get("extra", {})
        state = trainer.load_checkpoint(last_ckpt)
        start_epoch = int(extra.get("epoch", -1)) + 1
        best_score = float(extra.get("best_score", -np.inf))

    trainer.fit(
        train_iter_fn=lambda e: PrefetchIterator(
            train_loader.epoch(tcfg.num_train_batches_per_epoch), depth=2),
        val_iter_fn=lambda e: PrefetchIterator(
            val_loader.epoch(tcfg.num_val_batches_per_epoch), depth=2),
        evaluator_fn=lambda: BoxEvaluator.create(classes, fast=True),
        log_fn=_log,
        start_epoch=start_epoch,
        state=state,
        best_score=best_score,
        stop_after_epoch=stop_after_epoch,
    )
    return out_dir


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
