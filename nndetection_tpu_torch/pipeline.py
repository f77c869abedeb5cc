"""Stage entry points of the port (counterpart of :mod:`nndetection_tpu.pipeline`):
preparing a task (:func:`run_prep`: crop, analyze, plan, process), training
a fold (:func:`run_train`, with its folds, loaders and patch-pool budget),
the prediction of a directory of preprocessed cases (:func:`predict_dir`),
then the sweep of a fold's post-processing parameters (:func:`run_sweep`),
the consolidation of the folds (:func:`run_consolidate`), the validation
and test predictions and their evaluation.

The directories are the JAX package's: ``raw_splitted -> raw_cropped ->
preprocessed/{plan}/ -> {model_dir}/fold{k} -> consolidated ->
test_predictions``."""
from __future__ import annotations

import functools
import multiprocessing as mp
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


def _process_all(cropped_dir, plan: Plan, case_ids: Sequence[str], plan_dir: Path,
                 split: str = "Tr", num_workers: int = 0) -> Path:
    """Process every case for ``plan`` into ``plan_dir/{images,labels}{split}``
    (in ``num_workers`` host processes, none for 0), re-process any whose
    ``.npz`` does not load back (a corrupted write), then unpack the
    ``.npz`` into ``.npy``; returns the image directory."""
    out_images, out_labels = plan_dir / f"images{split}", plan_dir / f"labels{split}"
    kw = dict(target_spacing=np.asarray(plan.target_spacing),
              transpose_forward=plan.transpose_forward,
              normalization_schemes=plan.normalization_schemes,
              intensity_properties=plan.intensity_properties,
              use_nonzero_mask=plan.use_nonzero_mask)
    if num_workers > 0:
        with mp.Pool(num_workers) as pool:
            pool.starmap(functools.partial(process_case, **kw),
                         [(cropped_dir, out_images, out_labels, cid) for cid in case_ids])
    else:
        for cid in case_ids:
            process_case(cropped_dir, out_images, out_labels, cid, **kw)
    for cid in case_ids:
        try:
            load_npz_looped(out_images / f"{cid}.npz", keys=["data"])
        except RuntimeError:  # load_npz_looped's verdict after its retries
            process_case(cropped_dir, out_images, out_labels, cid, **kw)
    unpack_dataset(out_images)
    return out_images


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

    Cropping, analysis and processing run in ``num_workers`` host processes
    (none for 0);
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
    _process_all(cropped_dir, plan, case_ids, prep_dir / plan.plan_id, num_workers=num_workers)

    if plan.requires_lowres:
        plan_lr = planner.plan_lowres(plan, props, info)
        save_pickle(plan_lr, prep_dir / f"{plan_lr.plan_id}.pkl")
        _process_all(cropped_dir, plan_lr, case_ids, prep_dir / plan_lr.plan_id,
                     num_workers=num_workers)

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


def mesh_for_plan(plan: Any, batch_size: int, device_type: str = "cuda"):
    """The device mesh a plan asks for. A plan with ``n_model > 1`` (the
    planner's spatial partitioning: the patch exceeds one card) gets a
    ``(world // n_model, n_model)`` mesh over the process group; it raises
    when fewer processes than ``n_model`` run, and the data axis must divide
    ``batch_size``. Other plans return None, and the trainer builds its
    data-parallel mesh when there is a process group."""
    n_model = int(plan.n_model)
    if n_model <= 1:
        return None
    from nndetection_tpu_torch.parallel import distributed
    from nndetection_tpu_torch.parallel.mesh import make_mesh

    world = distributed.process_count()
    if world < n_model:
        raise RuntimeError(f"plan requires a model-axis of {n_model} but only {world} "
                           "process(es) run (NNDET_NUM_PROCESSES)")
    n_data = world // n_model
    if batch_size % n_data:
        raise ValueError(f"batch {batch_size} not divisible by the data axis {n_data}")
    return make_mesh(n_data, n_model, device_type)


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
    another (``"cpu"``).

    Under a multi-process job (``NNDET_COORDINATOR``,
    ``NNDET_NUM_PROCESSES``, ``NNDET_PROCESS_ID``) each process trains on
    its own card (``cuda:{rank % device_count}``, or the CPU with
    ``device="cpu"``): it loads its data index's share of the batch,
    seeded by that index, and rank 0 alone writes the files. ``run_prep``
    and the planner stay one process."""
    from nndetection_tpu_torch import modules  # noqa: F401 - registers the variants
    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.evaluator.det import BoxEvaluator
    from nndetection_tpu_torch.parallel import distributed
    from nndetection_tpu_torch.planning.planner import load_plan
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
    from nndetection_tpu_torch.utils.registry import MODULE_REGISTRY
    from nndetection_tpu_torch.utils.tracking import RunTracker

    distributed.initialize_from_env(device)
    dev = distributed.rank_device(resolve_device(device))
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
    mesh = mesh_for_plan(plan, batch_size, dev.type)

    out_dir = model_dir / f"fold{fold}"
    out_dir.mkdir(parents=True, exist_ok=True)
    main = distributed.is_main_process()
    if main:
        save_pickle(plan, out_dir / "plan.pkl")
    tracker = RunTracker(
        out_dir,
        params={"module": module, "plan": plan_id, "fold": fold, "trainer": tkw,
                "batch_size": batch_size},
        tags={"task": task_dir.name},
        device=dev,
    ) if main else None
    aug_cfg = get_augmentation(augmentation if augment else "no_aug", tuple(plan.patch_size),
                               dummy_2d=plan.do_dummy_2d, mask_norm_zero=plan.use_nonzero_mask)
    trainer = Trainer(model_cfg, tcfg, device=dev, output_dir=out_dir, augment_cfg=aug_cfg,
                      mesh=mesh)
    # each rank's card holds its share of the batch
    local_batch = distributed.local_batch_size(batch_size, trainer.n_model)
    train_loader, val_loader = build_loaders(
        plan,
        prep_dir / plan.plan_id / "imagesTr",
        splits,
        fold,
        local_batch,
        oversample=oversample,
        augment=augment,
        seed=tcfg.seed + fold + 10007 * trainer.data_index,
        aug_cfg=aug_cfg if augment else None,
        pool_hbm_budget=pool_budget(plan, local_batch, device_memory_bytes(dev)),
        num_epochs_hint=tcfg.max_epochs + tcfg.swa_epochs,
        device=dev,
    )
    classes = _classes(info)

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


def _classes(info: DatasetInfo) -> List[str]:
    return [str(info.labels[k]) for k in sorted(info.labels)]


def _swept_parameters(paths: Sequence[Path]):
    """``(parameters, mtime)`` of the first ``plan_inference.pkl`` of
    ``paths`` that exists, ``(None, None)`` when none does."""
    for path in paths:
        if path.exists():
            return load_pickle(path)["parameters"], path.stat().st_mtime
    return None, None


def run_sweep(
    task_dir,
    model_dir,
    fold: int,
    plan_id: str = "D3V001_3d",
    tta: bool = True,
    device: Union[torch.device, str] = "cuda",
) -> Dict[str, Any]:
    """Predict the validation split of ``fold`` with its ``model_last.ckpt``
    into ``fold{fold}/sweep/`` (the ensembler states kept), then sweep the
    post-processing parameters over those states: ``plan_inference.pkl``
    and ``sweep_results.json`` in the fold's directory.

    A case already predicted is not predicted again, unless its files are
    older than the checkpoint: those are deleted first. ``device`` runs the
    prediction and the sweep's consolidations: the card unless the caller
    passes another (``"cpu"``)."""
    from nndetection_tpu_torch.inference.loading import load_model_bundle
    from nndetection_tpu_torch.inference.sweeper import BoxSweeper
    from nndetection_tpu_torch.planning.planner import load_plan

    dev = resolve_device(device)
    task_dir, model_dir = Path(task_dir), Path(model_dir)
    prep_dir = task_dir / "preprocessed"
    plan = load_plan(prep_dir / f"{plan_id}.pkl")
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    fold_dir = model_dir / f"fold{fold}"
    bundle = load_model_bundle(fold_dir / "model_last.ckpt", name=f"fold{fold}")
    val_ids = make_splits([], prep_dir / "splits_final.pkl")[fold]["val"]

    sweep_dir = fold_dir / "sweep"
    # the states are raw detections, so new sweep parameters never make them
    # stale; a newer checkpoint does
    ckpt_mtime = (fold_dir / "model_last.ckpt").stat().st_mtime
    if sweep_dir.exists():
        for stale in list(sweep_dir.glob("*_boxes.pkl")) + list(
                sweep_dir.glob("*_boxes_state.pkl")):
            if stale.stat().st_mtime < ckpt_mtime:
                stale.unlink()
    predict_dir([bundle], prep_dir / plan.plan_id / "imagesTr", sweep_dir, case_ids=val_ids,
                tta=tta, save_state=True, batch_size=plan.batch_size, resume=True, device=dev)
    sweeper = BoxSweeper(_classes(info), state_dir=sweep_dir,
                         gt_dir=prep_dir / plan.plan_id / "labelsTr", save_dir=fold_dir,
                         device=dev)
    return sweeper.run_postprocessing_sweep()


def run_consolidate(
    task_dir,
    model_dir,
    num_folds: int = NUM_FOLDS,
    plan_id: str = "D3V001_3d",
    device: Union[torch.device, str] = "cuda",
) -> Path:
    """Copy each fold's ``model_last.ckpt`` (as ``model_fold{k}.ckpt``), its
    sweep states and ``plan.pkl`` into ``model_dir/consolidated/``, then
    sweep the pooled states there (``plan_inference.pkl``). A checkpoint of
    either package is copied as it is. ``device`` runs the sweep: the card
    unless the caller passes another (``"cpu"``)."""
    import shutil

    from nndetection_tpu_torch.inference.sweeper import BoxSweeper
    from nndetection_tpu_torch.planning.planner import load_plan

    dev = resolve_device(device)
    task_dir, model_dir = Path(task_dir), Path(model_dir)
    out = model_dir / "consolidated"
    state_dir = out / "sweep_states"
    state_dir.mkdir(parents=True, exist_ok=True)
    for fold in range(num_folds):
        fold_dir = model_dir / f"fold{fold}"
        ckpt = fold_dir / "model_last.ckpt"
        if ckpt.exists():
            shutil.copy(ckpt, out / f"model_fold{fold}.ckpt")
        for st in (fold_dir / "sweep").glob("*_boxes_state.pkl"):
            shutil.copy(st, state_dir / st.name)
        if (fold_dir / "plan.pkl").exists():
            shutil.copy(fold_dir / "plan.pkl", out / "plan.pkl")

    prep_dir = task_dir / "preprocessed"
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    plan = load_plan(prep_dir / f"{plan_id}.pkl")
    if any(state_dir.glob("*_boxes_state.pkl")):
        BoxSweeper(_classes(info), state_dir=state_dir,
                   gt_dir=prep_dir / plan.plan_id / "labelsTr", save_dir=out,
                   device=dev).run_postprocessing_sweep()
    return out


def run_predict_val(
    task_dir,
    model_dir,
    fold: int,
    plan_id: str = "D3V001_3d",
    tta: bool = True,
    restore: bool = True,
    ensembler: str = "BoxEnsemblerSelective",
    resume: bool = False,
    device: Union[torch.device, str] = "cuda",
) -> Path:
    """Predict the validation split of ``fold`` with that fold's model into
    ``fold{fold}/val_predictions/``, restored to the original image
    geometry (the cross-validation predictions a LUNA-style score pools),
    with the consolidated swept parameters, else the fold's own.

    With ``resume``, the cases predicted before those parameters were
    written are predicted again. ``device`` is the card unless the caller
    passes another (``"cpu"``)."""
    from nndetection_tpu_torch.inference.loading import load_model_bundle
    from nndetection_tpu_torch.planning.planner import load_plan

    dev = resolve_device(device)
    task_dir, model_dir = Path(task_dir), Path(model_dir)
    prep_dir = task_dir / "preprocessed"
    plan = load_plan(prep_dir / f"{plan_id}.pkl")
    fold_dir = model_dir / f"fold{fold}"
    bundle = load_model_bundle(fold_dir / "model_last.ckpt", name=f"fold{fold}")
    splits = make_splits([], prep_dir / "splits_final.pkl")
    params, params_mtime = _swept_parameters(
        [model_dir / "consolidated" / "plan_inference.pkl", fold_dir / "plan_inference.pkl"])
    out = fold_dir / "val_predictions"
    if resume and params_mtime is not None and out.exists():
        for stale in out.glob("*_boxes.pkl"):
            if stale.stat().st_mtime < params_mtime:
                stale.unlink()
    predict_dir([bundle], prep_dir / plan.plan_id / "imagesTr", out,
                case_ids=splits[fold]["val"], tta=tta, restore=restore,
                ensembler_parameters=params, batch_size=plan.batch_size, ensembler=ensembler,
                resume=resume, device=dev)
    return out


def materialize_val_predictions(
    task_dir,
    model_dir,
    fold: int,
    plan_id: str = "D3V001_3d",
    restore: bool = True,
    device: Union[torch.device, str] = "cuda",
) -> Path:
    """The validation predictions of ``fold`` (as :func:`run_predict_val`
    writes them) from the sweep's saved ensembler states, with no device
    work: each state consolidated again under the swept parameters
    (consolidated when present, the fold's own otherwise), the
    pad-to-min-shape offset undone, then restored to the original image
    geometry.

    The consolidation stays on the host (float64 WBC), as in the JAX
    package; ``device`` is checked as every entry point's and the card
    unless the caller passes another (``"cpu"``)."""
    from nndetection_tpu_torch.core.boxes.ops_np import box_axis_vector_np
    from nndetection_tpu_torch.inference.ensembler import BOX_ENSEMBLERS
    from nndetection_tpu_torch.inference.restore import restore_detection
    from nndetection_tpu_torch.planning.planner import load_plan

    resolve_device(device)
    task_dir, model_dir = Path(task_dir), Path(model_dir)
    prep_dir = task_dir / "preprocessed"
    plan = load_plan(prep_dir / f"{plan_id}.pkl")
    fold_dir = model_dir / f"fold{fold}"
    params, _ = _swept_parameters(
        [model_dir / "consolidated" / "plan_inference.pkl", fold_dir / "plan_inference.pkl"])
    out = fold_dir / "val_predictions"
    out.mkdir(parents=True, exist_ok=True)
    image_dir = prep_dir / plan.plan_id / "imagesTr"
    ens_cls = BOX_ENSEMBLERS["BoxEnsemblerSelective"]
    for state_path in sorted((fold_dir / "sweep").glob("*_boxes_state.pkl")):
        cid = state_path.name[: -len("_boxes_state.pkl")]
        t0 = time.time()
        ens = ens_cls.from_checkpoint(state_path)
        if params:
            ens.update_parameters(**params)
        result = ens.get_case_result()
        boxes = result["pred_boxes"]
        # the state's coordinates live in the case padded to the patch
        npy = image_dir / f"{cid}.npy"
        shape = (np.load(npy, mmap_mode="r").shape if npy.exists()
                 else np.load(image_dir / f"{cid}.npz")["data"].shape)
        lower = np.asarray([max(0, (m - s) // 2) for s, m in zip(shape[1:], plan.patch_size)],
                           np.int64)
        if lower.any() and len(boxes):
            boxes = boxes - box_axis_vector_np(lower.astype(np.float64), plan.dim)[None]
        props = load_pickle(image_dir / f"{cid}.pkl") if (image_dir / f"{cid}.pkl").exists() \
            else {}
        if restore and props:
            boxes = restore_detection(
                boxes,
                transpose_forward=props.get("transpose_forward", [0, 1, 2]),
                original_spacing=props.get("original_spacing", np.ones(3)),
                resampled_spacing=props.get("spacing_after_resampling", np.ones(3)),
                crop_bbox=props.get("crop_bbox"),
            )
        save_pickle(
            {
                "pred_boxes": boxes,
                "pred_scores": result["pred_scores"],
                "pred_labels": result["pred_labels"],
                "restored": bool(restore and props),
                "prediction_time_s": time.time() - t0,
            },
            out / f"{cid}_boxes.pkl",
        )
    return out


def run_predict_test(
    task_dir,
    model_dir,
    plan_id: str = "D3V001_3d",
    tta: bool = True,
    num_folds: int = NUM_FOLDS,
    restore: bool = True,
    ensembler: str = "BoxEnsemblerSelective",
    device: Union[torch.device, str] = "cuda",
) -> Path:
    """Prepare the test split (``raw_splitted/imagesTs``, with
    ``labelsTs`` when it exists) as the plan's training cases were prepared,
    into ``raw_cropped_test/`` and ``preprocessed/{plan}/{imagesTs,
    labelsTs}``, then predict it with every fold's model (the consolidated
    ones when they exist) under the consolidated swept parameters into
    ``model_dir/test_predictions/``, restored to the original image
    geometry. ``device`` is the card unless the caller passes another
    (``"cpu"``)."""
    from nndetection_tpu_torch.inference.loading import load_all_models
    from nndetection_tpu_torch.planning.planner import load_plan

    dev = resolve_device(device)
    task_dir, model_dir = Path(task_dir), Path(model_dir)
    prep_dir = task_dir / "preprocessed"
    plan = load_plan(prep_dir / f"{plan_id}.pkl")
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    splitted = task_dir / "raw_splitted"
    test_cases = discover_cases(
        splitted / "imagesTs",
        splitted / "labelsTs" if (splitted / "labelsTs").is_dir() else None,
        info.num_modalities,
    )
    cropped = task_dir / "raw_cropped_test"
    run_cropping(test_cases, cropped)
    test_images = _process_all(cropped, plan, [c.case_id for c in test_cases],
                               prep_dir / plan.plan_id, split="Ts")

    bundles = load_all_models(model_dir, num_folds=num_folds)
    params, _ = _swept_parameters([model_dir / "consolidated" / "plan_inference.pkl"])
    out = model_dir / "test_predictions"
    predict_dir(bundles, test_images, out, tta=tta, restore=restore,
                ensembler_parameters=params, batch_size=plan.batch_size, ensembler=ensembler,
                device=dev)
    return out


def run_evaluate(
    task_dir,
    pred_dir,
    plan_id: str = "D3V001_3d",
    split: str = "Ts",
    save_dir=None,
    device: Union[torch.device, str] = "cuda",
):
    """Box metrics of the predictions in ``pred_dir`` against
    ``preprocessed/{plan_id}/labels{split}``: restored predictions against
    the original-geometry GT (``*_boxes_gt_orig.npz``), others against
    ``*_boxes_gt.npz``; results into ``save_dir`` (``pred_dir`` by default).
    Returns ``(scores, curves)``. The evaluation runs on the host;
    ``device`` is checked as every entry point's and the card unless the
    caller passes another (``"cpu"``)."""
    from nndetection_tpu_torch.evaluator.registry import evaluate_box_dir

    resolve_device(device)
    task_dir, pred_dir = Path(task_dir), Path(pred_dir)
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    gt_dir = task_dir / "preprocessed" / plan_id / f"labels{split}"
    gt_suffix = "_boxes_gt.npz"
    sample = next(iter(p for p in sorted(pred_dir.glob("*_boxes.pkl"))
                       if p.name != "results_boxes.pkl"), None)
    if sample is not None and load_pickle(sample).get("restored"):
        gt_suffix = "_boxes_gt_orig.npz"
    return evaluate_box_dir(pred_dir, gt_dir, _classes(info), save_dir=save_dir or pred_dir,
                            fast=False, gt_suffix=gt_suffix)
