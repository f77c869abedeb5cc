"""The experiment planner and its training plan (counterpart of
:mod:`nndetection_tpu.planning.planner`): nnDetection's ``D3V001`` with the
architecture planner ``BoxC002`` (target spacing with the anisotropy rule,
lowest-resolution axis first, per-modality normalization, the patch and
topology search against a memory budget, anchor optimization and the
low-resolution stage), and the :class:`Plan` with the schema migration of
older pickles.

The port plans to the card it runs on: the budget is 0.85 x the card's
memory, and the final (patch, batch) decision is confirmed by running the
train step on the card (:func:`probe_train_step_estimate`).

:func:`load_plan` reads a plan pickled by either package. A JAX pickle
names ``nndetection_tpu.planning.planner.Plan``; its unpickler maps that
name to this :class:`Plan`, so that no module of the JAX package is
imported."""
from __future__ import annotations

import dataclasses
import logging
import pickle
from dataclasses import MISSING, dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.data.dataset import DatasetInfo
from nndetection_tpu_torch.models.encoder import encoder_strides
from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig
from nndetection_tpu_torch.planning.anchors_opt import filter_boxes_by_volume, optimize_anchors
from nndetection_tpu_torch.planning.architecture import (
    get_pool_and_conv_props,
    initial_patch_size,
    plan_decoder_levels,
    shrink_largest_axis,
)
from nndetection_tpu_torch.planning.estimator import analytic_estimate, probe_train_step_estimate
from nndetection_tpu_torch.utils.registry import PLANNER_REGISTRY

ANISO_THRESHOLD = 3.0
# the planner's default budget, as a share of the card's memory
BUDGET_SHARE = 0.85

# bump when Plan gains or changes fields; older pickles migrate on load
# (Plan.__setstate__): a pickled dataclass restores __dict__ without calling
# __init__, so a field added later would otherwise be missing at its use
PLAN_SCHEMA_VERSION = 2

JAX_PLAN_CLASS = ("nndetection_tpu.planning.planner", "Plan")

_plan_log = logging.getLogger("nndet")


@dataclass
class Plan:
    plan_id: str
    dim: int
    target_spacing: List[float]
    transpose_forward: List[int]
    normalization_schemes: List[str]
    intensity_properties: Dict[int, Dict[str, float]]
    use_nonzero_mask: bool
    patch_size: List[int]
    batch_size: int
    conv_kernels: List[List[int]]
    pool_strides: List[List[int]]
    decoder_levels: Tuple[int, ...]
    anchors: Dict[str, List]
    in_channels: int
    num_classes: int
    seg_classes: int
    start_channels: int = 32
    max_channels: int = 320
    fpn_channels: int = 128
    head_channels: int = 128
    max_instances_per_patch: int = 32
    class_weights: Optional[List[float]] = None
    anchor_score: float = 0.0
    mem_estimate_bytes: int = 0
    # the train step's peak memory that confirmed the plan: in a plan of the
    # port, the probe's measured peak on the card (allocated bytes above the
    # baseline); in a plan of the JAX package, XLA's memory analysis for its
    # accelerator; 0 when nothing was probed. The name is kept because
    # pickles of either package carry it
    mem_compiled_bytes: int = 0
    requires_lowres: bool = False
    # rematerialize activations in backward
    remat: bool = True
    # spatial partitioning degree; the port trains n_model == 1 only
    n_model: int = 1
    schema_version: int = PLAN_SCHEMA_VERSION

    def __setstate__(self, state: Dict[str, Any]):
        """Migrate plans pickled under an older schema: fill newly added
        defaulted fields, fail naming any field without a default, and
        reject plans from a newer schema."""
        loaded = state.get("schema_version", 1)
        if loaded > PLAN_SCHEMA_VERSION:
            raise ValueError(
                f"plan pickle has schema_version={loaded}, this build "
                f"supports <= {PLAN_SCHEMA_VERSION}: upgrade the package or re-run planning")
        missing_required = []
        migrated = []
        for f in dataclasses.fields(self):
            if f.name in state:
                continue
            if f.default is not MISSING:
                state[f.name] = f.default
                migrated.append(f.name)
            elif f.default_factory is not MISSING:  # type: ignore[misc]
                state[f.name] = f.default_factory()  # type: ignore[misc]
                migrated.append(f.name)
            else:
                missing_required.append(f.name)
        if missing_required:
            raise ValueError(
                f"plan pickle predates required field(s) {missing_required} "
                f"(saved schema_version={loaded}); re-run planning for this task")
        if migrated:
            _plan_log.warning("migrated plan pickle from schema_version=%s: defaulted %s",
                              loaded, migrated)
        state["schema_version"] = PLAN_SCHEMA_VERSION
        self.__dict__.update(state)

    @property
    def do_dummy_2d(self) -> bool:
        """Anisotropic patches (``max / min > 3``) take dummy-2D
        augmentation."""
        ps = list(self.patch_size)
        return bool(max(ps) / max(min(ps), 1) > 3)

    def model_config(self, **overrides) -> RetinaUNetConfig:
        """The architecture configuration of this plan."""
        kw = dict(
            dim=self.dim,
            in_channels=self.in_channels,
            classifier_classes=self.num_classes,
            seg_classes=self.num_classes,
            start_channels=self.start_channels,
            max_channels=self.max_channels,
            fpn_channels=self.fpn_channels,
            head_channels=self.head_channels,
            conv_kernels=tuple(tuple(k) for k in self.conv_kernels),
            strides=tuple(tuple(s) for s in self.pool_strides),
            decoder_levels=tuple(self.decoder_levels),
            patch_size=tuple(self.patch_size),
            anchor_width=tuple(tuple(w) for w in self.anchors["width"]),
            anchor_height=tuple(tuple(h) for h in self.anchors["height"]),
            anchor_depth=tuple(tuple(d) for d in self.anchors["depth"])
            if self.dim == 3
            else None,
            class_weights=tuple(self.class_weights) if self.class_weights else None,
            remat=self.remat,
        )
        kw.update(overrides)
        return RetinaUNetConfig(**kw)


class _PlanUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == JAX_PLAN_CLASS:
            return Plan
        if module.split(".")[0] == "nndetection_tpu":
            raise pickle.UnpicklingError(f"plan pickle holds {module}.{name}, which the port "
                                         "does not read")
        return super().find_class(module, name)


def load_plan(path) -> Plan:
    """The plan pickled at ``path`` by either package, as the port's
    :class:`Plan`."""
    with open(path, "rb") as f:
        plan = _PlanUnpickler(f).load()
    if not isinstance(plan, Plan):
        raise TypeError(f"{path} holds a {type(plan).__name__}, not a Plan")
    return plan


@PLANNER_REGISTRY.register(name="D3V001")
class Planner:
    """Planner ``D3V001`` with the architecture planner ``BoxC002``, planning
    to the memory of ``device``."""

    def __init__(
        self,
        hbm_budget: Optional[int] = None,
        batch_size: int = 4,
        max_batch_size: int = 16,
        anchor_budget: int = 3000,
        plan_tag: str = "D3V001_3d",
        compile_validate: Any = "auto",
        force_patch_size: Any = None,
        max_model_axis: int = 4,
        device: Union[torch.device, str] = "cuda",
    ):
        """``hbm_budget``: the bytes a train step may take. ``None`` on the
        card is ``BUDGET_SHARE`` (0.85) x the card's memory; on the CPU the
        caller passes it (``ValueError`` otherwise).

        ``compile_validate``: confirm the final (patch, batch) decision by
        running the real train step on the card and reading its peak memory
        (:func:`probe_train_step_estimate`). ``"auto"`` probes when
        ``device`` is the card; True / False force it (a CPU device has
        nothing to probe and keeps the analytic plan).

        ``force_patch_size``: a user-pinned patch (transposed axis order).
        When it cannot fit one device at the planned batch, the planner emits
        ``n_model`` in {2, 4} (capped by ``max_model_axis``) instead of
        shrinking; ``run_train`` trains such a plan over at least
        ``n_model`` processes (``pipeline.py::mesh_for_plan``).

        ``device`` is the card unless the caller passes another (``"cpu"``);
        without CUDA the default raises."""
        self.device = resolve_device(device)
        if hbm_budget is None:
            if self.device.type != "cuda":
                raise ValueError(f"Planner on {self.device}: pass hbm_budget (the default is "
                                 f"{BUDGET_SHARE} x the card's memory)")
            total = torch.cuda.get_device_properties(self.device).total_memory
            hbm_budget = int(total * BUDGET_SHARE)
        self.hbm_budget = hbm_budget
        self.batch_size = batch_size
        self.max_batch_size = max_batch_size
        self.anchor_budget = anchor_budget
        self.plan_tag = plan_tag
        self.compile_validate = compile_validate
        self.force_patch_size = force_patch_size
        self.max_model_axis = max_model_axis

    # ------------------------------------------------------------------
    def plan_target_spacing(self, all_spacings: np.ndarray) -> np.ndarray:
        """Median spacing; anisotropic axis uses its 10th percentile
        (``v001.py:148-184``)."""
        target = np.median(all_spacings, axis=0)
        if target.max() / max(target.min(), 1e-8) > ANISO_THRESHOLD:
            aniso = int(np.argmax(target))
            target[aniso] = np.percentile(all_spacings[:, aniso], 10)
        return target

    def plan_transpose(self, target_spacing: np.ndarray) -> List[int]:
        """Lowest-resolution (largest spacing) axis first (``v001.py:105-123``)."""
        order = list(np.argsort(-target_spacing, kind="stable"))
        return [int(o) for o in order]

    def plan_normalization(
        self, info: DatasetInfo, intensity: Dict[int, Dict[str, float]]
    ) -> Tuple[List[str], bool]:
        schemes = []
        for c in sorted(info.modalities):
            name = str(info.modalities[c]).upper()
            if name == "CT":
                schemes.append("CT")
            elif name == "CT2":
                schemes.append("CT2")
            else:
                schemes.append("nonCT")
        use_nonzero = all(s not in ("CT", "CT2") for s in schemes)
        return schemes, use_nonzero

    # ------------------------------------------------------------------
    def plan_architecture(
        self,
        target_spacing: np.ndarray,
        median_shape: np.ndarray,
        in_channels: int,
        num_classes: int,
        max_instances: int = 32,
    ) -> Dict[str, Any]:
        """Patch/topology search loop: shrink the largest axis until the
        analytic estimate fits the budget (``c002.py:165-227``). The probe
        steps with ``max_instances`` GT slots, the plan's
        ``max_instances_per_patch`` (the JAX planner's probe always takes
        32)."""
        if self.force_patch_size is not None:
            return self._plan_forced_patch(
                target_spacing, in_channels, num_classes, max_instances
            )
        patch = initial_patch_size(target_spacing, median_shape)
        while True:
            pool, kernels, must_div, patch_final = get_pool_and_conv_props(
                target_spacing, patch
            )
            decoder_levels = plan_decoder_levels(len(kernels))
            est = analytic_estimate(
                patch_size=patch_final,
                batch_size=self.batch_size,
                in_channels=in_channels,
                conv_kernels=kernels,
                strides=pool,
                decoder_levels=decoder_levels,
                num_classes=num_classes,
            )
            if est.fits(self.hbm_budget) or max(patch_final) <= 32:
                # grow the batch while the budget allows it (the step is
                # overhead-bound at small batches); nnDetection's fixed batch
                # 4 targets an 11 GB GPU
                batch = self.batch_size
                while batch < self.max_batch_size:
                    est2 = analytic_estimate(
                        patch_size=patch_final,
                        batch_size=batch * 2,
                        in_channels=in_channels,
                        conv_kernels=kernels,
                        strides=pool,
                        decoder_levels=decoder_levels,
                        num_classes=num_classes,
                    )
                    if not est2.fits(self.hbm_budget):
                        break
                    batch *= 2
                    est = est2
                arch = {
                    "patch_size": list(patch_final),
                    "pool_strides": pool,
                    "conv_kernels": kernels,
                    "decoder_levels": decoder_levels,
                    "batch_size": batch,
                    "mem_estimate_bytes": est.total_bytes,
                    "mem_compiled_bytes": 0,
                }
                return self._compile_validate_arch(
                    arch, in_channels, num_classes, target_spacing, max_instances
                )
            patch = shrink_largest_axis(patch_final, must_div)

    # ------------------------------------------------------------------
    def _plan_forced_patch(
        self,
        target_spacing: np.ndarray,
        in_channels: int,
        num_classes: int,
        max_instances: int = 32,
    ) -> Dict[str, Any]:
        """A user-pinned patch is honored, not shrunk: when it cannot fit a
        single chip at the planned batch size, the plan gains ``n_model``
        (2 or 4) — the leading (z) axis is sharded over the mesh "model" axis
        with halo-exchange convolutions. The z extent is rounded UP to the
        next multiple that keeps every encoder level's z divisible by
        ``n_model`` (the trainer's shardability requirement)."""
        for n_model in (1, 2, 4):
            if n_model > self.max_model_axis:
                break
            patch = np.asarray(self.force_patch_size, dtype=np.float64)
            # iterate: rounding z for the model axis can change the pooling
            # decision; recompute props until stable (>=1 extra pass)
            for _ in range(3):
                pool, kernels, must_div, patch_final = get_pool_and_conv_props(
                    target_spacing, patch
                )
                unit = int(must_div[0]) * n_model
                z_rounded = int(-(-int(patch_final[0]) // unit) * unit)
                if z_rounded == int(patch_final[0]):
                    break
                patch = np.asarray(
                    [z_rounded, *[int(v) for v in patch_final[1:]]], np.float64
                )
            decoder_levels = plan_decoder_levels(len(kernels))
            est = analytic_estimate(
                # per-chip activation footprint: each model shard holds a z-slab
                patch_size=[int(patch_final[0]) // n_model, *[int(v) for v in patch_final[1:]]],
                batch_size=self.batch_size,
                in_channels=in_channels,
                conv_kernels=kernels,
                strides=pool,
                decoder_levels=decoder_levels,
                num_classes=num_classes,
            )
            if est.fits(self.hbm_budget):
                arch = {
                    "patch_size": [int(v) for v in patch_final],
                    "pool_strides": pool,
                    "conv_kernels": kernels,
                    "decoder_levels": decoder_levels,
                    "batch_size": self.batch_size,
                    "n_model": n_model,
                    "mem_estimate_bytes": est.total_bytes,
                    "mem_compiled_bytes": 0,
                }
                if n_model == 1:
                    # one device: confirm with the probe as usual
                    return self._compile_validate_arch(
                        arch, in_channels, num_classes, target_spacing, max_instances
                    )
                return arch
        raise ValueError(
            f"forced patch {list(self.force_patch_size)} does not fit the HBM "
            f"budget even spatially partitioned over {self.max_model_axis} "
            f"chips; reduce the patch or raise max_model_axis"
        )

    # ------------------------------------------------------------------
    def _proxy_model_config(
        self, arch: Dict[str, Any], in_channels: int, num_classes: int,
        remat: bool = True,
    ) -> RetinaUNetConfig:
        """Architecture config with PROXY anchors — anchor optimization runs
        after the memory decision, exactly like the reference's probe net
        (``c002.py:209-212``: proxy anchors (16, 32, 64)^3 scaled per level)."""
        num_stages = len(arch["conv_kernels"])
        dim = len(arch["patch_size"])
        strides_abs = encoder_strides(num_stages, arch["pool_strides"], dim)
        dls = arch["decoder_levels"]
        base = np.asarray(strides_abs[dls[0]], dtype=np.float64)
        axes = ("width", "height", "depth")[:dim]
        proxy = {a: [] for a in axes}
        for l in dls:
            rel = np.asarray(strides_abs[l], dtype=np.float64) / base
            for ax_i, a in enumerate(axes):
                proxy[a].append(
                    [16.0 * rel[ax_i], 32.0 * rel[ax_i], 64.0 * rel[ax_i]]
                )
        return RetinaUNetConfig(
            dim=dim,
            in_channels=in_channels,
            classifier_classes=num_classes,
            seg_classes=num_classes,
            conv_kernels=tuple(tuple(k) for k in arch["conv_kernels"]),
            strides=tuple(tuple(s) for s in arch["pool_strides"]),
            decoder_levels=tuple(dls),
            patch_size=tuple(arch["patch_size"]),
            anchor_width=tuple(tuple(w) for w in proxy["width"]),
            anchor_height=tuple(tuple(h) for h in proxy["height"]),
            anchor_depth=tuple(tuple(d) for d in proxy["depth"])
            if dim == 3
            else None,
            remat=remat,
        )

    def _compile_validate_arch(
        self,
        arch: Dict[str, Any],
        in_channels: int,
        num_classes: int,
        target_spacing: np.ndarray,
        max_instances: int = 32,
    ) -> Dict[str, Any]:
        """The final fit decision by the measured peak of the real train
        step on the card (with ``max_instances`` GT slots): the analytic
        model drives the inner shrink loop, the probe confirms the result.
        Over budget, the batch is halved down to the base batch size, then
        the patch shrinks."""
        enabled = self.compile_validate
        if enabled == "auto":
            enabled = self.device.type == "cuda"
        if not enabled:
            return arch
        # a measured peak is near-exact: compare against the memory less a
        # small runtime headroom instead of the analytic margin
        compile_budget = int(self.hbm_budget * 0.92 / 0.85)
        # first choice: no rematerialization, the backward reusing stored
        # activations instead of recomputing the forward; affordable only when
        # the larger no-remat footprint fits, which this probe decides
        cfg_nr = self._proxy_model_config(arch, in_channels, num_classes, remat=False)
        est_nr = probe_train_step_estimate(cfg_nr, arch["batch_size"], max_instances,
                                           device=self.device)
        if est_nr is not None and est_nr.fits(compile_budget):
            arch["remat"] = False
            arch["mem_compiled_bytes"] = est_nr.total_bytes
            return arch
        for _ in range(3):
            cfg = self._proxy_model_config(arch, in_channels, num_classes)
            est = probe_train_step_estimate(cfg, arch["batch_size"], max_instances,
                                            device=self.device)
            if est is None:  # nothing to probe on this device: keep the analytic plan
                return arch
            arch["mem_compiled_bytes"] = est.total_bytes
            if est.fits(compile_budget):
                return arch
            if arch["batch_size"] > self.batch_size:
                arch["batch_size"] = max(self.batch_size, arch["batch_size"] // 2)
            else:  # base batch still over budget: shrink the patch one step
                pool, kernels, must_div, patch_final = get_pool_and_conv_props(
                    target_spacing, np.asarray(arch["patch_size"])
                )
                new_patch = shrink_largest_axis(patch_final, must_div)
                pool, kernels, must_div, patch_final = get_pool_and_conv_props(
                    target_spacing, np.asarray(new_patch)
                )
                arch.update(
                    patch_size=list(patch_final),
                    pool_strides=pool,
                    conv_kernels=kernels,
                    decoder_levels=plan_decoder_levels(len(kernels)),
                )
        return arch

    # ------------------------------------------------------------------
    def plan_anchors(
        self,
        arch: Dict[str, Any],
        boxes_vox: np.ndarray,
        dim: int = 3,
    ) -> Tuple[Dict[str, List], float]:
        """Optimize level-0 anchor sizes; scale for deeper levels by relative
        stride (``c002.py:244-275``)."""
        num_stages = len(arch["conv_kernels"])
        dim = len(arch["patch_size"])
        strides_abs = encoder_strides(num_stages, arch["pool_strides"], dim)
        dls = arch["decoder_levels"]
        base = np.asarray(strides_abs[dls[0]], dtype=np.float64)
        rel_strides = [
            (np.asarray(strides_abs[l], dtype=np.float64) / base).tolist()
            for l in dls
        ]
        sizes = filter_boxes_by_volume(boxes_vox)
        params, score = optimize_anchors(
            sizes, rel_strides, budget=self.anchor_budget
        )
        axes = ("width", "height", "depth")[:dim]
        anchors = {a: [] for a in axes}
        for rs in rel_strides:
            for ax_i, a in enumerate(axes):
                base_sizes = params[3 * ax_i : 3 * (ax_i + 1)]
                anchors[a].append([float(v * rs[ax_i]) for v in base_sizes])
        return anchors, score

    # ------------------------------------------------------------------
    def plan_experiment(
        self,
        dataset_properties: Dict[str, Any],
        info: DatasetInfo,
    ) -> Plan:
        spacings = np.asarray(dataset_properties["all_spacings"], dtype=np.float64)
        shapes = np.asarray(dataset_properties["all_shapes"], dtype=np.float64)
        target = self.plan_target_spacing(spacings)
        transpose = self.plan_transpose(target)
        target_t = target[transpose]

        # median shape in target spacing (transposed axis order)
        shapes_t = shapes[:, transpose]
        spacings_t = spacings[:, transpose]
        resampled = shapes_t * spacings_t / target_t[None]
        median_shape = np.median(resampled, axis=0)

        schemes, use_nonzero = self.plan_normalization(
            info, dataset_properties["intensity_properties"]
        )

        # instance budget per patch: the GT slots of training, and of the probe
        counts = [
            p.get("num_instances", 0)
            for p in dataset_properties.get("per_case", {}).values()
        ]
        max_inst = int(min(max(np.percentile(counts, 99) if counts else 8, 8), 64))

        arch = self.plan_architecture(
            target_t, median_shape, info.num_modalities, info.num_classes, max_inst
        )

        # GT boxes in voxels of the target spacing (transposed order)
        boxes_mm = np.asarray(dataset_properties["boxes_mm"], dtype=np.float64)
        if len(boxes_mm):
            size_cols = [
                boxes_mm[:, 2] - boxes_mm[:, 0],
                boxes_mm[:, 3] - boxes_mm[:, 1],
            ]
            if boxes_mm.shape[1] == 6:
                size_cols.append(boxes_mm[:, 5] - boxes_mm[:, 4])
            sizes_mm = np.stack(size_cols, axis=1)[:, transpose]
            boxes_vox = sizes_mm / target_t[None]
        else:
            boxes_vox = np.zeros((0, info.dim))
        anchors, anchor_score = self.plan_anchors(arch, boxes_vox)

        # class weights (frequency-balanced, reference formula
        # ``architecture/boxes/base.py:228-248``: background gets 1/(C+1),
        # foreground class i gets (1 - 1/(C+1)) * (1 - n_i / n_all))
        classes = np.asarray(dataset_properties.get("instance_classes", []))
        weights = None
        if len(classes):
            counts_c = np.bincount(classes.astype(int), minlength=info.num_classes)
            n_all = max(int(counts_c.sum()), 1)
            bg_weight = 1.0 / (len(counts_c) + 1)
            fg = (1.0 - bg_weight) * (1.0 - counts_c / n_all)
            weights = [bg_weight] + fg.tolist()

        # low-res stage trigger (``v001.py:186-210``)
        requires_lowres = False
        if len(boxes_vox):
            big = np.percentile(boxes_vox, 99.5, axis=0)
            requires_lowres = bool(np.any(big > np.asarray(arch["patch_size"])))

        return Plan(
            plan_id=self.plan_tag,
            dim=info.dim,
            target_spacing=[float(t) for t in target_t],
            transpose_forward=transpose,
            normalization_schemes=schemes,
            intensity_properties=dataset_properties["intensity_properties"],
            use_nonzero_mask=use_nonzero,
            patch_size=arch["patch_size"],
            batch_size=arch.get("batch_size", self.batch_size),
            conv_kernels=arch["conv_kernels"],
            pool_strides=arch["pool_strides"],
            decoder_levels=arch["decoder_levels"],
            anchors=anchors,
            in_channels=info.num_modalities,
            num_classes=info.num_classes,
            seg_classes=info.num_classes,
            max_instances_per_patch=max_inst,
            class_weights=weights,
            anchor_score=float(anchor_score),
            mem_estimate_bytes=arch["mem_estimate_bytes"],
            mem_compiled_bytes=arch.get("mem_compiled_bytes", 0),
            requires_lowres=requires_lowres,
            remat=arch.get("remat", True),
            n_model=arch.get("n_model", 1),
        )

    def plan_lowres(self, plan: Plan, dataset_properties, info) -> Plan:
        """Derived low-resolution stage: spacing x2 (``v001.py:50-70``)."""
        lr = Planner(
            hbm_budget=self.hbm_budget,
            batch_size=self.batch_size,
            anchor_budget=self.anchor_budget,
            plan_tag=self.plan_tag.replace("_3d", "_3dlr1"),
            device=self.device,
        )
        props = dict(dataset_properties)
        props["all_spacings"] = np.asarray(dataset_properties["all_spacings"]) * 2.0
        out = lr.plan_experiment(props, info)
        out.requires_lowres = False
        return out
