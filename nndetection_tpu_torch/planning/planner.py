"""The training plan (counterpart of the ``Plan`` dataclass of
:mod:`nndetection_tpu.planning.planner`; the planner itself is not ported
yet): the fields, the schema migration of older pickles, ``do_dummy_2d``
and ``model_config``.

:func:`load_plan` reads a plan pickled by either package. A JAX pickle
names ``nndetection_tpu.planning.planner.Plan``; its unpickler maps that
name to this :class:`Plan`, so that no module of the JAX package is
imported."""
from __future__ import annotations

import dataclasses
import logging
import pickle
from dataclasses import MISSING, dataclass
from typing import Any, Dict, List, Optional, Tuple

from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig

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
    # the peak memory of the train step the JAX planner compiled (XLA's
    # memory analysis for its accelerator), not a figure of the card
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
