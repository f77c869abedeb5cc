"""Training runtime (counterpart of :mod:`nndetection_tpu.train.trainer`):
on one device, or one process per device over a ``(data, model)`` mesh;
SGD with Nesterov momentum and no
weight decay on norm parameters, global-norm clipping, a guard that skips
non-finite updates, warm-up + poly learning rate, SWA weight averaging and
versioned checkpoints.

The optimizer reproduces the JAX package's optax chain
(``trainer.py:88-114``): ``apply_if_finite(chain(clip_by_global_norm,
masked(add_decayed_weights), sgd(schedule, momentum, nesterov)))``.

* The clip scales by ``max_norm / norm`` with no epsilon (optax's formula;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6), on the raw gradients.
* Weight decay is added after the clip, inside ``torch.optim.SGD``, on the
  weights of ``Conv`` and ``ConvTranspose`` modules only: the flax
  ``kernel`` leaves. The port names conv weights and norm scales alike
  ``weight``, so the mask goes by module type, never by name.
* The learning rate of an update is ``schedule(count)``, ``count`` the
  updates applied so far (optax's own count, which a skipped step does not
  advance).
* A step with a non-finite gradient leaves the parameters, the momentum and
  the count as they were; after more than ``max_consecutive_errors`` such
  steps in a row the update is applied all the same, as optax does.

PyTorch updates the model in place: :class:`TrainState` holds the model and
the optimizer, and the epoch functions return the state they were given.

Multi-process training (:mod:`nndetection_tpu_torch.parallel`): with a
process group the trainer builds the data mesh over it (or takes the
``mesh`` it is given) and wraps the model in
``torch.nn.parallel.DistributedDataParallel`` over the whole world, so that
the gradient is averaged over ``("data", "model")`` before the clip, the
guard and SGD, as the JAX step's ``pmean`` comes before optax. Each process
feeds its own rows of the global batch; its random draws come from its
data index (the JAX step folds its key with ``axis_index("data")``), equal
within a model group. The losses are averaged over the ranks, validation
gathers the detections and ground truth of the data ranks so that every
evaluator sees the global batch, and only rank 0 writes logs and
checkpoints, which hold the bare model's ``state_dict``. With a model axis
above 1, each rank of a model group runs the same module tree on its
z-slab of the batch under
:func:`~nndetection_tpu_torch.parallel.spatial.spatial_partitioning`, kept
open over the backward, which recomputes the forward under ``cfg.remat``.

Under a profiler each step records the spans of
:mod:`nndetection_tpu_torch.utils.trace`: ``train.to_device`` and the root
``train.step`` with ``train.prepare``, ``train.forward`` (forward and loss),
``train.backward`` and ``train.update``, which holds ``train.sync``, the
host's wait for the gradient norm; the counter ``train.patches`` counts the
rows stepped.

Batches are prepared (``images``, ``gt_boxes``, ``gt_classes``,
``gt_mask``, ``seg``) or raw, as the host loaders make them (``images``,
``seg_instances``, ``instance_classes``). With an ``augment_cfg`` a raw
batch is augmented on the device in training, centre-cropped to the patch
in validation, then turned into targets; a prepared batch passes
unchanged.
"""
from __future__ import annotations

import contextlib
import math
import resource
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.data.augment import AugmentConfig, augment_batch, center_crop_batch
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.models.conv import Conv, ConvTranspose
from nndetection_tpu_torch.models.retina_unet import (
    RetinaUNet,
    RetinaUNetConfig,
    batched_postprocess,
    train_step_loss,
)
from nndetection_tpu_torch.parallel import distributed
from nndetection_tpu_torch.parallel.mesh import axis_size, make_mesh
from nndetection_tpu_torch.parallel.spatial import spatial_partitioning
from nndetection_tpu_torch.train.lr import Schedule, swa_schedule
from nndetection_tpu_torch.utils import trace

# bump when the checkpoint payload gains or renames fields
CKPT_SCHEMA_VERSION = 1
# optax.apply_if_finite(max_consecutive_errors=...) of the JAX trainer
MAX_CONSECUTIVE_ERRORS = 50
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice")


@dataclass
class TrainerConfig:
    """The JAX package's ``TrainerConfig``, field for field."""

    max_epochs: int = 50
    num_train_batches_per_epoch: int = 2500
    num_val_batches_per_epoch: int = 100
    batch_size: int = 4
    initial_lr: float = 0.01
    sgd_momentum: float = 0.9
    sgd_nesterov: bool = True
    weight_decay: float = 3e-5
    warm_iterations: int = 4000
    warm_lr: float = 1e-6
    poly_gamma: float = 0.9
    swa_epochs: int = 10
    monitor_key: str = "mAP_IoU_0.10_0.50_0.05_MaxDet_100"
    seed: int = 42
    grad_clip_norm: float = 12.0
    skip_nonfinite_updates: bool = True


@dataclass
class TrainState:
    """Model and optimizer with the counters of the JAX ``TrainState`` and
    of optax's ``apply_if_finite``."""

    model: RetinaUNet
    optimizer: torch.optim.SGD
    swa_params: Dict[str, torch.Tensor]
    step: int = 0  # train steps taken, skipped ones included
    swa_count: int = 0
    opt_count: int = 0  # updates applied: the schedule's count
    notfinite_count: int = 0  # non-finite steps in a row
    ddp: Optional[DistributedDataParallel] = None  # the model, wrapped, in a process group

    @property
    def net(self) -> torch.nn.Module:
        """The module a train step runs: the DDP wrapper in a process group."""
        return self.model if self.ddp is None else self.ddp


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> takes weight decay: the weights of ``Conv`` and
    ``ConvTranspose`` modules (the flax ``kernel`` leaves); norm parameters,
    biases and the regressor's ``scales`` take none."""
    decayed = {id(m.weight) for m in model.modules() if isinstance(m, (Conv, ConvTranspose))}
    return {name: id(p) in decayed for name, p in model.named_parameters()}


def lr_schedule(tcfg: TrainerConfig) -> Schedule:
    """:func:`swa_schedule` over ``max_epochs`` epochs, one SWA cycle per
    epoch."""
    return swa_schedule(
        initial_lr=tcfg.initial_lr, warm_iterations=tcfg.warm_iterations,
        warm_lr=tcfg.warm_lr, poly_gamma=tcfg.poly_gamma,
        train_iterations=tcfg.max_epochs * tcfg.num_train_batches_per_epoch,
        swa_cycle_iterations=max(1, tcfg.num_train_batches_per_epoch),
    )


def make_optimizer(tcfg: TrainerConfig, model: torch.nn.Module) -> Tuple[torch.optim.SGD, Schedule]:
    """Nesterov SGD over two parameter groups (decay, no decay) and the
    learning-rate schedule of :func:`lr_schedule`."""
    schedule = lr_schedule(tcfg)
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if mask[n]], "weight_decay": tcfg.weight_decay},
        {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
    ]
    opt = torch.optim.SGD(groups, lr=schedule(0), momentum=tcfg.sgd_momentum,
                          nesterov=tcfg.sgd_nesterov)
    return opt, schedule


def _host_max_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 ** 2  # kB on Linux


class Trainer:
    """Runs the train and validation steps and the epoch loop on one
    device, or on this process's device of a ``(data, model)`` mesh."""

    def __init__(
        self,
        model_cfg: RetinaUNetConfig,
        trainer_cfg: TrainerConfig,
        device: Union[torch.device, str] = "cuda",
        output_dir: Optional[Path] = None,
        augment_cfg: Optional[AugmentConfig] = None,
        mesh=None,
    ):
        """Batches carry ``images [B, *patch, C]``, ``gt_boxes``,
        ``gt_classes``, ``gt_mask`` and ``seg``
        (:func:`nndetection_tpu_torch.data.gt_prep.prepare_targets` makes
        them from instance segmentations), or, with ``augment_cfg``, they
        may be raw loader batches (:meth:`_prepare`). ``device`` is the card
        unless the caller passes another (``"cpu"``); without CUDA the
        default raises. In a process group ``mesh`` defaults to every
        process on the data axis
        (:func:`~nndetection_tpu_torch.parallel.mesh.make_mesh`); a model
        axis above 1 partitions the patch's z axis (3D models only)."""
        self.cfg = model_cfg
        self.augment_cfg = augment_cfg
        self.tcfg = trainer_cfg
        self.device = resolve_device(device)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(device_type=self.device.type)
        self.mesh = mesh
        self.n_model = axis_size(mesh, "model")
        self.data_index = distributed.data_index(self.n_model)
        if self.n_model > 1:
            if model_cfg.dim != 3:
                raise ValueError("spatial partitioning needs a 3D model (the halo conv is 3D)")
            self._check_spatial_shardable(model_cfg, self.n_model)
        self.output_dir = Path(output_dir) if output_dir else None
        self.schedule = lr_schedule(trainer_cfg)
        anchors_np, self.anchors_per_level = model_cfg.anchors()
        self.anchors = torch.from_numpy(anchors_np).to(self.device)

    # ------------------------------------------------------------------
    def init_state(self, rng_seed: Optional[int] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: the model initialized from ``rng_seed`` (default
        ``seed``), or holding ``params`` (a ``state_dict``, e.g. from
        :func:`nndetection_tpu_torch.bridge.state_dict_from_flax`)."""
        seed = self.tcfg.seed if rng_seed is None else rng_seed
        model = RetinaUNet(self.cfg, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            model.load_state_dict(params)
        model.to(self.device)
        optimizer, _ = make_optimizer(self.tcfg, model)
        swa = {n: p.detach().clone() for n, p in model.named_parameters()}
        ddp = None
        if self.mesh is not None:
            ddp = DistributedDataParallel(
                model, device_ids=[self.device] if self.device.type == "cuda" else None)
        return TrainState(model=model, optimizer=optimizer, swa_params=swa, ddp=ddp)

    # ------------------------------------------------------------------
    @staticmethod
    def _check_spatial_shardable(cfg: RetinaUNetConfig, n_model: int) -> None:
        """Every encoder level's z extent must split evenly over the model
        axis (and stay divisible by the next stride) for halo-exchange
        convs."""
        z = int(cfg.patch_size[0])
        strides_z = [1] + [int(s[0]) for s in cfg.strides]
        for level, s in enumerate(strides_z):
            if z % s != 0:
                raise ValueError(f"patch z={cfg.patch_size[0]} not divisible by strides at "
                                 f"level {level}")
            z //= s
            if z % n_model != 0:
                raise ValueError(f"level-{level} z extent {z} not divisible by model-axis "
                                 f"size {n_model}; choose a patch with more z-divisibility")

    def _partitioned(self):
        """The spatial-partitioning context of this rank's model group (a
        no-op without a model axis)."""
        if self.n_model <= 1:
            return contextlib.nullcontext()
        return spatial_partitioning(self.mesh.get_group("model"))

    def _forward(self, net: torch.nn.Module, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model on this rank's z-slab of ``images [B, D, ...]`` under a
        model axis, on the whole patch otherwise; the outputs are the whole
        patch's on every rank."""
        if self.n_model > 1:
            z = images.shape[1] // self.n_model
            i = self.mesh.get_local_rank("model")
            images = images[:, i * z:(i + 1) * z]
        return net(images)

    def _seeded(self, seed: int) -> torch.Generator:
        """A generator on the device for ``seed``, decorrelated by the data
        index (rank 0 of the data axis keeps ``seed``)."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed + (self.data_index << 32))
        return generator

    def _mean_over_ranks(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each scalar averaged over every rank (JAX ``pmean``)."""
        if self.mesh is None:
            return values
        stacked = torch.stack([v.float() for v in values.values()])
        dist.all_reduce(stacked)
        stacked /= dist.get_world_size()
        return dict(zip(values, stacked.unbind()))

    def _gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s rows from every data rank, in data order (the global
        batch)."""
        n = axis_size(self.mesh, "data")
        if n == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.get_group("data"))
        return torch.cat(parts)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _prepare(self, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                 train: bool) -> Dict[str, torch.Tensor]:
        """A raw batch on the device -> the training batch: augmented with
        draws from ``generator`` in training, centre-cropped to the patch in
        validation, then :func:`prepare_targets`. A batch with ``gt_boxes``,
        or any batch without an ``augment_cfg``, passes unchanged."""
        if self.augment_cfg is None or "gt_boxes" in batch:
            return batch
        data, seg = batch["images"], batch["seg_instances"]
        if train:
            data, seg = augment_batch(generator, data, seg, self.augment_cfg)
        elif tuple(seg.shape[1:]) != tuple(self.cfg.patch_size):
            data, seg = center_crop_batch(data, seg, self.cfg.patch_size)
        return prepare_targets(data, seg, batch["instance_classes"])

    def _losses(self, model, batch, generator) -> Dict[str, torch.Tensor]:
        preds = self._forward(model, batch["images"])
        losses = train_step_loss(self.cfg, preds, self.anchors, self.anchors_per_level, batch,
                                 generator)
        losses["total"] = sum(losses[k] for k in LOSS_KEYS)
        return losses

    def _apply_update(self, state: TrainState) -> bool:
        """Clip, decay and SGD, unless the gradient is not finite; True if
        the update was applied. Reads the gradient norm on the host, where
        the host waits for the backward (the loss's ``BoxCoder.decode``
        waits for the forward as well)."""
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        with trace.span("train.sync"):
            norm = norm.item()
        finite = math.isfinite(norm)
        state.notfinite_count = 0 if finite else state.notfinite_count + 1
        if self.tcfg.skip_nonfinite_updates and not (
                finite or state.notfinite_count > MAX_CONSECUTIVE_ERRORS):
            return False
        clip = self.tcfg.grad_clip_norm
        if clip and not norm < clip:  # optax: g / norm * max_norm
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, clip)
        for group in state.optimizer.param_groups:
            group["lr"] = self.schedule(state.opt_count)
        state.optimizer.step()
        state.opt_count += 1
        return True

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One forward, backward and update on a batch already on the
        device (this process's rows of the global batch); returns the losses
        as device scalars, averaged over the ranks. A raw batch takes its
        augmentation draws from ``generator`` before the loss's sampler."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        trace.count("train.patches", batch["images"].shape[0])
        with self._partitioned():
            with trace.span("train.prepare"):
                batch = self._prepare(batch, generator, train=True)
            with trace.span("train.forward"):
                losses = self._losses(state.net, batch, generator)
            with trace.span("train.backward"):
                losses["total"].backward()
        with trace.span("train.update"):
            self._apply_update(state)
        state.step += 1
        return self._mean_over_ranks({k: v.detach() for k, v in losses.items()})

    # ------------------------------------------------------------------
    def train_epoch(self, state: TrainState, batches: Iterable[Dict[str, Any]],
                    epoch: int) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over ``batches``. The losses stay on the device and are
        read once, at the end; steps with non-finite losses are left out of
        the means and counted."""
        generator = self._seeded(self.tcfg.seed * 1000 + epoch)
        metrics: Dict[str, List[torch.Tensor]] = {}
        t0 = time.perf_counter()
        for batch in batches:
            with trace.span("train.to_device"):
                batch = self._to_device(batch)
            with trace.span("train.step"):
                losses = self.train_step(state, batch, generator)
            for k, v in losses.items():
                metrics.setdefault(k, []).append(v)
        host = {k: torch.stack(v).float().cpu().numpy() for k, v in metrics.items()}
        out = {f"train_{k}": float(v[np.isfinite(v)].mean()) if np.isfinite(v).any() else math.nan
               for k, v in host.items()}
        bad = np.flatnonzero(~np.isfinite(host.get("total", np.zeros(0))))
        out["train_nonfinite_steps"] = int(len(bad))
        if len(bad):
            out["train_first_nonfinite_step"] = float(bad[0])
        out["host_max_rss_gb"] = _host_max_rss_gb()
        out["epoch_time_s"] = time.perf_counter() - t0
        out["steps"] = len(host.get("total", ()))
        return state, out

    @torch.no_grad()
    def val_epoch(self, state: TrainState, batches: Iterable[Dict[str, Any]], epoch: int,
                  evaluator=None) -> Dict[str, float]:
        """Mean losses and detections per image over ``batches``. An
        ``evaluator`` (:class:`nndetection_tpu_torch.evaluator.det.BoxEvaluator`)
        gets each batch's detections and ground truth as NumPy arrays, and
        its scores join the result (``monitor_key`` among them). In a
        process group the losses are averaged over the ranks and the
        detections and ground truth gathered over the data ranks, so that
        every rank's evaluator sees the global batch."""
        generator = self._seeded(999 * (epoch + 1))
        state.model.eval()
        metrics: Dict[str, List[torch.Tensor]] = {}
        for batch in batches:
            batch = self._prepare(self._to_device(batch), generator, train=False)
            with self._partitioned():
                preds = self._forward(state.model, batch["images"])
            losses = train_step_loss(self.cfg, preds, self.anchors, self.anchors_per_level,
                                     batch, generator)
            dets = batched_postprocess(self.cfg, preds, self.anchors, self.cfg.patch_size,
                                       with_seg=False)
            dets = {k: self._gather_data(v) for k, v in dets.items()}
            losses = self._mean_over_ranks(losses)
            losses["detections_per_image"] = dets["valid"].float().sum(-1).mean()
            for k, v in losses.items():
                metrics.setdefault(k, []).append(v)
            if evaluator is not None:
                host = {k: v.cpu().numpy() for k, v in dets.items()}
                gt = {k: self._gather_data(batch[k]).cpu().numpy()
                      for k in ("gt_boxes", "gt_classes", "gt_mask")}
                evaluator.add_batch(
                    pred_boxes=host["boxes"], pred_scores=host["scores"],
                    pred_labels=host["labels"], pred_valid=host["valid"], **gt)
        out = {f"val_{k}": float(torch.stack(v).mean()) for k, v in metrics.items()}
        if evaluator is not None:
            out.update(evaluator.finish_online_evaluation()[0])
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def update_swa(self, state: TrainState) -> TrainState:
        """Average the weights into the SWA model (once per SWA epoch)."""
        n = float(state.swa_count)
        for name, p in state.model.named_parameters():
            avg = state.swa_params[name]
            avg.copy_((avg * n + p) / (n + 1.0))
        state.swa_count += 1
        return state

    # ------------------------------------------------------------------
    def save_checkpoint(self, state: TrainState, path, extra: Optional[dict] = None) -> None:
        """A ``torch.save`` checkpoint of the whole state with the model
        configuration as JSON-compatible data. For inference,
        :mod:`nndetection_tpu_torch.inference.loading` reads these and the
        JAX package's checkpoint pickles alike."""
        payload = {
            "schema_version": CKPT_SCHEMA_VERSION,
            "params": state.model.state_dict(),
            "opt_state": {
                "optimizer": state.optimizer.state_dict(),
                "opt_count": state.opt_count,
                "notfinite_count": state.notfinite_count,
            },
            "step": state.step,
            "swa_params": state.swa_params,
            "swa_count": state.swa_count,
            "model_cfg": self.cfg.to_dict(),
            "extra": extra or {},
        }
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, path)

    def load_checkpoint(self, path) -> TrainState:
        payload = torch.load(path, map_location=self.device, weights_only=True)
        required = {"params", "opt_state", "step", "swa_params", "swa_count"}
        missing = sorted(required - set(payload))
        if missing:
            raise ValueError(
                f"checkpoint {path} is missing field(s) {missing} "
                f"(schema_version={payload.get('schema_version', 'pre-1')})")
        loaded = payload.get("schema_version", 1)
        if loaded > CKPT_SCHEMA_VERSION:
            raise ValueError(f"checkpoint {path} has schema_version={loaded}, this build "
                             f"supports <= {CKPT_SCHEMA_VERSION}")
        state = self.init_state(params=payload["params"])
        opt = payload["opt_state"]
        state.optimizer.load_state_dict(opt["optimizer"])
        state.opt_count = int(opt["opt_count"])
        state.notfinite_count = int(opt["notfinite_count"])
        state.step = int(payload["step"])
        state.swa_params = {k: v.to(self.device) for k, v in payload["swa_params"].items()}
        state.swa_count = int(payload["swa_count"])
        return state

    # ------------------------------------------------------------------
    def fit(
        self,
        train_iter_fn: Callable[[int], Iterable[Dict[str, Any]]],
        val_iter_fn: Optional[Callable[[int], Iterable[Dict[str, Any]]]] = None,
        evaluator_fn: Optional[Callable[[], Any]] = None,
        log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
        start_epoch: int = 0,
        state: Optional[TrainState] = None,
        best_score: float = -np.inf,
        stop_after_epoch: Optional[int] = None,
    ) -> TrainState:
        """``max_epochs`` regular and ``swa_epochs`` SWA epochs; at the end
        the SWA average replaces the weights. ``stop_after_epoch`` ends the
        run early with a resumable checkpoint. Logs and checkpoints are rank
        0's alone."""
        if state is None:
            state = self.init_state()
        total_epochs = self.tcfg.max_epochs + self.tcfg.swa_epochs
        best = best_score
        for epoch in range(start_epoch, total_epochs):
            state, train_metrics = self.train_epoch(state, train_iter_fn(epoch), epoch)
            metrics = dict(train_metrics)
            if val_iter_fn is not None:
                evaluator = evaluator_fn() if evaluator_fn else None
                metrics.update(self.val_epoch(state, val_iter_fn(epoch), epoch, evaluator))
            if epoch >= self.tcfg.max_epochs:
                state = self.update_swa(state)
            main = distributed.is_main_process()
            if log_fn and main:
                log_fn(epoch, metrics)
            if self.output_dir is not None and main:
                score = metrics.get(self.tcfg.monitor_key)
                if score is not None and score > best:
                    best = score
                    self.save_checkpoint(state, self.output_dir / "model_best.ckpt",
                                         {"epoch": epoch, "score": score})
                self.save_checkpoint(state, self.output_dir / "model_last.ckpt",
                                     {"epoch": epoch, "best_score": float(best)})
            if stop_after_epoch is not None and stop_after_epoch <= epoch < total_epochs - 1:
                return state
        if self.tcfg.swa_epochs > 0 and state.swa_count > 0:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    p.copy_(state.swa_params[name])
            if self.output_dir is not None and distributed.is_main_process():
                self.save_checkpoint(state, self.output_dir / "model_last.ckpt",
                                     {"epoch": total_epochs - 1, "swa_final": True})
        return state

