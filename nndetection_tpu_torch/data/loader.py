"""Host-side patch sampling from preprocessed memmaps (counterpart of the
host part of :mod:`nndetection_tpu.data.loader`).

Fixed-length epochs of random patches with foreground oversampling: the
last ``oversample_foreground_percent`` of every batch is forced to contain
an instance, its crop drawn so that a chosen instance fits the patch
(``DataLoader3DOffset``). The host only reads memmaps and does the crop
arithmetic; augmentation runs on the device
(:mod:`nndetection_tpu_torch.data.augment`). Batches carry raw instance
ids and each case's instance -> class table; boxes and semantic masks are
made on the device after augmentation
(:func:`nndetection_tpu_torch.data.gt_prep.prepare_targets`).

The draws come from ``np.random.RandomState`` in the JAX loader's order, so
that one seed gives both packages the same patches.

:class:`DevicePatchPool` keeps the training cases resident on the device
and cuts each patch there, as the JAX package trains on its accelerator.
"""
from __future__ import annotations

import math
import queue as queue_mod
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.utils import trace
from nndetection_tpu_torch.utils.io import load_pickle
from nndetection_tpu_torch.utils.registry import DATALOADER_REGISTRY


@dataclass
class CaseRecord:
    case_id: str
    npy_path: Path  # [C+1, *spatial] float32 (last channel = instance seg)
    shape: tuple  # spatial shape
    boxes: np.ndarray  # [I, 2*dim] instance boxes (preprocessed space)
    classes: np.ndarray  # [I]
    instance_ids: np.ndarray  # [I]


def build_case_records(image_dir) -> List[CaseRecord]:
    """One record per ``{case}.npy`` with its ``{case}_boxes.pkl``."""
    image_dir = Path(image_dir)
    records = []
    for npy in sorted(image_dir.glob("*.npy")):
        if npy.stem.endswith("_boxes"):
            continue
        cand = load_pickle(image_dir / f"{npy.stem}_boxes.pkl")
        arr = np.load(npy, mmap_mode="r")
        records.append(
            CaseRecord(
                case_id=npy.stem,
                npy_path=npy,
                shape=tuple(arr.shape[1:]),
                boxes=np.asarray(cand["boxes"], np.float32),
                classes=np.asarray(cand["classes"], np.int64),
                instance_ids=np.asarray(cand["instance_ids"], np.int64),
            )
        )
    return records


@DATALOADER_REGISTRY.register(name="DataLoader3DOffset")
class PatchLoader:
    """Fixed-length random patch sampler over a set of cases
    (``DataLoader3DOffset``); :class:`BalancedPatchLoader` samples the
    foreground class-balanced, :class:`FastPatchLoader` drops the
    whole-instance-fits constraint."""

    def __init__(
        self,
        records: Sequence[CaseRecord],
        patch_size: Sequence[int],
        batch_size: int,
        oversample_foreground_percent: float = 0.5,
        max_instances: int = 32,
        seed: int = 0,
        balanced_classes: bool = False,
        inner_patch_size: Optional[Sequence[int]] = None,
        fixed_sequence: bool = False,
        pin_memory: bool = False,
    ):
        """``patch_size`` is what gets extracted (the enlarged generator
        patch when augmentation follows); ``inner_patch_size`` is the final
        network patch: the foreground constraint targets the centred inner
        region, so that instances survive the crop after augmentation.
        ``fixed_sequence`` replays the same patches every epoch (validation:
        per-epoch metrics then compare the model, not the sample).
        ``pin_memory`` returns batches in page-locked memory, for an
        asynchronous copy to the card."""
        if not records:
            raise ValueError("no cases to sample from")
        self.records = list(records)
        self.patch_size = tuple(int(p) for p in patch_size)
        self.inner_patch = (
            tuple(int(p) for p in inner_patch_size)
            if inner_patch_size is not None
            else self.patch_size
        )
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.max_instances = max_instances
        self.seed = seed
        self.fixed_sequence = fixed_sequence
        self.pin_memory = pin_memory
        self.rng = np.random.RandomState(seed)
        self.balanced_classes = balanced_classes
        self.dim = len(self.patch_size)
        self._arr_cache = {}

    def _array(self, rec: CaseRecord):
        arr = self._arr_cache.get(rec.case_id)
        if arr is None:
            arr = np.load(rec.npy_path, mmap_mode="r")
            self._arr_cache[rec.case_id] = arr
        return arr

    def _needs_fg(self, idx_in_batch: int) -> bool:
        # the last `oversample` fraction of the batch is forced foreground
        # (Python's round: halves to even, as the JAX loader)
        return idx_in_batch >= round(self.batch_size * (1.0 - self.oversample))

    def _box_bounds(self, box: np.ndarray):
        """Per-axis lo/hi of a box laid out (x1, y1, x2, y2[, z1, z2])."""
        lo = np.array([box[0], box[1], box[4]] if self.dim == 3 else [box[0], box[1]])
        hi = np.array([box[2], box[3], box[5]] if self.dim == 3 else [box[2], box[3]])
        return lo, hi

    def _fg_origin(self, rec: CaseRecord) -> np.ndarray:
        """Crop origin such that a randomly chosen instance fully fits."""
        if self.balanced_classes and len(rec.classes):
            cls = self.rng.choice(np.unique(rec.classes))
            pool = np.where(rec.classes == cls)[0]
            i = self.rng.choice(pool)
        else:
            i = self.rng.randint(len(rec.boxes))
        lo, hi = self._box_bounds(rec.boxes[i])
        patch = np.asarray(self.patch_size)
        inner = np.asarray(self.inner_patch)
        margin = (patch - inner) // 2
        shape = np.asarray(rec.shape)
        # valid INNER-region origin so that [lo, hi) lies in the centred
        # final-patch window; then shift back by the generator margin
        o_min = np.maximum(0, hi - inner).astype(np.int64)
        o_max = np.minimum(lo, np.maximum(shape - inner, 0)).astype(np.int64)
        o_max = np.maximum(o_max, o_min)
        inner_origin = np.array(
            [self.rng.randint(a, b + 1) for a, b in zip(o_min, o_max)], np.int64
        )
        origin = inner_origin - margin
        return np.clip(origin, 0, np.maximum(shape - patch, 0)).astype(np.int64)

    def _bg_origin(self, rec: CaseRecord) -> np.ndarray:
        shape = np.asarray(rec.shape)
        patch = np.asarray(self.patch_size)
        hi = np.maximum(shape - patch, 0)
        return np.array([self.rng.randint(0, h + 1) for h in hi], np.int64)

    def sample_patch(self, rec: CaseRecord, force_fg: bool):
        """``(data [C, *patch] float32, seg [*patch] int32)``, zero-padded
        at the high end where the case is smaller than the patch."""
        arr = self._array(rec)
        shape = np.asarray(rec.shape)
        patch = np.asarray(self.patch_size)

        use_fg = force_fg and len(rec.boxes) > 0
        origin = self._fg_origin(rec) if use_fg else self._bg_origin(rec)

        sl = tuple(
            slice(int(o), int(min(o + p, s)))
            for o, p, s in zip(origin, patch, shape)
        )
        crop = np.asarray(arr[(slice(None),) + sl])
        if any(crop.shape[1 + i] != patch[i] for i in range(self.dim)):
            pads = [(0, 0)] + [
                (0, int(patch[i] - crop.shape[1 + i])) for i in range(self.dim)
            ]
            crop = np.pad(crop, pads, mode="constant")
        data = crop[:-1]
        seg = crop[-1].astype(np.int32)
        return data, seg

    def _class_table(self, rec: CaseRecord) -> np.ndarray:
        table = np.full((self.max_instances,), -1, np.int32)
        for iid, cls in zip(rec.instance_ids, rec.classes):
            if 1 <= iid <= self.max_instances:
                table[iid - 1] = cls
        return table

    def generate_batch(self) -> Dict[str, torch.Tensor]:
        """``images [B, *patch, C]`` bfloat16 (channel-last), ``seg_instances
        [B, *patch]`` int16 and ``instance_classes [B, max_instances]``
        int32 (class of instance id ``i + 1``, -1 where absent), CPU
        tensors."""
        images, segs, tables = [], [], []
        for i in range(self.batch_size):
            rec = self.records[self.rng.randint(len(self.records))]
            data, seg = self.sample_patch(rec, self._needs_fg(i))
            images.append(np.moveaxis(data, 0, -1))
            segs.append(seg)
            tables.append(self._class_table(rec))
        # bf16 images and int16 seg: a quarter of the host -> device bytes;
        # torch rounds float32 to bfloat16 to nearest even, as ml_dtypes
        batch = {
            "images": torch.from_numpy(np.stack(images)).to(torch.bfloat16),
            "seg_instances": torch.from_numpy(np.stack(segs).astype(np.int16)),
            "instance_classes": torch.from_numpy(np.stack(tables)),
        }
        if self.pin_memory:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def epoch(self, num_batches: int) -> Iterator[Dict[str, torch.Tensor]]:
        if self.fixed_sequence:
            self.rng = np.random.RandomState(self.seed)
        for _ in range(num_batches):
            yield self.generate_batch()


@DATALOADER_REGISTRY.register(name="DataLoader3DBalanced")
class BalancedPatchLoader(PatchLoader):
    """Class-balanced foreground sampling."""

    def __init__(self, *args, **kwargs):
        kwargs["balanced_classes"] = True
        super().__init__(*args, **kwargs)


@DATALOADER_REGISTRY.register(name="DataLoader3DFast")
class FastPatchLoader(PatchLoader):
    """Foreground crops centred on a random voxel inside the instance box,
    without forcing the whole instance into the patch."""

    def _fg_origin(self, rec: CaseRecord) -> np.ndarray:
        i = self.rng.randint(len(rec.boxes))
        lo, hi = self._box_bounds(rec.boxes[i])
        center = np.array(
            [self.rng.randint(int(a), max(int(b), int(a) + 1)) for a, b in zip(lo, hi)]
        )
        patch = np.asarray(self.patch_size)
        shape = np.asarray(rec.shape)
        origin = center - patch // 2
        return np.clip(origin, 0, np.maximum(shape - patch, 0)).astype(np.int64)


@DATALOADER_REGISTRY.register(name="DevicePatchPool")
class DevicePatchPool(PatchLoader):
    """Patch sampling with the cases resident on the device (counterpart of
    the JAX ``DevicePatchPool``).

    Each case goes to the device once, as bfloat16 data ``[*max_shape, C]``
    and int16 instance ids ``[*max_shape]``, padded at the high end to the
    pool's common shape (data with 0, ids with -1, the outside-volume
    marker that :func:`~nndetection_tpu_torch.data.gt_prep.prepare_targets`
    ignores). A batch is cut on the device from a few indices per patch, so
    a step moves no image over PCIe.

    The draws are :class:`PatchLoader`'s, in its order (the case, then the
    foreground or background origin); pool management draws from a
    ``RandomState`` of its own and keeps the initial slots sorted, so with
    every case resident one seed gives the batches of the host loader (but
    for the -1 padding) and of the JAX pool.

    A dataset larger than ``max_pool_cases`` keeps a subset resident and
    rotates the others in during each epoch: a staging thread reads, pads and
    casts the next outsider case into pinned memory while the card trains,
    and between batches one slot is swapped at an even cadence, least-visited
    case in, most-visited out. A swap that finds nothing staged is deferred
    and counted (``pool_io_starved_last_epoch``); what is staged at the end
    of the epoch is swapped in before it ends. :meth:`sampling_report` says
    what coverage and skew that gave.

    Under a profiler (:mod:`nndetection_tpu_torch.utils.trace`) each cut
    records a ``pool.cut`` span, each swap ``pool.swap`` and each staged
    read ``pool.stage_read``.

    A batch is a new tensor, never a view of the pool: a later swap writes
    the pool in place, on the same stream as the cuts, and must not change a
    batch that waits in a prefetch queue. ``device`` is the card unless the
    caller passes another; without CUDA the default raises, and the cases
    never stay on the host in its place."""

    def __init__(
        self,
        records: Sequence[CaseRecord],
        patch_size: Sequence[int],
        batch_size: int,
        max_pool_cases: Optional[int] = None,
        swap_per_epoch: int = 2,
        num_epochs_hint: Optional[int] = None,
        max_swap_bytes_per_epoch: int = 8 * 1024**3,
        device: Union[torch.device, str] = "cuda",
        **kwargs,
    ):
        super().__init__(records, patch_size, batch_size, **kwargs)
        self.device = resolve_device(device)
        self.all_records = list(self.records)
        n_pool = min(len(self.all_records), max_pool_cases or len(self.all_records))
        self.swap_per_epoch = swap_per_epoch if n_pool < len(self.all_records) else 0
        self.max_shape = tuple(
            max(max(r.shape[d] for r in self.all_records), self.patch_size[d])
            for d in range(self.dim)
        )
        self.channels = np.load(self.all_records[0].npy_path, mmap_mode="r").shape[0] - 1
        case_bytes = math.prod(self.max_shape) * (2 * self.channels + 2)
        if self.swap_per_epoch and num_epochs_hint:
            # every case resident at least once over the run, bounded by the
            # per-epoch transfer budget and by the pool itself
            needed = -(-(len(self.all_records) - n_pool) // max(num_epochs_hint, 1))
            cap = max(1, min(max_swap_bytes_per_epoch // max(case_bytes, 1), n_pool))
            self.swap_per_epoch = int(min(max(self.swap_per_epoch, needed), cap))
        self.case_bytes = case_bytes
        self.max_swap_bytes_per_epoch = max_swap_bytes_per_epoch
        # telemetry: patches drawn per case, epochs resident per case
        self._visits: Dict[str, int] = {r.case_id: 0 for r in self.all_records}
        self._resident_epochs: Dict[str, int] = {r.case_id: 0 for r in self.all_records}
        self._ever_resident: set = set()
        self._rotations_last_epoch = 0
        self._io_starved_last_epoch = 0
        self._pool_slots: List[CaseRecord] = []
        self._data_pool: Optional[torch.Tensor] = None  # [n, *max_shape, C] bf16
        self._seg_pool: Optional[torch.Tensor] = None  # [n, *max_shape] int16
        self._pool_rng = np.random.RandomState((kwargs.get("seed", 0) * 7919 + 13) % (2**31))
        idx = np.sort(self._pool_rng.permutation(len(self.all_records))[:n_pool])
        self._fill([self.all_records[i] for i in idx])
        self.records = self._pool_slots  # the draws pick among resident cases

    # -- pool management -------------------------------------------------
    def _case_arrays(self, rec: CaseRecord) -> Tuple[torch.Tensor, torch.Tensor]:
        """One case padded to ``max_shape``: bfloat16 data (rounded to
        nearest even) and int16 ids, in pinned memory when the pool is on
        the card."""
        arr = np.load(rec.npy_path, mmap_mode="r")
        pin = self.device.type == "cuda"
        region = tuple(slice(0, s) for s in rec.shape)
        data = torch.zeros((*self.max_shape, self.channels), dtype=torch.bfloat16,
                           pin_memory=pin)
        data[region] = torch.from_numpy(np.moveaxis(np.array(arr[:-1], np.float32), 0, -1))
        seg = torch.full(self.max_shape, -1, dtype=torch.int16, pin_memory=pin)
        seg[region] = torch.from_numpy(np.asarray(arr[-1], np.float32).astype(np.int16))
        return data, seg

    def _fill(self, recs: List[CaseRecord]) -> None:
        n = len(recs)
        self._data_pool = torch.empty((n, *self.max_shape, self.channels),
                                      dtype=torch.bfloat16, device=self.device)
        self._seg_pool = torch.empty((n, *self.max_shape), dtype=torch.int16,
                                     device=self.device)
        for slot, rec in enumerate(recs):
            self._put(slot, *self._case_arrays(rec))
        self._pool_slots = list(recs)

    def _put(self, slot: int, data: torch.Tensor, seg: torch.Tensor) -> None:
        # in place, on the current stream: ordered after every cut enqueued
        # before it, whose batches are copies
        self._data_pool[slot].copy_(data, non_blocking=True)
        self._seg_pool[slot].copy_(seg, non_blocking=True)

    def refresh(self) -> None:
        """Swap ``swap_per_epoch`` resident cases for outsiders, the least
        resident (never resident first) in for the most resident out."""
        for rec in self._pool_slots:
            self._resident_epochs[rec.case_id] += 1
            self._ever_resident.add(rec.case_id)
        if not self.swap_per_epoch:
            return
        resident_ids = {r.case_id for r in self._pool_slots}
        outside = [r for r in self.all_records if r.case_id not in resident_ids]
        if not outside:
            return
        # least resident first; permuted first, so that ties break randomly
        order = self._pool_rng.permutation(len(outside))
        outside = sorted((outside[i] for i in order),
                         key=lambda r: self._resident_epochs[r.case_id])
        slot_order = sorted(range(len(self._pool_slots)),
                            key=lambda s: -self._resident_epochs[self._pool_slots[s].case_id])
        for j in range(min(self.swap_per_epoch, len(outside))):
            slot = slot_order[j % len(slot_order)]
            new = outside[j]
            self._put(slot, *self._case_arrays(new))
            self._pool_slots[slot] = new
            self._ever_resident.add(new.case_id)

    def sampling_report(self) -> Dict[str, float]:
        """Coverage and skew of the sampling: ``pool_coverage`` is the share
        of the dataset ever resident, ``pool_visit_cv`` the coefficient of
        variation of the patches drawn per case."""
        visits = np.asarray(list(self._visits.values()), np.float64)
        mean = float(visits.mean()) if len(visits) else 0.0
        return {
            "pool_cases": float(len(self._pool_slots)),
            "pool_coverage": len(self._ever_resident) / max(len(self.all_records), 1),
            "pool_swap_per_epoch": float(self.swap_per_epoch),
            "pool_rotations_last_epoch": float(self._rotations_last_epoch),
            "pool_io_starved_last_epoch": float(self._io_starved_last_epoch),
            "pool_visit_cv": float(visits.std() / mean) if mean else 0.0,
            "pool_visit_min": float(visits.min()) if len(visits) else 0.0,
            "pool_visit_max": float(visits.max()) if len(visits) else 0.0,
        }

    def pool_bytes(self) -> int:
        return len(self._pool_slots) * math.prod(self.max_shape) * (2 * self.channels + 2)

    # -- device cut ------------------------------------------------------
    def gather(self, case_idx: Sequence[int], origins: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``images [B, *patch, C]`` and ``seg [B, *patch]``: new tensors on
        the pool's device, patch ``i`` cut from slot ``case_idx[i]`` at
        ``origins[i]``. A start is taken as ``lax.dynamic_slice`` takes it:
        a negative one counts from the end of its axis, then it is clamped
        into ``[0, max_shape - patch]``."""
        size = np.asarray(self.max_shape)
        origins = np.asarray(origins, np.int64)
        origins = np.clip(np.where(origins < 0, origins + size, origins), 0,
                          size - np.asarray(self.patch_size))
        cuts = [tuple(slice(int(o), int(o) + p) for o, p in zip(org, self.patch_size))
                for org in origins]
        data = torch.stack([self._data_pool[k][c] for k, c in zip(case_idx, cuts)])
        seg = torch.stack([self._seg_pool[k][c] for k, c in zip(case_idx, cuts)])
        return data, seg

    def generate_batch(self) -> Dict[str, torch.Tensor]:
        """``images`` and ``seg_instances`` on the pool's device,
        ``instance_classes`` on the host, as :meth:`PatchLoader.generate_batch`
        lays them out."""
        case_idx, origins, tables = [], [], []
        for i in range(self.batch_size):
            # PatchLoader.generate_batch's draws, in its order
            k = self.rng.randint(len(self.records))
            rec = self.records[k]
            self._visits[rec.case_id] += 1
            use_fg = self._needs_fg(i) and len(rec.boxes) > 0
            origins.append(self._fg_origin(rec) if use_fg else self._bg_origin(rec))
            case_idx.append(k)
            tables.append(self._class_table(rec))
        with trace.span("pool.cut"):
            data, seg = self.gather(case_idx, np.stack(origins))
        return {"images": data, "seg_instances": seg,
                "instance_classes": torch.from_numpy(np.stack(tables))}

    # -- in-epoch rotation -------------------------------------------------
    def _rotation_plan(self) -> List[CaseRecord]:
        """The outsiders to rotate in this epoch, least visited first (never
        resident ones have no visits), as many as the transfer budget
        allows."""
        resident_ids = {r.case_id for r in self._pool_slots}
        outside = [r for r in self.all_records if r.case_id not in resident_ids]
        if not outside:
            return []
        budget = max(1, self.max_swap_bytes_per_epoch // max(self.case_bytes, 1))
        order = self._pool_rng.permutation(len(outside))
        outside = sorted((outside[i] for i in order), key=lambda r: self._visits[r.case_id])
        return outside[: min(len(outside), budget)]

    def _swap_slot(self, rec: CaseRecord, data: torch.Tensor, seg: torch.Tensor) -> None:
        # evict the most visited resident: new arrivals (fewer visits) stay
        slot = max(range(len(self._pool_slots)),
                   key=lambda s: self._visits[self._pool_slots[s].case_id])
        with trace.span("pool.swap"):
            self._put(slot, data, seg)
        self._pool_slots[slot] = rec
        self._ever_resident.add(rec.case_id)

    def epoch(self, num_batches: int) -> Iterator[Dict[str, torch.Tensor]]:
        for rec in self._pool_slots:
            self._resident_epochs[rec.case_id] += 1
            self._ever_resident.add(rec.case_id)
        plan = self._rotation_plan() if len(self._pool_slots) < len(self.all_records) else []
        self._rotations_last_epoch = 0
        self._io_starved_last_epoch = 0
        if not plan:
            for _ in range(num_batches):
                yield self.generate_batch()
            return

        stop = threading.Event()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)

        def stage():
            for rec in plan:
                if stop.is_set():
                    return
                with trace.span("pool.stage_read"):
                    d, s = self._case_arrays(rec)
                while not stop.is_set():
                    try:
                        q.put((rec, d, s), timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue

        t = threading.Thread(target=stage, daemon=True)
        t.start()
        # even cadence: rotation j is due at batch (j + 1) * nb // (n + 1)
        n_rot = len(plan)
        due = [((j + 1) * num_batches) // (n_rot + 1) for j in range(n_rot)]
        next_rot = 0
        try:
            for i in range(num_batches):
                while next_rot < n_rot and due[next_rot] <= i:
                    try:
                        rec, d, s = q.get_nowait()
                    except queue_mod.Empty:
                        # staging lags: defer to the next batch
                        self._io_starved_last_epoch += 1
                        break
                    self._swap_slot(rec, d, s)
                    self._rotations_last_epoch += 1
                    next_rot += 1
                yield self.generate_batch()
            # swap in what is staged but undelivered, so that its reads count
            while next_rot < n_rot:
                try:
                    rec, d, s = q.get_nowait()
                except queue_mod.Empty:
                    break
                self._swap_slot(rec, d, s)
                self._rotations_last_epoch += 1
                next_rot += 1
        finally:
            stop.set()
            try:  # unblock a stager waiting on a full queue
                while True:
                    q.get_nowait()
            except queue_mod.Empty:
                pass
            t.join(timeout=5.0)


class PrefetchIterator:
    """Background-thread prefetch of host batches (double buffering the
    memmap reads against device compute). A worker's error is raised by
    the ``next`` that reaches it. Under a profiler the consumer's wait
    for each item is a ``train.batch_wait`` span."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    self.q.put(item)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                self._err = e
            finally:
                self.q.put(self._sentinel)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with trace.span("train.batch_wait"):
            item = self.q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
