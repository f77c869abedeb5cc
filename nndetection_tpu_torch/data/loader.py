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
"""
from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from nndetection_tpu_torch.utils.io import load_pickle


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
            table = np.full((self.max_instances,), -1, np.int32)
            for iid, cls in zip(rec.instance_ids, rec.classes):
                if 1 <= iid <= self.max_instances:
                    table[iid - 1] = cls
            tables.append(table)
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


class BalancedPatchLoader(PatchLoader):
    """Class-balanced foreground sampling."""

    def __init__(self, *args, **kwargs):
        kwargs["balanced_classes"] = True
        super().__init__(*args, **kwargs)


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


# the reference's registry names
DataLoader3DOffset = PatchLoader
DataLoader3DBalanced = BalancedPatchLoader
DataLoader3DFast = FastPatchLoader


class PrefetchIterator:
    """Background-thread prefetch of host batches (double buffering the
    memmap reads against device compute). A worker's error is raised by
    the ``next`` that reaches it."""

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
        item = self.q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
