"""Pool-fed training on multi-sequence cases: the ``train_pool`` entry
(``Trainer.train_epoch`` over ``PrefetchIterator(DevicePatchPool.epoch(n))``)
for a plan of several input sequences, with what such a plan changes:

* the cases come from :func:`benchmark.traffic.generate_mr.write_mr_cases`
  (every sequence and the instance ids in one ``.npy``);
* the augmentation takes the configuration's ``dummy_2d`` (the plan's
  ``do_dummy_2d``: spatial transforms in plane only), as ``run_train``
  passes it;
* the pool's swap budget counts ``2 * C + 2`` bytes a voxel (C bfloat16
  sequences and the int16 ids);
* ``cut_mismatch`` compares every sequence of the cut with the case on disk.

The window, ``release()``, the captured epochs and every other number of
the check are ``train_pool``'s, unchanged.
"""
from __future__ import annotations

import math
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import harness
from benchmark.reference.model import param_specs
from benchmark.traffic import generate, generate_mr

train_pool = harness.load_piece("entries", "train_pool")


class Entry(train_pool.Entry):
    def __init__(self, run: harness.Run):
        from nndetection_tpu_torch.data.aug_presets import get_augmentation
        from nndetection_tpu_torch.data.augment import generator_patch_size_for
        from nndetection_tpu_torch.data.loader import DevicePatchPool, build_case_records
        from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig
        from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

        self.run = run
        cell, cfg, dev = run.workload, run.ref_cfg, run.device
        self.cfg, self.mix = cfg, cell.get("mix") or generate.load(cell["traffic"])
        self.tmp = tempfile.TemporaryDirectory(prefix="nndet_bench_")
        self.image_dir = Path(self.tmp.name) / "imagesTr"
        generate_mr.write_mr_cases(self.mix, harness.sub_seed(run.seed, 2), self.image_dir)
        self.tcfg = dict(run.config["trainer"], seed=harness.sub_seed(run.seed, 3) % 2 ** 31)
        patch = tuple(cfg["patch_size"])
        self.aug_cfg = get_augmentation(run.config["augmentation"], patch,
                                        dummy_2d=bool(run.config["dummy_2d"]))
        self.trainer = Trainer(RetinaUNetConfig.from_dict(run.config["model"]),
                               TrainerConfig(**self.tcfg), device=dev, augment_cfg=self.aug_cfg)
        self.specs = param_specs(cfg)
        self.weights = harness.make_weights(self.specs, harness.sub_seed(run.seed, 1), dev)
        self.state = self.trainer.init_state(params=self.weights)
        records = build_case_records(self.image_dir)
        gen_patch = generator_patch_size_for(self.aug_cfg)
        max_shape = [max(max(r.shape[d] for r in records), gen_patch[d])
                     for d in range(len(gen_patch))]
        # bf16 sequences and int16 ids
        case_bytes = math.prod(max_shape) * (2 * cfg["in_channels"] + 2)
        self.pool = DevicePatchPool(
            records, patch_size=gen_patch, batch_size=self.tcfg["batch_size"],
            max_pool_cases=self.mix["resident_cases"],
            max_swap_bytes_per_epoch=max(1, self.mix["swaps_per_epoch"]) * case_bytes,
            device=dev, oversample_foreground_percent=0.5,
            max_instances=run.config["max_instances_per_patch"],
            seed=harness.sub_seed(run.seed, 4) % 2 ** 31, inner_patch_size=patch)
        self.epoch = 0
        self.captures = [self._capture_epoch(cell["check"]["steps"], fresh=True)]
        run.counts.update(steps=0, batch=self.tcfg["batch_size"], remat=cfg["remat"])
        self._trace_spans()

    def _cut_mismatch(self, cap: train_pool.Capture) -> int:
        """Patches of the program's cut unlike the reference's window of the
        case, every sequence read from disk as bfloat16 and the ids as
        int16, padded at the high end to the largest case (sequences 0, ids
        -1), the start taken as ``lax.dynamic_slice`` takes it."""
        files = sorted(self.image_dir.glob("*.npy"))
        shapes = [np.load(p, mmap_mode="r").shape[1:] for p in files]
        largest = [max(s[d] for s in shapes) for d in range(len(shapes[0]))]
        padded, bad = {}, 0
        for ids, origins, data, seg in cap.cuts:
            gen_patch = tuple(seg.shape[1:])
            full = np.maximum(largest, gen_patch)
            for b, (cid, org) in enumerate(zip(ids, origins)):
                if cid not in padded:
                    arr = np.load(self.image_dir / f"{cid}.npy", mmap_mode="r")
                    channels = arr.shape[0] - 1
                    pd = torch.zeros((*full, channels), dtype=torch.bfloat16)
                    ps = torch.full(tuple(full), -1, dtype=torch.int16)
                    region = tuple(slice(0, s) for s in arr.shape[1:])
                    pd[region] = torch.from_numpy(
                        np.moveaxis(np.asarray(arr[:-1], np.float32), 0, -1)).to(torch.bfloat16)
                    ps[region] = torch.from_numpy(np.asarray(arr[-1], np.float32).astype(np.int16))
                    padded[cid] = (pd, ps)
                pd, ps = padded[cid]
                org = np.clip(np.where(org < 0, org + full, org), 0, full - np.asarray(gen_patch))
                win = tuple(slice(int(o), int(o) + p) for o, p in zip(org, gen_patch))
                same = torch.equal(pd[win], data[b].cpu()) and torch.equal(ps[win], seg[b].cpu())
                bad += 0 if same else 1
        return bad
