"""Training fed by the device patch pool: ``Trainer.train_epoch`` of the
program over ``PrefetchIterator(DevicePatchPool.epoch(n))``, the path
``run_train`` takes on the card, with the augmentation and the target
preparation on the card inside each step.

Set-up writes the mix's cases under the run's ``TMPDIR``, makes the
weights on the card from the seed, builds the trainer, its state and the
pool, and drives that state through a first epoch of ``check.steps`` steps
(the check's first steps, which also build every kernel and plan the cell
uses). The window runs further epochs of the mix's ``steps_per_epoch``
until ``seconds`` have passed; with fewer cases resident than written,
each epoch rotates cases in from disk. Once the window has closed and the
peak is read, the same state runs one more epoch of ``check.steps`` steps,
captured as the first was: it starts from what the window left (its
parameters, momentum, schedule count and resident cases).

The check follows both captured epochs with :mod:`benchmark.reference`,
stage by stage from what the program took in; each number is the worse of
the two epochs (the mismatches: their sum):

* ``cut_mismatch``: patches of the pool's cut that differ from the same
  window of the case as the reference reads it from disk.
* ``aug_img_err``, ``target_mismatch``: the reference's augmentation of the
  cut, with the generator in the state the program's found it, then its
  target preparation, against the program's training batch: the largest
  image difference over the largest image value; voxels, boxes, classes and
  masks that differ.
* ``fwd_cls_err``, ``fwd_reg_err``: the program's classifier logits and box
  deltas of the epoch's first step, against the float32 reference forward
  of the same training batch from the same parameters: per patch, the norm
  of the difference over the norm of the reference's deviation from its
  mean; the worst patch.
* ``loss_gap``, ``grad_gap_med``, ``update_gap_med``: float32 train steps
  on the program's training batches, the sampler's draws from the
  program's generator states: the worst step's gap of the total loss over
  the sum of the magnitudes of its four terms (the regression term is a
  negative GIoU, which cancels the others as training goes on: over the
  total itself the gap swings with that cancellation); per parameter, the
  gap of the norm of the first step's gradient as SGD took it (clipped and
  decayed; the change of the momentum) and of the norm of the change after
  the steps, each over the reference's norm of that parameter or of the
  median parameter, whichever is larger; the median parameter's gap. (The
  worst parameter's gap swings from seed to seed with the rounding of the
  full-resolution encoder's norm parameters: bfloat16 alone, in the
  reference, reads as high there.) Parameters whose reference gradient is
  under a thousandth of the median parameter's are left out of
  ``update_gap_med``. The first epoch's steps start from the benchmark's
  weights and a fresh optimizer; the last epoch's from the program's state
  after the window, which the reference takes as it is.
"""
from __future__ import annotations

import math
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import augment as ref_augment
from benchmark.reference import gt_prep as ref_gt
from benchmark.reference import train as ref_train
from benchmark.reference.detect import anchors as ref_anchors
from benchmark.harness import rel_err, worst
from benchmark.reference.model import Net, param_specs, strict_float32
from benchmark.traffic import generate


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names) -> Dict[str, float]:
    """Per parameter ``|got - want|`` over ``max(want, median of want)``."""
    names = list(names)
    median = float(np.median([want[k] for k in names]))
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names}


class Capture:
    """What the check takes from the first steps of one epoch of the
    program: the state they start from, and per step the pool's cut, the
    raw and the prepared batch, the generator's states, the losses; the
    first step's outputs and gradient; the parameters after the steps."""

    def __init__(self, start: Optional[Dict[str, torch.Tensor]],
                 momentum: Optional[Dict[str, torch.Tensor]], opt_count: int):
        self.start, self.momentum, self.opt_count = start, momentum, opt_count
        self.cuts, self.raw, self.prepared, self.losses = [], [], [], []
        self.gen_before, self.gen_after = [], []
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None
        self.after: Dict[str, torch.Tensor] = {}
        self.failed = 0


class Entry:
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
        generate.write_train_cases(self.mix, harness.sub_seed(run.seed, 2), self.image_dir)
        self.tcfg = dict(run.config["trainer"], seed=harness.sub_seed(run.seed, 3) % 2 ** 31)
        patch = tuple(cfg["patch_size"])
        self.aug_cfg = get_augmentation(run.config["augmentation"], patch)
        self.trainer = Trainer(RetinaUNetConfig.from_dict(run.config["model"]),
                               TrainerConfig(**self.tcfg), device=dev, augment_cfg=self.aug_cfg)
        self.specs = param_specs(cfg)
        self.weights = harness.make_weights(self.specs, harness.sub_seed(run.seed, 1), dev)
        self.state = self.trainer.init_state(params=self.weights)
        records = build_case_records(self.image_dir)
        gen_patch = generator_patch_size_for(self.aug_cfg)
        max_shape = [max(max(r.shape[d] for r in records), gen_patch[d])
                     for d in range(len(gen_patch))]
        case_bytes = math.prod(max_shape) * 4  # bf16 image and int16 ids
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

    # ------------------------------------------------------------ program
    def _epoch(self, n: int) -> dict:
        from nndetection_tpu_torch.data.loader import PrefetchIterator

        self.state, metrics = self.trainer.train_epoch(
            self.state, PrefetchIterator(self.pool.epoch(n), depth=2), self.epoch)
        self.epoch += 1
        return metrics

    def _momentum(self) -> Optional[Dict[str, torch.Tensor]]:
        """The optimizer's momentum per parameter (zeros where it has none
        yet), or None for a fresh optimizer."""
        opt_state = self.state.optimizer.state
        if not opt_state:
            return None
        return {k: (opt_state[p]["momentum_buffer"].clone() if p in opt_state
                    else torch.zeros_like(p))
                for k, p in self.state.model.named_parameters()}

    def _capture_epoch(self, n: int, fresh: bool) -> Capture:
        """An epoch of ``n`` steps through ``train_epoch``, with what the
        check needs taken from it. ``fresh``: the state is the benchmark's
        weights under a fresh optimizer, which the reference takes from the
        benchmark itself."""
        trainer, pool, state = self.trainer, self.pool, self.state
        cap = Capture(None if fresh else {k: p.detach().clone()
                                          for k, p in state.model.named_parameters()},
                      self._momentum(), state.opt_count)
        gather, prepare = pool.gather, trainer._prepare
        forward, step = trainer._forward, trainer.train_step
        beta = self.tcfg["sgd_momentum"]

        def cut(case_idx, origins):
            ids = [pool._pool_slots[k].case_id for k in case_idx]
            out = gather(case_idx, origins)
            cap.cuts.append((ids, np.asarray(origins).copy(), out[0].clone(), out[1].clone()))
            return out

        def prepared(batch, generator, train):
            cap.raw.append({k: v.clone() for k, v in batch.items()})
            cap.gen_before.append(generator.get_state())
            out = prepare(batch, generator, train)
            cap.gen_after.append(generator.get_state())
            cap.prepared.append({k: v.clone() for k, v in out.items()})
            return out

        def forwarded(net, images):
            out = forward(net, images)
            if cap.outputs is None:
                cap.outputs = {k: out[k].detach().clone() for k in ("box_logits", "box_deltas")}
            return out

        def stepped(st, batch, generator):
            before = cap.momentum if not cap.losses else None
            losses = step(st, batch, generator)
            cap.losses.append({k: float(v) for k, v in losses.items()})
            if len(cap.losses) == 1:
                # the step's gradient as SGD took it: buf' = beta * buf + d
                cap.first_grad = {}
                for name, p in st.model.named_parameters():
                    buf = st.optimizer.state.get(p, {}).get("momentum_buffer")
                    buf = torch.zeros_like(p) if buf is None else buf
                    cap.first_grad[name] = (buf - beta * before[name] if before is not None
                                            else buf.clone())
            return losses

        pool.gather, trainer._prepare = cut, prepared
        trainer._forward, trainer.train_step = forwarded, stepped
        try:
            metrics = self._epoch(n)
        finally:
            del pool.gather, trainer._prepare, trainer._forward, trainer.train_step
        cap.failed = metrics["train_nonfinite_steps"]
        cap.after = {k: p.detach().clone() for k, p in self.state.model.named_parameters()}
        return cap

    def _trace_spans(self) -> None:
        from nndetection_tpu_torch.data.loader import PrefetchIterator

        spans, trainer = self.run.spans, self.trainer
        spans.wrap(trainer, "train_step", "train step")
        spans.wrap(trainer, "_prepare", "augmentation and targets")
        spans.wrap(trainer, "_apply_update", "clip, SGD and the step's host sync")
        spans.wrap(self.pool, "gather", "pool cut (prefetch thread)")
        spans.wrap(PrefetchIterator, "__next__", "waiting for the next batch")

    def window(self, seconds: float) -> dict:
        steps = failed = 0
        epoch_s = []
        t0 = time.perf_counter()
        while True:
            m = self._epoch(self.mix["steps_per_epoch"])
            steps += m["steps"]
            failed += m["train_nonfinite_steps"]
            epoch_s.append(time.perf_counter() - t0 - sum(epoch_s))
            if time.perf_counter() - t0 >= seconds:
                break
        total = time.perf_counter() - t0
        harness.log(f"[bench] epoch seconds {[round(e, 4) for e in epoch_s]}")
        self.run.counts["steps"] = steps
        rate = self.run.workload.get("rate_metric", "train_patches_per_s")
        return {rate: steps * self.tcfg["batch_size"] / total,
                "attempted": steps + len(self.captures[0].losses),
                "failed": failed + self.captures[0].failed}

    def release(self) -> None:
        """The check's last epoch, from the state the window left; then the
        program's state is freed."""
        self.captures.append(self._capture_epoch(self.run.workload["check"]["steps"],
                                                 fresh=False))
        del self.state, self.trainer, self.pool

    # ---------------------------------------------------------------- check
    def _cut_mismatch(self, cap: Capture) -> int:
        """Patches of the program's cut unlike the reference's window of the
        case, read from disk as bfloat16 image and int16 ids, padded at the
        high end to the largest case (image 0, ids -1), the start taken as
        ``lax.dynamic_slice`` takes it."""
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
                    pd = torch.zeros(tuple(full), dtype=torch.bfloat16)
                    ps = torch.full(tuple(full), -1, dtype=torch.int16)
                    region = tuple(slice(0, s) for s in arr.shape[1:])
                    pd[region] = torch.from_numpy(np.asarray(arr[0], np.float32)).to(torch.bfloat16)
                    ps[region] = torch.from_numpy(np.asarray(arr[1], np.float32).astype(np.int16))
                    padded[cid] = (pd, ps)
                pd, ps = padded[cid]
                org = np.clip(np.where(org < 0, org + full, org), 0, full - np.asarray(gen_patch))
                win = tuple(slice(int(o), int(o) + p) for o, p in zip(org, gen_patch))
                same = (torch.equal(pd[win], data[b, ..., 0].cpu())
                        and torch.equal(ps[win], seg[b].cpu()))
                bad += 0 if same else 1
        return bad

    def _augmentation(self, cap: Capture):
        """The reference's augmentation and targets of each captured raw
        batch: the largest image error relative to the largest image value,
        and the target entries that differ."""
        cfg = ref_augment.AugmentConfig(**{f: getattr(self.aug_cfg, f)
                                           for f in ref_augment.AugmentConfig.__dataclass_fields__})
        img_err, mismatch = 0.0, 0
        for raw, state, got in zip(cap.raw, cap.gen_before, cap.prepared):
            gen = torch.Generator(device=self.run.device)
            gen.set_state(state)
            data, seg = ref_augment.augment_batch(gen, raw["images"], raw["seg_instances"], cfg)
            want = ref_gt.prepare_targets(data, seg, raw["instance_classes"].to(self.run.device))
            scale = float(want["images"].abs().max())
            img_err = max(img_err, float((got["images"].float() - want["images"].float())
                                         .abs().max()) / max(scale, 1e-30))
            mismatch += int((got["seg"] != want["seg"]).sum())
            mask = got["gt_mask"] | want["gt_mask"]
            mismatch += int((got["gt_mask"] != want["gt_mask"]).sum())
            mismatch += int((mask[..., None] & (got["gt_boxes"] != want["gt_boxes"])).any(-1).sum())
            mismatch += int((mask & (got["gt_classes"] != want["gt_classes"])).sum())
        return img_err, mismatch

    def _start(self, cap: Capture) -> Dict[str, torch.Tensor]:
        return self.weights if cap.start is None else cap.start

    def reference_steps(self, cap: Capture, **kwargs) -> dict:
        grid_np, per_level = ref_anchors(self.cfg)
        decayed = {name for name, _, init, _ in self.specs if init != "const"}
        return ref_train.run_steps(
            self.cfg, self.tcfg, self._start(cap), decayed, cap.prepared, cap.gen_after,
            torch.from_numpy(grid_np).to(self.run.device), per_level,
            momentum_buffers=cap.momentum, start_step=cap.opt_count, **kwargs)

    def forward_errors(self, cap: Capture, quant: Optional[str] = None) -> List[float]:
        """``fwd_cls_err``, ``fwd_reg_err`` of the first step's outputs (the
        program's, or with ``quant`` the reference's in that precision),
        the worst patch of the batch."""
        images = cap.prepared[0]["images"]
        cls, reg = [], []
        for b in range(images.shape[0]):
            with torch.no_grad():
                want = Net(self.cfg, self._start(cap))(images[b:b + 1])
                got = (Net(self.cfg, self._start(cap), quant=quant)(images[b:b + 1])
                       if quant else {k: v[b:b + 1] for k, v in cap.outputs.items()})
            cls.append(rel_err(got["box_logits"], want["box_logits"]))
            reg.append(rel_err(got["box_deltas"], want["box_deltas"]))
        return [worst(cls), worst(reg)]

    def leaf_gaps(self, cap: Capture, got: dict, ref: dict) -> Dict[str, Dict[str, float]]:
        """Per parameter, the gap of the first gradient's norm (``grad``)
        and of the change's norm (``update``, over the parameters the
        reference moves) of ``got`` against the reference's ``ref``."""
        start = self._start(cap)
        g_ref = _norms(ref["first_grad"])
        median = float(np.median(list(g_ref.values())))
        moved = [k for k in g_ref if g_ref[k] >= 1e-3 * median]
        change = lambda p: _norms({k: p[k].float() - start[k].float() for k in moved})  # noqa: E731
        return {"grad": leaf_gaps(_norms(got["first_grad"]), g_ref, g_ref),
                "update": leaf_gaps(change(got["params"]), change(ref["params"]), moved)}

    def gaps(self, cap: Capture, got: dict, ref: dict) -> Dict[str, float]:
        """``loss_gap``, ``grad_gap_med``, ``update_gap_med`` of ``got``
        (``losses``, ``first_grad``, ``params``) against the reference's
        ``ref``."""
        loss = worst(abs(g["total"] - r["total"]) / sum(abs(r[k]) for k in ref_train.LOSS_KEYS)
                     for g, r in zip(got["losses"], ref["losses"]))
        self.loss_pairs.append({"got": got["losses"], "ref": ref["losses"]})
        per_leaf = self.leaf_gaps(cap, got, ref)
        self.diagnosis.append({k: sorted(v.items(), key=lambda kv: -kv[1])[:5]
                               for k, v in per_leaf.items()})
        return {"loss_gap": loss,
                "grad_gap_med": float(np.median(list(per_leaf["grad"].values()))),
                "update_gap_med": float(np.median(list(per_leaf["update"].values())))}

    def check(self, control: str = None) -> List[dict]:
        """The compared numbers, each the worse of the two captured epochs.
        ``control`` (calibration only): ``fp8`` puts the reference in
        float8 in the program's place, ``bf16`` in bfloat16, ``half_batch``
        the reference on half of each batch; each compares the forward (not
        ``half_batch``) and the train steps alone."""
        strict_float32()
        limits = self.run.workload["limits"]
        if not hasattr(self, "_ref"):
            self._ref = [self.reference_steps(cap) for cap in self.captures]
        self.diagnosis, self.readings, self.loss_pairs = [], [], []
        for cap, ref in zip(self.captures, self._ref):
            row: Dict[str, float] = {}
            if control == "half_batch":
                got = self.reference_steps(cap, drop_half=True)
            elif control:
                got = self.reference_steps(cap, quant=control)
            else:
                got = {"losses": cap.losses, "first_grad": cap.first_grad, "params": cap.after}
                row["cut_mismatch"] = self._cut_mismatch(cap)
                row["aug_img_err"], row["target_mismatch"] = self._augmentation(cap)
            if control != "half_batch":
                row["fwd_cls_err"], row["fwd_reg_err"] = self.forward_errors(cap, quant=control)
            row.update(self.gaps(cap, got, ref))
            self.readings.append(row)
        values = {k: (sum(r[k] for r in self.readings) if k.endswith("_mismatch")
                      else worst(r[k] for r in self.readings)) for k in self.readings[0]}
        if not control:
            self.tmp.cleanup()
        return [{"name": k, "value": v, "limit": limits[k]} for k, v in values.items()]
