"""Whole-case prediction: ``Predictor.predict_case`` of the program over a
closed loop of cases, one at a time, as a deployment sends them.

Set-up makes the weights of each model (fold) on the card from the seed,
the program's ``Predictor`` over them, the mix's cases, and predicts each
case once. The window sends rounds of the mix's cases, each round every
case once in a seeded order, until ``seconds`` have passed and a round is
complete, so that every run does the same work per round; every case is
timed from the call to its return.

The check (after the window, the program's state freed), against
:mod:`benchmark.reference`:

* ``fwd_cls_err``, ``fwd_reg_err``: the program's classifier logits and box
  deltas of a seeded sample of the window's tiles (taken by a forward hook
  as the window ran them) against the float32 reference forward of the
  same tiles, cut by the reference from the case: the norm of the
  difference over the norm of the reference's deviation from its mean,
  the worst tile.
* ``post_mismatch``: those tiles' detections as the program post-processed
  them, against the reference's decode, top-k and greedy NMS of the
  program's own logits: detections of either side without their match.
* ``case_mismatch``: a seeded sample of the window's cases (one of the
  largest among them), every tile's detections of the program's through
  the reference's consolidation, against the program's case result:
  detections without their match, and every tile the program did not
  predict.
"""
from __future__ import annotations

import time
import traceback
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import harness
from benchmark.harness import rel_err, worst
from benchmark.reference import detect, ensemble, tiles
from benchmark.reference.model import Net, param_specs, strict_float32
from benchmark.traffic import generate

# a detection matches another of its label within these (post-processing
# and consolidation read the same program outputs on both sides: float32
# on the card against float32 or float64 in the reference)
SCORE_RTOL = 1e-5
BOX_ATOL = 1e-2


def invert_box_flips(boxes: np.ndarray, flips, patch) -> np.ndarray:
    """Boxes of a tile flipped along ``flips`` back to the tile's frame."""
    out = boxes.copy()
    cols = {0: (0, 2), 1: (1, 3), 2: (4, 5)}
    for axis in flips:
        lo, hi = cols[axis]
        out[..., lo], out[..., hi] = patch[axis] - boxes[..., hi], patch[axis] - boxes[..., lo]
    return out


def unmatched(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> int:
    """Detections of ``a`` or ``b`` (``boxes``, ``scores``, ``labels``) with no
    partner of the same label, score and box on the other side."""
    free = np.ones(len(b["scores"]), bool)
    missing = 0
    for i in np.argsort(-a["scores"], kind="stable"):
        ok = (free & (b["labels"] == a["labels"][i])
              & (np.abs(b["scores"] - a["scores"][i]) <= SCORE_RTOL * np.abs(a["scores"][i]) + 1e-12)
              & (np.abs(b["boxes"] - a["boxes"][i]).max(axis=-1, initial=0) <= BOX_ATOL))
        hit = np.flatnonzero(ok)
        if len(hit):
            free[hit[0]] = False
        else:
            missing += 1
    return missing + int(free.sum())


class Entry:
    def __init__(self, run: harness.Run):
        from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
        from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig

        self.run = run
        cell, cfg, dev = run.workload, run.ref_cfg, run.device
        self.cfg, self.patch = cfg, tuple(cfg["patch_size"])
        self.mix = cell.get("mix") or generate.load(cell["traffic"])
        model_cfg = RetinaUNetConfig.from_dict(run.config["model"])
        specs = param_specs(cfg)
        self.weights = [harness.make_weights(specs, harness.sub_seed(run.seed, 1, m), dev)
                        for m in range(cell["models"])]
        bundles = [ModelBundle(cfg=model_cfg, params=w, name=f"fold{m}")
                   for m, w in enumerate(self.weights)]
        self.predictor = Predictor(bundles, tta=cell["tta"], ensembler=cell["ensembler"],
                                   device=dev)
        self.flips = list(self.predictor.tta_flips)
        self.tile_topk, self.tile_max = self.predictor.tile_topk, self.predictor.tile_detections
        assert self.flips[0] == ()
        self.cases = generate.case_volumes(self.mix, harness.sub_seed(run.seed, 2), dev)
        self.order = generate.order(self.mix, harness.sub_seed(run.seed, 3), 10_000)
        for case in self.cases:  # every shape once: cuDNN's plans, the kernels' builds
            self.predictor.predict_case(case)
        self.n_tiles = [len(tiles.grid(tiles.pad_to_min_shape(c, self.patch)[0].shape[1:],
                                       self.patch)) for c in self.cases]
        # the forward sample: (case index in the window, tile, variant, model)
        rng = np.random.default_rng(harness.sub_seed(run.seed, 4))
        early = cell["check"]["forward_cases"]
        self.sample = set()
        while len(self.sample) < cell["check"]["forward_tiles"]:
            i = int(rng.integers(early))
            self.sample.add((i, int(rng.integers(self.n_tiles[self.order[i]])),
                             int(rng.integers(len(self.flips))), int(rng.integers(len(self.weights)))))
        self.captured: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.infer_out: Dict[int, List[tuple]] = {}
        self.results: List[dict] = []
        self.case_idx, self.rows = -1, [0] * len(self.weights)
        run.counts["tiles_forwarded"] = 0
        for m, net in enumerate(self.predictor.nets):
            net.register_forward_hook(self._hook(m))
        infer = self.predictor._infer

        def recorded(net, batch):
            out, seg = infer(net, batch)
            self.infer_out.setdefault(self.case_idx, []).append(
                (self.predictor.nets.index(net), out))
            return out, seg

        self.predictor._infer = recorded
        ens = self.predictor.ensembler_cls
        spans = run.spans
        spans.wrap(self.predictor, "_infer", "forward, post-processing, copy to host")
        spans.wrap(ens, "process_tile", "process_tile")
        spans.wrap(ens, "get_case_result", "get_case_result", after=lambda t0, _: spans.add(
            "consolidate_ms", (time.time_ns() - t0) / 1e6))
        spans.wrap(self.predictor, "predict_case", "predict_case")

    def _hook(self, m: int):
        n_var = len(self.flips)

        def hook(module, args, out):
            rows = out["box_logits"].shape[0]
            if self.case_idx < 0:
                return
            self.run.counts["tiles_forwarded"] += rows
            b = rows // n_var
            for j in range(b):
                for v in range(n_var):
                    key = (self.case_idx, self.rows[m] + j, v, m)
                    if key in self.sample:
                        row = v * b + j
                        self.captured[key] = (out["box_logits"][row].clone(),
                                              out["box_deltas"][row].clone())
            self.rows[m] += b

        return hook

    def window(self, seconds: float) -> dict:
        latencies, failed = [], 0
        t0 = time.perf_counter()
        i = 0
        while True:
            self.case_idx, self.rows = i, [0] * len(self.weights)
            c0 = time.perf_counter()
            try:
                res = self.predictor.predict_case(self.cases[self.order[i]])
                res = {k: res[k] for k in ("pred_boxes", "pred_scores", "pred_labels")}
            except Exception:  # a case that fails is counted and the loop goes on
                traceback.print_exc()
                res, failed = None, failed + 1
            c1 = time.perf_counter()
            self.results.append(res)
            latencies.append(c1 - c0)
            i += 1
            if c1 - t0 >= seconds and i % len(self.cases) == 0:
                break
        self.case_idx = -1
        total = c1 - t0
        return {"volumes_per_min": 60.0 * i / total,
                "case_latency_p90_s": float(np.percentile(latencies, 90)),
                "attempted": i, "failed": failed}

    def release(self) -> None:
        del self.predictor

    # ---------------------------------------------------------------- check
    def _tile(self, case_i: int, tile_j: int) -> Tuple[np.ndarray, np.ndarray]:
        padded, lower = tiles.pad_to_min_shape(self.cases[self.order[case_i]], self.patch)
        origin = tiles.grid(padded.shape[1:], self.patch)[tile_j]
        region = (slice(None),) + tuple(slice(int(o), int(o) + p) for o, p in zip(origin, self.patch))
        return padded[region], origin

    def check(self, control: str = None) -> List[dict]:
        """The compared numbers. ``control`` (calibration only) puts the
        reference in that precision in the program's place and compares its
        forward alone: the later stages would read its own output."""
        strict_float32()
        cfg, dev, limits = self.cfg, self.run.device, self.run.workload["limits"]
        grid_np, _ = detect.anchors(cfg)
        anchor_grid = torch.from_numpy(grid_np).to(dev)
        cls_errs, reg_errs, post = [], [], 0
        for (case_i, tile_j, v, m), (logits, deltas) in sorted(self.captured.items()):
            tile, _ = self._tile(case_i, tile_j)
            x = torch.from_numpy(np.ascontiguousarray(tile)).to(dev).movedim(0, -1)[None]
            flips = self.flips[v]
            if flips:
                x = torch.flip(x, dims=[a + 1 for a in flips])
            with torch.no_grad():
                ref = Net(cfg, self.weights[m])(x)
                if control:
                    got = Net(cfg, self.weights[m], quant=control)(x)
                    logits, deltas = got["box_logits"][0], got["box_deltas"][0]
            cls_errs.append(rel_err(logits, ref["box_logits"][0]))
            reg_errs.append(rel_err(deltas, ref["box_deltas"][0]))
            if control:
                continue
            # post-processing of the program's own outputs
            mine = detect.postprocess(cfg, logits[None], deltas[None], anchor_grid,
                                      topk=self.tile_topk, max_out=self.tile_max)
            mine = {k: t[0].cpu().numpy() for k, t in mine.items()}
            keep = mine["valid"]
            want = {"boxes": invert_box_flips(mine["boxes"][keep], flips, self.patch),
                    "scores": mine["scores"][keep], "labels": mine["labels"][keep]}
            got = self._program_tile(case_i, tile_j, v, m)
            post += unmatched(got, want)
        out = [{"name": "fwd_cls_err", "value": worst(cls_errs), "limit": limits["fwd_cls_err"]},
               {"name": "fwd_reg_err", "value": worst(reg_errs), "limit": limits["fwd_reg_err"]},
               {"name": "post_mismatch", "value": post, "limit": limits["post_mismatch"]}]
        if control:
            return out[:2]
        out.append({"name": "case_mismatch", "value": self._consolidation(),
                    "limit": limits["case_mismatch"]})
        return out

    def _calls(self, case_i: int, m: int):
        """The program's ``_infer`` outputs of model ``m`` for a case."""
        return [out for mm, out in self.infer_out.get(case_i, []) if mm == m]

    def _program_tile(self, case_i, tile_j, v, m) -> Dict[str, np.ndarray]:
        seen = 0
        for out in self._calls(case_i, m):
            b = out["scores"].shape[1]
            if tile_j < seen + b:
                j = tile_j - seen
                keep = out["valid"][v, j]
                return {"boxes": out["boxes"][v, j][keep], "scores": out["scores"][v, j][keep],
                        "labels": out["labels"][v, j][keep].astype(np.int64)}
            seen += b
        return {"boxes": np.zeros((0, 2 * self.cfg["dim"])), "scores": np.zeros(0),
                "labels": np.zeros(0, np.int64)}

    def _consolidation(self) -> int:
        """Unmatched detections over the sampled cases (every tile missing
        from the program's outputs counts as one)."""
        done = [i for i, r in enumerate(self.results) if r is not None]
        rng = np.random.default_rng(harness.sub_seed(self.run.seed, 5))
        biggest = max(self.n_tiles)
        large = [i for i in done if self.n_tiles[self.order[i]] == biggest]
        picks = set(rng.choice(large, 1).tolist()) if large else set()
        want_n = min(len(done), self.run.workload["check"]["cases"])
        while len(picks) < want_n:
            picks.add(int(rng.choice(done)))
        bad = 0
        for i in sorted(picks):
            case = self.cases[self.order[i]]
            padded, lower = tiles.pad_to_min_shape(case, self.patch)
            origins = tiles.grid(padded.shape[1:], self.patch)
            ens = ensemble.Selective(padded.shape[1:])
            for m in range(len(self.weights)):
                t = 0
                for out in self._calls(i, m):
                    for j in range(out["scores"].shape[1]):
                        if t >= len(origins):
                            bad += 1
                            continue
                        for v, flips in enumerate(self.flips):
                            keep = out["valid"][v, j]
                            ens.add_tile((m, v), out["boxes"][v, j][keep], out["scores"][v, j][keep],
                                         out["labels"][v, j][keep], origins[t], self.patch)
                        t += 1
                bad += max(0, len(origins) - t)
            want = ens.result()
            if lower.any() and len(want["pred_boxes"]):
                want["pred_boxes"] = want["pred_boxes"] - ensemble.axis_vector(
                    lower.astype(np.float64), self.cfg["dim"])[None]
            got = self.results[i]
            bad += unmatched({"boxes": got["pred_boxes"], "scores": got["pred_scores"],
                              "labels": got["pred_labels"]},
                             {"boxes": want["pred_boxes"], "scores": want["pred_scores"],
                              "labels": want["pred_labels"]})
        return bad
