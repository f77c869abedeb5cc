"""Empirical post-processing sweep (counterpart of
:mod:`nndetection_tpu.inference.sweeper`): greedy coordinate ascent over the
ensembler's sweep space on saved ensembler states, maximizing the target
metric on the validation cases. Every trial consolidates every case; the
whole-case WBC of each runs on the sweeper's device.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from nndetection_tpu_torch import resolve_device
from nndetection_tpu_torch.evaluator.det import BoxEvaluator
from nndetection_tpu_torch.inference.ensembler import BoxEnsemblerSelective
from nndetection_tpu_torch.utils.io import save_json, save_pickle


class BoxSweeper:
    def __init__(
        self,
        classes: Sequence[str],
        state_dir,
        gt_dir,
        target_metric: str = "mAP_IoU_0.10_0.50_0.05_MaxDet_100",
        save_dir=None,
        device: Union[torch.device, str] = "cuda",
    ):
        """``state_dir`` holds ``<case>_boxes_state.pkl`` (written by
        ``save_state`` of either package), ``gt_dir`` ``<case>_boxes_gt.npz``
        with ``boxes`` and ``classes``. ``device`` is the card unless the
        caller passes another (``"cpu"``); without CUDA the default raises."""
        self.classes = list(classes)
        self.state_dir = Path(state_dir)
        self.gt_dir = Path(gt_dir)
        self.target_metric = target_metric
        self.save_dir = Path(save_dir) if save_dir else None
        self.device = resolve_device(device)
        self.case_ids = sorted(
            p.name[: -len("_boxes_state.pkl")] for p in self.state_dir.glob("*_boxes_state.pkl")
        )
        if not self.case_ids:
            raise FileNotFoundError(f"no ensembler states in {self.state_dir}")
        # every case's ensembler and GT stay in memory for the whole sweep:
        # states are top-k reduced (a few MB in all), and the ensembler's
        # memoization lets ensemble-level trials reuse the per-model NMS
        self._ens: Dict[str, BoxEnsemblerSelective] = {}
        self._gt: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def _case(self, cid: str) -> BoxEnsemblerSelective:
        ens = self._ens.get(cid)
        if ens is None:
            ens = BoxEnsemblerSelective.from_checkpoint(
                self.state_dir / f"{cid}_boxes_state.pkl", device=self.device)
            self._ens[cid] = ens
            with np.load(self.gt_dir / f"{cid}_boxes_gt.npz") as f:
                self._gt[cid] = (f["boxes"], f["classes"])
        return ens

    def _evaluate_params(self, params: Dict[str, Any]) -> float:
        evaluator = BoxEvaluator.create(self.classes, fast=True)
        for cid in self.case_ids:
            ens = self._case(cid)
            ens.update_parameters(**params)
            res = ens.get_case_result()
            gt_boxes, gt_classes = self._gt[cid]
            evaluator.add_batch(
                pred_boxes=[res["pred_boxes"]],
                pred_scores=[res["pred_scores"]],
                pred_labels=[res["pred_labels"]],
                gt_boxes=[gt_boxes],
                gt_classes=[gt_classes],
            )
        scores, _ = evaluator.finish_online_evaluation()
        return scores[self.target_metric]

    def run_postprocessing_sweep(self) -> Dict[str, Any]:
        """Greedy coordinate ascent over the ensembler's sweep space; writes
        ``plan_inference.pkl`` and ``sweep_results.json`` to ``save_dir``."""
        best_params, sweep_space = BoxEnsemblerSelective.sweep_parameters()
        best_params = dict(best_params)
        best_score = self._evaluate_params(best_params)
        for pname, values in sweep_space.items():
            for v in values:
                if best_params.get(pname) == v:
                    continue
                trial = dict(best_params, **{pname: v})
                score = self._evaluate_params(trial)
                if score > best_score:
                    best_score = score
                    best_params = trial
        plan = {"parameters": best_params, "score": best_score}
        if self.save_dir is not None:
            save_pickle(plan, self.save_dir / "plan_inference.pkl")
            save_json(
                {"best_score": best_score, "parameters": {
                    k: (v if not isinstance(v, np.ndarray) else v.tolist())
                    for k, v in best_params.items()}},
                self.save_dir / "sweep_results.json",
            )
        return plan
