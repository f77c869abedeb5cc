"""The post-processing sweep of the PyTorch port (``inference/sweeper.py``,
``BoxSweeper(device="cpu")``) against the JAX package's ``BoxSweeper`` on the
same saved ensembler states: the same best parameters and score, on the host
path and with the device formulation of the WBC on both sides."""
import json
import pickle

import numpy as np
import pytest
import torch

import nndetection_tpu.inference.ensembler as jax_ens
import nndetection_tpu.ops.native as jax_native
import nndetection_tpu_torch.inference.ensembler as ens
from nndetection_tpu.inference.sweeper import BoxSweeper as JaxSweeper
from nndetection_tpu_torch.inference.sweeper import BoxSweeper

torch.set_num_threads(1)


def make_states(path, cases=3, seed=0):
    """As ``tests/test_sweeper.py``: per case a confident true positive and
    low-score clutter, here in two streams, with jittered near-duplicates of
    the true box and random clutter of any score; written by the JAX
    package's ensembler, GT beside it."""
    rng = np.random.RandomState(seed)
    for i in range(cases):
        gt = np.asarray([[10 + i, 10, 20 + i, 20, 10, 20], [40, 30, 47, 38, 30, 39]], np.float64)
        e = jax_ens.BoxEnsemblerSelective((64, 64, 64))
        for stream in ("m0_t()", "m0_t(0,)"):
            e.add_model(stream)
            near = gt[rng.randint(0, 2, 6)] + rng.uniform(-2, 2, (6, 6))
            lo = rng.uniform(2, 50, (12, 3))
            size = rng.uniform(2, 9, (12, 3))
            clutter = np.concatenate([lo[:, :2], lo[:, :2] + size[:, :2], lo[:, 2:], lo[:, 2:] + size[:, 2:]], 1)
            boxes = np.concatenate([gt[:1], near, clutter]).astype(np.float32)
            boxes[:, 2:4] = np.maximum(boxes[:, 2:4], boxes[:, 0:2] + 1)
            boxes[:, 5] = np.maximum(boxes[:, 5], boxes[:, 4] + 1)
            scores = np.concatenate([[0.9], rng.uniform(0.3, 0.8, 6), rng.uniform(0.05, 0.5, 12)])
            e.process_tile(boxes, scores.astype(np.float32), np.zeros(len(boxes), np.int64),
                           (0, 0, 0), (64, 64, 64))
        e.save_state(path, f"case_{i}")
        np.savez(path / f"case_{i}_boxes_gt.npz", boxes=gt.astype(np.float32),
                 classes=np.zeros(len(gt), np.int64))


@pytest.mark.parametrize("device_wbc", [False, True])
def test_sweep_matches_jax(monkeypatch, tmp_path, device_wbc):
    # the JAX host WBC through its NumPy twin, which the port copies
    monkeypatch.setattr(jax_native, "wbc_native", lambda *a, **k: None)
    monkeypatch.setattr(ens, "DEVICE_WBC", device_wbc)
    monkeypatch.setattr(jax_ens, "DEVICE_WBC", device_wbc)
    states = tmp_path / "states"
    states.mkdir()
    make_states(states)
    out_port, out_jax = tmp_path / "port", tmp_path / "jax"
    got = BoxSweeper(["lesion"], states, states, save_dir=out_port, device="cpu")
    want = JaxSweeper(["lesion"], states, states, save_dir=out_jax)
    trials = []
    evaluate = got._evaluate_params
    monkeypatch.setattr(got, "_evaluate_params", lambda p: trials.append(p) or evaluate(p))
    plan, want_plan = got.run_postprocessing_sweep(), want.run_postprocessing_sweep()
    assert len(trials) > 20
    assert plan["parameters"] == want_plan["parameters"]
    assert abs(plan["score"] - want_plan["score"]) <= 1e-9
    # the sweep moved away from the defaults and gained
    defaults = ens.BoxEnsemblerSelective.get_default_parameters()
    assert plan["parameters"] != defaults and plan["score"] > evaluate(defaults)
    with open(out_port / "plan_inference.pkl", "rb") as f:
        assert pickle.load(f)["parameters"] == plan["parameters"]
    assert (json.loads((out_port / "sweep_results.json").read_text())
            == json.loads((out_jax / "sweep_results.json").read_text()))


def test_device_is_the_card_by_default(tmp_path):
    make_states(tmp_path, cases=1)
    if torch.cuda.is_available():
        assert BoxSweeper(["c"], tmp_path, tmp_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BoxSweeper(["c"], tmp_path, tmp_path)
    sweeper = BoxSweeper(["c"], tmp_path, tmp_path, device="cpu")
    assert sweeper._case("case_0").device == torch.device("cpu")


def test_no_states_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        BoxSweeper(["c"], tmp_path, tmp_path, device="cpu")
