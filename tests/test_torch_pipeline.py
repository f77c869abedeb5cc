"""The port's drivers after training (``run_sweep``, ``run_consolidate``,
``run_predict_val``, ``materialize_val_predictions``, ``run_predict_test``,
``run_evaluate``) against the JAX package's on one seeded toy task: the JAX
package prepares ``data/example.py``'s task, trains a tiny fold and runs its
drivers; the port gets a copy of the prepared task and of the JAX
``fold0/model_last.ckpt`` and runs its own on the CPU.

Each driver is held twice: for its orchestration (the same files, and the
same parameters, arrays and scores from the same inputs, exactly) and for
its forward (predictions made by the port's model against the JAX model's,
at ``CASE_TOL``). Also the two staleness guards, and that every driver
raises without a card unless given ``device="cpu"``."""
import os
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nndetection_tpu.ops.native as jax_native
import nndetection_tpu_torch.core.boxes.wbc as twbc
from nndetection_tpu import pipeline as jpipeline
from nndetection_tpu.data.example import generate_example_dataset
from nndetection_tpu.planning.planner import Planner as JPlanner
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.inference.sweeper import BoxSweeper
from nndetection_tpu_torch.utils.io import load_json, load_pickle
from tests.test_torch_predictor import CASE_TOL
from tests.test_torch_prep import assert_same, assert_same_tree

torch.set_num_threads(1)

PLAN_ID = "D3V001_3d"
TINY_MODEL = dict(start_channels=8, fpn_channels=16, head_channels=16, topk_candidates=200,
                  detections_per_img=20, dtype="float32")
TINY_TRAINER = dict(max_epochs=1, num_train_batches_per_epoch=2, num_val_batches_per_epoch=1,
                    warm_iterations=1, swa_epochs=0, batch_size=2)
# the re-prediction against the materialization from the states, as the JAX
# package's own end-to-end test holds them (the forward rounds differently
# from the saved states' float32 only in the host consolidation's order)
VAL_SCORE_ATOL, VAL_BOX_ATOL = 1e-5, 1e-3


def _copy_fold(src: Path, dst: Path, states: bool) -> None:
    """The fold's checkpoint and plan (and its sweep states), mtimes kept."""
    (dst / "sweep").mkdir(parents=True)
    for name in ("model_last.ckpt", "plan.pkl"):
        shutil.copy2(src / name, dst / name)
    if states:
        for st in (src / "sweep").glob("*_boxes_state.pkl"):
            shutil.copy2(st, dst / "sweep" / st.name)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both sides' directories: the JAX package's whole sequence on its
    task; on the port's copy of the prepared task, the port's sweep of its
    own fold (the JAX checkpoint), then its consolidation, validation and
    test predictions over a fold that holds the JAX fold's sweep states
    (``consolidated``), so that both sides consolidate the same states."""
    root = tmp_path_factory.mktemp("pipeline")
    task = generate_example_dataset(root / "jax" / "Task000D3_Example", num_train=4, num_test=2,
                                    image_size=(32, 32, 32), object_size=(8, 14), object_width=2)
    jmodels = root / "jax" / "models"
    port_task = root / "port" / task.name
    with pytest.MonkeyPatch.context() as mp:
        # both host WBCs through the NumPy loop (the port's is a copy of the
        # JAX package's), so that the same states give the same bits
        mp.setattr(jax_native, "wbc_native", lambda *a, **k: None)
        mp.setattr(twbc, "wbc_native", lambda *a, **k: None)
        jpipeline.run_prep(task, planner=JPlanner(anchor_budget=200))
        shutil.copytree(task, port_task)
        jpipeline.run_train(task, jmodels, fold=0, trainer_overrides=TINY_TRAINER,
                            model_overrides=TINY_MODEL)
        jpipeline.run_sweep(task, jmodels, fold=0)
        jpipeline.run_consolidate(task, jmodels, num_folds=1)
        jpipeline.run_predict_test(task, jmodels, num_folds=1)
        jval = jpipeline.run_predict_val(task, jmodels, fold=0)
        jval_predicted = jval.parent / "val_predicted"
        jval.rename(jval_predicted)
        jpipeline.materialize_val_predictions(task, jmodels, fold=0)

        swept = root / "port" / "swept"
        _copy_fold(jmodels / "fold0", swept / "fold0", states=False)
        tpipeline.run_sweep(port_task, swept, fold=0, device="cpu")
        consolidated = root / "port" / "consolidated"
        _copy_fold(jmodels / "fold0", consolidated / "fold0", states=True)
        tpipeline.run_consolidate(port_task, consolidated, num_folds=1, device="cpu")
        tpipeline.run_predict_test(port_task, consolidated, num_folds=1, device="cpu")
        val = tpipeline.run_predict_val(port_task, consolidated, fold=0, device="cpu")
        val.rename(val.parent / "val_predicted")
        tpipeline.materialize_val_predictions(port_task, consolidated, fold=0, device="cpu")
    return SimpleNamespace(task=task, jmodels=jmodels, port_task=port_task, swept=swept,
                           consolidated=consolidated)


def _rows(r):
    keys = (("pred_boxes", "pred_scores", "pred_labels") if "pred_boxes" in r
            else ("boxes", "scores", "labels"))
    boxes, scores, labels = (np.asarray(r[k], np.float64) for k in keys)
    # a label differs by more than any tolerance
    return np.concatenate([boxes.reshape(len(scores), -1), scores[:, None],
                           labels[:, None] * 1e3], 1)


def assert_same_detections(got, want, tol=CASE_TOL, where=""):
    """The same number of detections, each paired one to one with the
    nearest on the other side (boxes, score and label) within ``tol``:
    scores that tie at float32 may come in either order."""
    rows = [_rows(got), _rows(want)]
    assert len(rows[0]) == len(rows[1]), (where, len(rows[0]), len(rows[1]))
    assert len(rows[1]) > 0, f"{where}: no detections to compare"
    dist = np.abs(rows[0][:, None] - rows[1][None]).max(-1)
    nearest = dist.argmin(1)
    assert sorted(nearest.tolist()) == list(range(len(nearest))), where
    assert dist[np.arange(len(nearest)), nearest].max() <= tol, (where, dist.min(1).max())


def files_of(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


# ------------------------------------------------------------------ sweep
def test_run_sweep_states_match_jax(run):
    want_dir = run.jmodels / "fold0" / "sweep"
    got_dir = run.swept / "fold0" / "sweep"
    assert files_of(got_dir) == files_of(want_dir) == ["case_0_boxes.pkl",
                                                       "case_0_boxes_state.pkl"]
    for state in sorted(want_dir.glob("*_boxes_state.pkl")):
        got, want = load_pickle(got_dir / state.name), load_pickle(state)
        for k in ("case_shape", "parameters", "properties", "model_weights"):
            assert_same(got[k], want[k], k)
        assert list(got["model_results"]) == list(want["model_results"])
        assert len(want["model_results"]) == 8  # one stream per flip
        for stream, res in want["model_results"].items():
            g = {k: v[0] for k, v in got["model_results"][stream].items()}
            w = {k: v[0] for k, v in res.items()}
            np.testing.assert_allclose(np.sort(g["weights"]), np.sort(w["weights"]), rtol=0,
                                       atol=CASE_TOL)
            assert_same_detections(g, w, where=f"{state.name} {stream}")
    for pred in sorted(want_dir.glob("*_boxes.pkl")):
        got, want = load_pickle(got_dir / pred.name), load_pickle(pred)
        assert got["restored"] is want["restored"] is False
        assert_same_detections(got, want, where=pred.name)
    # both sweeps over states this close pick the same parameters
    assert_same(load_pickle(run.swept / "fold0" / "plan_inference.pkl")["parameters"],
                load_pickle(run.jmodels / "fold0" / "plan_inference.pkl")["parameters"])


def test_sweeper_over_the_jax_states_picks_the_jax_parameters(run, tmp_path):
    classes = ["0", "1"]
    got = BoxSweeper(classes, run.jmodels / "fold0" / "sweep",
                     run.task / "preprocessed" / PLAN_ID / "labelsTr", save_dir=tmp_path,
                     device="cpu").run_postprocessing_sweep()
    want = load_pickle(run.jmodels / "fold0" / "plan_inference.pkl")
    assert_same(load_pickle(tmp_path / "plan_inference.pkl"), want)
    assert_same(got, want)
    assert load_json(tmp_path / "sweep_results.json") == load_json(
        run.jmodels / "fold0" / "sweep_results.json")


# ------------------------------------------------------------ consolidate
def test_run_consolidate_matches_jax(run):
    got, want = run.consolidated / "consolidated", run.jmodels / "consolidated"
    assert files_of(got) == files_of(want) == [
        "model_fold0.ckpt", "plan.pkl", "plan_inference.pkl", "sweep_results.json",
        "sweep_states/case_0_boxes_state.pkl"]
    assert_same(load_pickle(got / "plan_inference.pkl"), load_pickle(want / "plan_inference.pkl"))
    assert load_json(got / "sweep_results.json") == load_json(want / "sweep_results.json")
    for name in ("model_fold0.ckpt", "plan.pkl", "sweep_states/case_0_boxes_state.pkl"):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


# ------------------------------------------------------------ predict test
def test_run_predict_test_prepares_the_test_split_as_jax(run):
    for d in ("raw_cropped_test", f"preprocessed/{PLAN_ID}/imagesTs",
              f"preprocessed/{PLAN_ID}/labelsTs"):
        files = assert_same_tree(run.port_task / d, run.task / d)
        assert files, d
    assert (run.port_task / "preprocessed" / PLAN_ID / "labelsTs" /
            "case_4_boxes_gt_orig.npz").exists()


def test_run_predict_test_matches_jax(run):
    got_dir, want_dir = run.consolidated / "test_predictions", run.jmodels / "test_predictions"
    assert files_of(got_dir) == files_of(want_dir) == ["case_4_boxes.pkl", "case_5_boxes.pkl"]
    for pred in sorted(want_dir.glob("*_boxes.pkl")):
        got, want = load_pickle(got_dir / pred.name), load_pickle(pred)
        assert got["restored"] is want["restored"] is True
        assert_same_detections(got, want, where=pred.name)


# ------------------------------------------------------------ predict val
def test_materialize_val_predictions_matches_jax(run):
    """The same states under the same parameters through the same host
    float64 consolidation: the same arrays."""
    got_dir = run.consolidated / "fold0" / "val_predictions"
    want_dir = run.jmodels / "fold0" / "val_predictions"
    assert files_of(got_dir) == files_of(want_dir) == ["case_0_boxes.pkl"]
    got, want = load_pickle(got_dir / "case_0_boxes.pkl"), load_pickle(want_dir /
                                                                      "case_0_boxes.pkl")
    assert len(want["pred_scores"]) > 0
    for k in ("pred_boxes", "pred_scores", "pred_labels", "restored"):
        assert_same(got[k], want[k], k)


def test_run_predict_val_matches_jax(run):
    got_dir = run.consolidated / "fold0" / "val_predicted"
    want_dir = run.jmodels / "fold0" / "val_predicted"
    assert files_of(got_dir) == files_of(want_dir) == ["case_0_boxes.pkl"]
    got, want = load_pickle(got_dir / "case_0_boxes.pkl"), load_pickle(want_dir /
                                                                      "case_0_boxes.pkl")
    assert got["restored"] is want["restored"] is True
    assert_same_detections(got, want, where="val")


def test_run_predict_val_agrees_with_materialize(run):
    """The port's re-prediction against the materialization from the
    states, at the JAX package's end-to-end tolerance."""
    ref = load_pickle(run.consolidated / "fold0" / "val_predicted" / "case_0_boxes.pkl")
    mat = load_pickle(run.consolidated / "fold0" / "val_predictions" / "case_0_boxes.pkl")
    assert ref["restored"] and mat["restored"]
    assert len(ref["pred_scores"]) == len(mat["pred_scores"]) > 0
    n = min(10, len(ref["pred_scores"]))
    np.testing.assert_allclose(ref["pred_scores"][:n], mat["pred_scores"][:n], rtol=0,
                               atol=VAL_SCORE_ATOL)
    np.testing.assert_allclose(ref["pred_boxes"][:n], mat["pred_boxes"][:n], rtol=0,
                               atol=VAL_BOX_ATOL)
    np.testing.assert_array_equal(ref["pred_labels"][:n], mat["pred_labels"][:n])


# --------------------------------------------------------------- evaluate
@pytest.mark.parametrize("pred,split", [("test_predictions", "Ts"), ("fold0/sweep", "Tr"),
                                        ("fold0/val_predictions", "Tr")])
def test_run_evaluate_matches_jax(run, tmp_path, pred, split):
    """On the JAX prediction directory (restored, then not): the same
    scores to the bit, and the same files."""
    pred_dir = run.jmodels / pred
    restored = load_pickle(sorted(pred_dir.glob("case_*_boxes.pkl"))[0])["restored"]
    assert restored == (split == "Ts" or pred.endswith("val_predictions"))
    got, _ = tpipeline.run_evaluate(run.task, pred_dir, split=split, save_dir=tmp_path / "port",
                                    device="cpu")
    want, _ = jpipeline.run_evaluate(run.task, pred_dir, split=split, save_dir=tmp_path / "jax")
    assert len(got) > 10 and "mAP_IoU_0.10_0.50_0.05_MaxDet_100" in got
    assert_same(got, want)
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")


# ------------------------------------------------------------------ guards
def _age(path: Path, than: Path, seconds: float = 100.0) -> None:
    t = than.stat().st_mtime - seconds
    os.utime(path, (t, t))


def test_run_sweep_drops_states_older_than_the_checkpoint(run, tmp_path):
    models = tmp_path / "models"
    shutil.copytree(run.swept, models)  # copy2: mtimes kept
    fold = models / "fold0"
    state = fold / "sweep" / "case_0_boxes_state.pkl"
    fresh = state.stat().st_mtime_ns
    tpipeline.run_sweep(run.port_task, models, fold=0, device="cpu")
    assert state.stat().st_mtime_ns == fresh  # resumed: not predicted again
    for f in fold.joinpath("sweep").glob("*"):
        _age(f, fold / "model_last.ckpt")
    tpipeline.run_sweep(run.port_task, models, fold=0, device="cpu")
    assert state.stat().st_mtime >= (fold / "model_last.ckpt").stat().st_mtime
    assert_same(load_pickle(fold / "plan_inference.pkl"),
                load_pickle(run.swept / "fold0" / "plan_inference.pkl"))


def test_run_predict_val_drops_predictions_older_than_the_parameters(run, tmp_path):
    models = tmp_path / "models"
    shutil.copytree(run.consolidated, models)
    shutil.rmtree(models / "fold0" / "val_predictions")
    (models / "fold0" / "val_predicted").rename(models / "fold0" / "val_predictions")
    pred = models / "fold0" / "val_predictions" / "case_0_boxes.pkl"
    fresh = pred.stat().st_mtime_ns
    tpipeline.run_predict_val(run.port_task, models, fold=0, resume=True, device="cpu")
    assert pred.stat().st_mtime_ns == fresh
    params = models / "consolidated" / "plan_inference.pkl"
    _age(pred, params)
    tpipeline.run_predict_val(run.port_task, models, fold=0, resume=True, device="cpu")
    assert pred.stat().st_mtime >= params.stat().st_mtime
    assert_same_detections(load_pickle(pred), load_pickle(
        run.consolidated / "fold0" / "val_predicted" / "case_0_boxes.pkl"))


@pytest.mark.parametrize("name", ["run_sweep", "run_consolidate", "run_predict_val",
                                  "materialize_val_predictions", "run_predict_test",
                                  "run_evaluate"])
def test_drivers_default_to_the_card(run, monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = tmp_path / "models"
    args = {"run_sweep": (models, 0), "run_consolidate": (models,),
            "run_predict_val": (models, 0), "materialize_val_predictions": (models, 0),
            "run_predict_test": (models,), "run_evaluate": (run.jmodels / "test_predictions",)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tpipeline, name)(run.port_task, *args[name])
    assert not models.exists()
