"""The port's ``run_prep`` against the JAX package's on ``data/example.py``'s
toy task (two copies of the same seeded task): the same ``Plan`` field by
field, the same dataset properties, the same arrays and pickles under the
same names, and the same ``splits_final.pkl``; with a pinned patch smaller
than the objects, the ``3dlr1`` plan and its cases as well. Then
``run_train(device="cpu")`` takes a step on the port's own plan, and
``run_prep`` with its default device raises without a card."""
import json

import pytest
import torch

from nndetection_tpu import pipeline as jpipeline
from nndetection_tpu.data.example import generate_example_dataset
from nndetection_tpu.planning.estimator import DEFAULT_BUDGET
from nndetection_tpu.planning.planner import Planner as JPlanner
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.planning.planner import Planner, load_plan
from nndetection_tpu_torch.utils.io import load_pickle
from tests.test_torch_planning import same_plan
from tests.test_torch_prep import assert_same, assert_same_tree

torch.set_num_threads(1)

TINY_MODEL = dict(start_channels=8, fpn_channels=16, head_channels=16, topk_candidates=200,
                  detections_per_img=20, dtype="float32")
CASES = {  # name -> (example kwargs, planner kwargs)
    "default": (dict(object_size=(8, 14)), {}),
    "lowres": (dict(object_size=(18, 24)), dict(force_patch_size=[16, 16, 16])),
}


def toy_task(root, object_size):
    return generate_example_dataset(root / "Task000D3_Example", num_train=5, num_test=0,
                                    image_size=(32, 32, 32), object_size=object_size,
                                    object_width=2, spacing=(1.5, 1.0, 1.0))


@pytest.fixture(scope="module", params=sorted(CASES))
def prepped(request, tmp_path_factory):
    """The same task prepared by each package: ``(case, port task, JAX task,
    port plan, JAX plan)``."""
    example_kw, planner_kw = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    got_task, want_task = toy_task(root / "t", **example_kw), toy_task(root / "j", **example_kw)
    got = tpipeline.run_prep(got_task, planner=Planner(
        hbm_budget=DEFAULT_BUDGET, anchor_budget=50, device="cpu", **planner_kw), device="cpu")
    want = jpipeline.run_prep(want_task, planner=JPlanner(anchor_budget=50, **planner_kw))
    return request.param, got_task, want_task, got, want


def test_run_prep_matches_jax(prepped):
    case, got_task, want_task, got, want = prepped
    same_plan(got, want)
    assert got.requires_lowres == (case == "lowres")
    prep = "preprocessed"
    same_plan(load_plan(got_task / prep / f"{got.plan_id}.pkl"), want)
    files = assert_same_tree(got_task / prep, want_task / prep)
    assert_same_tree(got_task / "raw_cropped", want_task / "raw_cropped")
    names = {str(f) for f in files}
    assert {"splits_final.pkl", "properties/dataset_properties.pkl", f"{got.plan_id}.pkl",
            f"{got.plan_id}/imagesTr/case_0.npy", f"{got.plan_id}/imagesTr/case_0_boxes.pkl",
            f"{got.plan_id}/labelsTr/case_0_boxes_gt.npz"} <= names
    if got.requires_lowres:
        assert "D3V001_3dlr1.pkl" in names and "D3V001_3dlr1/imagesTr/case_4.npy" in names
        same_plan(load_plan(got_task / prep / "D3V001_3dlr1.pkl"),
                  load_pickle(want_task / prep / "D3V001_3dlr1.pkl"))
    assert_same(load_pickle(got_task / prep / "splits_final.pkl"),
                load_pickle(want_task / prep / "splits_final.pkl"))


@pytest.mark.parametrize("prepped", ["default"], indirect=True)
def test_run_train_on_the_port_plan(prepped, tmp_path):
    _, got_task, _, plan, _ = prepped
    out = tpipeline.run_train(
        got_task, tmp_path / "models", fold=0, model_overrides=TINY_MODEL,
        trainer_overrides=dict(max_epochs=1, num_train_batches_per_epoch=1,
                               num_val_batches_per_epoch=1, warm_iterations=1, swa_epochs=0,
                               batch_size=2),
        device="cpu")
    rows = [json.loads(r) for r in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["steps"] == 1 and rows[0]["train_nonfinite_steps"] == 0
    same_plan(load_plan(out / "plan.pkl"), load_plan(got_task / "preprocessed" /
                                                     f"{plan.plan_id}.pkl"))
    assert (out / "model_last.ckpt").exists()


def test_run_prep_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = toy_task(tmp_path, object_size=(8, 14))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.run_prep(task)
    assert not (task / "raw_cropped").exists()
