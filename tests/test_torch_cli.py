"""The port's command line and the host modules it copies, against the JAX
package's: ``utils/config.py`` (``compose`` over overrides, a task YAML and
environment interpolation; ``trainer_overrides_from_cfg``),
``utils/check.py`` on a good toy task and broken copies,
``cli/utils.py``'s exports, ``utils/analysis.py``'s report; then the
README's sequence through the port's ``main()``s on the CPU
(``-o device=cpu``), and every command raising without a card when no
override names the CPU."""
import csv
import functools
import json
import math
import shutil
import sys

import numpy as np
import pytest
import torch

import nndetection_tpu.cli.train as jcli_train
import nndetection_tpu.cli.utils as jcli_utils
from nndetection_tpu.data.example import generate_example_dataset as j_generate
from nndetection_tpu.evaluator.registry import evaluate_case_dir as jevaluate_case_dir
from nndetection_tpu.planning.estimator import DEFAULT_BUDGET
from nndetection_tpu.utils import analysis as janalysis
from nndetection_tpu.utils import check as jcheck
from nndetection_tpu.utils import config as jconfig
from nndetection_tpu_torch.cli import consolidate as cli_consolidate
from nndetection_tpu_torch.cli import evaluate as cli_evaluate
from nndetection_tpu_torch.cli import example as cli_example
from nndetection_tpu_torch.cli import predict as cli_predict
from nndetection_tpu_torch.cli import prep as cli_prep
from nndetection_tpu_torch.cli import sweep as cli_sweep
from nndetection_tpu_torch.cli import train as cli_train
from nndetection_tpu_torch.cli import utils as cli_utils
from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.planning.planner import Planner
from nndetection_tpu_torch.utils import analysis, check, config
from nndetection_tpu_torch.utils.io import load_json, load_pickle, save_json, save_pickle
from tests.test_torch_prep import assert_same

torch.set_num_threads(1)

TASK_YAML = """
module: RetinaUNetV001
trainer_cfg:
  max_num_epochs: 7
  initial_lr: 0.002
  batch_size: 4
augment_cfg:
  augmentation: no_aug
paths:
  data: ${env:det_data}/raw
  cache: ${env:NNDET_TEST_UNSET:/tmp/fallback}
additional_imports: []
"""
OVERRIDES = [
    [],
    ["trainer_cfg.max_num_epochs=3", "trainer_cfg.swa_epochs=0", "module=RetinaUNetV001"],
    ["augment_cfg.oversample_foreground_percent=0.33", "trainer_cfg.sgd_nesterov=false",
     "model_cfg.plan_arch_overwrites.start_channels=8"],
    ["trainer_cfg.initial_lr=1e-3", "trainer_cfg.batch_size=null", "device=cpu"],
    ["out=${env:det_models}/m", "names=[a, b]", "broken=[1,", "nested.deep.key={x: 1}"],
]


@pytest.mark.parametrize("with_yaml", [False, True])
@pytest.mark.parametrize("overrides", OVERRIDES)
def test_compose_matches_jax(monkeypatch, tmp_path, with_yaml, overrides):
    monkeypatch.setenv("det_data", "/data/det")
    monkeypatch.setenv("det_models", "/models/det")
    monkeypatch.delenv("NNDET_TEST_UNSET", raising=False)
    task_cfg = None
    if with_yaml:
        task_cfg = tmp_path / "config.yaml"
        task_cfg.write_text(TASK_YAML)
    got = config.compose(task_cfg, overrides)
    want = jconfig.compose(task_cfg, overrides)
    assert got == want
    assert cli_train.trainer_overrides_from_cfg(got) == jcli_train.trainer_overrides_from_cfg(want)
    assert config.config_device(got) == ("cpu" if "device=cpu" in overrides else "cuda")
    if with_yaml:
        assert got["paths"] == {"data": "/data/det/raw", "cache": "/tmp/fallback"}
    for key in ("trainer_cfg.max_num_epochs", "model_cfg.plan_arch_overwrites", "a.b.c"):
        assert config.get_dotted(got, key, "-") == jconfig.get_dotted(want, key, "-")


def test_config_helpers_match_jax(monkeypatch):
    with pytest.raises(ValueError, match="key=value"):
        config.compose(overrides=["no_equals"])
    base = {"a": {"b": 1, "c": [1]}, "d": 2}
    assert config.merge(base, {"a": {"c": [2]}, "e": 3}) == jconfig.merge(base, {"a": {"c": [2]},
                                                                             "e": 3})
    got, want = {}, {}
    config.set_dotted(got, "x.y.z", 1)
    jconfig.set_dotted(want, "x.y.z", 1)
    assert got == want == {"x": {"y": {"z": 1}}}
    monkeypatch.delenv("det_data", raising=False)
    with pytest.raises(EnvironmentError):
        config.env_paths()
    monkeypatch.setenv("det_data", "/d")
    monkeypatch.setenv("det_models", "/m")
    assert config.env_paths() == jconfig.env_paths()
    config.load_additional_imports({"additional_imports": ["nndetection_tpu_torch.modules"]})
    assert config.DEFAULT_CONFIG == jconfig.DEFAULT_CONFIG


# ------------------------------------------------------------------ checks
def _missing_label(task):
    (task / "raw_splitted" / "labelsTr" / "case_1.nii.gz").unlink()


def _bad_json(task):
    save_json({"instances": {"1": 1.0, "3": 5}},
              task / "raw_splitted" / "labelsTr" / "case_2.json")


def _geometry(task):
    labels = task / "raw_splitted" / "labelsTr"
    seg, _, _ = nifti.load(labels / "case_0.nii.gz")
    seg = seg.copy()
    seg[0, 0, 0] = 2  # an instance the json does not declare
    nifti.save(labels / "case_0.nii.gz", seg[:, :, :-1], spacing=(1.0, 1.5, 1.0))


def _dataset_yaml(task):
    text = (task / "dataset.yaml").read_text().replace("'1': hollow_square", "'2': hollow_square")
    (task / "dataset.yaml").write_text(text.replace("dim: 3", "dim: 4"))


def _missing_modality(task):
    shutil.copy(task / "raw_splitted" / "imagesTs" / "case_4_0000.nii.gz",
                task / "raw_splitted" / "imagesTs" / "case_4_0001.nii.gz")


@pytest.mark.parametrize("break_fn", [None, _missing_label, _bad_json, _geometry, _dataset_yaml,
                                      _missing_modality])
@pytest.mark.parametrize("full", [False, True])
def test_dataset_checks_match_jax(tmp_path, break_fn, full):
    task = j_generate(tmp_path / "Task000D3_Example", num_train=3, num_test=2,
                      image_size=(16, 16, 16), object_size=(4, 8), object_width=2)
    if break_fn is not None:
        break_fn(task)
    got = check.check_data_and_label_consistency(task, full=full)
    want = jcheck.check_data_and_label_consistency(task, full=full)
    assert got == want
    if break_fn is None or (break_fn is _geometry and not full):
        assert got == []
    else:
        assert got, break_fn.__name__
    assert check.check_dataset_file(task) == jcheck.check_dataset_file(task)
    if break_fn is None:
        cli_prep.check_dataset(task, full=full)
    elif got:
        with pytest.raises(RuntimeError, match="dataset check failed"):
            cli_prep.check_dataset(task, full=full)


def test_env_guard_matches_jax(monkeypatch):
    calls = []
    monkeypatch.delenv("det_data", raising=False)
    for guard in (check.env_guard, jcheck.env_guard):
        with pytest.raises(EnvironmentError, match="det_data"):
            guard(lambda: calls.append(1))()
    monkeypatch.setenv("det_data", "/d")
    monkeypatch.setenv("det_models", "/m")
    assert check.env_guard(lambda: 3)() == 3


# ---------------------------------------------------------- utils, analysis
def write_predictions(pred_dir, gt_dir, props_dir, n_cases=3, seed=0):
    """Seeded predictions (``*_boxes.pkl``, ``*_seg.npz``), their GT and
    properties: per case two objects, each found by jittered boxes of high
    score, and clutter of any score."""
    rng = np.random.RandomState(seed)
    for d in (pred_dir, gt_dir, props_dir):
        d.mkdir(parents=True, exist_ok=True)
    for i in range(n_cases):
        cid = f"case_{i}"
        gt = np.asarray([[4 + i, 6, 12 + i, 14, 3, 11], [20, 18, 27, 26, 15, 24]], np.float32)
        classes = np.asarray([0, 1 if i % 2 else 0])
        near = gt[rng.randint(0, 2, 4)] + rng.uniform(-1.5, 1.5, (4, 6)).astype(np.float32)
        lo = rng.uniform(0, 20, (5, 3))
        clutter = np.concatenate([lo[:, :2], lo[:, :2] + rng.uniform(2, 6, (5, 2)), lo[:, 2:],
                                  lo[:, 2:] + rng.uniform(2, 6, (5, 1))], 1).astype(np.float32)
        save_pickle({"pred_boxes": np.concatenate([near, clutter]),
                     "pred_scores": np.concatenate([rng.uniform(0.5, 1.0, 4),
                                                    rng.uniform(0.0, 0.6, 5)]),
                     "pred_labels": rng.randint(0, 2, 9), "restored": False},
                    pred_dir / f"{cid}_boxes.pkl")
        np.savez(gt_dir / f"{cid}_boxes_gt.npz", boxes=gt, classes=classes)
        np.savez_compressed(pred_dir / f"{cid}_seg.npz",
                            seg=(rng.rand(30, 28, 26) < 0.2).astype(np.int16))
        shape = (30, 28, 26) if i else None
        save_pickle({"shape_after_resampling": shape, "shape_after_crop": (31, 29, 27)},
                    props_dir / f"{cid}.pkl")


def run_main(monkeypatch, fn, *argv):
    monkeypatch.setattr(sys, "argv", ["prog", *map(str, argv)])
    fn()


def assert_same_nii_dir(got_dir, want_dir):
    names = sorted(p.name for p in want_dir.iterdir())
    assert names and names == sorted(p.name for p in got_dir.iterdir())
    for name in names:
        if name.endswith(".json"):
            assert load_json(got_dir / name) == load_json(want_dir / name)
        else:
            for g, w in zip(nifti.load(got_dir / name), nifti.load(want_dir / name)):
                assert_same(np.asarray(g), np.asarray(w), name)
    return names


def test_exports_match_jax(monkeypatch, tmp_path):
    pred, gt, props = tmp_path / "pred", tmp_path / "gt", tmp_path / "props"
    write_predictions(pred, gt, props)
    for argv in ([pred, "OUT"], [pred, "OUT", "--shape_dir", props, "--score_thresh", 0.5]):
        out = {}
        for side, fn in (("port", cli_utils.main_boxes2nii), ("jax", jcli_utils.main_boxes2nii)):
            out[side] = tmp_path / f"{side}_{len(argv)}"
            run_main(monkeypatch, fn, *[out[side] if a == "OUT" else a for a in argv])
        names = assert_same_nii_dir(out["port"], out["jax"])
        assert "case_0_boxes.nii.gz" in names and "case_2_boxes.json" in names
    for side, fn in (("port", cli_utils.main_seg2nii), ("jax", jcli_utils.main_seg2nii)):
        run_main(monkeypatch, fn, pred, tmp_path / f"seg_{side}")
    assert len(assert_same_nii_dir(tmp_path / "seg_port", tmp_path / "seg_jax")) == 3

    # unpack through the command dispatch of ``python -m ...cli.utils``
    src = tmp_path / "npz"
    src.mkdir()
    rng = np.random.RandomState(3)
    for i in range(2):
        np.savez_compressed(src / f"case_{i}.npz", data=rng.rand(2, 5, 6, 7).astype(np.float32))
    shutil.copytree(src, tmp_path / "npz_jax")
    run_main(monkeypatch, cli_utils.main, "unpack", src)
    run_main(monkeypatch, jcli_utils.main_unpack, tmp_path / "npz_jax")
    for i in range(2):
        assert_same(np.load(src / f"case_{i}.npy"), np.load(tmp_path / "npz_jax" / f"case_{i}.npy"))
    with pytest.raises(SystemExit, match="unknown command"):
        run_main(monkeypatch, cli_utils.main, "nope")


def test_env_and_searchpath(monkeypatch, capsys):
    run_main(monkeypatch, cli_utils.main)
    run_main(monkeypatch, cli_utils.main, "searchpath")
    out = capsys.readouterr().out
    assert f"torch: {torch.__version__}" in out and "cuda: " in out and "devices: " in out
    assert "nndetection_tpu_torch.utils.config.DEFAULT_CONFIG" in out
    assert "jax" not in out


def test_analysis_suite_matches_jax(tmp_path):
    pred, gt, props = tmp_path / "pred", tmp_path / "gt", tmp_path / "props"
    write_predictions(pred, gt, props)
    got = analysis.run_analysis_suite(pred, gt, tmp_path / "port", num_classes=2)
    want = janalysis.run_analysis_suite(pred, gt, tmp_path / "jax", num_classes=2)
    assert_same(got, want)
    assert got["iou_0.10_score_0.10"]["tp"] > 0 and got["iou_0.50_score_0.50"]["fp"] > 0
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.suffix in (".json", ".csv"))
    assert len(files) == 13  # 4 grid cells x (2 json + 1 csv), and the summary
    assert files == sorted(p.relative_to(tmp_path / "port") for p in
                           (tmp_path / "port").rglob("*") if p.suffix in (".json", ".csv"))
    for f in files:
        g, w = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.suffix == ".json":
            assert load_json(g) == load_json(w), f
        else:
            with open(g) as fg, open(w) as fw:
                assert list(csv.reader(fg)) == list(csv.reader(fw)), f
    # a box evaluation's results saved beside the predictions are skipped
    # (the JAX suite reads them as a case and fails)
    save_pickle({"scores": {}, "curves": {}}, pred / "results_boxes.pkl")
    assert_same(analysis.run_analysis_suite(pred, gt, tmp_path / "again", num_classes=2), want)
    case = load_pickle(pred / "case_1_boxes.pkl")
    with np.load(gt / "case_1_boxes_gt.npz") as f:
        assert_same(analysis.analyze_case(case, f["boxes"], f["classes"], 0.1, 0.3),
                    janalysis.analyze_case(case, f["boxes"], f["classes"], 0.1, 0.3))
    mask, meta = analysis.convert_boxes_to_mask(case["pred_boxes"], case["pred_scores"],
                                                case["pred_labels"], (30, 28, 26), 0.4)
    jmask, jmeta = janalysis.convert_boxes_to_mask(case["pred_boxes"], case["pred_scores"],
                                                   case["pred_labels"], (30, 28, 26), 0.4)
    assert_same(mask, jmask)
    assert meta == jmeta and len(meta) > 0


# ------------------------------------------------- the README's sequence
TINY = ["trainer_cfg.max_num_epochs=1", "trainer_cfg.num_train_batches_per_epoch=2",
        "trainer_cfg.num_val_batches_per_epoch=1", "trainer_cfg.batch_size=2",
        "trainer_cfg.warm_iterations=1", "trainer_cfg.swa_epochs=0",
        "model_cfg.plan_arch_overwrites.start_channels=8",
        "model_cfg.plan_arch_overwrites.fpn_channels=16",
        "model_cfg.plan_arch_overwrites.head_channels=16",
        "model_cfg.plan_arch_overwrites.topk_candidates=200",
        "model_cfg.plan_arch_overwrites.detections_per_img=20",
        "model_cfg.plan_arch_overwrites.dtype=float32"]
TASK = "Task000D3_Example"


def test_readme_sequence_on_the_cpu(monkeypatch, tmp_path):
    """``example -> prep -> train --sweep -> consolidate -> predict ->
    evaluate`` and the exports, every command with ``-o device=cpu``; the
    planner on the CPU with a budget."""
    monkeypatch.setenv("det_data", str(tmp_path / "data"))
    monkeypatch.setenv("det_models", str(tmp_path / "models"))
    monkeypatch.setattr(cli_prep, "Planner", functools.partial(
        Planner, hbm_budget=DEFAULT_BUDGET, anchor_budget=50))
    cpu = ["-o", "device=cpu"]
    run_main(monkeypatch, cli_example.main, "--num_train", 4, "--num_test", 2, "--size", 48)
    run_main(monkeypatch, cli_prep.main, TASK, "--num_workers", 0, *cpu)
    run_main(monkeypatch, cli_train.main, TASK, "--fold", 0, "--sweep", *cpu, *TINY)
    run_main(monkeypatch, cli_consolidate.main, TASK, "--num_folds", 1, *cpu)
    run_main(monkeypatch, cli_predict.main, TASK, "--num_folds", 1, *cpu)
    run_main(monkeypatch, cli_evaluate.main, TASK, "--seg", "--case", "--analyze_boxes", *cpu)

    task = tmp_path / "data" / TASK
    models = tmp_path / "models" / TASK / "RetinaUNetV001_D3V001_3d"
    prep = task / "preprocessed"
    for f in ("D3V001_3d.pkl", "splits_final.pkl", "properties/dataset_properties.pkl",
              "prep.log", "D3V001_3d/imagesTr/case_0.npy", "D3V001_3d/labelsTr/case_0_boxes_gt.npz",
              "D3V001_3d/imagesTs/case_4.npy", "D3V001_3d/labelsTs/case_5_boxes_gt_orig.npz"):
        assert (prep / f).exists(), f
    for f in ("fold0/model_last.ckpt", "fold0/plan.pkl", "fold0/plan_inference.pkl",
              "fold0/metrics.json", "fold0/train.log", "fold0/sweep/case_0_boxes_state.pkl",
              "consolidated/model_fold0.ckpt", "consolidated/plan_inference.pkl",
              "consolidated/plan.pkl", "consolidated/sweep_states/case_0_boxes_state.pkl",
              "test_predictions/results_boxes.json", "test_predictions/results_case.json",
              "test_predictions/results_seg.json", "test_predictions/analysis/analysis.json"):
        assert (models / f).exists(), f
    metrics = load_json(models / "fold0" / "metrics.json")
    assert [m["epoch"] for m in metrics] == [0] and metrics[0]["steps"] == 2
    preds = sorted((models / "test_predictions").glob("case_*_boxes.pkl"))
    assert [p.name for p in preds] == ["case_4_boxes.pkl", "case_5_boxes.pkl"]
    for p in preds:
        pred = load_pickle(p)
        assert pred["restored"] is True and len(pred["pred_scores"]) > 0
    box_scores = load_json(models / "test_predictions" / "results_boxes.json")
    assert math.isfinite(box_scores["mAP_IoU_0.10_0.50_0.05_MaxDet_100"])
    # every toy case holds an object: the case AUROC and AP are undefined
    # (NaN) in both packages
    assert_same(load_json(models / "test_predictions" / "results_case.json"),
                jevaluate_case_dir(models / "test_predictions", prep / "D3V001_3d" / "labelsTs",
                                   ["square", "hollow_square"]))

    out = tmp_path / "nii"
    run_main(monkeypatch, cli_utils.main, "boxes2nii", models / "test_predictions", out,
             "--shape_dir", prep / "D3V001_3d" / "imagesTs")
    assert sorted(p.name for p in out.iterdir()) == [
        "case_4_boxes.json", "case_4_boxes.nii.gz", "case_5_boxes.json", "case_5_boxes.nii.gz"]


@pytest.mark.parametrize("module", [cli_prep, cli_train, cli_sweep, cli_consolidate,
                                    cli_predict, cli_evaluate])
def test_commands_default_to_the_card(monkeypatch, tmp_path, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("det_data", str(tmp_path / "data"))
    monkeypatch.setenv("det_models", str(tmp_path / "models"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(monkeypatch, module.main, TASK, "-o", "trainer_cfg.swa_epochs=0")
    assert not (tmp_path / "models").exists() and not (tmp_path / "data").exists()


def test_cli_device_comes_from_the_config():
    assert json.dumps(config.compose(overrides=["device=cpu"])["device"]) == '"cpu"'
    assert "device" not in config.compose()
