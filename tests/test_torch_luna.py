"""The LUNA-proxy path of the port against the JAX package's: the proxy
generator bit for bit (``data/luna_proxy.py``), the Task016 annotations
reader, CPM export (rows within 1e-9 on the same pickles) and FROC/CPM
scoring (the same dict on the same CSV), and ``proxy_cv.run_proxy_cv`` on
the CPU at a tiny size: its stage 7 (pooling, export, score over the
validation series, box evaluation) equal to the stage-7 code of
``scripts_dev/luna_proxy.py`` applied to the same fold directories, a
resumed run that redoes nothing, and the device rule."""
import csv
import functools
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from nndetection_tpu import pipeline as jpipeline
from nndetection_tpu.data import luna_proxy as jproxy
from nndetection_tpu.data import mhd as jmhd
from nndetection_tpu.utils.io import load_pickle, save_pickle
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.data import luna_proxy as tproxy
from nndetection_tpu_torch.data import mhd as tmhd
from nndetection_tpu_torch.planning.planner import Planner
from nndetection_tpu_torch.projects.Task016_Luna import prepare as ttask016
from nndetection_tpu_torch.projects.Task016_Luna import proxy_cv
from tests.test_torch_converters import assert_same_outputs
from tests.test_torch_prep import assert_same

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY_MODEL = dict(start_channels=8, fpn_channels=16, head_channels=16, topk_candidates=200,
                  detections_per_img=20, dtype="float32")


def load_jax_task016():
    spec = importlib.util.spec_from_file_location(
        "jax_task016_prepare", REPO / "projects" / "Task016_Luna" / "prepare.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtask016 = load_jax_task016()


# ----------------------------------------------------------------- the generator
@pytest.mark.parametrize("seed, inplane", [(0, 32), (3, 48), (100003, 40)])
def test_generate_proxy_case_bit_for_bit(seed, inplane):
    got = tproxy.generate_proxy_case(np.random.RandomState(seed), inplane=inplane)
    want = jproxy.generate_proxy_case(np.random.RandomState(seed), inplane=inplane)
    assert_same(got, want)


def test_generate_luna_proxy_bit_for_bit(tmp_path):
    """The same LUNA16 layout: headers, ``.zraw`` bytes (zlib is
    deterministic), volumes and ``annotations.csv``."""
    tproxy.generate_luna_proxy(tmp_path / "t", num_cases=4, seed=2, inplane=32, num_subsets=3)
    jproxy.generate_luna_proxy(tmp_path / "j", num_cases=4, seed=2, inplane=32, num_subsets=3)
    names = assert_same_outputs(tmp_path / "t", tmp_path / "j")
    assert "subset2/proxy_0002.zraw" in names
    for mhd_file in sorted((tmp_path / "t").rglob("*.mhd")):
        assert_same(tmhd.load(mhd_file), jmhd.load(tmp_path / "j" / mhd_file.relative_to(
            tmp_path / "t")))


# ----------------------------------------------------------------- export and score
@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Five proxy cases converted by the port's Task016 (the converter is
    held to the JAX script in ``tests/test_torch_projects.py``)."""
    root = tmp_path_factory.mktemp("luna")
    src = tproxy.generate_luna_proxy(root / "raw", num_cases=5, seed=2, inplane=48,
                                     num_subsets=2)
    ttask016.convert(src, root / "task")
    return root


def test_load_annotations(converted):
    csv_path = converted / "raw" / "annotations.csv"
    assert ttask016.load_annotations(csv_path) == jtask016.load_annotations(csv_path)


def write_predictions(pred_dir: Path, labels_dir: Path, seed: int):
    """Random restored predictions for every converted case, a case
    without geometry and the evaluator's ``results_boxes.pkl``."""
    rng = np.random.RandomState(seed)
    pred_dir.mkdir(parents=True)
    for geom in sorted(labels_dir.glob("*_geometry.pkl")):
        cid = geom.name[: -len("_geometry.pkl")]
        n = rng.randint(0, 12)
        lo = rng.uniform(0, 40, (n, 3))
        hi = lo + rng.uniform(1, 8, (n, 3))
        boxes = np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1)
        save_pickle({"pred_boxes": boxes.astype(np.float32), "pred_scores":
                     rng.rand(n).astype(np.float32) - 0.1, "pred_labels": np.zeros(n, np.int64),
                     "restored": True}, pred_dir / f"{cid}_boxes.pkl")
    save_pickle({"pred_boxes": np.zeros((1, 6)), "pred_scores": np.ones(1)},
                pred_dir / "nogeom_boxes.pkl")
    save_pickle({"mAP": 0.0}, pred_dir / "results_boxes.pkl")


def read_rows(path):
    with open(path) as f:
        return [(r["seriesuid"], [float(r[k]) for k in ("coordX", "coordY", "coordZ",
                                                           "probability")])
                for r in csv.DictReader(f)]


@pytest.mark.parametrize("seed, thresh", [(0, 0.0), (1, 0.3)])
def test_export_cpm(tmp_path, converted, seed, thresh, capsys):
    labels = converted / "task" / "raw_splitted" / "labelsTr"
    write_predictions(tmp_path / "preds", labels, seed)
    ttask016.export_cpm(tmp_path / "preds", labels, tmp_path / "t.csv", thresh)
    jtask016.export_cpm(tmp_path / "preds", labels, tmp_path / "j.csv", thresh)
    got, want = read_rows(tmp_path / "t.csv"), read_rows(tmp_path / "j.csv")
    assert [c for c, _ in got] == [c for c, _ in want] and len(got) > 0
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=0, atol=1e-9)
    assert "skipping nogeom_boxes.pkl" in capsys.readouterr().out


def write_scoring_csvs(tmp_path, seed, n_scans=12):
    """Annotations and predictions (hits near centres, random FPs, ties),
    as ``tests/test_luna_proxy.py::test_score_cpm_matches_bruteforce``
    draws them."""
    rng = np.random.RandomState(seed)
    ann_rows, pred_rows = [], []
    for s in range(n_scans):
        cid = f"s{s}"
        anns = [(rng.uniform(0, 200, 3), rng.uniform(4, 20)) for _ in range(rng.randint(0, 3))]
        ann_rows += [[cid, *c.tolist(), d] for c, d in anns]
        for _ in range(rng.randint(0, 8)):
            if anns and rng.rand() < 0.5:
                base, d = anns[rng.randint(len(anns))]
                c = base + rng.uniform(-0.4, 0.4, 3) * d / 2
            else:
                c = rng.uniform(0, 200, 3)
            pred_rows.append([cid, *c.tolist(), float(np.round(rng.rand(), 1))])
    for name, header, rows in (("a.csv", "diameter_mm", ann_rows), ("p.csv", "probability",
                                                                     pred_rows)):
        with open(tmp_path / name, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["seriesuid", "coordX", "coordY", "coordZ", header])
            w.writerows(rows)
    return tmp_path / "p.csv", tmp_path / "a.csv"


@pytest.mark.parametrize("seed, kwargs", [
    (11, dict(num_scans=12)), (12, dict()), (13, dict(series=["s0", "s3", "s5", "s7", "s99"])),
    (14, dict(series=[]))])
def test_score_cpm(tmp_path, seed, kwargs):
    pred_csv, ann_csv = write_scoring_csvs(tmp_path, seed)
    got = ttask016.score_cpm(pred_csv, ann_csv, **kwargs)
    want = jtask016.score_cpm(pred_csv, ann_csv, **kwargs)
    assert got == want
    assert list(got["froc"]) == [str(f) for f in ttask016.FPPI_POINTS]


def test_prepare_main_scores(tmp_path):
    """``--score-cpm`` with ``--series-csv`` through both scripts' ``main``
    prints the same result."""
    import subprocess
    import sys

    pred_csv, ann_csv = write_scoring_csvs(tmp_path, 21)
    (tmp_path / "series.csv").write_text("seriesuid\ns1\ns2\ns4\n")
    args = ["--score-cpm", str(pred_csv), str(ann_csv), "--series-csv",
            str(tmp_path / "series.csv")]
    out = [subprocess.run([sys.executable, str(p), *args], capture_output=True, text=True,
                          cwd=REPO) for p in (REPO / "projects" / "Task016_Luna" / "prepare.py",
                                              Path(ttask016.__file__))]
    assert out[0].returncode == out[1].returncode == 0, out[0].stderr + out[1].stderr
    assert out[0].stdout == out[1].stdout and "cpm" in out[0].stdout


# ----------------------------------------------------------------- run_proxy_cv
def jax_stage7(task, raw, model_dir, folds):
    """Stage 7 of ``scripts_dev/luna_proxy.py``, with the
    JAX package's Task016 module and ``run_evaluate``."""
    pooled = model_dir / "cv_predictions"
    pooled.mkdir(exist_ok=True)
    for fold in folds:
        for p in (model_dir / f"fold{fold}" / "val_predictions").glob("*_boxes.pkl"):
            dst = pooled / p.name
            if not dst.exists() or p.stat().st_mtime > dst.stat().st_mtime:
                shutil.copy(p, dst)
    cpm_csv = model_dir / "cpm_predictions.csv"
    jtask016.export_cpm(pooled, task / "raw_splitted" / "labelsTr", cpm_csv)
    splits = load_pickle(task / "preprocessed" / "splits_final.pkl")
    series = sorted({cid for f in folds for cid in splits[f]["val"]})
    cpm = jtask016.score_cpm(cpm_csv, raw / "annotations.csv", series=series)
    box_metrics, _ = jpipeline.run_evaluate(task, pooled, split="Tr")
    return cpm, box_metrics


@pytest.fixture(scope="module")
def proxy_run(tmp_path_factory):
    """5 cases at inplane 40, fold 0 trained 2 steps at the tiny widths
    (``run_train``'s ``model_overrides``), on the CPU."""
    root = tmp_path_factory.mktemp("proxy")
    kwargs = dict(num_cases=5, inplane=40, epochs=1, steps=2, swa_epochs=0, val_steps=1,
                  warmup=1, folds=[0], batch_size=2, device="cpu",
                  planner=Planner(hbm_budget=2 * 1024 ** 3, anchor_budget=50, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "run_train",
                   functools.partial(tpipeline.run_train, model_overrides=TINY_MODEL))
        result = proxy_cv.run_proxy_cv(root, **kwargs)
    return root, kwargs, result


def test_run_proxy_cv_stage7_matches_jax(proxy_run, tmp_path):
    """The port's pooled CPM, CSV and box metrics equal the JAX script's
    stage 7 on a copy of the same fold directory."""
    root, _, result = proxy_run
    task, raw = root / proxy_cv.TASK_NAME, root / "raw"
    model_dir = root / "models" / proxy_cv.TASK_NAME / proxy_cv.MODULE
    jmodel = tmp_path / "jmodel"
    shutil.copytree(model_dir / "fold0" / "val_predictions", jmodel / "fold0" / "val_predictions")
    cpm, box_metrics = jax_stage7(task, raw, jmodel, [0])
    assert result["cpm"] == cpm
    assert cpm["num_scans"] == 1 and cpm["num_annotations"] == 3 and cpm["num_fps"] > 0
    assert read_rows(model_dir / "cpm_predictions.csv") == read_rows(jmodel / "cpm_predictions.csv")
    assert result["box_eval"] == {k: round(float(v), 4) for k, v in box_metrics.items()
                                  if isinstance(v, (int, float)) and ("AP" in k or "FROC" in k)}
    assert_same_outputs(model_dir / "cv_predictions", jmodel / "cv_predictions")
    splits = load_pickle(task / "preprocessed" / "splits_final.pkl")
    assert sorted(p.name for p in (model_dir / "fold0" / "val_predictions").glob("*_boxes.pkl")) \
        == sorted(f"{c}_boxes.pkl" for c in splits[0]["val"])


def test_run_proxy_cv_result_and_resume(proxy_run):
    """The artifact's keys, the fold's history, and a second run that finds
    every stage done (nothing generated, converted, prepared, trained or
    swept again) and scores the same."""
    root, kwargs, result = proxy_run
    assert set(result) == {"config", "cpm", "box_eval", "fold_final_epochs", "fold_histories",
                           "telemetry", "reference_bar", "in_stats_provenance"}
    assert result["config"]["batch_size"] == 2 and result["config"]["folds"] == [0]
    assert [r["epoch"] for r in result["fold_histories"][0]] == [0]
    assert {"generate", "convert", "prep", "train_fold0", "sweep_fold0", "consolidate",
            "predict_fold0"} <= set(result["telemetry"]["stage_times_s"])
    assert (root / "luna_proxy_partial.json").exists() and (root / "luna_proxy.json").exists()
    again = proxy_cv.run_proxy_cv(root, **kwargs)
    assert set(again["telemetry"]["stage_times_s"]) == {"score"}
    assert again["cpm"] == result["cpm"] and again["fold_histories"] == result["fold_histories"]


def test_run_proxy_cv_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proxy_cv.run_proxy_cv(tmp_path, 2, 32, 1, 1, 0, 1, 1, [0])
    assert not any(tmp_path.iterdir())
