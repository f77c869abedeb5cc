"""The port's training entry point against the JAX package's on a task that
the JAX package's own ``run_prep`` made (``data/example.py``'s toy task,
``Planner(anchor_budget=200)``): ``load_plan`` reads the JAX plan, the seven
module variants give the JAX model configurations field by field,
``build_loaders(device_pool=True, device="cpu")`` gives the JAX loaders'
first batches at the ``run_train`` seed, the pool budget is the JAX
formula's with the same memory figure, and ``run_train(device="cpu")``
trains, writes its files and resumes. Also ``DatasetInfo``, the YAML, JSON
and npz helpers, the task and case-id helpers, and the guards of a job that
cannot form."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from nndetection_tpu import modules as jmodules  # noqa: F401 - registers the variants
from nndetection_tpu import pipeline as jpipeline
from nndetection_tpu.data import dataset as jdataset
from nndetection_tpu.data.aug_presets import get_augmentation as j_get_augmentation
from nndetection_tpu.data.example import generate_example_dataset
from nndetection_tpu.planning.estimator import V5E_HBM_BYTES
from nndetection_tpu.planning.planner import Planner
from nndetection_tpu.utils import io as jio
from nndetection_tpu.utils.registry import MODULE_REGISTRY as J_MODULES
from nndetection_tpu_torch import modules as tmodules
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.data import dataset as tdataset
from nndetection_tpu_torch.data import loader as tloader
from nndetection_tpu_torch.data.aug_presets import get_augmentation
from nndetection_tpu_torch.planning.planner import PLAN_SCHEMA_VERSION, Plan, load_plan
from nndetection_tpu_torch.train.trainer import TrainerConfig
from nndetection_tpu_torch.utils import io as tio
from nndetection_tpu_torch.utils.registry import MODULE_REGISTRY
from tests.test_torch_loader import assert_same_batch

torch.set_num_threads(1)

PLAN_ID = "D3V001_3d"
TINY_MODEL = dict(start_channels=8, fpn_channels=16, head_channels=16, topk_candidates=200,
                  detections_per_img=20, dtype="float32")
TINY_TRAINER = dict(max_epochs=2, num_train_batches_per_epoch=2, num_val_batches_per_epoch=1,
                    warm_iterations=1, swa_epochs=0, batch_size=2)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    task_dir = generate_example_dataset(root / "Task000D3_Example", num_train=5, num_test=0,
                                        image_size=(32, 32, 32), object_size=(8, 14),
                                        object_width=2)
    jpipeline.run_prep(task_dir, planner=Planner(anchor_budget=200))
    return task_dir


def jax_plan(task):
    return jio.load_pickle(task / "preprocessed" / f"{PLAN_ID}.pkl")


# ---------------------------------------------------------------- the plan
def test_load_plan_reads_the_jax_plan(task):
    want = jax_plan(task)
    got = load_plan(task / "preprocessed" / f"{PLAN_ID}.pkl")
    assert type(got) is Plan
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.do_dummy_2d == want.do_dummy_2d


def test_load_plan_migrates_an_old_schema(task, tmp_path):
    """A plan pickled before ``n_model`` and ``schema_version`` existed gets
    their defaults; a newer schema raises."""
    old = jax_plan(task)
    del old.__dict__["n_model"], old.__dict__["schema_version"]
    jio.save_pickle(old, tmp_path / "old.pkl")
    got = load_plan(tmp_path / "old.pkl")
    assert got.n_model == 1 and got.schema_version == PLAN_SCHEMA_VERSION
    new = jax_plan(task)
    new.__dict__["schema_version"] = PLAN_SCHEMA_VERSION + 1
    jio.save_pickle(new, tmp_path / "new.pkl")
    with pytest.raises(ValueError, match="schema_version"):
        load_plan(tmp_path / "new.pkl")
    # the port's own pickle reads back
    tio.save_pickle(got, tmp_path / "port.pkl")
    assert dataclasses.asdict(load_plan(tmp_path / "port.pkl")) == dataclasses.asdict(got)


@pytest.mark.parametrize("module", sorted(J_MODULES.keys()))
def test_module_configs_match_jax(task, module):
    assert set(MODULE_REGISTRY.keys()) == set(J_MODULES.keys())
    plan = load_plan(task / "preprocessed" / f"{PLAN_ID}.pkl")
    got = dataclasses.asdict(MODULE_REGISTRY[module].model_config(plan, **TINY_MODEL))
    want = dataclasses.asdict(J_MODULES[module].model_config(jax_plan(task), **TINY_MODEL))
    assert got == want
    assert MODULE_REGISTRY[module] is getattr(tmodules, module)


# ------------------------------------------------------------- the loaders
def test_build_loaders_pool_matches_jax(task):
    """The first train and validation batches of the JAX ``build_loaders``
    with its pool, at the seed ``run_train`` gives fold 0."""
    prep = task / "preprocessed"
    image_dir = prep / PLAN_ID / "imagesTr"
    splits = tpipeline.make_splits([p.stem for p in image_dir.glob("*.npz")],
                                   prep / "splits_final.pkl")
    plan, jplan = load_plan(prep / f"{PLAN_ID}.pkl"), jax_plan(task)
    seed = TrainerConfig().seed + 0  # run_train's seed for fold 0
    got = tpipeline.build_loaders(plan, image_dir, splits, 0, 2, seed=seed,
                                  aug_cfg=get_augmentation("base_more", plan.patch_size),
                                  device_pool=True, num_epochs_hint=2, device="cpu")
    want = jpipeline.build_loaders(jplan, image_dir, splits, 0, 2, seed=seed,
                                   aug_cfg=j_get_augmentation("base_more", jplan.patch_size),
                                   device_pool=True, num_epochs_hint=2)
    assert type(got[0]) is tloader.DevicePatchPool and type(want[0]).__name__ == "DevicePatchPool"
    assert type(got[1]) is tloader.PatchLoader and got[1].fixed_sequence
    for g, w in zip(got, want):
        assert [r.case_id for r in g.records] == [r.case_id for r in w.records]
        assert (g.patch_size, g.inner_patch, g.seed) == (w.patch_size, w.inner_patch, w.seed)
        for gb, wb in zip(g.epoch(2), w.epoch(2)):
            assert_same_batch(gb, {k: np.asarray(v) for k, v in wb.items()})


def test_auto_takes_the_host_loader_on_the_cpu(task):
    prep = task / "preprocessed"
    image_dir = prep / PLAN_ID / "imagesTr"
    splits = tpipeline.make_splits([p.stem for p in image_dir.glob("*.npz")],
                                   prep / "splits_final.pkl")
    train, _ = tpipeline.build_loaders(load_plan(prep / f"{PLAN_ID}.pkl"), image_dir, splits, 0,
                                       2, device="cpu")
    assert type(train) is tloader.PatchLoader
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipeline.build_loaders(load_plan(prep / f"{PLAN_ID}.pkl"), image_dir, splits, 0, 2)


class _Budget(Exception):
    pass


def _jax_budget(monkeypatch, task, plan, batch_size):
    """The pool budget the JAX ``run_train`` hands ``build_loaders``."""
    def capture(*args, **kwargs):
        raise _Budget(kwargs["pool_hbm_budget"])

    monkeypatch.setattr(jpipeline, "load_pickle", lambda path: plan)
    monkeypatch.setattr(jpipeline, "build_loaders", capture)
    with pytest.raises(_Budget) as info:
        jpipeline.run_train(task, task / "jax_models", trainer_overrides={
            "batch_size": batch_size}, model_overrides=TINY_MODEL)
    return info.value.args[0]


@pytest.mark.parametrize("compiled,batch,env", [
    (0, 2, None),  # no compiled figure: 4 GiB
    (9 * 1024**3, 2, None),  # capped by what the step leaves
    (2 * 1024**3, 32, None),  # the step's figure scaled up to a larger batch
    (15 * 1024**3, 2, None),  # nothing left: the 512 MiB floor
    (9 * 1024**3, 2, str(3 * 74 * 1024**2)),  # NNDET_POOL_BYTES wins
])
def test_pool_budget_matches_jax(monkeypatch, task, compiled, batch, env):
    if env is None:
        monkeypatch.delenv("NNDET_POOL_BYTES", raising=False)
    else:
        monkeypatch.setenv("NNDET_POOL_BYTES", env)
    jplan = dataclasses.replace(jax_plan(task), mem_compiled_bytes=compiled)
    want = _jax_budget(monkeypatch, task, jplan, batch)
    plan = dataclasses.replace(load_plan(task / "preprocessed" / f"{PLAN_ID}.pkl"),
                               mem_compiled_bytes=compiled)
    assert tpipeline.pool_budget(plan, batch, V5E_HBM_BYTES) == want

    # the port's run_train hands build_loaders the same figure
    def capture(*args, **kwargs):
        raise _Budget(kwargs["pool_hbm_budget"])

    monkeypatch.setattr(tpipeline, "build_loaders", capture)
    monkeypatch.setattr(tpipeline, "device_memory_bytes", lambda dev: V5E_HBM_BYTES)
    monkeypatch.setattr("nndetection_tpu_torch.planning.planner.load_plan", lambda path: plan)
    with pytest.raises(_Budget) as info:
        tpipeline.run_train(task, task / "port_models", trainer_overrides={"batch_size": batch},
                            model_overrides=TINY_MODEL, device="cpu")
    assert info.value.args[0] == want


# ------------------------------------------------------------ train a fold
def test_run_train_writes_its_files_and_resumes(task, tmp_path):
    logged = []
    out = tpipeline.run_train(task, tmp_path / "models", fold=0,
                              trainer_overrides=TINY_TRAINER, model_overrides=TINY_MODEL,
                              stop_after_epoch=0, log_fn=lambda e, m: logged.append((e, m)),
                              device="cpu")
    assert out == tmp_path / "models" / "fold0"
    for name in ("plan.pkl", "model_last.ckpt", "metrics.jsonl", "params.json", "run_meta.json"):
        assert (out / name).exists(), name
    assert dataclasses.asdict(load_plan(out / "plan.pkl")) == dataclasses.asdict(jax_plan(task))
    meta = json.loads((out / "run_meta.json").read_text())
    assert meta["torch_version"] == torch.__version__ and meta["device"] == "cpu"
    params = json.loads((out / "params.json").read_text())
    assert params["module"] == "RetinaUNetV001" and params["batch_size"] == 2
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0] and [e for e, _ in logged] == [0]
    assert np.isfinite(rows[0]["train_total"]) and rows[0]["steps"] == 2
    assert "mAP_IoU_0.10_0.50_0.05_MaxDet_100" in rows[0]
    first = torch.load(out / "model_last.ckpt", weights_only=True)
    assert first["extra"]["epoch"] == 0 and first["step"] == 2

    tpipeline.run_train(task, tmp_path / "models", fold=0, trainer_overrides=TINY_TRAINER,
                        model_overrides=TINY_MODEL, resume=True, device="cpu")
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    last = torch.load(out / "model_last.ckpt", weights_only=True)
    assert last["extra"]["epoch"] == 1 and last["step"] == 4
    assert any(not torch.equal(last["params"][k], first["params"][k]) for k in first["params"])


def test_run_train_stays_on_one_process(monkeypatch, task, tmp_path):
    """A job that cannot form fails and leaves no process group: a
    coordinator nobody serves fails within the group's timeout (not a
    hang), a coordinator without a process count raises, and a plan that
    partitions its patch over 2 devices raises in one process. Multi-process
    runs: ``test_torch_distributed.py``, ``test_torch_spatial.py``."""
    import socket
    import time

    import torch.distributed as dist

    from nndetection_tpu_torch.parallel import distributed

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there
    monkeypatch.setattr(distributed, "DEFAULT_TIMEOUT_MIN", 0.05)
    monkeypatch.setenv("NNDET_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("NNDET_NUM_PROCESSES", "2")
    monkeypatch.setenv("NNDET_PROCESS_ID", "1")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        tpipeline.run_train(task, tmp_path, device="cpu")
    assert time.monotonic() - t0 < 60 and not dist.is_initialized()
    monkeypatch.delenv("NNDET_NUM_PROCESSES")
    with pytest.raises(RuntimeError, match="NNDET_NUM_PROCESSES"):
        tpipeline.run_train(task, tmp_path, device="cpu")
    monkeypatch.delenv("NNDET_COORDINATOR")
    plan = dataclasses.replace(load_plan(task / "preprocessed" / f"{PLAN_ID}.pkl"), n_model=2)
    with pytest.raises(RuntimeError, match="model-axis of 2"):
        tpipeline.mesh_for_plan(plan, 2, "cpu")
    assert not dist.is_initialized() and not (tmp_path / "fold0").exists()


# ------------------------------------------------------ dataset info, YAML
def test_dataset_info_matches_jax(task):
    got = tdataset.DatasetInfo.from_file(task / "dataset.yaml")
    want = jdataset.DatasetInfo.from_file(task / "dataset.yaml")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_classes, got.num_modalities) == (want.num_classes, want.num_modalities)
    assert tdataset.get_task_dir("000", task.parent) == jdataset.get_task_dir("000", task.parent)
    for name in ("case_7_0000.nii.gz", "a_b_0001.nii"):
        assert tdataset.case_id_from_image(name) == jdataset.case_id_from_image(name)
    for name in ("case_7.nii.gz", "case_7.json"):
        assert tdataset.case_id_from_label(name) == jdataset.case_id_from_label(name)
    with pytest.raises(ValueError):
        tdataset.case_id_from_image("case_7.nii.gz")


def test_yaml_round_trip_with_jax(tmp_path):
    """What either package writes, the other reads (``dataset.yaml`` as
    ``data/example.py`` and the LIDC converter write it)."""
    docs = [{"task": "Task000D3_Example", "name": "Example", "dim": 3, "target_class": None,
             "test_labels": True, "labels": {"0": "square", "1": "hollow_square"},
             "modalities": {"0": "synthetic"}},
            {"task": "Task012_LIDC", "dim": 3, "modalities": {0: "CT"},
             "labels": {0: "benign", 1: "malignant"}, "target_class": None}]
    for i, doc in enumerate(docs):
        tio.save_yaml(doc, tmp_path / f"port{i}.yaml")
        jio.save_yaml(doc, tmp_path / f"jax{i}.yaml")
        assert (tmp_path / f"port{i}.yaml").read_text() == (tmp_path / f"jax{i}.yaml").read_text()
        assert tio.load_yaml(tmp_path / f"jax{i}.yaml") == jio.load_yaml(
            tmp_path / f"port{i}.yaml") == doc


def test_npz_and_json_helpers(tmp_path):
    np.savez(tmp_path / "a.npz", data=np.arange(6).reshape(2, 3), seg=np.ones(2))
    got = tio.load_npz_looped(tmp_path / "a.npz", keys=["data"])
    np.testing.assert_array_equal(got["data"], np.arange(6).reshape(2, 3))
    assert set(tio.load_npz_looped(tmp_path / "a.npz")) == {"data", "seg"}
    with pytest.raises(RuntimeError, match="failed to load"):
        tio.load_npz_looped(tmp_path / "missing.npz", num_tries=1)
    tio.save_json({"a": np.int64(3)}, tmp_path / "a.json")
    assert tio.load_json(tmp_path / "a.json") == jio.load_json(tmp_path / "a.json") == {"a": 3}
