"""Checkpoint loading of the PyTorch port (``inference/loading.py``): its own
``torch.save`` checkpoints, and pickles written by the JAX package's
``Trainer.save_checkpoint``, read in a process that cannot import JAX, flax,
optax, ml_dtypes or the JAX package; their predictions equal the JAX
predictor's. The SWA rule both ways, and both directory layouts."""
import json
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from nndetection_tpu.inference.predictor import ModelBundle as JaxBundle
from nndetection_tpu.inference.predictor import Predictor as JaxPredictor
from nndetection_tpu.train import trainer as jtrainer
from nndetection_tpu_torch.inference import loading
from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_predictor import CASE_TOL, _sorted, spread_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jax.numpy", "jaxlib", "flax", "flax.core", "flax.core.frozen_dict",
           "flax.linen", "optax", "ml_dtypes", "nndetection_tpu", "sklearn")


def port_checkpoint(path, swa_count, use_swa):
    """A port checkpoint whose SWA average differs from the weights."""
    trainer = Trainer(torch_cfg(), TrainerConfig(batch_size=2), "cpu")
    state = trainer.init_state(rng_seed=3)
    state.swa_params = {k: v * 2 for k, v in state.swa_params.items()}
    state.swa_count = swa_count
    trainer.save_checkpoint(state, path, extra={"use_swa": use_swa})
    return state


@pytest.mark.parametrize("swa_count,use_swa,takes_swa", [(2, True, True), (2, False, False),
                                                         (0, True, False)])
def test_port_checkpoint_round_trip(tmp_path, swa_count, use_swa, takes_swa):
    state = port_checkpoint(tmp_path / "fold3" / "model_last.ckpt", swa_count, use_swa)
    bundle = loading.load_model_bundle(tmp_path / "fold3" / "model_last.ckpt")
    assert bundle.name == "fold3" and bundle.cfg == torch_cfg()
    want = state.swa_params if takes_swa else state.model.state_dict()
    assert set(bundle.params) == set(state.model.state_dict())
    for k, v in bundle.params.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def jax_checkpoint(path, params, swa_params, swa_count, use_swa):
    """A checkpoint written by the JAX ``Trainer.save_checkpoint``: optax
    state, SWA average and the JAX config pickled as the JAX package pickles
    them."""
    jt = jtrainer.Trainer(jax_cfg(), jtrainer.TrainerConfig(batch_size=2))
    state = jtrainer.TrainState(params=params, opt_state=jt.tx.init(params),
                                step=np.int32(7), swa_params=swa_params,
                                swa_count=np.int32(swa_count))
    jt.save_checkpoint(state, path, extra={"use_swa": use_swa})


def test_jax_checkpoint_predicts_as_jax_without_jax(tmp_path):
    """The SWA average is the scaled-classifier parameters, the trained
    weights the unscaled ones: loading the wrong tree would change the
    predictions."""
    swa = spread_params(100.0)
    trained = spread_params(1.0)
    ckpt = tmp_path / "fold0" / "model_last.ckpt"
    jax_checkpoint(ckpt, trained, swa, swa_count=3, use_swa=True)
    case = np.random.RandomState(1).standard_normal((1, 48, 48, 48)).astype(np.float32)
    np.save(tmp_path / "case.npy", case)
    want = _sorted(JaxPredictor([JaxBundle(cfg=jax_cfg(), params=swa)], tta=False).predict_case(case))

    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        from nndetection_tpu_torch.inference.loading import load_all_models
        from nndetection_tpu_torch.inference.predictor import Predictor
        bundles = load_all_models({str(tmp_path)!r})
        res = Predictor(bundles, tta=False, device="cpu").predict_case(
            np.load({str(tmp_path / "case.npy")!r}))
        np.savez({str(tmp_path / "got.npz")!r}, **{{k: res[k] for k in
                 ("pred_boxes", "pred_scores", "pred_labels")}})
        assert not any(k.split(".")[0] in ("jax", "flax", "optax", "ml_dtypes", "nndetection_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print(len(bundles), bundles[0].name)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "fold0"]
    with np.load(tmp_path / "got.npz") as f:
        got = _sorted({k: f[k] for k in f.files})
    assert len(want["pred_scores"]) > 0
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=CASE_TOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=0, atol=CASE_TOL)


@pytest.mark.parametrize("swa_count,use_swa,takes_swa", [(2, True, True), (2, False, False),
                                                         (0, True, False)])
def test_jax_checkpoint_swa_rule(tmp_path, swa_count, use_swa, takes_swa):
    trained = spread_params(1.0)
    swa = spread_params(3.0)
    jax_checkpoint(tmp_path / "model_last.ckpt", trained, swa, swa_count, use_swa)
    bundle = loading.load_model_bundle(tmp_path / "model_last.ckpt", name="m")
    assert bundle.name == "m" and bundle.cfg == torch_cfg()
    want = (swa if takes_swa else trained)["params"]["classifier"]["out"]["kernel"]
    got = bundle.params["classifier.out.weight"].numpy()
    np.testing.assert_array_equal(got, np.transpose(want, (4, 3, 0, 1, 2)))


def test_jax_checkpoint_with_ml_dtypes_names_the_field(tmp_path):
    """An array that needs ``ml_dtypes`` in a kept field raises and names the
    field; in the dropped optimizer state it is never read."""
    params = jax.tree.map(lambda v: v, spread_params(1.0))
    payload = {"params": params, "swa_params": params, "swa_count": 0, "extra": {},
               "model_cfg": jax_cfg(),
               "opt_state": (np.zeros(3, ml_dtypes.bfloat16),)}
    with open(tmp_path / "ok.ckpt", "wb") as f:
        pickle.dump(payload, f)
    assert len(loading.load_model_bundle(tmp_path / "ok.ckpt").params) > 0
    params["params"]["classifier"]["out"]["bias"] = np.zeros(27, ml_dtypes.bfloat16)
    with open(tmp_path / "bf16.ckpt", "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="params/params/classifier/out/bias.*ml_dtypes"):
        loading.load_model_bundle(tmp_path / "bf16.ckpt")


def test_both_layouts_and_a_missing_directory(tmp_path):
    for fold in (0, 2):
        port_checkpoint(tmp_path / "folds" / f"fold{fold}" / "model_last.ckpt", 0, False)
    port_checkpoint(tmp_path / "folds" / "fold1" / "model_best.ckpt", 0, False)
    bundles = loading.load_all_models(tmp_path / "folds")
    assert [b.name for b in bundles] == ["fold0", "fold2"]
    assert [b.name for b in loading.load_all_models(tmp_path / "folds", identifier="best")] == [
        "fold1"]

    cons = tmp_path / "cons"
    port_checkpoint(cons / "consolidated" / "model_fold1.ckpt", 0, False)
    jax_checkpoint(cons / "consolidated" / "model_fold0.ckpt", spread_params(1.0),
                   spread_params(1.0), 0, False)
    port_checkpoint(cons / "fold4" / "model_last.ckpt", 0, False)
    assert [b.name for b in loading.load_all_models(cons)] == ["model_fold0", "model_fold1"]

    # an empty consolidated/ falls through to the folds
    (tmp_path / "folds" / "consolidated").mkdir()
    assert len(loading.load_all_models(tmp_path / "folds")) == 2

    assert loading.get_latest_model(tmp_path / "folds" / "fold1").name == "model_best.ckpt"
    assert loading.load_final_model(tmp_path / "folds" / "fold2").name == "fold2"
    with pytest.raises(FileNotFoundError):
        loading.load_all_models(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        loading.get_latest_model(tmp_path / "missing")
    json.dumps([b.cfg.to_dict() for b in bundles])
