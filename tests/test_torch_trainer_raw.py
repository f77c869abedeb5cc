"""The trainer's raw-batch mode against the JAX ``Trainer``: raw loader
batches (bfloat16 images a voxel taller than the patch on axis 0, int16
instance ids, the class table) through ``no_aug`` on the gather branch
and GT preparation, then one train step and one validation step of the
tiny float32 model, with the JAX sampler draws of the step's loss key
injected; a ``fit`` of two epochs fed by ``build_loaders`` and
``PrefetchIterator`` on the CPU; and a prepared batch passing the
preparation unchanged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.data import aug_presets as JP
from nndetection_tpu.parallel.mesh import make_mesh
from nndetection_tpu.train import trainer as jtrainer
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.data import aug_presets as TP
from nndetection_tpu_torch.data.loader import PrefetchIterator
from nndetection_tpu_torch.evaluator.det import BoxEvaluator
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.pipeline import build_loaders, make_splits
from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_loader import write_cases
from tests.test_torch_train_loss import inject_draws, jax_draws, numpy_params, pool_cap, tiny_batch
from tests.test_torch_trainer import LOSS_ATOL, LOSS_RTOL, STEP_TCFG, jax_tcfg, micro

torch.set_num_threads(1)

HEAD = "hnm"
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg")
RAW_SHAPE = (33, 32, 32)  # the tiny model's patch, one voxel taller on axis 0


def raw_batch(shape=RAW_SHAPE):
    """A loader-format batch: bfloat16 images, int16 ids, int32 table."""
    images, seg, table = tiny_batch(3, 2, shape)
    return {"images": np.asarray(jnp.asarray(images, jnp.bfloat16)),
            "seg_instances": seg.astype(np.int16), "instance_classes": table}


def to_torch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items() if k != "images"}
    out["images"] = torch.from_numpy(batch["images"].astype(np.float32)).to(torch.bfloat16)
    return out


def loss_key(key):
    """The loss key of the JAX step for the step key ``key``: folded with
    the data shard's index 0, the augmentation's half split off."""
    return jax.random.split(jax.random.fold_in(key, 0))[1]


def both_trainers():
    aug = TP.get_augmentation("no_aug", jax_cfg().patch_size)
    jaug = dataclasses.replace(JP.get_augmentation("no_aug", jax_cfg().patch_size),
                               use_mxu_resample=False)
    # one data shard: the whole batch in one loss, as the port computes it
    jt = jtrainer.Trainer(jax_cfg(head_type=HEAD, exact_topk=True), jax_tcfg(STEP_TCFG),
                          mesh=make_mesh(n_data=1), augment_cfg=jaug)
    params = jax.tree.map(jnp.asarray, numpy_params())
    jstate = jtrainer.TrainState(params=params, opt_state=jt.tx.init(params),
                                 step=jnp.zeros((), jnp.int32),
                                 swa_params=jax.tree.map(jnp.copy, params),
                                 swa_count=jnp.zeros((), jnp.int32))
    cfg = torch_cfg(head_type=HEAD)
    trainer = Trainer(cfg, STEP_TCFG, "cpu", augment_cfg=aug)
    state = trainer.init_state(params=bridge.state_dict_from_flax(numpy_params(), RetinaUNet(cfg)))
    return jt, jstate, trainer, state, cfg


def test_raw_train_step_matches_jax(monkeypatch):
    jt, jstate, trainer, state, cfg = both_trainers()
    batch = raw_batch()
    # the targets of the raw batch, as both trainers prepare them
    step_key = jax.random.split(jax.random.PRNGKey(STEP_TCFG.seed * 1000))[1]
    k_aug = jax.random.split(jax.random.fold_in(step_key, 0))[0]
    want = jt._prepare({k: jnp.asarray(v) for k, v in batch.items()}, k_aug, train=True)
    got = trainer._prepare(to_torch(batch), torch.Generator(), train=True)
    for k in ("gt_boxes", "gt_classes", "gt_mask", "seg"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]),
                               rtol=1e-4, atol=1e-4)
    assert got["gt_mask"].any()

    _, jm = jt.train_epoch(jstate, [batch], 0)
    inject_draws(monkeypatch, jax_draws(loss_key(step_key), 2, len(cfg.anchors()[0]),
                                        pool_cap(cfg)))
    _, m = trainer.train_epoch(state, [to_torch(batch)], 0)
    assert jm["train_num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(m[f"train_{k}"], jm[f"train_{k}"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", [(32, 32, 32), RAW_SHAPE])
def test_raw_val_step_matches_jax(monkeypatch, shape):
    """At the patch, and centre-cropped from a taller batch."""
    jt, jstate, trainer, state, cfg = both_trainers()
    batch = raw_batch(shape)
    jm = jt.val_epoch(jstate, [batch], 0)
    step_key = jax.random.split(jax.random.PRNGKey(999))[1]
    inject_draws(monkeypatch, jax_draws(loss_key(step_key), 2, len(cfg.anchors()[0]),
                                        pool_cap(cfg)))
    m = trainer.val_epoch(state, [to_torch(batch)], 0)
    assert jm["val_num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(m[f"val_{k}"], jm[f"val_{k}"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


def test_fit_fed_by_loaders(tmp_path):
    """``build_loaders`` -> ``Trainer(augment_cfg=base_more)`` -> ``fit``:
    two epochs through ``PrefetchIterator``, both checkpoints written."""
    cfg, tcfg, _ = micro()
    tcfg = dataclasses.replace(tcfg, num_train_batches_per_epoch=2, num_val_batches_per_epoch=1)
    write_cases(tmp_path / "imagesTr", [(24, 30, 28), (30, 26, 26), (20, 34, 30),
                                        (28, 28, 24), (26, 24, 32)], seed=2, classes=1)
    splits = make_splits([f"case_{i:03d}" for i in range(5)], tmp_path / "splits_final.pkl")
    plan = type("Plan", (), dict(patch_size=cfg.patch_size, max_instances_per_patch=4))
    aug = TP.get_augmentation("base_more", cfg.patch_size)
    train_loader, val_loader = build_loaders(plan, tmp_path / "imagesTr", splits, 0, 2,
                                             aug_cfg=aug, device="cpu")
    assert train_loader.patch_size == (32, 32, 32)
    trainer = Trainer(cfg, tcfg, "cpu", output_dir=tmp_path / "fold0", augment_cfg=aug)
    logs = []
    state = trainer.fit(
        train_iter_fn=lambda e: PrefetchIterator(train_loader.epoch(2), depth=2),
        val_iter_fn=lambda e: PrefetchIterator(val_loader.epoch(1), depth=2),
        evaluator_fn=lambda: BoxEvaluator.create(["a"]),
        log_fn=lambda e, m: logs.append(m))
    assert state.step == 4 and len(logs) == 2
    for m in logs:
        assert m["steps"] == 2 and m["train_nonfinite_steps"] == 0
        assert all(np.isfinite(m[f"train_{k}"]) for k in ("cls", "reg", "seg_ce", "seg_dice"))
        assert np.isfinite(m["val_cls"]) and tcfg.monitor_key in m
    assert (tmp_path / "fold0" / "model_last.ckpt").exists()
    assert (tmp_path / "fold0" / "model_best.ckpt").exists()


def test_prepared_batch_bypasses_prepare():
    """With an augmentation config a prepared batch is neither augmented nor
    re-targeted: the same step, to the bit, as without the config."""
    cfg, tcfg, batch = micro()
    results = []
    for aug in (None, TP.get_augmentation("insane", cfg.patch_size)):
        trainer = Trainer(cfg, tcfg, "cpu", augment_cfg=aug)
        state = trainer.init_state()
        on_device = trainer._to_device(batch)
        assert trainer._prepare(on_device, torch.Generator(), train=True) is on_device
        state, m = trainer.train_epoch(state, [batch], 0)
        results.append((m, state.model.state_dict()))
    (m0, p0), (m1, p1) = results
    assert all(m0[k] == m1[k] for k in m0 if k.startswith("train_"))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
