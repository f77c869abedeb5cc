"""The port's trainer against the JAX package's: one full train step of the
tiny float32 model (losses, the gradient of every parameter, the parameters
after the optimizer update) for the ``no_sampler`` and ``hnm`` heads under
the ``plane_sub:8`` and ``two_pass`` instance-norm schedules, with the same
flax parameters on both sides and the JAX sampler draws injected; the
learning-rate schedule, the weight-decay mask, the non-finite guard, SWA,
checkpoints, resume, a loss that falls on a fixed batch, and the validation
epoch with a ``BoxEvaluator`` (the JAX ``val_epoch``'s metrics; ``fit``
then writes ``model_best.ckpt``). The
``two_pass`` case of the full step is in ``test_torch_train_step_two_pass.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu.evaluator.det import BoxEvaluator as JaxBoxEvaluator
from nndetection_tpu.train import trainer as jtrainer
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.evaluator.det import BoxEvaluator
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.train.trainer import (
    MAX_CONSECUTIVE_ERRORS,
    Trainer,
    TrainerConfig,
    decay_mask,
    lr_schedule,
)
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_train_loss import (
    inject_draws,
    jax_draws,
    jax_targets,
    numpy_params,
    pool_cap,
)

torch.set_num_threads(1)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4  # times max|g| of each tensor: a float32 backward through the whole model
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
# no warm-up: the first update runs at the full learning rate
STEP_TCFG = TrainerConfig(batch_size=2, warm_iterations=0, max_epochs=1,
                          num_train_batches_per_epoch=10, swa_epochs=0)
HEADS = ("no_sampler", "hnm")


def jax_tcfg(tcfg: TrainerConfig):
    return jtrainer.TrainerConfig(**dataclasses.asdict(tcfg))


@functools.lru_cache(maxsize=None)
def _jax_train_steps(schedule):
    """Per head: losses, clipped gradients and updated parameters of one JAX
    step (``jax.grad`` of ``train_step_loss`` and the optax chain of
    ``make_optimizer``). One compiled program serves both heads: the forward
    once, and the model's VJP vmapped over the two heads' cotangents. The
    instance-norm schedule is read while it is traced."""
    cfg = jax_cfg(exact_topk=True)
    params = numpy_params()
    anchors, per_level = cfg.anchors()
    targets = jax_targets(2)
    key = jax.random.PRNGKey(4)

    def both(p, batch, key):
        preds, vjp_fn = jax.vjp(lambda q: JaxRetinaUNet(cfg).apply(q, batch["images"]), p)
        losses, cotangents = [], []
        for head in HEADS:
            c = dataclasses.replace(cfg, head_type=head)

            def loss_fn(pr):
                out = j_train_step_loss(c, pr, jnp.asarray(anchors), per_level, batch, key)
                return out["cls"] + out["reg"] + out["seg_ce"] + out["seg_dice"], out

            (_, out), ct = jax.value_and_grad(loss_fn, has_aux=True)(preds)
            losses.append(out)
            cotangents.append(ct)
        stacked = jax.tree.map(lambda *v: jnp.stack(v), *cotangents)
        return losses, jax.vmap(vjp_fn)(stacked)[0]

    losses, grads = jax.jit(both)(params, {k: jnp.asarray(v) for k, v in targets.items()}, key)
    tx, _ = jtrainer.make_optimizer(jax_tcfg(STEP_TCFG))
    clip = optax.clip_by_global_norm(STEP_TCFG.grad_clip_norm)

    @jax.jit
    def update(g):
        updates, _ = tx.update(g, tx.init(params), params)
        return clip.update(g, None)[0], optax.apply_updates(params, updates)

    out = {}
    for i, head in enumerate(HEADS):
        out[head] = jax.device_get((losses[i], *update(jax.tree.map(lambda v: v[i], grads))))
    return targets, key, out


def check_train_step_matches_jax(monkeypatch, head, schedule):
    """One ``Trainer.train_step`` against the JAX step: losses, the clipped
    gradient of every parameter, and every parameter after the update."""
    if schedule is None:
        monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    else:
        monkeypatch.setenv("NNDET_IN_STATS", schedule)
    monkeypatch.delenv("NNDET_IN_IMPL", raising=False)
    targets, key, results = _jax_train_steps(schedule)
    want_losses, want_grads, want_params = results[head]

    cfg = torch_cfg(head_type=head)
    trainer = Trainer(cfg, STEP_TCFG, device="cpu")
    model = RetinaUNet(cfg)
    state = trainer.init_state(params=bridge.state_dict_from_flax(numpy_params(), model))
    if head != "no_sampler":
        inject_draws(monkeypatch, jax_draws(key, 2, len(cfg.anchors()[0]), pool_cap(cfg)))
    losses = trainer.train_step(state, trainer._to_device(targets), torch.Generator())

    assert want_losses["num_pos"] > 0
    for k in ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg"):
        np.testing.assert_allclose(float(losses[k]), float(want_losses[k]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    # on the CPU the step leaves the clipped gradients on the parameters
    grads = bridge.state_dict_from_flax(want_grads, model)
    for name, p in state.model.named_parameters():
        w = grads[name]
        torch.testing.assert_close(p.grad, w, rtol=0, atol=GRAD_TOL * float(w.abs().max()),
                                   msg=name)
    new = bridge.state_dict_from_flax(want_params, model)
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(p, new[name], rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=name)
    assert (state.step, state.opt_count, state.notfinite_count) == (1, 1, 0)


@pytest.mark.parametrize("head", HEADS)
def test_train_step_matches_jax(monkeypatch, head):
    """Under the default ``plane_sub:8`` schedule (``two_pass``:
    ``test_torch_train_step_two_pass.py``, a file of its own so that each
    file's JAX compiles fit its time)."""
    check_train_step_matches_jax(monkeypatch, head, None)


def test_lr_schedule_matches_jax():
    tcfg = TrainerConfig(warm_iterations=10, max_epochs=3, num_train_batches_per_epoch=20,
                         warm_lr=1e-6, initial_lr=0.01)
    _, jsched = jtrainer.make_optimizer(jax_tcfg(tcfg))
    sched = lr_schedule(tcfg)
    steps = [0, 1, 5, 9, 10, 11, 30, 59, 60, 61, 75, 79, 80, 99]  # warm-up, poly, SWA cycles
    got = [sched(s) for s in steps]
    want = [float(jsched(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] < got[2] < got[3] and got[5] > got[7]
    assert got[8] == pytest.approx(0.001) and got[12] == pytest.approx(0.001)


def test_decay_mask_matches_jax():
    """The JAX mask (flax ``kernel`` leaves) mapped through the bridge equals
    the port's mask by module type: conv weights decay, norm weights, biases
    and ``scales`` do not."""
    params = numpy_params()
    jmask = jtrainer._decay_mask(params)
    as_arrays = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32), params, jmask)
    model = RetinaUNet(torch_cfg())
    want = {k: bool(v.all()) for k, v in bridge.state_dict_from_flax(as_arrays, model).items()}
    got = decay_mask(model)
    assert got == want
    assert got["encoder.stage0.ConvNormAct_0.Conv_0.weight"]
    assert got["classifier.out.weight"] and not got["classifier.out.bias"]
    assert not got["encoder.stage0.ConvNormAct_0.InstanceNorm_0.weight"]
    assert not got["regressor.scales"]
    groups = Trainer(torch_cfg(), STEP_TCFG, "cpu").init_state().optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [STEP_TCFG.weight_decay, 0.0]
    assert len(groups[0]["params"]) == sum(got.values())


def test_nonfinite_steps_are_skipped_as_optax_does():
    """A non-finite gradient leaves parameters, momentum and count alone; the
    ``MAX_CONSECUTIVE_ERRORS + 1``-th in a row is applied, as
    ``optax.apply_if_finite`` applies it."""
    tx = optax.apply_if_finite(optax.sgd(0.1), max_consecutive_errors=MAX_CONSECUTIVE_ERRORS)
    p = jnp.ones(2)
    opt_state = tx.init(p)
    applied = []
    for _ in range(MAX_CONSECUTIVE_ERRORS + 1):
        upd, opt_state = tx.update(jnp.full(2, jnp.nan), opt_state, p)
        applied.append(bool(jnp.isnan(upd).any()))
    assert applied == [False] * MAX_CONSECUTIVE_ERRORS + [True]

    trainer = Trainer(torch_cfg(), STEP_TCFG, "cpu")
    state = trainer.init_state()
    params = list(state.model.parameters())
    for p_ in params:
        p_.grad = torch.ones_like(p_)
    assert trainer._apply_update(state)  # one good update: momentum buffers exist
    before = [p_.detach().clone() for p_ in params]
    momentum = [state.optimizer.state[p_]["momentum_buffer"].clone() for p_ in params]
    got = []
    for _ in range(MAX_CONSECUTIVE_ERRORS + 1):
        for p_ in params:
            p_.grad = torch.ones_like(p_)
        params[3].grad[0] = float("inf")
        got.append(trainer._apply_update(state))
        if not got[-1]:
            assert all(torch.equal(a, b) for a, b in zip(before, params))
            assert all(torch.equal(m, state.optimizer.state[p_]["momentum_buffer"])
                       for m, p_ in zip(momentum, params))
    assert got == applied
    assert state.opt_count == 2 and state.notfinite_count == MAX_CONSECUTIVE_ERRORS + 1


def test_nonfinite_batch_is_skipped_in_the_epoch():
    cfg, tcfg, batch = micro()
    trainer = Trainer(cfg, tcfg, "cpu")
    state = trainer.init_state()
    bad = dict(batch, images=np.full_like(batch["images"], np.nan))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = trainer.train_epoch(state, [bad], 0)
    assert metrics["train_nonfinite_steps"] == 1 and metrics["train_first_nonfinite_step"] == 0
    assert state.step == 1 and state.opt_count == 0
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


def test_swa_average():
    trainer = Trainer(torch_cfg(), STEP_TCFG, "cpu")
    state = trainer.init_state()
    snapshots = []
    for i in range(3):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(0.5 * (i + 1))
        snapshots.append({n: p.detach().clone() for n, p in state.model.named_parameters()})
        trainer.update_swa(state)
    assert state.swa_count == 3
    for name in snapshots[0]:
        want = sum(s[name] for s in snapshots) / 3
        torch.testing.assert_close(state.swa_params[name], want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------- loop, checkpoints
def micro(b: int = 2, seed: int = 0):
    """A micro configuration (16^3 patch, 3 stages) and one prepared batch."""
    cfg = torch_cfg(conv_kernels=((3, 3, 3),) * 3, strides=((2, 2, 2),) * 2,
                    decoder_levels=(1, 2), patch_size=(16, 16, 16),
                    anchor_width=((6.0, 10.0),) * 2, anchor_height=((6.0, 10.0),) * 2,
                    anchor_depth=((6.0, 10.0),) * 2, start_channels=4, max_channels=8,
                    fpn_channels=8, head_channels=8, topk_candidates=64, detections_per_img=8)
    tcfg = TrainerConfig(batch_size=b, warm_iterations=2, max_epochs=2,
                         num_train_batches_per_epoch=1, swa_epochs=0)
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, 16, 16, 16), np.int32)
    seg[:, 4:10, 4:10, 4:10] = 1
    table = np.full((b, 4), -1, np.int32)
    table[:, 0] = 0
    images = rng.standard_normal((b, 16, 16, 16, 1)).astype(np.float32)
    batch = prepare_targets(torch.from_numpy(images), torch.from_numpy(seg), torch.from_numpy(table))
    return cfg, tcfg, {k: v.numpy() for k, v in batch.items()}


def test_checkpoint_round_trip(tmp_path):
    cfg, tcfg, batch = micro()
    trainer = Trainer(cfg, tcfg, "cpu")
    state = trainer.init_state()
    state, _ = trainer.train_epoch(state, [batch, batch], 0)
    trainer.update_swa(state)
    trainer.save_checkpoint(state, tmp_path / "ckpt.pt", extra={"epoch": 3})
    back = Trainer(cfg, tcfg, "cpu").load_checkpoint(tmp_path / "ckpt.pt")
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(back.model.state_dict()[k], v, rtol=0, atol=0)
    for k, v in state.swa_params.items():
        torch.testing.assert_close(back.swa_params[k], v, rtol=0, atol=0)
    for p, q in zip(state.model.parameters(), back.model.parameters()):
        torch.testing.assert_close(back.optimizer.state[q]["momentum_buffer"],
                                   state.optimizer.state[p]["momentum_buffer"], rtol=0, atol=0)
    assert (back.step, back.opt_count, back.swa_count) == (2, 2, 1)
    payload = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    assert payload["schema_version"] == 1 and payload["extra"] == {"epoch": 3}
    assert payload["model_cfg"] == cfg.to_dict()
    torch.save({"params": {}}, tmp_path / "stale.pt")
    with pytest.raises(ValueError, match="missing"):
        trainer.load_checkpoint(tmp_path / "stale.pt")


def test_fit_resume_matches_uninterrupted(tmp_path):
    """Two epochs straight equal one epoch, a checkpoint, and a fresh
    trainer resuming the second."""
    cfg, tcfg, batch = micro()
    straight = Trainer(cfg, tcfg, "cpu").fit(train_iter_fn=lambda e: [batch])

    first = Trainer(cfg, tcfg, "cpu")
    st, _ = first.train_epoch(first.init_state(), [batch], 0)
    first.save_checkpoint(st, tmp_path / "model_last.ckpt", {"epoch": 0})
    second = Trainer(cfg, tcfg, "cpu")
    resumed = second.fit(train_iter_fn=lambda e: [batch], start_epoch=1,
                         state=second.load_checkpoint(tmp_path / "model_last.ckpt"))
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


def test_loss_decreases_on_fixed_batch(tmp_path):
    cfg, tcfg, batch = micro(seed=1)
    tcfg = dataclasses.replace(tcfg, max_epochs=1, num_train_batches_per_epoch=8, swa_epochs=1)
    trainer = Trainer(cfg, tcfg, "cpu", output_dir=tmp_path)
    logs = []
    state = trainer.fit(train_iter_fn=lambda e: [batch] * 4, log_fn=lambda e, m: logs.append(m))
    first = Trainer(cfg, tcfg, "cpu")
    totals = []
    st = first.init_state()
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        totals.append(float(first.train_step(st, first._to_device(batch), gen)["total"]))
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    assert min(m["train_num_pos"] for m in logs) > 0
    # fit ran a regular and an SWA epoch, and wrote the last checkpoint
    assert len(logs) == 2 and state.swa_count == 1 and (tmp_path / "model_last.ckpt").exists()
    val = trainer.val_epoch(state, [batch], 0)
    assert np.isfinite(val["val_cls"]) and val["val_detections_per_image"] <= 8


def test_unported_options_raise():
    """The augmentation is ported (``test_torch_trainer_raw.py``), and so is
    the device patch pool (``test_torch_pool.py``); a pool asked for on a
    card that is not there raises instead of keeping the cases on the
    host."""
    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.pipeline import build_loaders

    aug = get_augmentation("base_more", torch_cfg().patch_size)
    assert Trainer(torch_cfg(), STEP_TCFG, "cpu", augment_cfg=aug).augment_cfg == aug
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_loaders(None, "unused", [], 0, 2, device_pool=True, device="cuda")


# ------------------------------------------------------------- evaluation
EVAL_TOL = 1e-6


def test_val_epoch_evaluator_matches_jax():
    """``val_epoch`` with a ``BoxEvaluator``, the same flax parameters and
    the same two prepared batches on both sides: the evaluator's metric
    keys and values equal the JAX ``Trainer.val_epoch``'s within 1e-6 (its
    losses are held by the train-step tests; the hard-negative draws
    differ by generator)."""
    cfg = jax_cfg(exact_topk=True)
    tcfg = TrainerConfig(batch_size=2)
    batches = [jax_targets(0), jax_targets(1)]
    jt = jtrainer.Trainer(cfg, jax_tcfg(tcfg))
    params = numpy_params()
    jstate = jtrainer.TrainState(params=params, opt_state=None, step=None, swa_params=None,
                                 swa_count=None)
    want = jt.val_epoch(jstate, iter(batches), 0, evaluator=JaxBoxEvaluator.create(["c"]))

    trainer = Trainer(torch_cfg(), tcfg, "cpu")
    state = trainer.init_state(params=bridge.state_dict_from_flax(params, RetinaUNet(torch_cfg())))
    got = trainer.val_epoch(state, batches, 0, evaluator=BoxEvaluator.create(["c"]))

    # the port also reports its detections per image
    assert set(got) == set(want) | {"val_detections_per_image"}
    evaluated = [k for k in want if not k.startswith("val_")]
    assert tcfg.monitor_key in evaluated and len(evaluated) >= 4
    for k in evaluated:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=EVAL_TOL, err_msg=k)
    assert any(want[k] > 0 for k in evaluated)


def test_fit_with_evaluator_writes_model_best(tmp_path):
    cfg, tcfg, batch = micro()
    trainer = Trainer(cfg, tcfg, "cpu", output_dir=tmp_path)
    logs = []
    trainer.fit(train_iter_fn=lambda e: [batch], val_iter_fn=lambda e: [batch],
                evaluator_fn=lambda: BoxEvaluator.create(["c"]),
                log_fn=lambda e, m: logs.append(m))
    assert all(np.isfinite(m[tcfg.monitor_key]) for m in logs)
    best = torch.load(tmp_path / "model_best.ckpt", weights_only=True)
    scores = [m[tcfg.monitor_key] for m in logs]
    assert best["extra"] == {"epoch": int(np.argmax(scores)), "score": max(scores)}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    cfg, tcfg, batch = micro()
    cpu, dev = Trainer(cfg, tcfg, "cpu"), Trainer(cfg, tcfg, "cuda")
    s_cpu, s_dev = cpu.init_state(), dev.init_state()
    l_cpu = cpu.train_step(s_cpu, cpu._to_device(batch), torch.Generator().manual_seed(0))
    l_dev = dev.train_step(s_dev, dev._to_device(batch), torch.Generator("cuda").manual_seed(0))
    assert torch.isfinite(l_dev["total"])
    for name, p in s_dev.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    torch.testing.assert_close(l_dev["seg_ce"].cpu(), l_cpu["seg_ce"], rtol=1e-3, atol=1e-3)
