"""The port's bfloat16 model against the JAX package's bfloat16 model on the
tiny configuration (``dtype="bfloat16"``, as every LUNA-plan run on the card
is), with the same flax parameters on both sides and the same inputs from a
NumPy seed: the forward (``box_logits``, ``box_deltas``, ``seg_logits``), the
loss and its gradient with respect to the head outputs, and one train step
(the losses, and the gradient of every parameter before the SGD update) for
the ``no_sampler`` and ``hnm`` heads, the JAX sampler draws injected.

Errors are relative L2, ``|got - want| / |want|`` over a whole tensor.

Two findings set what the train step can be held to:

* XLA's CPU backend accumulates a bfloat16 ``reduce_sum`` in bfloat16: the
  sum of 65536 ones is 256 (pinned below). ``jax.grad`` reduces the bias and
  norm-parameter gradients of bfloat16 layers that way, so on the CPU the
  JAX package's head-bias gradients are off by up to 100x. The port, like
  PyTorch on every device, accumulates in float32. The JAX reference here
  runs its jaxpr with every bfloat16 ``reduce_sum`` accumulated in float32
  (:func:`f32_sums`), everything else unchanged.
* The bfloat16 gradient of this model is chaotic in its rounding: moving 10 %
  of the input voxels by one bfloat16 ulp moves the JAX package's own
  per-tensor gradients by a median 0.21 relative L2, and the bfloat16
  gradient lies 0.16 (port) and 0.22 (JAX) from the float32 gradient of the
  same parameters. Two programs that round at slightly different points (the
  packages' convolutions sum in different orders) cannot agree at 5e-2 on the
  whole step. So the loss's own gradient is held at 1e-3 on the same
  predictions, the whole step's losses at 2e-2, and the whole step's
  gradient is held to be no farther from the float32 gradient than the JAX
  package's bfloat16 gradient is."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.extend import core as jcore

from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.models.retina_unet import RetinaUNet, train_step_loss
from nndetection_tpu_torch.train.trainer import LOSS_KEYS, Trainer, TrainerConfig
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_train_loss import (
    inject_draws,
    jax_draws,
    jax_targets,
    numpy_params,
    pool_cap,
)

torch.set_num_threads(1)

FWD_REL = 2e-2  # each forward output (measured 0.0124, 0.0165, 0.0093)
LOSS_REL = 2e-2  # each loss of the whole step (measured at most 0.0122, hnm cls)
# d loss / d outputs on the same bf16 predictions: only the float32 loss
# arithmetic differs (measured <= 1.2e-6)
COTANGENT_REL = 1e-3
STEP_TCFG = TrainerConfig(batch_size=2, warm_iterations=0, max_epochs=1,
                          num_train_batches_per_epoch=10, swa_epochs=0)
HEADS = ("no_sampler", "hnm")
OUTPUTS = ("box_logits", "box_deltas", "seg_logits")


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------ float32 sums for the JAX side
_CALLS = {"pjit": "jaxpr", "closed_call": "call_jaxpr", "custom_jvp_call": "call_jaxpr",
          "custom_vjp_call": "call_jaxpr"}


def _eval(jaxpr, consts, *args):
    """Evaluate ``jaxpr`` with every bfloat16 ``reduce_sum`` accumulated in
    float32 and rounded to bfloat16 once; calls, checkpoints and custom
    derivatives are evaluated inline, every other primitive as it is."""
    env = dict(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    for eqn in jaxpr.eqns:
        vals = [read(v) for v in eqn.invars]
        name, p = eqn.primitive.name, eqn.params
        if name in _CALLS:
            sub = p[_CALLS[name]]
            outs = _eval(sub.jaxpr, sub.consts, *vals)
        elif name == "checkpoint":
            outs = _eval(p["jaxpr"], (), *vals)
        elif name == "reduce_sum" and vals[0].dtype == jnp.bfloat16:
            outs = [lax.reduce_sum_p.bind(vals[0].astype(jnp.float32), **p).astype(jnp.bfloat16)]
        else:
            outs = eqn.primitive.bind(*vals, **p)
            outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def f32_sums(fn):
    """``fn`` with its bfloat16 sums accumulated in float32."""
    def wrapped(*args):
        closed = jax.make_jaxpr(fn)(*args)
        out_tree = jax.tree.structure(jax.eval_shape(fn, *args))
        return jax.tree.unflatten(out_tree, _eval(closed.jaxpr, closed.consts,
                                                  *jax.tree.leaves(args)))
    return wrapped


def test_cpu_backend_sums_bf16_in_bf16():
    """Why the JAX reference needs :func:`f32_sums`: on XLA's CPU backend the
    bias gradient of a bfloat16 layer, a bfloat16 sum of 65536 ones per
    channel, stops growing at 256."""
    x = jnp.asarray(np.random.RandomState(0).uniform(0, 1, (2, 32, 32, 32, 4)), jnp.bfloat16)

    def bias_grad(b, v):
        return jax.grad(lambda c: jnp.sum((v + c.astype(jnp.bfloat16)).astype(jnp.float32)))(b)

    np.testing.assert_array_equal(jax.jit(bias_grad)(jnp.zeros(4), x), 256.0)
    np.testing.assert_array_equal(jax.jit(f32_sums(bias_grad))(jnp.zeros(4), x), 65536.0)


# ---------------------------------------------------------------- forward
@functools.lru_cache(maxsize=None)
def _jax_forward():
    cfg = jax_cfg(dtype="bfloat16")
    x = np.random.RandomState(0).standard_normal((2, *cfg.patch_size, 1)).astype(np.float32)
    want = jax.jit(lambda p, v: JaxRetinaUNet(cfg).apply(p, v))(numpy_params(), x)
    return x, jax.device_get(want)


def bf16_model(**overrides) -> RetinaUNet:
    model = RetinaUNet(torch_cfg(dtype="bfloat16", **overrides))
    model.load_state_dict(bridge.state_dict_from_flax(numpy_params(), model))
    return model


def test_bf16_forward_matches_jax():
    x, want = _jax_forward()
    with torch.inference_mode():
        got = bf16_model().eval()(torch.from_numpy(x))
    for key in OUTPUTS:
        assert got[key].dtype == torch.bfloat16 and want[key].dtype == jnp.bfloat16, key
        assert tuple(got[key].shape) == want[key].shape, key
        err = rel_l2(got[key].float().numpy(), np.asarray(want[key], np.float32))
        assert err <= FWD_REL, (key, err)


# ----------------------------------------------- loss gradient, same inputs
@pytest.mark.parametrize("head", HEADS)
def test_bf16_loss_gradient_matches_jax(monkeypatch, head):
    """The JAX package's bfloat16 predictions through both packages'
    ``train_step_loss``: the losses, and their gradient with respect to the
    three outputs (the cotangents the backward starts from). Pins the BCE's
    gradient at a logit of exactly 0, which the bfloat16 classifier emits."""
    cfg = jax_cfg(exact_topk=True, head_type=head, dtype="bfloat16")
    anchors, per_level = cfg.anchors()
    targets = jax_targets(2)
    key = jax.random.PRNGKey(4)
    preds = jax.device_get(jax.jit(lambda p, v: JaxRetinaUNet(cfg).apply(p, v))(
        numpy_params(), targets["images"]))
    assert (np.asarray(preds["box_logits"], np.float32) == 0).any()

    def loss(pr):
        out = j_train_step_loss(cfg, pr, jnp.asarray(anchors), per_level,
                                {k: jnp.asarray(v) for k, v in targets.items()}, key)
        return sum(out[k] for k in LOSS_KEYS), out

    want_ct, want = jax.device_get(jax.jit(f32_sums(jax.grad(loss, has_aux=True)))(preds))

    tcfg = torch_cfg(head_type=head, dtype="bfloat16")
    if head != "no_sampler":
        inject_draws(monkeypatch, jax_draws(key, 2, len(anchors), pool_cap(tcfg)))
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).requires_grad_()
          for k, v in preds.items()}
    got = train_step_loss(tcfg, tp, torch.from_numpy(anchors), per_level,
                          {k: torch.from_numpy(v) for k, v in targets.items()}, torch.Generator())
    sum(got[k] for k in LOSS_KEYS).backward()
    for k in ("num_pos", "num_neg"):
        assert float(got[k]) == float(want[k]), k
    for k in LOSS_KEYS:
        assert abs(got[k].item() - float(want[k])) <= LOSS_REL * abs(float(want[k])), k
    for k in OUTPUTS:
        assert tp[k].grad.dtype == torch.bfloat16
        err = rel_l2(tp[k].grad.float().numpy(), np.asarray(want_ct[k], np.float32))
        assert err <= COTANGENT_REL, (k, err)


# ------------------------------------------------------------ one train step
@functools.lru_cache(maxsize=None)
def _jax_grads(head, dtype):
    """Losses and raw gradients of one JAX step (bfloat16 sums in float32)."""
    cfg = jax_cfg(exact_topk=True, head_type=head, dtype=dtype)
    anchors, per_level = cfg.anchors()
    targets = jax_targets(2)
    key = jax.random.PRNGKey(4)

    def loss(p):
        preds = JaxRetinaUNet(cfg).apply(p, jnp.asarray(targets["images"]))
        out = j_train_step_loss(cfg, preds, jnp.asarray(anchors), per_level,
                                {k: jnp.asarray(v) for k, v in targets.items()}, key)
        return sum(out[k] for k in LOSS_KEYS), out

    (_, out), grads = jax.jit(f32_sums(jax.value_and_grad(loss, has_aux=True)))(numpy_params())
    return targets, key, jax.device_get(out), jax.device_get(grads)


def flat(grads: dict) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in sorted(grads)])


@pytest.mark.parametrize("head", HEADS)
def test_bf16_train_step_matches_jax(monkeypatch, head):
    """One bfloat16 step: the losses at 2e-2; the gradient before the update
    no farther from the float32 gradient than the JAX package's bfloat16
    gradient is (measured: port 0.160 against JAX 0.223, ``no_sampler``)."""
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    monkeypatch.delenv("NNDET_IN_IMPL", raising=False)
    targets, key, want_losses, want_grads = _jax_grads(head, "bfloat16")
    *_, grads32 = _jax_grads(head, "float32")

    cfg = torch_cfg(head_type=head, dtype="bfloat16")
    trainer = Trainer(cfg, STEP_TCFG, device="cpu")
    state = trainer.init_state(params=bridge.state_dict_from_flax(numpy_params(), bf16_model()))
    if head != "no_sampler":
        inject_draws(monkeypatch, jax_draws(key, 2, len(cfg.anchors()[0]), pool_cap(cfg)))
    state.model.train()
    losses = trainer._losses(state.model, trainer._to_device(targets), torch.Generator())
    losses["total"].backward()

    assert want_losses["num_pos"] > 0
    for k in ("num_pos", "num_neg"):
        assert float(losses[k]) == float(want_losses[k]), k
    for k in LOSS_KEYS:
        err = abs(losses[k].item() - float(want_losses[k])) / abs(float(want_losses[k]))
        assert err <= LOSS_REL, (k, err)
    model = state.model
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want = {n: v.numpy() for n, v in bridge.state_dict_from_flax(want_grads, model).items()}
    ref = {n: v.numpy() for n, v in bridge.state_dict_from_flax(grads32, model).items()}
    assert set(got) == set(want) == set(ref)
    assert all(np.isfinite(g).all() for g in got.values())
    port_err, jax_err = rel_l2(flat(got), flat(ref)), rel_l2(flat(want), flat(ref))
    assert port_err <= jax_err, (port_err, jax_err)
    per_port = np.median([rel_l2(got[n], ref[n]) for n in got])
    per_jax = np.median([rel_l2(want[n], ref[n]) for n in got])
    assert per_port <= per_jax, (per_port, per_jax)
