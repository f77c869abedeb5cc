"""Spatial partitioning of the port over a model group, against the JAX
package: each op of ``parallel/spatial.py`` (the halo conv at (k, s) in
(3, 1), (3, 2), (5, 1), (1, 1), the transposed conv, the global instance
norm through the kernels' plain versions, the group norm, the max pool at
(2, 2) and (3, 1), the gather) on 2 and on 4 gloo ranks, forward and
gradient (the pool and the gather forward only), against the JAX function under ``shard_map`` on as many virtual
devices at 1e-5; a 2-rank spatial train step of the JAX spatial test's
micro configuration (``tests/test_spatial.py:198-240``, exact statistics)
against the JAX step on ``make_mesh(n_data=1, n_model=2)`` and against the
port's one-process step, three steps; ``_check_spatial_shardable`` against
JAX's; and the planner's forced oversized plan trained through
``mesh_for_plan`` on 2 ranks against the same plan unpartitioned.

The workers are :func:`tests.test_torch_distributed.run_ranks`'s: ``torch``
and the port only."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nndetection_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from nndetection_tpu.parallel import spatial as jspatial
from nndetection_tpu.parallel.mesh import make_mesh, shard_batch
from nndetection_tpu.train import trainer as jtrainer
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.data.augment import AugmentConfig
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.planning.planner import Plan, Planner
from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_distributed import MICRO, run_ranks, shard_keys
from tests.test_torch_train_loss import jax_draws, pool_cap

torch.set_num_threads(1)

OP_TOL = 1e-5
CONV_CASES = ((3, 1), (3, 2), (5, 1), (1, 1))
POOL_CASES = ((2, 2), (3, 1))
WORLDS = (2, 4)
# the JAX spatial test's tolerances (tests/test_spatial.py:254-266, :376-378)
STEP_LOSS_RTOL = 2e-4
STEP_PARAM_RTOL, STEP_PARAM_ATOL = 5e-3, 5e-4
STEPS = 3
STEP_TCFG = TrainerConfig(batch_size=2, warm_iterations=2, swa_epochs=0)
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg", "total")


# ------------------------------------------------------------ op references
def op_inputs():
    """Seeded inputs of every op, channel-last as the JAX functions take them."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    out = {"conv/x": f(2, 16, 6, 6, 3), "tconv/x": f(1, 8, 4, 4, 3),
           "tconv/k": f(2, 2, 2, 3, 5), "in/x": f(2, 16, 5, 5, 4) + 3.0,
           "in/scale": 1.0 + 0.1 * f(4), "in/bias": f(4), "gn/x": f(2, 16, 5, 5, 8),
           "gn/scale": 1.0 + 0.1 * f(8), "gn/bias": f(8), "pool/x": f(1, 16, 6, 6, 2),
           "gather/x": f(2, 16, 3)}
    for k, s in CONV_CASES:
        out[f"conv/{k}{s}/k"] = 0.2 * f(k, k, k, 3, 4)
        out[f"conv/{k}{s}/b"] = f(4)
    return out


def cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def model_mesh(n: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), axis_names=("data", "model"))


def sharded_vjp(fn, n, x, params=(), seed=0):
    """Output and gradients of ``sum(fn(x, *params) * w)`` with ``x`` sharded
    along axis 1 over ``n`` devices and ``params`` replicated."""
    mesh = model_mesh(n)
    g = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, "model"),) + (P(),) * len(params),
                      out_specs=P(None, "model"))

    @jax.jit
    def run(x, *params):
        y, vjp = jax.vjp(g, x, *params)
        return y, vjp(jnp.asarray(cotangent(y.shape, seed)))

    x = jax.device_put(x, NamedSharding(mesh, P(None, "model")))
    y, grads = run(x, *params)
    return np.asarray(y), [np.asarray(v) for v in grads]


def conv_weight(k):
    """A JAX conv kernel ``[*k, Ci, Co]`` (or its gradient) as the port's
    ``weight [Co, Ci, *k]``."""
    return np.ascontiguousarray(np.asarray(k).transpose(4, 3, 0, 1, 2))


def tconv_weight(k):
    """A transposed-conv kernel as the port's ``[Ci, Co, *k]``: flipped, as
    the bridge maps it."""
    return np.ascontiguousarray(np.flip(np.asarray(k), (0, 1, 2)).transpose(3, 4, 0, 1, 2))


@functools.lru_cache(maxsize=None)
def jax_ops(n: int) -> dict:
    """The JAX functions' outputs and gradients on ``n`` devices, keyed as
    the workers key theirs, in the port's layouts."""
    inp = op_inputs()
    ref = {}
    to_ncdhw = lambda a: np.ascontiguousarray(np.moveaxis(a, -1, 1))  # noqa: E731
    for k, s in CONV_CASES:
        y, (dx, dk, db) = sharded_vjp(
            lambda x, kk, b, s=s: jspatial.spatial_conv(x, kk, b, strides=(s, s, s)), n,
            inp["conv/x"], (inp[f"conv/{k}{s}/k"], inp[f"conv/{k}{s}/b"]), seed=k * 10 + s)
        ref.update({f"conv/{k}{s}/y": to_ncdhw(y), f"conv/{k}{s}/dx": to_ncdhw(dx),
                    f"conv/{k}{s}/dw": conv_weight(dk), f"conv/{k}{s}/db": db})
    y, (dx, dk) = sharded_vjp(
        lambda x, kk: jspatial.spatial_transposed_conv(x, kk, strides=(2, 2, 2)), n,
        inp["tconv/x"], (inp["tconv/k"],), seed=1)
    ref.update({"tconv/y": to_ncdhw(y), "tconv/dx": to_ncdhw(dx), "tconv/dw": tconv_weight(dk)})
    y, (dx, dsc, db) = sharded_vjp(
        lambda x, sc, b: jspatial.spatial_instance_norm(x, sc, b), n, inp["in/x"],
        (inp["in/scale"], inp["in/bias"]), seed=2)
    ref.update({"in/y": y, "in/dx": dx, "in/dscale": dsc, "in/dbias": db})
    y, (dx, dsc, db) = sharded_vjp(
        lambda x, sc, b: jspatial.spatial_group_norm(x, 2, sc, b), n, inp["gn/x"],
        (inp["gn/scale"], inp["gn/bias"]), seed=3)
    ref.update({"gn/y": to_ncdhw(y), "gn/dx": to_ncdhw(dx), "gn/dscale": dsc, "gn/dbias": db})
    for w, s in POOL_CASES:
        # forward only: JAX cannot linearize the max pool's -inf-initialized window
        pool = jax.jit(jax.shard_map(
            lambda x, w=w, s=s: jspatial.spatial_max_pool(x, (w,) * 3, (s,) * 3),
            mesh=model_mesh(n), in_specs=P(None, "model"), out_specs=P(None, "model")))
        ref[f"pool/{w}{s}/y"] = to_ncdhw(np.asarray(pool(inp["pool/x"])))
    gather = jax.jit(jax.shard_map(
        lambda x: jspatial.gather_spatial(x), mesh=model_mesh(n), in_specs=P(None, "model"),
        out_specs=P(None, None), check_vma=False))
    ref["gather/y"] = np.asarray(gather(inp["gather/x"]))
    return ref


def op_worker_inputs(n: int) -> dict:
    inp = op_inputs()
    to_ncdhw = lambda a: np.ascontiguousarray(np.moveaxis(a, -1, 1))  # noqa: E731
    out = {"conv/x": to_ncdhw(inp["conv/x"]), "tconv/x": to_ncdhw(inp["tconv/x"]),
           "tconv/w": tconv_weight(inp["tconv/k"]), "in/x": inp["in/x"],
           "in/scale": inp["in/scale"], "in/bias": inp["in/bias"],
           "gn/x": to_ncdhw(inp["gn/x"]), "gn/scale": inp["gn/scale"],
           "gn/bias": inp["gn/bias"], "pool/x": to_ncdhw(inp["pool/x"]),
           "gather/x": inp["gather/x"]}
    for k, s in CONV_CASES:
        out[f"conv/{k}{s}/w"] = conv_weight(inp[f"conv/{k}{s}/k"])
        out[f"conv/{k}{s}/b"] = inp[f"conv/{k}{s}/b"]
    # the cotangents, in the port's layouts, sliced per rank in the worker
    ref = jax_ops(n)
    seeds = {**{f"conv/{k}{s}": k * 10 + s for k, s in CONV_CASES}, "tconv": 1, "in": 2,
             "gn": 3}
    for name, seed in seeds.items():
        y = ref[f"{name}/y"]
        layout = y.shape if name == "in" else (y.shape[0], *y.shape[2:], y.shape[1])
        w = cotangent(layout, seed)
        out[f"{name}/w_out"] = w if name == "in" else to_ncdhw(w)
    return out


OPS_WORKER = """
import torch.distributed as dist
from nndetection_tpu_torch.ops.instance_norm import spatial_instance_norm
from nndetection_tpu_torch.parallel import spatial
init()
t = lambda a: torch.from_numpy(np.array(a))
def local(a, axis):
    z = a.shape[axis] // WORLD
    return np.take(a, range(RANK * z, (RANK + 1) * z), axis=axis)
def total(g):
    g = g.clone()
    dist.all_reduce(g)
    return g.numpy()
def run(name, fn, x, axis, *params):
    xl = t(local(INP[f"{name}/x"] if x is None else x, axis)).requires_grad_(True)
    ps = [t(p).requires_grad_(True) for p in params]
    y = fn(xl, *ps)
    (y * t(local(INP[f"{name}/w_out"], axis))).sum().backward()
    OUT[f"{name}/y"], OUT[f"{name}/dx"] = y.detach().numpy(), xl.grad.numpy()
    return [total(p.grad) for p in ps]
for k, s in [(3, 1), (3, 2), (5, 1), (1, 1)]:
    n = f"conv/{k}{s}"
    OUT[f"{n}/dw"], OUT[f"{n}/db"] = run(
        n, lambda x, w, b, s=s: spatial.spatial_conv(x, w, b, (s, s, s)), INP["conv/x"], 2,
        INP[f"{n}/w"], INP[f"{n}/b"])
OUT["tconv/dw"], = run("tconv", lambda x, w: spatial.spatial_transposed_conv(x, w), None, 2,
                       INP["tconv/w"])
OUT["in/dscale"], OUT["in/dbias"] = run(
    "in", lambda x, g, b: spatial_instance_norm(x, g, b), None, 1, INP["in/scale"],
    INP["in/bias"])
OUT["gn/dscale"], OUT["gn/dbias"] = run(
    "gn", lambda x, g, b: spatial.spatial_group_norm(x, 2, g, b), None, 2, INP["gn/scale"],
    INP["gn/bias"])
for w, s in [(2, 2), (3, 1)]:
    OUT[f"pool/{w}{s}/y"] = spatial.spatial_max_pool(t(local(INP["pool/x"], 2)), (w,) * 3,
                                                      (s,) * 3).numpy()
OUT["gather/y"] = spatial.gather_spatial(t(local(INP["gather/x"], 1)), spatial_axis=1).numpy()
"""


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def op_runs(request, tmp_path_factory):
    n = request.param
    runs = run_ranks(tmp_path_factory.mktemp(f"ops{n}"), OPS_WORKER, n, op_worker_inputs(n))
    return n, runs, jax_ops(n)


def rank_slice(a, n, rank, axis):
    z = a.shape[axis] // n
    return np.take(a, range(rank * z, (rank + 1) * z), axis=axis)


def check_op(op_runs, name, axis=2, params=(), keys=("y", "dx")):
    n, runs, ref = op_runs
    for rank, got in enumerate(runs):
        for key in keys:
            np.testing.assert_allclose(got[f"{name}/{key}"], rank_slice(ref[f"{name}/{key}"], n,
                                                                        rank, axis),
                                       rtol=OP_TOL, atol=OP_TOL, err_msg=f"{name}/{key} {rank}")
        for p in params:
            # a parameter's gradient sums every voxel: 1e-5 of its largest entry
            want = ref[f"{name}/{p}"]
            np.testing.assert_allclose(got[f"{name}/{p}"], want, rtol=OP_TOL,
                                       atol=OP_TOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"{name}/{p} {rank}")


@pytest.mark.parametrize("k,s", CONV_CASES)
def test_spatial_conv_matches_jax(op_runs, k, s):
    check_op(op_runs, f"conv/{k}{s}", params=("dw", "db"))


def test_spatial_transposed_conv_matches_jax(op_runs):
    check_op(op_runs, "tconv", params=("dw",))


def test_spatial_instance_norm_matches_jax(op_runs):
    """The global statistics (#1's plain version, merged over the ranks)
    and #2-#4's plain versions with the sums all-reduced."""
    check_op(op_runs, "in", axis=1, params=("dscale", "dbias"))


def test_spatial_group_norm_matches_jax(op_runs):
    check_op(op_runs, "gn", params=("dscale", "dbias"))


@pytest.mark.parametrize("w,s", POOL_CASES)
def test_spatial_max_pool_matches_jax(op_runs, w, s):
    check_op(op_runs, f"pool/{w}{s}", keys=("y",))


def test_gather_spatial_matches_jax(op_runs):
    n, runs, ref = op_runs
    for got in runs:
        np.testing.assert_array_equal(got["gather/y"], ref["gather/y"])


# ------------------------------------------------------- the spatial step
def step_batch():
    """The JAX spatial test's batch (``tests/test_spatial.py:221-232``) with
    a second object, so that ATSS matches anchors (the lone 6^3 cube matches
    none), prepared, so that both trainers skip the augmentation."""
    rng = np.random.RandomState(0)
    b, patch = 2, (16, 16, 16)
    seg = np.zeros((b, *patch), np.int32)
    seg[:, 4:10, 4:10, 4:10] = 1
    seg[:, 9:14, 2:7, 8:15] = 2
    table = np.full((b, 4), -1, np.int32)
    table[:, :2] = 0
    images = rng.standard_normal((b, *patch, 1)).astype(np.float32)
    out = prepare_targets(torch.from_numpy(images), torch.from_numpy(seg), torch.from_numpy(table))
    return {k: v.numpy() for k, v in out.items()}


def step_keys():
    return [jax.random.fold_in(jax.random.PRNGKey(0), step) for step in range(STEPS)]


@functools.lru_cache(maxsize=None)
def jax_spatial_steps():
    """The JAX ``Trainer`` on ``make_mesh(n_data=1, n_model=2)``, exact
    statistics (``NNDET_IN_STATS=two_pass``, as the JAX test pins): its
    initial parameters, each step's losses, the parameters after the last
    step, and each step's sampler draws."""
    cfg = jax_cfg(**MICRO, exact_topk=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NNDET_IN_STATS", "two_pass")
        jt = jtrainer.Trainer(cfg, jtrainer.TrainerConfig(**dataclasses.asdict(STEP_TCFG)),
                              mesh=make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2]),
                              augment_cfg=JaxAugmentConfig(patch_size=cfg.patch_size))
        state = jt.init_state()
        init = jax.device_get(state.params)
        batch = step_batch()
        losses = []
        for key in step_keys():
            state, lo = jt._train_step(state, shard_batch(jt.mesh, batch), key)
            losses.append(jax.device_get(lo))
    draws = [d for key in step_keys() for d in
             jax_draws(shard_keys(key, 1)[0], 2, len(cfg.anchors()[0]), pool_cap(cfg))]
    return init, losses, jax.device_get(state.params), draws


STEP_WORKER = """
from nndetection_tpu_torch.parallel.mesh import make_mesh
from nndetection_tpu_torch.train.trainer import Trainer
init()
inject([INP[f"draw/{i}"] for i in range(len([k for k in INP.files if k.startswith("draw/")]))])
trainer = Trainer(cfg_from("cfg"), tcfg_from("tcfg"), device="cpu", mesh=make_mesh(1, 2))
assert trainer.n_model == 2
state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in arrays("p/").items()})
batch = {k: torch.from_numpy(v) for k, v in arrays("b/").items()}
for step in range(%d):
    losses = trainer.train_step(state, batch, torch.Generator())
    OUT.update({f"loss/{step}/{k}": v.numpy() for k, v in losses.items()})
OUT.update({f"param/{k}": v.numpy() for k, v in state.model.state_dict().items()})
""" % STEPS


def port_steps(cfg, params, batch, draws, monkeypatch):
    """The port's one-process steps with the same draws."""
    from tests.test_torch_train_loss import inject_draws

    monkeypatch.setenv("NNDET_IN_STATS", "two_pass")
    inject_draws(monkeypatch, draws)
    trainer = Trainer(cfg, STEP_TCFG, "cpu")
    state = trainer.init_state(params=params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [{k: v.numpy() for k, v in trainer.train_step(state, tb, torch.Generator()).items()}
              for _ in range(STEPS)]
    return losses, {k: v.numpy() for k, v in state.model.state_dict().items()}


def test_two_rank_spatial_step_matches_jax_and_one_process(tmp_path, monkeypatch):
    init, want_losses, want_params, draws = jax_spatial_steps()
    cfg = torch_cfg(**MICRO)
    params = bridge.state_dict_from_flax(init, RetinaUNet(cfg))
    batch = step_batch()
    inputs = {"cfg": np.array(json.dumps(cfg.to_dict())),
              "tcfg": np.array(json.dumps(dataclasses.asdict(STEP_TCFG)))}
    inputs.update({f"p/{k}": v.numpy() for k, v in params.items()})
    inputs.update({f"b/{k}": v for k, v in batch.items()})
    inputs.update({f"draw/{i}": np.asarray(d) for i, d in enumerate(draws)})
    runs = run_ranks(tmp_path, STEP_WORKER, 2, inputs)
    one_losses, one_params = port_steps(cfg, params, batch, draws, monkeypatch)

    assert want_losses[0]["num_pos"] > 0
    for step in range(STEPS):
        for k in LOSS_KEYS:
            got = float(runs[0][f"loss/{step}/{k}"])
            for want, label in ((float(want_losses[step][k]), "jax"),
                                (float(one_losses[step][k]), "one process")):
                assert got == pytest.approx(want, rel=STEP_LOSS_RTOL, abs=1e-6), (step, k, label)
    want_sd = bridge.state_dict_from_flax(want_params, RetinaUNet(cfg))
    for name, w in want_sd.items():
        for other, label in ((w.numpy(), "jax"), (one_params[name], "one process")):
            np.testing.assert_allclose(runs[0][f"param/{name}"], other, rtol=STEP_PARAM_RTOL,
                                       atol=STEP_PARAM_ATOL, err_msg=f"{name} ({label})")
        np.testing.assert_array_equal(runs[0][f"param/{name}"], runs[1][f"param/{name}"])


# ----------------------------------------------------------- shardability
@pytest.mark.parametrize("z,n_model", [(16, 2), (12, 2), (16, 4), (8, 4), (20, 2), (15, 2),
                                       (32, 4)])
def test_check_spatial_shardable_raises_where_jax_does(z, n_model):
    from nndetection_tpu.models import RetinaUNetConfig as JaxConfig

    kw = dict(conv_kernels=((3, 3, 3),) * 3, strides=((2, 2, 2),) * 2, decoder_levels=(1, 2),
              patch_size=(z, 16, 16), anchor_width=((6.0,),) * 2,
              anchor_height=((6.0,),) * 2, anchor_depth=((6.0,),) * 2)
    outcomes = []
    for check, cfg in ((jtrainer.Trainer._check_spatial_shardable, JaxConfig(**kw)),
                       (Trainer._check_spatial_shardable, torch_cfg(**kw))):
        try:
            check(cfg, n_model)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


# ------------------------------------------------- the planner's spatial plan
def forced_plans():
    """The planner's plan for a pinned 16^3 patch at a budget under its
    one-device estimate (``n_model`` 2), and the same plan unpartitioned."""
    spacing, median = np.ones(3), np.asarray([64.0, 64.0, 64.0])
    forced = (16, 16, 16)
    ref = Planner(force_patch_size=forced, compile_validate=False, hbm_budget=16 << 30,
                  device="cpu").plan_architecture(spacing, median, 1, 1)
    arch = Planner(force_patch_size=forced, compile_validate=False,
                   hbm_budget=int(ref["mem_estimate_bytes"] * 0.85),
                   device="cpu").plan_architecture(spacing, median, 1, 1)
    assert arch["n_model"] == 2

    def mk(n_model):
        levels = len(arch["decoder_levels"])
        return Plan(plan_id="T", dim=3, target_spacing=[1.0] * 3, transpose_forward=[0, 1, 2],
                    normalization_schemes=["CT"], intensity_properties={},
                    use_nonzero_mask=False, patch_size=arch["patch_size"], batch_size=2,
                    conv_kernels=arch["conv_kernels"], pool_strides=arch["pool_strides"],
                    decoder_levels=arch["decoder_levels"],
                    anchors={"width": [[6.0]] * levels, "height": [[6.0]] * levels,
                             "depth": [[6.0]] * levels},
                    in_channels=1, num_classes=1, seg_classes=1, start_channels=4,
                    max_channels=8, fpn_channels=8, head_channels=8, n_model=n_model)
    return mk(2), mk(1)


PLAN_OVERRIDES = dict(topk_candidates=64, detections_per_img=8, dtype="float32")

PLAN_WORKER = """
import pickle
from nndetection_tpu_torch import pipeline
from nndetection_tpu_torch.data.augment import AugmentConfig
from nndetection_tpu_torch.train.trainer import Trainer
init()
plan = pickle.loads(INP["plan"].tobytes())
mesh = pipeline.mesh_for_plan(plan, 2, "cpu")
cfg = plan.model_config(**json.loads(str(INP["overrides"])))
trainer = Trainer(cfg, tcfg_from("tcfg"), device="cpu", mesh=mesh,
                  augment_cfg=AugmentConfig(patch_size=cfg.patch_size))
assert trainer.n_model == 2 and mesh.get_group("model").size() == 2
state = trainer.init_state()
batch = {k: torch.from_numpy(v) for k, v in arrays("b/").items()}
losses = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
OUT.update({k: v.numpy() for k, v in losses.items()})
OUT.update({k: np.array(v) for k, v in trainer.val_epoch(state, [batch], 0).items()})
"""


def test_planner_spatial_plan_trains_through_mesh_for_plan(tmp_path, monkeypatch):
    """The raw batch of the JAX test, augmented on both sides with the same
    generator: the partitioned loss equals the unpartitioned one, and so do
    the validation losses after the update."""
    import pickle

    monkeypatch.setenv("NNDET_IN_STATS", "two_pass")
    plan_sp, plan_single = forced_plans()
    rng = np.random.RandomState(0)
    patch = tuple(plan_sp.patch_size)
    seg = np.zeros((2, *patch), np.int32)
    seg[:, 4:10, 4:10, 4:10] = 1
    table = np.full((2, 4), -1, np.int32)
    table[:, 0] = 0
    batch = {"images": rng.standard_normal((2, *patch, 1)).astype(np.float32),
             "seg_instances": seg, "instance_classes": table}
    inputs = {"plan": np.frombuffer(pickle.dumps(plan_sp), np.uint8),
              "overrides": np.array(json.dumps(PLAN_OVERRIDES)),
              "tcfg": np.array(json.dumps(dataclasses.asdict(STEP_TCFG)))}
    inputs.update({f"b/{k}": v for k, v in batch.items()})
    runs = run_ranks(tmp_path, PLAN_WORKER, 2, inputs)

    cfg = plan_single.model_config(**PLAN_OVERRIDES)
    trainer = Trainer(cfg, STEP_TCFG, "cpu", augment_cfg=AugmentConfig(patch_size=cfg.patch_size))
    state = trainer.init_state()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = trainer.train_step(state, tb, torch.Generator().manual_seed(0))
    want_val = trainer.val_epoch(state, [tb], 0)
    assert np.isfinite(float(want["total"])) and "val_cls" in want_val
    for got in runs:
        np.testing.assert_allclose(float(got["total"]), float(want["total"]),
                                   rtol=STEP_LOSS_RTOL)
        # the validation forward after the update, partitioned and not
        for k, v in want_val.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=STEP_LOSS_RTOL, atol=1e-6,
                                       err_msg=k)
