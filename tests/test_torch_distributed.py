"""Data-parallel training of the port over processes, against the JAX
package: two real OS processes join a gloo group over ``tcp://`` (the
``NNDET_*`` launcher contract's coordinator) and take one train step of the
micro float32 model on their rows of a prepared global batch of 4, for both
heads, with the JAX sampler draws of each data shard injected
(``fold_in(key, data_index)``). Held against ``jtrainer.Trainer`` on a
``make_mesh(n_data=2)`` mesh: the losses, the averaged clipped gradient and
every parameter after the update, at the one-process tolerances; the two
ranks' parameters equal bit for bit. Also the helpers against the JAX
package's multi-process formulas, and ``run_train`` under a 2-rank job:
rank 0 alone writes the one-process run's files, and its checkpoint (no
``module.`` prefix) loads in the one-process ``Predictor``.

The workers import only ``torch`` and the port; they read their inputs from
an ``.npz`` the test writes and write their results to another.
:func:`run_ranks` is the harness ``test_torch_spatial.py`` shares."""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu.parallel import distributed as jdistributed
from nndetection_tpu.parallel.mesh import make_mesh, shard_batch
from nndetection_tpu.train import trainer as jtrainer
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.inference.loading import load_all_models
from nndetection_tpu_torch.inference.predictor import Predictor
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.train.trainer import TrainerConfig
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_run_train import TINY_MODEL, TINY_TRAINER, task  # noqa: F401 - fixture
from tests.test_torch_train_loss import jax_draws, numpy_params, pool_cap
from tests.test_torch_trainer import (
    GRAD_TOL,
    LOSS_ATOL,
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_RTOL,
    jax_tcfg,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# seconds: the group's timeout inside the workers, and the wait for them
GROUP_TIMEOUT_MIN = 2.0
WORKER_TIMEOUT_S = 300

# the micro configuration of tests/test_distributed.py::micro_trainer
MICRO = dict(conv_kernels=((3, 3, 3),) * 3, strides=((2, 2, 2),) * 2, decoder_levels=(1, 2),
             patch_size=(16, 16, 16), anchor_width=((6.0,),) * 2,
             anchor_height=((6.0,),) * 2, anchor_depth=((6.0,),) * 2, start_channels=4,
             max_channels=8, fpn_channels=8, head_channels=8, topk_candidates=64,
             detections_per_img=8, dtype="float32")
GLOBAL_BATCH = 4
DP_TCFG = TrainerConfig(batch_size=GLOBAL_BATCH, warm_iterations=0, max_epochs=1,
                        num_train_batches_per_epoch=10, swa_epochs=0)
HEADS = ("no_sampler", "hnm")
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg", "total")


# ------------------------------------------------------------------ harness
def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


PREAMBLE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from nndetection_tpu_torch.parallel import distributed
WORK, RANK, WORLD, PORT = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
INP = np.load(f"{WORK}/in.npz")
OUT = {}
def init(**kw):
    distributed.initialize(f"localhost:{PORT}", WORLD, RANK, device="cpu",
                           timeout_min=%(timeout)r, **kw)
def cfg_from(key, **overrides):
    from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig
    return RetinaUNetConfig.from_dict({**json.loads(str(INP[key])), **overrides})
def tcfg_from(key):
    from nndetection_tpu_torch.train.trainer import TrainerConfig
    return TrainerConfig(**json.loads(str(INP[key])))
def arrays(prefix):
    return {k[len(prefix):]: INP[k] for k in INP.files if k.startswith(prefix)}
def inject(draws):
    from nndetection_tpu_torch.core.boxes import sampler
    it = iter(draws)
    sampler.draw_uniform = lambda generator, shape, device: torch.from_numpy(next(it)).to(device)
""" % {"timeout": GROUP_TIMEOUT_MIN}

EPILOGUE = """
np.savez(f"{WORK}/out{RANK}.npz", **OUT)
torch.distributed.destroy_process_group()
"""


def run_ranks(work: Path, body: str, world: int, inputs: dict, env: dict = None) -> list:
    """Run ``body`` (after :data:`PREAMBLE`) in ``world`` processes joined by
    a gloo group; each writes ``OUT`` (arrays); returns them by rank."""
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "in.npz", **inputs)
    script = work / "worker.py"
    script.write_text(PREAMBLE + textwrap.dedent(body) + EPILOGUE)
    port = str(free_port())
    base = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("NNDET_COORDINATOR", "NNDET_NUM_PROCESSES", "NNDET_PROCESS_ID"):
        base.pop(var, None)
    procs = []
    for rank in range(world):
        penv = dict(base, **{k: v.format(rank=rank, world=world, port=port)
                             for k, v in (env or {}).items()})
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(work), str(rank), str(world), port],
            env=penv, cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err[-4000:]}"
    return [dict(np.load(work / f"out{rank}.npz")) for rank in range(world)]


# --------------------------------------------------------- the JAX reference
def global_batch():
    """A prepared global batch of 4 (a cube of class 0 in every image)."""
    rng = np.random.RandomState(0)
    b, patch = GLOBAL_BATCH, MICRO["patch_size"]
    seg = np.zeros((b, *patch), np.int32)
    seg[:, 4:10, 4:10, 4:10] = 1
    seg[1::2, 9:14, 2:7, 8:15] = 2
    table = np.full((b, 4), -1, np.int32)
    table[:, :2] = 0
    images = rng.standard_normal((b, *patch, 1)).astype(np.float32)
    out = prepare_targets(torch.from_numpy(images), torch.from_numpy(seg), torch.from_numpy(table))
    return {k: v.numpy() for k, v in out.items()}


def shard_keys(key, n_data: int):
    """The loss keys of the JAX step's data shards: the step key folded with
    each shard's index, the augmentation's half split off."""
    return [jax.random.split(jax.random.fold_in(key, i))[1] for i in range(n_data)]


@functools.lru_cache(maxsize=None)
def jax_dp_reference():
    """Per head: the JAX ``Trainer`` step on a 2-shard data mesh (losses,
    parameters after the update), the clipped mean of the two shards'
    gradients, and each shard's sampler draws."""
    batch = global_batch()
    params = jax.tree.map(jnp.asarray, numpy_params(**MICRO))
    key = jax.random.PRNGKey(3)
    keys = shard_keys(key, 2)
    half = GLOBAL_BATCH // 2
    clip = optax.clip_by_global_norm(DP_TCFG.grad_clip_norm)
    out = {}
    for head in HEADS:
        cfg = jax_cfg(**MICRO, head_type=head, exact_topk=True)
        jt = jtrainer.Trainer(cfg, jax_tcfg(DP_TCFG), mesh=make_mesh(n_data=2))
        # the step donates its state: give it copies
        own = jax.tree.map(jnp.copy, params)
        state = jtrainer.TrainState(params=own, opt_state=jt.tx.init(own),
                                    step=jnp.zeros((), jnp.int32),
                                    swa_params=jax.tree.map(jnp.copy, params),
                                    swa_count=jnp.zeros((), jnp.int32))
        new, losses = jt._train_step(state, shard_batch(jt.mesh, batch), key)
        anchors, per_level = cfg.anchors()

        @jax.jit
        def shard_grad(p, b, k):
            def loss_fn(q):
                preds = JaxRetinaUNet(cfg).apply(q, b["images"])
                lo = j_train_step_loss(cfg, preds, jnp.asarray(anchors), per_level, b, k)
                return lo["cls"] + lo["reg"] + lo["seg_ce"] + lo["seg_dice"]
            return jax.grad(loss_fn)(p)

        grads = [shard_grad(params, {k: jnp.asarray(v[i * half:(i + 1) * half])
                                     for k, v in batch.items()}, keys[i]) for i in range(2)]
        mean = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
        clipped = clip.update(mean, None)[0]
        draws = [jax_draws(k, half, len(cfg.anchors()[0]), pool_cap(cfg)) for k in keys]
        out[head] = (jax.device_get(losses), jax.device_get(clipped),
                     jax.device_get(new.params), draws)
    return batch, out


def state_dict_arrays(tree, cfg) -> dict:
    return {k: v.numpy() for k, v in bridge.state_dict_from_flax(tree, RetinaUNet(cfg)).items()}


DP_WORKER = """
from nndetection_tpu_torch.parallel.mesh import shard_batch
from nndetection_tpu_torch.train.trainer import Trainer
init()
tcfg = tcfg_from("tcfg")
rows = distributed.local_batch_slice(tcfg.batch_size)
params = {k: torch.from_numpy(v) for k, v in arrays("p/").items()}
for head in ("no_sampler", "hnm"):
    inject([INP[f"draw/{head}/{RANK}/{i}"] for i in range(2)])
    trainer = Trainer(cfg_from("cfg", head_type=head), tcfg, device="cpu")
    state = trainer.init_state(params=params)
    assert state.ddp is not None and trainer.mesh is not None
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(trainer.mesh, arrays("b/")).items()}
    assert all(np.array_equal(batch[k], v[rows]) for k, v in arrays("b/").items())
    losses = trainer.train_step(state, batch, torch.Generator())
    OUT.update({f"{head}/loss/{k}": v.numpy() for k, v in losses.items()})
    OUT.update({f"{head}/grad/{n}": p.grad.numpy() for n, p in state.model.named_parameters()})
    OUT.update({f"{head}/param/{n}": v.numpy() for n, v in state.model.state_dict().items()})
OUT["slice"] = np.array([rows.start, rows.stop])
OUT["helpers"] = np.array([distributed.process_index(), distributed.process_count(),
                           distributed.is_main_process(), distributed.local_batch_size(8)])
slices = [distributed.local_batch_slice(8)]
try:
    distributed.local_batch_size(3)
    OUT["indivisible_raises"] = np.array(False)
except ValueError:
    OUT["indivisible_raises"] = np.array(True)
OUT["slice8"] = np.array([slices[0].start, slices[0].stop])
"""


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    batch, ref = jax_dp_reference()
    cfg = torch_cfg(**MICRO)
    inputs = {"cfg": np.array(json.dumps(cfg.to_dict())),
              "tcfg": np.array(json.dumps(dataclasses.asdict(DP_TCFG)))}
    inputs.update({f"b/{k}": v for k, v in batch.items()})
    inputs.update({f"p/{k}": v for k, v in
                   state_dict_arrays(numpy_params(**MICRO), cfg).items()})
    for head in HEADS:
        for rank, draws in enumerate(ref[head][3]):
            inputs.update({f"draw/{head}/{rank}/{i}": np.asarray(d) for i, d in enumerate(draws)})
    return run_ranks(tmp_path_factory.mktemp("dp"), DP_WORKER, 2, inputs), ref


@pytest.mark.parametrize("head", HEADS)
def test_two_rank_step_matches_jax_data_mesh(dp_runs, head):
    """Losses, the averaged clipped gradient and the parameters after the
    update of rank 0 against the JAX step on ``make_mesh(n_data=2)``."""
    runs, ref = dp_runs
    want_losses, want_grads, want_params, _ = ref[head]
    got = runs[0]
    assert want_losses["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[f"{head}/loss/{k}"], want_losses[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    cfg = torch_cfg(**MICRO)
    for name, w in state_dict_arrays(want_grads, cfg).items():
        np.testing.assert_allclose(got[f"{head}/grad/{name}"], w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name)
    for name, w in state_dict_arrays(want_params, cfg).items():
        np.testing.assert_allclose(got[f"{head}/param/{name}"], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_two_ranks_agree_bit_for_bit(dp_runs):
    """Both ranks hold the same losses, gradients and parameters, to the
    bit; each fed its own half of the batch."""
    runs, _ = dp_runs
    r0, r1 = runs
    keys = [k for k in r0 if k.count("/") == 2 and k.split("/")[1] in ("loss", "grad", "param")]
    assert len(keys) > 50
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["slice"].tolist() == [0, 2] and r1["slice"].tolist() == [2, 4]


def test_helpers_match_jax(dp_runs, monkeypatch):
    """``process_index``, ``process_count``, ``is_main_process``,
    ``local_batch_size``/``local_batch_slice`` and the indivisible batch on
    each rank against the JAX package's helpers at that process index."""
    runs, _ = dp_runs
    for rank, got in enumerate(runs):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        want_slice = jdistributed.local_batch_slice(8)
        assert got["slice8"].tolist() == [want_slice.start, want_slice.stop]
        assert got["helpers"].tolist() == [rank, 2, int(jdistributed.is_main_process()),
                                           jdistributed.local_batch_size(8)]
        with pytest.raises(ValueError):
            jdistributed.local_batch_size(3)
        assert bool(got["indivisible_raises"])


# ------------------------------------------------------- run_train, 2 ranks
RUN_TRAIN_WORKER = """
from pathlib import Path
from nndetection_tpu_torch import pipeline
out = pipeline.run_train(str(INP["task"]), Path(str(INP["models"])) / f"rank{RANK}", fold=0,
                         trainer_overrides=json.loads(str(INP["trainer"])),
                         model_overrides=json.loads(str(INP["model"])), device="cpu")
assert distributed.process_count() == 2 and distributed.process_index() == RANK
OUT["done"] = np.array(True)
"""


def test_run_train_two_ranks_writes_from_rank_zero(task, tmp_path):  # noqa: F811
    """``run_train(device="cpu")`` under ``NNDET_COORDINATOR`` /
    ``NNDET_NUM_PROCESSES=2`` / ``NNDET_PROCESS_ID``: rank 0 writes the
    files of the one-process run, rank 1 none; the checkpoint holds the bare
    model's ``state_dict`` and loads in the one-process ``Predictor``."""
    trainer = dict(TINY_TRAINER, max_epochs=1)
    env = {"NNDET_COORDINATOR": "localhost:{port}", "NNDET_NUM_PROCESSES": "{world}",
           "NNDET_PROCESS_ID": "{rank}"}
    inputs = {"task": np.array(str(task)), "models": np.array(str(tmp_path / "models")),
              "trainer": np.array(json.dumps(trainer)), "model": np.array(json.dumps(TINY_MODEL))}
    run_ranks(tmp_path / "work", RUN_TRAIN_WORKER, 2, inputs, env=env)
    single = tpipeline.run_train(task, tmp_path / "single", fold=0, trainer_overrides=trainer,
                                 model_overrides=TINY_MODEL, device="cpu")
    rank0 = tmp_path / "models" / "rank0" / "fold0"
    assert sorted(p.name for p in rank0.iterdir()) == sorted(p.name for p in single.iterdir())
    assert list((tmp_path / "models" / "rank1" / "fold0").iterdir()) == []
    rows = [json.loads(line) for line in (rank0 / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_total"]) and rows[0]["steps"] == 2
    ckpt = torch.load(rank0 / "model_last.ckpt", weights_only=True)
    want = torch.load(single / "model_last.ckpt", weights_only=True)
    assert not any(k.startswith("module.") for k in ckpt["params"])
    assert list(ckpt["params"]) == list(want["params"])
    assert ckpt["step"] == want["step"] == 2
    bundles = load_all_models(tmp_path / "models" / "rank0")
    case = np.random.RandomState(0).standard_normal((1, 32, 32, 32)).astype(np.float32)
    res = Predictor(bundles, tta=False, device="cpu").predict_case(case)
    assert np.isfinite(res["pred_scores"]).all() and res["pred_boxes"].shape[-1] == 6
