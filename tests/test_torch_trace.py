"""The port's spans and counters (:mod:`nndetection_tpu_torch.utils.trace`)
on the CPU: nothing recorded without a profiler; under
``torch.profiler.profile`` the spans of a whole-case prediction and of a
pool-fed training epoch, with their parents, threads and nesting,
and the counters; identical results with tracing on and off; the profiler
flag the recorder reads, seen from a second thread; the bound on the
buffer."""
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nndetection_tpu_torch.data.aug_presets import get_augmentation
from nndetection_tpu_torch.data.augment import generator_patch_size_for
from nndetection_tpu_torch.data.loader import DevicePatchPool, PrefetchIterator, build_case_records
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
from nndetection_tpu_torch.utils import trace
from tests.test_torch_bridge import torch_cfg
from tests.test_torch_loader import write_cases

torch.set_num_threads(1)

CASE = (1, 48, 32, 32)  # two tiles of the tiny 32^3 patch
MODELS, FLIPS = 2, 8  # with TTA: 16 streams
STEPS, BATCH = 3, 2


def traced(fn):
    """``fn()`` under a CPU profiler: its result and what the recorder took."""
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.take()


def by_name(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp)
    return out


def inside(child, parent):
    return (child.parent == parent.id
            and parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns)


@pytest.fixture(scope="module")
def predicted():
    """One case predicted by two tiny models with TTA: untraced, then traced."""
    cfg = torch_cfg()
    bundles = []
    for m in range(MODELS):
        net = RetinaUNet(cfg, generator=torch.Generator().manual_seed(m))
        bundles.append(ModelBundle(cfg=cfg, params=net.state_dict(), name=f"fold{m}"))
    predictor = Predictor(bundles, tta=True, device="cpu")
    case = np.random.RandomState(3).standard_normal(CASE).astype(np.float32)
    off = predictor.predict_case(case)
    on, recorded = traced(lambda: predictor.predict_case(case))
    return off, on, recorded


def train_once(tmp_path, on: bool):
    """One epoch of ``STEPS`` steps of a fresh tiny trainer, fed by a device
    pool on the CPU that rotates one of its 4 cases in, through
    ``PrefetchIterator``: the epoch's metrics, the parameters after it, the
    recorder's take and the prefetch thread's ident."""
    cfg = torch_cfg()
    aug = get_augmentation("no_aug", cfg.patch_size)
    trainer = Trainer(cfg, TrainerConfig(batch_size=BATCH, warm_iterations=0, max_epochs=1,
                                         num_train_batches_per_epoch=STEPS, swa_epochs=0),
                      device="cpu", augment_cfg=aug)
    state = trainer.init_state()
    pool = DevicePatchPool(build_case_records(tmp_path), patch_size=generator_patch_size_for(aug),
                           batch_size=BATCH, max_pool_cases=3, device="cpu", max_instances=8,
                           seed=5, inner_patch_size=cfg.patch_size)
    holder = {}

    def epoch():
        it = PrefetchIterator(pool.epoch(STEPS), depth=2)
        holder["thread"] = it.thread.ident
        return trainer.train_epoch(state, it, 0)[1]

    metrics, recorded = traced(epoch) if on else (epoch(), None)
    params = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    return metrics, params, recorded, holder["thread"], pool


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = write_cases(tmp_path_factory.mktemp("trace_cases"),
                       [(36, 36, 36), (40, 36, 38), (36, 40, 36), (38, 38, 40)])
    return train_once(root, on=False), train_once(root, on=True)


def test_off_records_nothing():
    trace.take()
    assert not trace.enabled()
    assert trace.span("predict.case") is trace.OFF
    assert trace.span("train.step") is trace.span("x")
    with trace.span("predict.case"):
        trace.count("predict.tiles", 5)
    assert trace.take() == ([], {}, 0)


def test_predict_spans_nest_under_the_case(predicted):
    _, _, (spans, counts, dropped) = predicted
    assert dropped == 0
    names = by_name(spans)
    (case,) = names["predict.case"]
    assert case.parent is None
    assert {sp.thread for sp in spans} == {threading.get_ident()}
    calls = MODELS  # two tiles a call: one call per model
    # per call the decode's and the clip's copies, and one per flipped variant
    copies = calls * (2 + FLIPS - 1)
    want = {"predict.stage": 1, "predict.cut": 1, "predict.forward": calls,
            "predict.postprocess": calls, "predict.fetch": calls,
            "predict.ensemble_tiles": calls, "ensemble.consolidate": 1,
            "ensemble.model_nms": MODELS * FLIPS, "ensemble.cluster": 1, "sync.copy": copies}
    assert Counter(sp.name for sp in spans) == Counter({"predict.case": 1, **want})
    for name in ("predict.stage", "predict.cut", "predict.forward", "predict.postprocess",
                 "predict.fetch", "predict.ensemble_tiles", "ensemble.consolidate"):
        assert all(inside(sp, case) for sp in names[name]), name
    post = {sp.id: sp for sp in names["predict.postprocess"]}
    assert all(inside(sp, post[sp.parent]) for sp in names["sync.copy"])
    (consolidate,) = names["ensemble.consolidate"]
    assert all(inside(sp, consolidate)
               for sp in names["ensemble.model_nms"] + names["ensemble.cluster"])
    # in order: stage, cut, then per call forward, postprocess, fetch, tiles
    order = sorted((sp for sp in spans if sp.parent == case.id), key=lambda sp: sp.start_ns)
    assert [sp.name for sp in order] == (
        ["predict.stage", "predict.cut"]
        + ["predict.forward", "predict.postprocess", "predict.fetch",
           "predict.ensemble_tiles"] * calls + ["ensemble.consolidate"])
    assert counts == {"predict.tiles": 2 * FLIPS * MODELS}


def test_predict_results_identical_with_tracing(predicted):
    off, on, _ = predicted
    for k in ("pred_boxes", "pred_scores", "pred_labels"):
        np.testing.assert_array_equal(on[k], off[k])
    assert len(off["pred_scores"]) > 0


def test_train_spans_nest_under_the_step(trained):
    _, (metrics, _, (spans, counts, dropped), worker, pool) = trained
    assert dropped == 0 and metrics["steps"] == STEPS
    names = by_name(spans)
    main = threading.get_ident()
    steps = sorted(names["train.step"], key=lambda sp: sp.start_ns)
    assert len(steps) == STEPS
    assert all(sp.parent is None and sp.thread == main for sp in steps)
    for step in steps:
        children = [sp for sp in spans if sp.parent == step.id]
        assert [sp.name for sp in sorted(children, key=lambda sp: sp.start_ns)] == [
            "train.prepare", "train.forward", "train.backward", "train.update"]
        assert all(inside(sp, step) for sp in children)
        # the loss's decode copies the coder's weights to the device
        (forward,) = [sp for sp in children if sp.name == "train.forward"]
        (copy,) = [sp for sp in spans if sp.parent == forward.id]
        assert copy.name == "sync.copy" and inside(copy, forward)
        (update,) = [sp for sp in children if sp.name == "train.update"]
        (sync,) = [sp for sp in spans if sp.parent == update.id]
        assert sync.name == "train.sync" and inside(sync, update)
    to_device = sorted(names["train.to_device"], key=lambda sp: sp.start_ns)
    assert [sp.end_ns <= step.start_ns for sp, step in zip(to_device, steps)] == [True] * STEPS
    # one wait per batch and the one that ends the epoch
    assert len(names["train.batch_wait"]) == STEPS + 1
    assert all(sp.thread == main and sp.parent is None for sp in names["train.batch_wait"])
    assert counts == {"train.patches": STEPS * BATCH}
    assert len(names.get("pool.swap", [])) == pool._rotations_last_epoch
    assert len(names.get("pool.stage_read", [])) >= pool._rotations_last_epoch


def test_pool_cut_is_on_the_prefetch_thread_with_the_steps_key(trained):
    _, (_, _, (spans, _, _), worker, _) = trained
    names = by_name(spans)
    # the n-th cut on the prefetch thread is the n-th step's batch
    cuts = sorted(names["pool.cut"], key=lambda sp: sp.start_ns)
    steps = sorted(names["train.step"], key=lambda sp: sp.start_ns)
    assert len(cuts) == len(steps) == STEPS
    assert all(sp.thread == worker != threading.get_ident() and sp.parent is None
               for sp in cuts)
    for cut, step in zip(cuts, steps):
        assert cut.end_ns <= step.start_ns
    assert all(sp.thread == worker for sp in names.get("pool.swap", []))


def test_train_results_identical_with_tracing(trained):
    (m_off, p_off, _, _, _), (m_on, p_on, _, _, _) = trained
    for k in ("train_total", "train_cls", "train_reg", "train_seg_ce", "train_seg_dice"):
        assert m_on[k] == m_off[k], k
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_off)


def test_profiler_flag_flips_on_a_second_thread():
    """The recorder's switch is the process-wide flag torch sets when a
    profiler starts and clears when it stops: a thread that did not start
    the profiler sees it turn on and off."""
    import torch.autograd.profiler as prof

    assert isinstance(prof._is_profiler_enabled, bool)
    started, stopped = threading.Event(), threading.Event()
    looked, seen = [threading.Event() for _ in range(3)], []

    def look():
        for i, event in enumerate((None, started, stopped)):
            if event is not None:
                event.wait(timeout=30)
            seen.append(trace.enabled())
            if i == 1:
                with trace.span("worker"):
                    pass
            looked[i].set()

    trace.take()
    t = threading.Thread(target=look)
    t.start()
    assert looked[0].wait(timeout=30)
    with profile(activities=[ProfilerActivity.CPU]):
        started.set()
        assert looked[1].wait(timeout=30)
    stopped.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [False, True, False]
    spans, _, _ = trace.take()
    assert [(sp.name, sp.thread) for sp in spans] == [("worker", t.ident)]


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    rec = trace.Recorder(max_spans=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with rec.span("s"):
                with rec.span("child"):
                    pass
        rec.count("n", 2)
        rec.count("n")
    spans, counts, dropped = rec.take()
    assert [sp.name for sp in spans] == ["child", "s", "child"]
    assert spans[0].parent == spans[1].id and spans[1].parent is None
    assert dropped == 7 and counts == {"n": 3}
    assert rec.take() == ([], {}, 0)
