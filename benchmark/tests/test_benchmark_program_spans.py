"""The readers of the program's own spans (``benchmark/program_spans.py`` and
the ``program_span`` metrics that use it) on synthetic span lists: per-case
and per-step values, self time, the recorder taken once per run, and None
where the program recorded nothing. On the tiny cells, the program's twins
of what the benchmark counts and times from outside agree with it.

    python -m pytest benchmark/tests -q
"""
import json
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program_spans
from benchmark.tests import tiny
from nndetection_tpu_torch.utils import trace

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NEW = {"stage_ms.predict", "fetch_wait_ms.predict", "tile_ensemble_ms.predict",
       "model_nms_ms.predict", "host_step_ms.train", "sync_wait_ms.train",
       "batch_wait_ms.train", "host_step_ms.train2d", "sync_wait_ms.train2d",
       "batch_wait_ms.train2d"}
MS = 1_000_000  # ns


def run_with(spans=None, counts=None):
    """A run whose program recorded ``spans`` (``(name, start_ms, end_ms,
    id, parent)``; None: nothing)."""
    run = harness.Run(bench=BENCH, workload={}, config={}, seed=1, seconds=1.0, trace=True,
                      device=torch.device("cpu"), spans=harness.Spans(True))
    run.program_spans = None if spans is None else program_spans.ProgramSpans(
        [trace.Span(n, s * MS, e * MS, 1, i, p) for n, s, e, i, p in spans], counts or {})
    return run


def read(name, run):
    return harness.load_reader(name).read(run)


# two cases: 10 and 20 ms of staging, two calls of the second case
PREDICT = [
    ("predict.case", 0, 100, 1, None),
    ("predict.stage", 0, 10, 2, 1),
    ("predict.forward", 10, 20, 3, 1),
    ("predict.postprocess", 20, 30, 18, 1),
    ("sync.copy", 22, 27, 19, 18),
    ("predict.fetch", 30, 50, 4, 1),
    ("predict.ensemble_tiles", 50, 60, 5, 1),
    ("ensemble.consolidate", 60, 100, 6, 1),
    ("ensemble.model_nms", 60, 70, 7, 6),
    ("ensemble.model_nms", 70, 85, 8, 6),
    ("ensemble.cluster", 85, 99, 9, 6),
    ("predict.case", 200, 400, 10, None),
    ("predict.stage", 200, 220, 11, 10),
    ("predict.postprocess", 220, 230, 20, 10),
    ("sync.copy", 221, 229, 21, 20),
    ("predict.fetch", 230, 240, 12, 10),
    ("predict.ensemble_tiles", 240, 250, 13, 10),
    ("predict.fetch", 260, 300, 14, 10),
    ("predict.ensemble_tiles", 300, 304, 15, 10),
    ("ensemble.consolidate", 310, 400, 16, 10),
    ("ensemble.model_nms", 310, 331, 17, 16),
]

# two steps of 100 ms, each with a 60-ms sync and a synchronising copy in
# its forward; a wait outside any step (a direct call of _apply_update, a
# decode outside training) does not count against the steps
TRAIN = [
    ("train.batch_wait", 0, 4, 1, None),
    ("train.to_device", 4, 5, 2, None),
    ("train.step", 5, 105, 3, None),
    ("train.prepare", 5, 20, 4, 3),
    ("train.forward", 20, 40, 14, 3),
    ("sync.copy", 30, 35, 15, 14),
    ("train.update", 40, 100, 5, 3),
    ("train.sync", 40, 100, 6, 5),
    ("train.batch_wait", 105, 107, 7, None),
    ("train.to_device", 107, 110, 8, None),
    ("train.step", 110, 210, 9, None),
    ("train.forward", 110, 130, 16, 9),
    ("sync.copy", 120, 128, 17, 16),
    ("train.update", 130, 200, 10, 9),
    ("train.sync", 140, 200, 11, 10),
    ("train.batch_wait", 210, 220, 12, None),
    ("train.sync", 300, 350, 13, None),
    ("sync.copy", 360, 370, 18, None),
]


def test_new_metrics_are_declared_with_program_spans():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert NEW <= set(per_layer)
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"
        assert hasattr(harness.load_reader(name), "read")
    # the 2D cell's metrics are aliases of the 3D readers
    for name in NEW:
        if name.endswith(".train2d"):
            alias = harness.BENCH / "metrics" / f"{name}.json"
            assert json.loads(alias.read_text()) == {"reader": name.replace("2d", "")}


def test_prediction_readers_per_case():
    run = run_with(PREDICT)
    assert read("stage_ms.predict", run) == pytest.approx((10 + 20) / 2)
    # the copies back and the post-processing's synchronising copies
    assert read("fetch_wait_ms.predict", run) == pytest.approx((5 + 20 + 8 + 10 + 40) / 2)
    assert read("tile_ensemble_ms.predict", run) == pytest.approx((10 + 10 + 4) / 2)
    assert read("model_nms_ms.predict", run) == pytest.approx((10 + 15 + 21) / 2)
    # the training readers find no step there
    assert all(read(n, run) is None for n in NEW if ".train" in n)


def test_training_readers_per_step():
    run = run_with(TRAIN)
    assert read("host_step_ms.train", run) == pytest.approx(
        ((100 - 60 - 5) + 1 + (100 - 60 - 8) + 3) / 2)
    assert read("sync_wait_ms.train", run) == pytest.approx((60 + 5 + 60 + 8) / 2)
    assert read("batch_wait_ms.train", run) == pytest.approx((4 + 2 + 10) / 2)
    assert read("host_step_ms.train2d", run) == read("host_step_ms.train", run)
    assert all(read(n, run) is None for n in NEW if n.endswith(".predict"))


def test_self_time_leaves_out_what_children_cover():
    spans = run_with(PREDICT).program_spans
    by_id = spans.by_id
    assert spans.self_ms(by_id[6]) == pytest.approx(40 - 39)  # 10 + 15 + 14 of children
    assert spans.self_ms(by_id[1]) == pytest.approx(100 - 100)
    assert spans.self_ms(by_id[10]) == pytest.approx(200 - 20 - 10 - 10 - 10 - 40 - 4 - 90)
    assert spans.self_ms(by_id[7]) == pytest.approx(10)
    # overlapping children are counted once
    overlap = run_with([("a", 0, 10, 1, None), ("b", 1, 5, 2, 1),
                        ("c", 3, 8, 3, 1)]).program_spans
    assert overlap.self_ms(overlap.by_id[1]) == pytest.approx(10 - 7)
    assert overlap.root(overlap.by_id[3]).name == "a"


def test_none_without_spans():
    run = run_with(None)
    assert all(read(n, run) is None for n in NEW)
    assert all(read(n, run_with([])) is None for n in NEW)


def test_the_recorder_is_taken_once_per_run():
    run = run_with()
    del run.program_spans
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("predict.case"):
            with trace.span("predict.stage"):
                pass
    first = program_spans.read(run)
    assert [sp.name for sp in first.spans] == ["predict.stage", "predict.case"]
    assert program_spans.read(run) is first
    assert read("stage_ms.predict", run) is not None
    # nothing recorded (an untraced run, or the CPU): None
    other = run_with()
    del other.program_spans
    assert program_spans.read(other) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """The benchmark runs its traced cells on the parent commit too, whose
    program may lack the recorder: the readers then give None."""
    import nndetection_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "nndetection_tpu_torch.utils.trace", None)
    monkeypatch.delattr(nndetection_tpu_torch.utils, "trace")
    run = run_with()
    del run.program_spans
    assert program_spans.read(run) is None
    assert all(read(n, run) is None for n in NEW)


def twin_pairs(program, outside, name):
    """Each of the benchmark's ``name`` spans with the program's span on
    the same thread that holds it or lies in it (the program's span is
    around a call that the benchmark wraps, or inside the wrapped method);
    every program span is used once. ``(program span, the benchmark's ns)``."""
    items = sorted((sp for sp in outside.items if sp[0] == name), key=lambda sp: sp[1])
    assert items, name
    twins = sorted(program, key=lambda sp: sp.start_ns)
    assert len(twins) == len(items), name
    for sp, (_, t0, t1, thread) in zip(twins, items):
        assert harness.thread_key(sp.thread) == thread
        assert (sp.start_ns <= t0 <= t1 <= sp.end_ns) or (t0 <= sp.start_ns <= sp.end_ns <= t1)
    return [(sp, t1 - t0) for sp, (_, t0, t1, _) in zip(twins, items)]


@pytest.mark.parametrize("kind", ["predict", "train"])
def test_the_programs_twins_match_the_benchmarks_own_counts(kind, monkeypatch):
    """The twins a later benchmark change may read in place of its own
    spans and counts: ``ensemble.consolidate`` and ``predict.tiles``
    (against ``consolidate_ms`` and the forward hook's ``tiles_forwarded``),
    ``pool.cut``, ``train.prepare`` and ``train.patches`` (against the cut's
    and ``_prepare``'s wrapped calls and steps x batch), on a tiny cell's
    window run on the CPU under a profiler."""
    from nndetection_tpu_torch.data.loader import PrefetchIterator
    from nndetection_tpu_torch.inference.ensembler import BoxEnsemblerSelective

    # the entries wrap these classes' methods: put them back afterwards
    for cls, attr in ((PrefetchIterator, "__next__"), (BoxEnsemblerSelective, "process_tile"),
                      (BoxEnsemblerSelective, "get_case_result")):
        monkeypatch.setattr(cls, attr, cls.__dict__[attr])
    cell = tiny.predict_cell() if kind == "predict" else tiny.train_cell(3)
    run = harness.Run(bench=tiny.bench_for(cell), workload=cell, config=tiny.config(cell["config"]),
                      seed=2147483659, seconds=1.0, trace=True, device=torch.device("cpu"),
                      spans=harness.Spans(True))
    torch.manual_seed(0)
    entry = harness.load_piece("entries", cell["entry"]).Entry(run)
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        entry.window(1.0)
    spans, counts, dropped = trace.take()
    assert dropped == 0
    ps = program_spans.ProgramSpans(spans, counts)
    if kind == "predict":
        assert counts["predict.tiles"] == run.counts["tiles_forwarded"] > 0
        pairs = twin_pairs(ps.named("ensemble.consolidate"), run.spans, "get_case_result")
        assert len(pairs) == len(run.spans.values["consolidate_ms"])
        assert len(pairs) == len(ps.named("predict.case"))
    else:
        assert counts["train.patches"] == run.counts["steps"] * run.counts["batch"] > 0
        twin_pairs(ps.named("pool.cut"), run.spans, "pool cut (prefetch thread)")
        pairs = twin_pairs(ps.named("train.prepare"), run.spans, "augmentation and targets")
        assert len(pairs) == run.counts["steps"]
    # the two time the same work
    total = sum(t for _, t in pairs) / 1e6
    assert sum(abs(ps.ms(sp) - t / 1e6) for sp, t in pairs) <= 0.05 * total
