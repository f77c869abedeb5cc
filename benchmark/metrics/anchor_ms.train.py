"""Device milliseconds per step of the anchor work of the loss: the kernels,
copies and memsets of the traced window that the program launched inside
its ``train.match`` (ATSS matching of every anchor to the ground truth)
and ``train.sample`` (the hard-negative sampler's draw) spans, on the
span's own thread, per ``train.step`` span. None where the program has no
such spans."""
from types import SimpleNamespace

from benchmark import harness, program_spans
from benchmark.readers import span_device_seconds

SPANS = ("train.match", "train.sample")


def read(run):
    spans = program_spans.read(run)
    steps = len(spans.named("train.step")) if spans else 0
    if not steps:
        return None
    items = [(sp.name, sp.start_ns, sp.end_ns, harness.thread_key(sp.thread))
             for sp in spans.spans if sp.name in SPANS]
    view = SimpleNamespace(spans=SimpleNamespace(items=items), launches=run.launches,
                           events=run.events)
    seconds = span_device_seconds(view, SPANS)
    return 1e3 * seconds / steps if seconds else None
