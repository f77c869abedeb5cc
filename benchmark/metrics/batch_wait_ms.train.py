"""Host milliseconds per step of the program's ``train.batch_wait`` spans:
the main thread waiting in ``PrefetchIterator.__next__`` for the prefetch
thread's next batch (the pool's draws and cut)."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return spans.per_root("train.batch_wait", "train.step") if spans else None
