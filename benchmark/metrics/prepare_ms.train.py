"""Device milliseconds per step of the pool's cut and of ``Trainer._prepare``
(augmentation and target preparation): the kernels of the traced window
that were launched inside the spans around those calls, on the thread
that made each call (the prefetch thread's cut, the main thread's
preparation), per step of the window."""
from benchmark.readers import span_device_seconds

SPANS = ("pool cut (prefetch thread)", "augmentation and targets")


def read(run):
    steps = run.counts.get("steps", 0)
    seconds = span_device_seconds(run, SPANS)
    return 1e3 * seconds / steps if seconds and steps else None
