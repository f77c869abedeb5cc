"""The program's own spans and counters in a traced run, as the port's
recorder (``nndetection_tpu_torch/utils/trace.py``) kept them while the
harness's profiler was on: the window alone, on every thread.

:func:`read` takes them from the recorder once per run and keeps them on the
run, for every reader. It gives None where the program recorded nothing: an
untraced run, a run on the CPU (no profiler), or a program without the
recorder. The readers of ``metrics/`` that use it then give None too.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from benchmark import harness

# the spans in which the host waits for the card: a call's detections copied
# back, the gradient norm read, and the small copies to the card from
# pageable memory (``sync.copy``), which wait for the work queued before
# them. Where such a copy stops waiting, the wait moves into the next read,
# and the sum stays.
WAITS = ("predict.fetch", "train.sync", "sync.copy")


class ProgramSpans:
    """Spans (``name``, ``start_ns``, ``end_ns``, ``thread``, ``id``,
    ``parent``) and counters, with durations and self times in
    milliseconds."""

    def __init__(self, spans: Sequence, counts: Dict[str, int], dropped: int = 0):
        self.spans = list(spans)
        self.counts = dict(counts)
        self.dropped = dropped
        self.by_id = {sp.id: sp for sp in self.spans}
        self.children: Dict[int, List] = {}
        for sp in self.spans:
            if sp.parent is not None:
                self.children.setdefault(sp.parent, []).append(sp)

    def named(self, name: str) -> List:
        return [sp for sp in self.spans if sp.name == name]

    @staticmethod
    def ms(sp) -> float:
        return (sp.end_ns - sp.start_ns) / 1e6

    def self_ms(self, sp) -> float:
        """The span's duration less the part of it that its children cover."""
        covered, last = 0, sp.start_ns
        for s, e in sorted((c.start_ns, c.end_ns) for c in self.children.get(sp.id, ())):
            s, e = max(s, last), min(e, sp.end_ns)
            if e > s:
                covered += e - s
                last = e
        return (sp.end_ns - sp.start_ns - covered) / 1e6

    def root(self, sp):
        while sp.parent is not None and sp.parent in self.by_id:
            sp = self.by_id[sp.parent]
        return sp

    def total_ms(self, name: str, root: Optional[str] = None) -> float:
        """Milliseconds of every span named ``name`` (under a root named
        ``root``, if given)."""
        return sum(self.ms(sp) for sp in self.named(name)
                   if root is None or self.root(sp).name == root)

    def wait_ms(self, root: str) -> float:
        """Milliseconds of the :data:`WAITS` spans under roots named ``root``."""
        return sum(self.total_ms(name, root=root) for name in WAITS)

    def per_root(self, name: str, root: str) -> Optional[float]:
        """Milliseconds of the ``name`` spans per ``root`` span (a case, a
        step); None where either is missing."""
        n = len(self.named(root))
        if not n or not self.named(name):
            return None
        return self.total_ms(name) / n


def _take() -> Optional[ProgramSpans]:
    try:
        from nndetection_tpu_torch.utils import trace
    except ImportError:  # a program without the recorder
        return None
    spans, counts, dropped = trace.take()
    if dropped:
        harness.log(f"[bench] the program's recorder dropped {dropped} spans")
    return ProgramSpans(spans, counts, dropped) if spans else None


def read(run) -> Optional[ProgramSpans]:
    """The program's spans of ``run``, taken at the first call."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _take()
    return run.program_spans
