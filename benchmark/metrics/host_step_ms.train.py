"""Host milliseconds per step that are not a wait for the card: the
program's ``train.step`` span less the waits inside it (``train.sync`` and
``sync.copy``, as ``sync_wait_ms`` reads them), plus ``train.to_device``.
With ``sync_wait_ms`` and ``batch_wait_ms`` it makes up the step's wall
time."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    steps = len(spans.named("train.step")) if spans else 0
    if not steps:
        return None
    busy = (spans.total_ms("train.step") - spans.wait_ms("train.step")
            + spans.total_ms("train.to_device"))
    return busy / steps
