"""Host milliseconds per step blocked on the card inside the program's
``train.step``: ``train.sync``, the gradient norm's ``.item()`` in
``Trainer._apply_update``, and the loss's ``sync.copy`` (the box coder's
weights copied to the card from pageable memory, which waits for the
forward queued before it)."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    steps = len(spans.named("train.step")) if spans else 0
    if not steps or not spans.named("train.sync"):
        return None
    return spans.wait_ms("train.step") / steps
