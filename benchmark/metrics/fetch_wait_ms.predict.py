"""Host milliseconds per case blocked on the card in the program's
``Predictor._infer``: each call's ``predict.fetch`` (the detections' copy
to the host) and the post-processing's ``sync.copy`` spans (the box coder's
weights, the clip's bounds and the flips' lists copied to the card from
pageable memory, each waiting for the work queued before it)."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    cases = len(spans.named("predict.case")) if spans else 0
    if not cases or not spans.named("predict.fetch"):
        return None
    return spans.wait_ms("predict.case") / cases
