"""Host milliseconds per case of the ensembler's ``get_case_result`` (the
model-level NMS, the whole-case WBC on the card, its copy back), from a
span around each call in the traced window."""
from benchmark.readers import mean


def read(run):
    return mean(run.spans.values.get("consolidate_ms"))
