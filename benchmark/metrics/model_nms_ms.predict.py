"""Host milliseconds per case of the program's ``ensemble.model_nms`` spans:
each stream's model-level top-k, clip and float64 NMS on the host, inside
the ensembler's ``get_case_result``."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return spans.per_root("ensemble.model_nms", "predict.case") if spans else None
