"""Host milliseconds per case of the program's ``predict.ensemble_tiles``
spans: each call's tiles handed to the box ensembler's ``process_tile``,
one stream per model and flip, before the next call is queued."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return spans.per_root("predict.ensemble_tiles", "predict.case") if spans else None
