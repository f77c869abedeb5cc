"""Host milliseconds per case of the program's ``predict.stage`` span in
``Predictor.predict_case``: the case's pad, its float32 and bfloat16
conversion and its copy to the card."""
from benchmark import program_spans


def read(run):
    spans = program_spans.read(run)
    return spans.per_root("predict.stage", "predict.case") if spans else None
