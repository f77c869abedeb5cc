"""Model FLOP utilization of prediction: the forward operations of every
tile (and flip) the window ran, over wall time x the bf16 peak."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, run.counts.get("tiles_forwarded", 0))
