"""Model FLOP utilization of training: 3 x the forward operations of every
patch the window stepped (remat's recomputation not counted), over wall
time x the bf16 peak."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, 3 * run.counts.get("steps", 0) * run.counts.get("batch", 0))
