"""Roofline share of the instance-norm kernels in prediction: the bytes #1
and #2 must move for every tile the window ran, at 3.35 TB/s, over their
device time in the trace."""
from benchmark.readers import norm_bytes_per_patch, roofline_pct


def read(run):
    fwd, _ = norm_bytes_per_patch(run.ref_cfg)
    return roofline_pct(run, fwd * run.counts.get("tiles_forwarded", 0), "norm")
