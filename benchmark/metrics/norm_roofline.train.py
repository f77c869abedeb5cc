"""Roofline share of the instance-norm kernels in training: per patch the
bytes of #1 and #2 (twice under remat, whose backward runs the forward
again) and of #3 and #4, at 3.35 TB/s, over their device time in the
trace."""
from benchmark.readers import norm_bytes_per_patch, roofline_pct


def read(run):
    fwd, bwd = norm_bytes_per_patch(run.ref_cfg)
    per_patch = (2 if run.counts.get("remat") else 1) * fwd + bwd
    patches = run.counts.get("steps", 0) * run.counts.get("batch", 0)
    return roofline_pct(run, per_patch * patches, "norm")
