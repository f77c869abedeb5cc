"""The card's idle share over the traced training window: 1 - (union of
kernel, copy and memset intervals) / window."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
