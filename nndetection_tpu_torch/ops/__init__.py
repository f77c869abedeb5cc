"""Hand-written Hopper kernels, each beside a plain PyTorch version of the
same function.

A wrapper calls the plain version for a tensor on the CPU. For a CUDA tensor
it launches its kernel or raises; there is no fallback on the card.
:data:`LAUNCHES` counts kernel launches per wrapper name, so that a run can
show that its main path went through the kernels.
"""
from collections import Counter

LAUNCHES: Counter = Counter()
