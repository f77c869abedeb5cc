"""The command-line entry points of the port (counterpart of
:mod:`nndetection_tpu.cli`), each run as ``python -m
nndetection_tpu_torch.cli.<name>``. Every command runs on the card unless
its config names another device (``-o device=cpu``)."""
