"""Dataset converters of the port (counterpart of the repository's
``projects/``): each ``Task*/prepare.py`` runs as a file or as ``python -m
nndetection_tpu_torch.projects.<Task>.prepare`` with the JAX script's
arguments."""
