"""The benchmark of ``nndetection_tpu_torch`` on one NVIDIA H100: see
``README.md`` beside this file."""
