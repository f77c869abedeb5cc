"""nndetection-tpu on PyTorch and CUDA: the port of :mod:`nndetection_tpu`.

The module tree mirrors the JAX package (``core/boxes``, ``models``, ``ops``,
``inference``, ``data``, ``train``, ``losses``) so that every module has a
counterpart of the same name there. The JAX package is the reference this
port is tested against.

Plain tensor code is PyTorch. Every kernel the JAX package wrote in Pallas for
the TPU is a hand-written Hopper kernel here (``ops/``), CUDA C++ under
``csrc/`` or Triton, each beside a plain PyTorch version of the same function
that runs on CPU tensors.

This package imports ``torch`` and never ``jax``.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when a CUDA device is asked for and there is none; the
    CPU runs only when the caller passes ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev
