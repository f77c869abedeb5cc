"""Parameter bridge from the JAX package's flax parameter trees.

:func:`state_dict_from_flax` maps a flax tree (nested dicts of NumPy arrays,
as ``jax.device_get(variables)`` gives them) onto a port model's
``state_dict``. The port names its submodules after the flax scopes, so the
mapping is a leaf rename plus the layout changes:

* conv kernels ``[*k, Ci, Co]`` -> ``weight [Co, Ci, *k]``, 2D or 3D (a
  dense kernel ``[Ci, Co]`` is the case without ``k``);
* transposed-conv kernels ``[*k, Ci, Co]`` -> ``weight [Ci, Co, *k]``,
  flipped along the spatial axes (flax's ``ConvTranspose`` does not flip its
  kernel, PyTorch's transposed convolution does);
* ``scale`` -> ``weight``, including the group norms' doubled scope
  ``GroupNorm_0/GroupNorm_0/{scale,bias}``.

:func:`save_npz` / :func:`load_npz` store such a tree with ``/``-joined keys,
so that parameters exported where JAX runs load where only PyTorch does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias", "scales": "scales"}


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a/b/c": array}``."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/c": array}`` -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


def _convert_leaf(path: str, value: np.ndarray):
    *scopes, leaf = path.split("/")
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"flax leaf {path!r} has no counterpart in the port")
    arr = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        nd = arr.ndim - 2  # spatial dims
        spatial = tuple(range(nd))
        if scopes[-1] == "ConvTranspose_0":
            arr = np.flip(arr, axis=spatial).transpose(nd, nd + 1, *spatial)
        else:
            arr = arr.transpose(nd + 1, nd, *spatial)
    key = ".".join(scopes + [_LEAF_NAMES[leaf]])
    return key, torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def state_dict_from_flax(params: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` of a flax parameter tree.

    Args:
        params: ``{"params": {...}}`` or the inner ``{...}``, nested dicts of
            arrays
        model: the port model whose keys and shapes the tree must fill

    Raises ``KeyError`` if a flax leaf maps to no parameter of ``model`` or a
    parameter of ``model`` gets no leaf, and ``ValueError`` on a shape
    mismatch.
    """
    if set(params) == {"params"}:
        params = params["params"]
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in flatten_tree(params).items():
        key, tensor = _convert_leaf(path, value)
        if key not in expected:
            raise KeyError(f"flax leaf {path!r} -> {key!r}: not a parameter of the model")
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(f"{path!r} -> {key!r}: shape {tuple(tensor.shape)}, "
                             f"model has {tuple(expected[key].shape)}")
        out[key] = tensor
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"model parameters without a flax leaf: {missing}")
    return out


def save_npz(path, params: Mapping[str, Any]) -> None:
    """Store a nested parameter tree as ``.npz`` with ``/``-joined keys."""
    np.savez(path, **flatten_tree(params))


def load_npz(path) -> Dict[str, Any]:
    """Inverse of :func:`save_npz`."""
    with np.load(path) as f:
        return unflatten_tree({k: f[k] for k in f.files})
