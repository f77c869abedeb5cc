"""Checkpoint discovery and loading for inference (counterpart of
:mod:`nndetection_tpu.inference.loading`), for the checkpoints of either
package.

Both packages name their checkpoints ``*.ckpt``; the content tells them
apart. A ``torch.save`` zip (the port's ``Trainer.save_checkpoint``) starts
with the ``PK`` magic and loads with ``weights_only=True``. Anything else is
a pickle of the JAX ``Trainer.save_checkpoint``, read here without JAX:
:class:`_JaxCheckpointUnpickler` maps the JAX ``RetinaUNetConfig`` to a stub
that keeps its fields, flax's ``FrozenDict`` to ``dict`` and every other
``jax``, ``jaxlib``, ``flax`` or ``optax`` class to an inert stub. Only
``params``, ``swa_params``, ``swa_count``, ``extra`` and ``model_cfg`` are
kept (the optimizer state is dropped); the flax parameters become a port
``state_dict`` through :func:`nndetection_tpu_torch.bridge.state_dict_from_flax`.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nndetection_tpu_torch.bridge import state_dict_from_flax
from nndetection_tpu_torch.inference.predictor import ModelBundle
from nndetection_tpu_torch.models.retina_unet import RetinaUNet, RetinaUNetConfig

KEPT_FIELDS = ("params", "swa_params", "swa_count", "extra", "model_cfg")
_FOREIGN = ("jax", "jaxlib", "flax", "optax")
_NUMPY_CORE = ("numpy.core.multiarray", "numpy._core.multiarray", "numpy.core.numeric",
               "numpy._core.numeric")


class _Inert:
    """Stands in for a jax, flax or optax object (the optimizer state): takes
    any constructor arguments and any state."""

    qualname = "?"

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _JaxConfig:
    """The JAX ``RetinaUNetConfig``: a frozen dataclass, pickled as its
    ``__dict__``, which this stub keeps."""


class _NeedsMlDtypes:
    """An array, scalar or dtype whose type lives in ``ml_dtypes``: the
    subclass made for each such type carries its name."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _ArrayShell:
    """What ``numpy``'s ``_reconstruct`` returns here: the array is made when
    its state arrives, unless its dtype needs ``ml_dtypes``."""

    def __init__(self, reconstruct, args):
        self._make = lambda: reconstruct(*args)
        self.value: Any = None

    def __setstate__(self, state):
        dtype = state[2]
        if isinstance(dtype, _NeedsMlDtypes):
            self.value = dtype
        else:
            self.value = self._make()
            self.value.__setstate__(state)


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if module == "nndetection_tpu.models.retina_unet" and name == "RetinaUNetConfig":
            return _JaxConfig
        if module == "flax.core.frozen_dict" and name == "FrozenDict":
            return dict
        if root == "ml_dtypes":
            return type(name, (_NeedsMlDtypes,), {})
        if root in _FOREIGN or root == "nndetection_tpu":
            return type(name, (_Inert,), {"qualname": f"{module}.{name}"})
        if module == "numpy" and name == "dtype":
            return _dtype
        if module in _NUMPY_CORE:
            real = super().find_class(module, name)
            if name == "_reconstruct":
                return lambda *args: _ArrayShell(real, args)
            if name in ("scalar", "_frombuffer"):
                return lambda *args: _unless_ml_dtypes(real, args)
            return real
        return super().find_class(module, name)


def _dtype(obj, *args):
    if isinstance(obj, type) and issubclass(obj, _NeedsMlDtypes):
        return obj()
    return np.dtype(obj, *args)


def _unless_ml_dtypes(make, args):
    missing = [a for a in args if isinstance(a, _NeedsMlDtypes)]
    return missing[0] if missing else make(*args)


def _resolve(obj, path: str):
    """The kept field ``obj`` with its arrays made; raises for anything that
    needs a package the port does not import."""
    if isinstance(obj, _ArrayShell):
        obj = obj.value
    if isinstance(obj, _NeedsMlDtypes):
        raise ValueError(f"checkpoint field {path!r} holds {type(obj).__name__} data, which "
                         "needs ml_dtypes; store it as float32")
    if isinstance(obj, _Inert):
        raise ValueError(f"checkpoint field {path!r} holds a {obj.qualname} object")
    if isinstance(obj, dict):
        return {k: _resolve(v, f"{path}/{k}") for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_resolve(v, f"{path}[{i}]") for i, v in enumerate(obj))
    return obj


def _plain(value):
    """NumPy scalars of a config field as Python numbers."""
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def read_jax_checkpoint(path) -> Dict[str, Any]:
    """The kept fields of a JAX ``Trainer.save_checkpoint`` pickle, without
    JAX: ``model_cfg`` as the JAX config's field dict, the parameter trees
    as nested dicts of NumPy arrays."""
    with open(path, "rb") as f:
        payload = _JaxCheckpointUnpickler(f).load()
    out = {k: _resolve(payload.get(k), k) for k in KEPT_FIELDS if k != "model_cfg"}
    cfg = payload.get("model_cfg")
    if not isinstance(cfg, _JaxConfig):
        raise ValueError(f"{path}: model_cfg is a {type(cfg).__name__}, not the JAX "
                         "RetinaUNetConfig")
    out["model_cfg"] = {k: _plain(v) for k, v in _resolve(vars(cfg), "model_cfg").items()}
    return out


def _is_torch_zip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def load_model_bundle(ckpt_path, name: Optional[str] = None) -> ModelBundle:
    """A :class:`ModelBundle` from a checkpoint of either package: the SWA
    average when the checkpoint holds one (``swa_count``) and ``extra``
    asks for it (``use_swa``), else the trained parameters."""
    from_port = _is_torch_zip(ckpt_path)
    if from_port:
        payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    else:
        payload = read_jax_checkpoint(ckpt_path)
    cfg = RetinaUNetConfig.from_dict(payload["model_cfg"])
    use_swa = payload.get("swa_count", 0) and (payload.get("extra") or {}).get("use_swa", False)
    params = payload["swa_params"] if use_swa else payload["params"]
    if not from_port:
        params = state_dict_from_flax(params, RetinaUNet(cfg))
    return ModelBundle(cfg=cfg, params=params, name=name or Path(ckpt_path).parent.name)


def get_latest_model(train_dir, identifier: str = "last") -> Path:
    train_dir = Path(train_dir)
    cand = train_dir / f"model_{identifier}.ckpt"
    if cand.exists():
        return cand
    matches = sorted(train_dir.glob("model_*.ckpt"))
    if not matches:
        raise FileNotFoundError(f"no checkpoints in {train_dir}")
    return matches[-1]


def load_final_model(train_dir, identifier: str = "last") -> ModelBundle:
    return load_model_bundle(get_latest_model(train_dir, identifier))


def load_all_models(model_dir, identifier: str = "last", num_folds: int = 5) -> List[ModelBundle]:
    """Every fold's checkpoint: ``consolidated/model_fold*.ckpt`` when that
    directory holds any, else ``fold{k}/model_{identifier}.ckpt``."""
    model_dir = Path(model_dir)
    consolidated = model_dir / "consolidated"
    bundles = []
    if consolidated.is_dir():
        for ckpt in sorted(consolidated.glob("model_fold*.ckpt")):
            bundles.append(load_model_bundle(ckpt, name=ckpt.stem))
        if bundles:
            return bundles
    for fold in range(num_folds):
        ckpt = model_dir / f"fold{fold}" / f"model_{identifier}.ckpt"
        if ckpt.exists():
            bundles.append(load_model_bundle(ckpt, name=f"fold{fold}"))
    if not bundles:
        raise FileNotFoundError(f"no fold checkpoints found in {model_dir}")
    return bundles
