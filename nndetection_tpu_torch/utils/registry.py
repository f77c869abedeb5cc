"""Name -> class registries that decouple configuration strings from
implementations (copy of :mod:`nndetection_tpu.utils.registry`)."""
from __future__ import annotations

from typing import Callable, Dict, TypeVar

T = TypeVar("T")


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._mapping: Dict[str, Callable] = {}

    def register(self, cls: T = None, *, name: str = None) -> T:
        def deco(c):
            key = name or c.__name__
            if key in self._mapping and self._mapping[key] is not c:
                raise KeyError(f"{key} already registered in {self.name}")
            self._mapping[key] = c
            return c

        if cls is None:
            return deco
        return deco(cls)

    def __getitem__(self, key: str) -> Callable:
        if key not in self._mapping:
            raise KeyError(
                f"{key} not found in registry {self.name}; "
                f"available: {sorted(self._mapping)}"
            )
        return self._mapping[key]

    def __contains__(self, key: str) -> bool:
        return key in self._mapping

    def keys(self):
        return self._mapping.keys()


MODULE_REGISTRY = Registry("module")
PLANNER_REGISTRY = Registry("planner")
DATALOADER_REGISTRY = Registry("dataloader")
AUGMENTATION_REGISTRY = Registry("augmentation")
